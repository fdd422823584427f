from .single_stage import SingleStageDetector
from .kd_one_stage import IMDetector, KnowledgeDistillationSingleStageDetector
from .two_stage import (RPN, FastRCNN, KnowledgeDistillationTwoStageDetector,
                        TwoStageDetector)

__all__ = ['SingleStageDetector', 'KnowledgeDistillationSingleStageDetector',
           'IMDetector', 'TwoStageDetector', 'FastRCNN', 'RPN',
           'KnowledgeDistillationTwoStageDetector']
