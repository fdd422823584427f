from .single_stage import SingleStageDetector
from .kd_one_stage import IMDetector, KnowledgeDistillationSingleStageDetector

__all__ = ['SingleStageDetector', 'KnowledgeDistillationSingleStageDetector',
           'IMDetector']
