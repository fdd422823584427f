from .single_stage import SingleStageDetector
from .kd_one_stage import IMDetector, KnowledgeDistillationSingleStageDetector
from .two_stage import (RPN, FastRCNN, KnowledgeDistillationTwoStageDetector,
                        TridentFasterRCNN, TwoStageDetector)
from ld_tpu_torch.utils.registry import DETECTORS

# the JAX package's other detectors, by the ROADMAP.md Queue A item that
# ports them
DETECTORS.not_ported.update({
    'YOLACT': 'ROADMAP.md Queue A item 8', 'SOLO': 'ROADMAP.md Queue A item 8',
    'CornerNet': 'ROADMAP.md Queue A item 9',
    'CentripetalNet': 'ROADMAP.md Queue A item 9',
    'SparseRCNN': 'ROADMAP.md Queue A item 10',
    'DETR': 'ROADMAP.md Queue A item 10'})

__all__ = ['SingleStageDetector', 'KnowledgeDistillationSingleStageDetector',
           'IMDetector', 'TwoStageDetector', 'FastRCNN', 'RPN',
           'KnowledgeDistillationTwoStageDetector', 'TridentFasterRCNN']
