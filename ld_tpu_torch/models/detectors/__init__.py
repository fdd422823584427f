from .single_stage import SingleStageDetector
from .kd_one_stage import IMDetector, KnowledgeDistillationSingleStageDetector
from .two_stage import (RPN, FastRCNN, KnowledgeDistillationTwoStageDetector,
                        TwoStageDetector)
from ld_tpu_torch.utils.registry import DETECTORS, HEADS

# the JAX package's other detectors, by the ROADMAP.md Queue A item that
# ports them
DETECTORS.not_ported.update({
    'TOOD': 'ROADMAP.md Queue A item 6', 'YOLOV3': 'ROADMAP.md Queue A item 7',
    'YOLACT': 'ROADMAP.md Queue A item 8', 'SOLO': 'ROADMAP.md Queue A item 8',
    'CornerNet': 'ROADMAP.md Queue A item 9',
    'CentripetalNet': 'ROADMAP.md Queue A item 9',
    'SparseRCNN': 'ROADMAP.md Queue A item 10',
    'DETR': 'ROADMAP.md Queue A item 10'})
HEADS.not_ported['CascadeRPNHead'] = 'ROADMAP.md Queue A item 6'

__all__ = ['SingleStageDetector', 'KnowledgeDistillationSingleStageDetector',
           'IMDetector', 'TwoStageDetector', 'FastRCNN', 'RPN',
           'KnowledgeDistillationTwoStageDetector']
