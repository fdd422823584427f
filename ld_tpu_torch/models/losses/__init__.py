from .utils import reduce_loss, weight_reduce_loss, weighted_loss
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy)
from .focal_loss import FocalLoss, sigmoid_focal_loss
from .gfocal_loss import (DistributionFocalLoss, QualityFocalLoss,
                          distribution_focal_loss, quality_focal_loss)
from .iou_loss import CIoULoss, DIoULoss, GIoULoss, IoULoss
from .kd_loss import (IMLoss, KnowledgeDistillationKLDivLoss, im_loss,
                      knowledge_distillation_kl_div_loss)

__all__ = [
    'reduce_loss', 'weight_reduce_loss', 'weighted_loss', 'QualityFocalLoss',
    'DistributionFocalLoss', 'quality_focal_loss', 'distribution_focal_loss',
    'IoULoss', 'GIoULoss', 'DIoULoss', 'CIoULoss',
    'KnowledgeDistillationKLDivLoss', 'IMLoss',
    'knowledge_distillation_kl_div_loss', 'im_loss', 'FocalLoss',
    'sigmoid_focal_loss', 'CrossEntropyLoss', 'cross_entropy',
    'binary_cross_entropy'
]
