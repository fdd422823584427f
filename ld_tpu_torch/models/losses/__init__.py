from ld_tpu_torch.utils.registry import LOSSES
from .utils import reduce_loss, weight_reduce_loss, weighted_loss
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy)
from .focal_loss import FocalLoss, sigmoid_focal_loss
from .gfocal_loss import (DistributionFocalLoss, QualityFocalLoss,
                          distribution_focal_loss, quality_focal_loss)
from .iou_loss import CIoULoss, DIoULoss, GIoULoss, IoULoss
from .smooth_l1_loss import L1Loss, SmoothL1Loss, l1_loss, smooth_l1_loss
from .kd_loss import (IMLoss, KnowledgeDistillationKLDivLoss, im_loss,
                      knowledge_distillation_kl_div_loss)
from .varifocal_loss import VarifocalLoss
from .misc_losses import (GHMC, GHMR, BalancedL1Loss, BoundedIoULoss,
                          MSELoss, balanced_l1_loss, bounded_iou_loss,
                          mse_loss)

__all__ = [
    'reduce_loss', 'weight_reduce_loss', 'weighted_loss', 'QualityFocalLoss',
    'DistributionFocalLoss', 'quality_focal_loss', 'distribution_focal_loss',
    'IoULoss', 'GIoULoss', 'DIoULoss', 'CIoULoss',
    'KnowledgeDistillationKLDivLoss', 'IMLoss',
    'knowledge_distillation_kl_div_loss', 'im_loss', 'FocalLoss',
    'sigmoid_focal_loss', 'CrossEntropyLoss', 'cross_entropy',
    'binary_cross_entropy', 'L1Loss', 'SmoothL1Loss', 'l1_loss',
    'smooth_l1_loss', 'VarifocalLoss', 'BalancedL1Loss', 'BoundedIoULoss',
    'balanced_l1_loss', 'bounded_iou_loss', 'GHMC', 'GHMR', 'MSELoss',
    'mse_loss'
]

# the JAX package's other losses, not ported yet
LOSSES.not_ported.update({name: 'ROADMAP.md Queue A item 9' for name in (
    'AssociativeEmbeddingLoss', 'GaussianFocalLoss')})
LOSSES.not_ported['DiceLoss'] = 'ROADMAP.md Queue A item 8'
