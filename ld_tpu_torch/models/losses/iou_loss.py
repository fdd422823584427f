"""IoU-family box regression losses (IoU / GIoU / DIoU / CIoU); port of
`ld_tpu/models/losses/iou_loss.py:15-80` over the port's `bbox_overlaps`.

As in the JAX package, the loss classes default `eps=1e-6` and pass it on,
so GIoULoss runs at 1e-6 and not at the 1e-7 of `giou_loss`'s signature; an
(N, 4) weight becomes its per-box mean.
"""
from __future__ import annotations

from torch import nn

from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.utils.registry import LOSSES
from .utils import weighted_loss


@weighted_loss
def iou_loss(pred, target, linear=False, eps=1e-6):
    ious = bbox_overlaps(pred, target, is_aligned=True).clamp(min=eps)
    return 1 - ious if linear else -ious.log()


@weighted_loss
def giou_loss(pred, target, eps=1e-7):
    return 1 - bbox_overlaps(pred, target, mode='giou', is_aligned=True,
                             eps=eps)


@weighted_loss
def diou_loss(pred, target, eps=1e-7):
    return 1 - bbox_overlaps(pred, target, mode='diou', is_aligned=True,
                             eps=eps)


@weighted_loss
def ciou_loss(pred, target, eps=1e-7):
    return 1 - bbox_overlaps(pred, target, mode='ciou', is_aligned=True,
                             eps=eps)


class _IoUFamilyLoss(nn.Module):
    _fn = None

    def __init__(self, eps=1e-6, reduction='mean', loss_weight=1.0, **kwargs):
        super().__init__()
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.extra = kwargs

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        if weight is not None and weight.dim() > 1:
            # (N, 4) box weights -> one per box (the 4 components are equal)
            weight = weight.mean(dim=-1)
        return self.loss_weight * type(self)._fn(
            pred, target, weight, eps=self.eps, reduction=reduction,
            avg_factor=avg_factor, **self.extra)


@LOSSES.register_module()
class IoULoss(_IoUFamilyLoss):
    _fn = staticmethod(iou_loss)

    def __init__(self, linear=False, **kwargs):
        super().__init__(linear=linear, **kwargs)


@LOSSES.register_module()
class GIoULoss(_IoUFamilyLoss):
    _fn = staticmethod(giou_loss)


@LOSSES.register_module()
class DIoULoss(_IoUFamilyLoss):
    _fn = staticmethod(diou_loss)


@LOSSES.register_module()
class CIoULoss(_IoUFamilyLoss):
    _fn = staticmethod(ciou_loss)
