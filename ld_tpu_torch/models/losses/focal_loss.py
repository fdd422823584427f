"""Sigmoid focal loss (Focal Loss, arXiv:1708.02002); port of
`ld_tpu/models/losses/focal_loss.py:17-54`.

  FL(x, t) = BCE(x, t) * (alpha * t + (1 - alpha) * (1 - t)) * pt^gamma
  with pt = (1 - sigmoid(x)) * t + sigmoid(x) * (1 - t)

over (..., C) logits, against int targets (background == C) or one-hot
float targets. Only the sigmoid form exists, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.utils.registry import LOSSES
from .utils import weight_reduce_loss


def bce_with_logits(pred: torch.Tensor, target) -> torch.Tensor:
    """Element-wise binary cross entropy on logits, in the numerically
    stable form max(x, 0) - x * t + log(1 + exp(-|x|))."""
    return pred.clamp(min=0) - pred * target + torch.log1p(
        torch.exp(-pred.abs()))


def sigmoid_focal_loss(pred, target, weight=None, gamma=2.0, alpha=0.25,
                       reduction='mean', avg_factor=None):
    """Focal loss on (..., C) logits with (...,) int targets (background
    == C) or (..., C) one-hot float targets; a (...,) weight applies to
    every class of its row."""
    num_classes = pred.shape[-1]
    if target.dim() == pred.dim() - 1:
        pos = (target >= 0) & (target < num_classes)
        target = F.one_hot(torch.where(pos, target, torch.zeros_like(target))
                           .long(), num_classes).to(pred.dtype) * \
            pos[..., None].to(pred.dtype)
    pred_sigmoid = torch.sigmoid(pred)
    pt = (1 - pred_sigmoid) * target + pred_sigmoid * (1 - target)
    focal_weight = (alpha * target + (1 - alpha) * (1 - target)) * pt**gamma
    loss = bce_with_logits(pred, target) * focal_weight
    if weight is not None and weight.dim() == loss.dim() - 1:
        weight = weight[..., None]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


@LOSSES.register_module()
class FocalLoss(nn.Module):

    def __init__(self, use_sigmoid=True, gamma=2.0, alpha=0.25,
                 reduction='mean', loss_weight=1.0):
        super().__init__()
        if not use_sigmoid:
            raise NotImplementedError('only the sigmoid focal loss exists, '
                                      'in the JAX package and in the port')
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * sigmoid_focal_loss(
            pred, target, weight, gamma=self.gamma, alpha=self.alpha,
            reduction=reduction, avg_factor=avg_factor)
