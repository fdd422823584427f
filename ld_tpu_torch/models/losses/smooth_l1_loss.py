"""L1 and smooth-L1 regression losses; port of
`ld_tpu/models/losses/smooth_l1_loss.py`.

Element-wise |pred - target|, or its smooth form (quadratic below `beta`),
under the weighted-loss contract of `utils.py`.
"""
from __future__ import annotations

import torch
from torch import nn

from ld_tpu_torch.utils.registry import LOSSES
from .utils import weighted_loss


@weighted_loss
def smooth_l1_loss(pred, target, beta=1.0):
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


@weighted_loss
def l1_loss(pred, target):
    return torch.abs(pred - target)


@LOSSES.register_module()
class SmoothL1Loss(nn.Module):

    def __init__(self, beta=1.0, reduction='mean', loss_weight=1.0):
        super().__init__()
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        return self.loss_weight * smooth_l1_loss(
            pred, target, weight, beta=self.beta,
            reduction=reduction_override or self.reduction,
            avg_factor=avg_factor)


@LOSSES.register_module()
class L1Loss(nn.Module):

    def __init__(self, reduction='mean', loss_weight=1.0):
        super().__init__()
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        return self.loss_weight * l1_loss(
            pred, target, weight,
            reduction=reduction_override or self.reduction,
            avg_factor=avg_factor)
