"""The JAX package's misc losses; port of `BalancedL1Loss` and
`BoundedIoULoss` (`ld_tpu/models/losses/misc_losses.py:19-45, 121-161`).
The file's other losses (GHM, ...) are not ported yet (ROADMAP.md A7).

Balanced L1 (Libra R-CNN) of |pred - target| = x, with b = e^(gamma /
alpha) - 1: alpha / b (b x + 1) ln(b x / beta + 1) - alpha x under `beta`,
gamma x + gamma / b - alpha beta over it; element-wise, through the
`weighted_loss` contract.

Bounded IoU (Libra R-CNN) on decoded xyxy boxes: for the centre offsets
1 - max((t - 2|d|) / (t + 2|d| + eps), 0) on each axis, for the sides
1 - min(t / (p + eps), p / (t + eps)); each of the four terms through a
smooth L1 at `beta` (0.5 x^2 / beta under it, x - beta / 2 over it), summed
over the four. A (..., 4) weight is reduced by its mean over the last axis
before the `weighted_loss` reduction, as the JAX loss does.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ld_tpu_torch.utils.registry import LOSSES
from .utils import weighted_loss


@weighted_loss
def balanced_l1_loss(pred, target, beta=1.0, alpha=0.5, gamma=1.5):
    diff = (pred - target).abs()
    b = math.e**(gamma / alpha) - 1
    return torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log(b * diff / beta + 1) -
        alpha * diff,
        gamma * diff + gamma / b - alpha * beta)


@LOSSES.register_module()
class BalancedL1Loss(nn.Module):

    def __init__(self, alpha=0.5, gamma=1.5, beta=1.0, reduction='mean',
                 loss_weight=1.0):
        super().__init__()
        self.alpha, self.gamma, self.beta = alpha, gamma, beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * balanced_l1_loss(
            pred, target, weight, beta=self.beta, alpha=self.alpha,
            gamma=self.gamma, reduction=reduction, avg_factor=avg_factor)


@weighted_loss
def bounded_iou_loss(pred, target, beta=0.2, eps=1e-3):
    px = (pred[..., 0] + pred[..., 2]) * 0.5
    py = (pred[..., 1] + pred[..., 3]) * 0.5
    pw = pred[..., 2] - pred[..., 0]
    ph = pred[..., 3] - pred[..., 1]
    tx = (target[..., 0] + target[..., 2]) * 0.5
    ty = (target[..., 1] + target[..., 3]) * 0.5
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    dx = tx - px
    dy = ty - py
    loss_dx = 1 - ((tw - 2 * dx.abs()) / (tw + 2 * dx.abs() + eps)).clamp(
        min=0)
    loss_dy = 1 - ((th - 2 * dy.abs()) / (th + 2 * dy.abs() + eps)).clamp(
        min=0)
    loss_dw = 1 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    loss_dh = 1 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], -1)
    return torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta).sum(-1)


@LOSSES.register_module()
class BoundedIoULoss(nn.Module):

    def __init__(self, beta=0.2, eps=1e-3, reduction='mean',
                 loss_weight=1.0):
        super().__init__()
        self.beta, self.eps = beta, eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        if weight is not None and weight.dim() > 1:
            weight = weight.mean(-1)
        return self.loss_weight * bounded_iou_loss(
            pred, target, weight, beta=self.beta, eps=self.eps,
            reduction=reduction, avg_factor=avg_factor)
