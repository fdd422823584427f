"""Quality Focal Loss and Distribution Focal Loss (GFocal, arXiv:2006.04388);
port of `ld_tpu/models/losses/gfocal_loss.py:22-121`.

Dense forms, as in the JAX package:

  QFL(x) = sum_c BCE(x_c, q_c) * |q_c - sigmoid(x_c)|^beta
  with q_c the IoU quality on the assigned class of a positive, 0 elsewhere
  (a one-hot over the classes; background is label == num_classes).

  DFL(x) = -((y_r - y) * log p_{y_l} + (y - y_l) * log p_{y_r})
  with y_l = floor(y) clipped to [0, n_bins - 2] and y_r = y_l + 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.utils.registry import LOSSES
from .focal_loss import bce_with_logits
from .utils import weighted_loss


def _bce_on_probs(pred, target, eps=1e-12):
    p = pred.clamp(eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


@weighted_loss
def quality_focal_loss(pred: torch.Tensor, target, beta: float = 2.0,
                       use_sigmoid: bool = True):
    """Element-wise QFL.

    Args:
        pred: (..., C) joint cls-quality logits (use_sigmoid=True), or
            probabilities (use_sigmoid=False).
        target: tuple (label (...,) int with background == C,
            score (...,) float).
    Returns:
        (...,) loss per anchor, summed over the classes.
    """
    label, score = target
    num_classes = pred.shape[-1]
    if use_sigmoid:
        bce = bce_with_logits
        pred_sigmoid = torch.sigmoid(pred)
    else:
        bce = _bce_on_probs
        pred_sigmoid = pred

    # every position starts as a negative: target quality 0
    loss = bce(pred, torch.zeros_like(pred)) * pred_sigmoid**beta

    # positives: the assigned class channel is supervised by the IoU score
    pos = (label >= 0) & (label < num_classes)
    safe_label = torch.where(pos, label, torch.zeros_like(label))
    onehot = F.one_hot(safe_label.long(), num_classes).to(pred.dtype)
    onehot = onehot * pos[..., None].to(pred.dtype)
    score_b = score[..., None]
    pos_loss = bce(pred, score_b) * (score_b - pred_sigmoid).abs()**beta
    loss = loss * (1.0 - onehot) + pos_loss * onehot
    return loss.sum(dim=-1)


@weighted_loss
def distribution_focal_loss(pred: torch.Tensor, label: torch.Tensor):
    """Element-wise DFL.

    Args:
        pred: (N, reg_max+1) distribution logits of one box side.
        label: (N,) continuous target in [0, reg_max).
    Returns:
        (N,) loss.
    """
    n_bins = pred.shape[-1]
    dis_left = label.long().clamp(0, n_bins - 2)
    dis_right = dis_left + 1
    weight_left = dis_right.to(label.dtype) - label
    weight_right = label - dis_left.to(label.dtype)
    logp = F.log_softmax(pred, dim=-1)
    ce_left = -logp.gather(-1, dis_left[..., None])[..., 0]
    ce_right = -logp.gather(-1, dis_right[..., None])[..., 0]
    return ce_left * weight_left + ce_right * weight_right


@LOSSES.register_module()
class QualityFocalLoss(nn.Module):

    def __init__(self, use_sigmoid=True, beta=2.0, reduction='mean',
                 loss_weight=1.0, activated=False):
        super().__init__()
        # `activated` (TOOD's probabilities) is stored and not read, as in
        # the JAX loss: the TOOD head writes its activated QFL inline
        # (ROADMAP.md caveat 83)
        self.activated = activated
        self.use_sigmoid = use_sigmoid
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * quality_focal_loss(
            pred, target, weight, beta=self.beta,
            use_sigmoid=self.use_sigmoid, reduction=reduction,
            avg_factor=avg_factor)


@LOSSES.register_module()
class DistributionFocalLoss(nn.Module):

    def __init__(self, reduction='mean', loss_weight=1.0):
        super().__init__()
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * distribution_focal_loss(
            pred, target, weight, reduction=reduction, avg_factor=avg_factor)
