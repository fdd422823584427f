"""Varifocal loss (VarifocalNet, arXiv:2008.13367); port of
`ld_tpu/models/losses/misc_losses.py:51-75`.

  VFL(x, q) = BCE(x, q) * (q where q > 0, else alpha * |sigmoid(x) - q|^gamma)

over (..., C) logits against (..., C) IoU-aware targets q (the IoU at the
gt's class, 0 elsewhere); with `iou_weighted=False` a positive weighs 1.
The sum over the classes is then weighted and reduced as every loss here.
"""
from __future__ import annotations

import torch
from torch import nn

from ld_tpu_torch.utils.registry import LOSSES
from .focal_loss import bce_with_logits
from .utils import weight_reduce_loss


@LOSSES.register_module()
class VarifocalLoss(nn.Module):

    def __init__(self, use_sigmoid=True, alpha=0.75, gamma=2.0,
                 iou_weighted=True, reduction='mean', loss_weight=1.0):
        super().__init__()
        if not use_sigmoid:
            raise NotImplementedError('only the sigmoid varifocal loss '
                                      'exists, in the JAX package and here')
        self.alpha, self.gamma = alpha, gamma
        self.iou_weighted = iou_weighted
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        pos = (target > 0).to(pred.dtype)
        focal = target * pos if self.iou_weighted else pos
        focal = focal + self.alpha * (torch.sigmoid(pred) - target).abs() \
            ** self.gamma * (1 - pos)
        loss = bce_with_logits(pred, target) * focal
        if loss.dim() > 1:
            loss = loss.sum(-1)
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)
