"""Cross-entropy and binary cross-entropy losses; port of
`ld_tpu/models/losses/cross_entropy_loss.py:13-57`.

  * softmax (`use_sigmoid=False`): -log_softmax(x)[label] per row;
  * sigmoid (`use_sigmoid=True`): BCE on logits against one-hot (int
    labels) or float targets, summed over the last dim of a 2-d or wider
    loss; a weight of the loss's own shape applies before that sum, a
    per-row one after it.

The mask form (`use_mask=True`) belongs to the mask heads, not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.utils.registry import LOSSES
from .focal_loss import bce_with_logits
from .utils import weight_reduce_loss


def cross_entropy(pred, label, weight=None, reduction='mean',
                  avg_factor=None, class_weight=None):
    logp = F.log_softmax(pred, dim=-1)
    loss = -logp.gather(-1, label[..., None].long())[..., 0]
    if class_weight is not None:
        loss = loss * torch.as_tensor(class_weight, dtype=loss.dtype,
                                      device=loss.device)[label.long()]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy(pred, label, weight=None, reduction='mean',
                         avg_factor=None, class_weight=None):
    if label.dim() == pred.dim() - 1:
        label = F.one_hot(label.long(), pred.shape[-1]).to(pred.dtype)
    loss = bce_with_logits(pred, label)
    if class_weight is not None:
        loss = loss * torch.as_tensor(class_weight, dtype=loss.dtype,
                                      device=loss.device)
    if weight is not None and weight.dim() == loss.dim() and loss.dim() > 1:
        loss = loss * weight
        weight = None
    loss = loss.sum(dim=-1) if loss.dim() > 1 else loss
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


@LOSSES.register_module()
class CrossEntropyLoss(nn.Module):

    def __init__(self, use_sigmoid=False, use_mask=False, reduction='mean',
                 class_weight=None, loss_weight=1.0):
        super().__init__()
        if use_mask:
            raise NotImplementedError('CrossEntropyLoss use_mask=True (the '
                                      'mask heads) is not ported to '
                                      'ld_tpu_torch yet (see ROADMAP.md A8)')
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.class_weight = class_weight
        self.loss_weight = loss_weight

    def forward(self, cls_score, label, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        fn = binary_cross_entropy if self.use_sigmoid else cross_entropy
        return self.loss_weight * fn(
            cls_score, label, weight, reduction=reduction,
            avg_factor=avg_factor, class_weight=self.class_weight)
