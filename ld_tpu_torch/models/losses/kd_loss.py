"""Distillation losses: the LD/KD KL divergence and the feature-imitation
MSE; port of `ld_tpu/models/losses/kd_loss.py:24-84`.

  * knowledge_distillation_kl_div_loss: KL(softmax(t/T) || softmax(s/T))
    averaged over the last dim and scaled by T^2, including the p*log(p)
    term of the target (F.kl_div's pointwise form), with the target
    detached; evaluated in float64 (see its docstring).
  * IMLoss: the plain MSE over all elements, a scalar.

Both registry names of the KL loss resolve to one class:
`LocalizationDistillationLoss` is named by some head defaults of the
reference, every shipped config names `KnowledgeDistillationKLDivLoss`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.utils.registry import LOSSES
from .utils import weighted_loss


@weighted_loss
def knowledge_distillation_kl_div_loss(pred: torch.Tensor,
                                       soft_label: torch.Tensor,
                                       T: float,
                                       detach_target: bool = True):
    """Element-wise KD loss.

    Args:
        pred: (N, K) student logits.
        soft_label: (N, K) teacher logits.
        T: distillation temperature.
    Returns:
        (N,) loss in pred's dtype: mean_k[p_k * (log p_k - log q_k)] * T^2,
        evaluated in float64. Between two nearly equal distributions (a
        fresh student and teacher, a high T) the sum cancels to a value
        second order in their difference, and the float32 rounding of the
        two log-softmaxes reaches ~1e-3 of it.
    """
    if pred.shape != soft_label.shape:
        raise ValueError(f'pred {tuple(pred.shape)} and soft_label '
                         f'{tuple(soft_label.shape)} differ')
    dtype = pred.dtype
    pred, soft_label = pred.double(), soft_label.double()
    target_logp = F.log_softmax(soft_label / T, dim=-1)
    target = target_logp.exp()
    if detach_target:
        target = target.detach()
        target_logp = target_logp.detach()
    logp = F.log_softmax(pred / T, dim=-1)
    kd = target * (target_logp - logp)
    return (kd.mean(dim=-1) * (T * T)).to(dtype)


@weighted_loss
def im_loss(x: torch.Tensor, soft_target: torch.Tensor):
    """Feature-imitation loss: the scalar MSE, so weight and avg_factor do
    nothing (the reference wraps F.mse_loss the same way)."""
    return ((x - soft_target)**2).mean()


@LOSSES.register_module(name=['KnowledgeDistillationKLDivLoss',
                              'LocalizationDistillationLoss'])
class KnowledgeDistillationKLDivLoss(nn.Module):

    def __init__(self, reduction='mean', loss_weight=1.0, T=10):
        super().__init__()
        if T < 1:
            raise ValueError(f'temperature T={T} must be >= 1')
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.T = T

    def forward(self, pred, soft_label, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * knowledge_distillation_kl_div_loss(
            pred, soft_label, weight, reduction=reduction,
            avg_factor=avg_factor, T=self.T)


@LOSSES.register_module()
class IMLoss(nn.Module):

    def __init__(self, reduction='mean', loss_weight=1.0):
        super().__init__()
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, x, soft_target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * im_loss(x, soft_target, reduction=reduction)
