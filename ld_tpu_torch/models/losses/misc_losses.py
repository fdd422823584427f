"""The JAX package's misc losses; port of `BalancedL1Loss`,
`BoundedIoULoss`, `MSELoss`, `GHMC` and `GHMR` (`ld_tpu/models/losses/
misc_losses.py:19-45, 103-230`). `MSELoss` is registered for the YOLOv3
configs and called by no head, as in JAX: the YOLOv3 head writes its own
squared error (ROADMAP.md caveat 87). Its corner and Gaussian losses wait for the corner
detectors (ROADMAP.md Queue A item 9).

Balanced L1 (Libra R-CNN) of |pred - target| = x, with b = e^(gamma /
alpha) - 1: alpha / b (b x + 1) ln(b x / beta + 1) - alpha x under `beta`,
gamma x + gamma / b - alpha beta over it; element-wise, through the
`weighted_loss` contract.

GHM-C and GHM-R (gradient harmonizing, the static-bin form of the JAX
losses; `momentum` is accepted and not read): each element's gradient norm
g (|sigmoid(pred) - target| for GHM-C, |d| / sqrt(d^2 + mu^2) of d = pred -
target for GHM-R) falls in one of `bins` bins (edges i / bins, the last
raised to 1 + 1e-6 / 1e3); an element of a bin holding n weighs total / n,
total the count of valid rows (GHM-C: rows, not elements) or elements
(GHM-R). The loss is the sum of BCE-with-logits (GHM-C) or the authentic
smooth L1 sqrt(d^2 + mu^2) - mu (GHM-R) times its weight, divided by
`bins` (not by the bins that hold elements, as mmdet does: ROADMAP.md
caveat 72) and by total, times `loss_weight`. As in JAX, the only weights
read are `label_weight`'s; a head's `weight` and `avg_factor` are taken and
not read, so a RetinaNet's GHM losses count every anchor, GHM-R its
negatives too (caveat 73). Total cancels against the bin weights: the
loss is `loss_weight` / `bins` x the sum over bins of the mean loss of
each bin's elements. The counts are the global batch's (one
`global_sum` of the bin counts and total).

Bounded IoU (Libra R-CNN) on decoded xyxy boxes: for the centre offsets
1 - max((t - 2|d|) / (t + 2|d| + eps), 0) on each axis, for the sides
1 - min(t / (p + eps), p / (t + eps)); each of the four terms through a
smooth L1 at `beta` (0.5 x^2 / beta under it, x - beta / 2 over it), summed
over the four. A (..., 4) weight is reduced by its mean over the last axis
before the `weighted_loss` reduction, as the JAX loss does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ld_tpu_torch.parallel.dist import global_sum
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
def mse_loss(pred, target):
    return (pred - target) ** 2


@LOSSES.register_module()
class MSELoss(nn.Module):

    def __init__(self, reduction='mean', loss_weight=1.0):
        super().__init__()
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * mse_loss(pred, target, weight,
                                           reduction=reduction,
                                           avg_factor=avg_factor)


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


def _ghm_edges(bins: int, last: float) -> torch.Tensor:
    """`jnp.linspace(0, 1, bins + 1)` in float32 (i x float32(1 / bins)),
    its last edge set to `last`."""
    edges = np.arange(bins + 1, dtype=np.float32) * (
        np.float32(1) / np.float32(bins))
    edges[-1] = last
    return torch.from_numpy(edges)


def _ghm_loss(loss, g, valid, edges, bins, loss_weight) -> torch.Tensor:
    """The harmonized sum: each element of `loss` weighted by total / (its
    bin's count), over `bins` and total (`valid`: the counted rows or
    elements, broadcast against `loss`)."""
    edges = edges.to(g.device)
    g = g.detach()
    # each element's bin: edges[i] <= g < edges[i + 1]; `bins` where g is
    # in none or the element is not valid
    idx = torch.bucketize(g, edges[1:-1], right=True)
    inside = (g >= edges[0]) & (g < edges[-1]) & valid
    idx = torch.where(inside, idx, torch.full_like(idx, bins))
    counts = torch.bincount(idx.reshape(-1), minlength=bins + 1)[:bins]
    counts = global_sum(torch.cat([counts.float(),
                                   valid.sum().float().reshape(1)]))
    total = counts[-1].clamp(min=1.0)
    per_bin = total / counts[:-1].clamp(min=1.0)
    weights = torch.cat([per_bin, per_bin.new_zeros(1)])[idx]
    return loss_weight * (loss * weights / bins).sum() / total


@LOSSES.register_module()
class GHMC(nn.Module):

    def __init__(self, bins=10, momentum=0.0, use_sigmoid=True,
                 loss_weight=1.0):
        super().__init__()
        if not use_sigmoid:
            raise ValueError('GHMC takes use_sigmoid=True only')
        self.bins = bins
        self.loss_weight = loss_weight
        self.register_buffer('edges', _ghm_edges(bins, 1 + 1e-6),
                             persistent=False)

    def forward(self, pred, target, label_weight=None, avg_factor=None,
                **kwargs):
        """pred (..., C) logits; target (..., C) or labels (...) (C and
        below 0 the background); label_weight (...) or (..., C), ones of
        every row if None (JAX's ones of pred.shape[:1] fail to broadcast
        against a batch > 1 of (B, N, C) logits; on (N, C) they are these:
        ROADMAP.md caveat 73)."""
        pred = pred.float()
        if target.dim() == pred.dim() - 1:
            c = pred.shape[-1]
            pos = (target >= 0) & (target < c)
            target = torch.nn.functional.one_hot(
                torch.where(pos, target, torch.zeros_like(target)).long(),
                c).to(pred.dtype) * pos[..., None]
        if label_weight is None:
            label_weight = pred.new_ones(pred.shape[:-1])
        lw = label_weight[..., None] if label_weight.dim() < pred.dim() \
            else label_weight
        g = (torch.sigmoid(pred) - target).abs()
        bce = pred.clamp(min=0) - pred * target + torch.log1p(
            torch.exp(-pred.abs()))
        return _ghm_loss(bce, g, lw > 0, self.edges, self.bins,
                         self.loss_weight)


@LOSSES.register_module()
class GHMR(nn.Module):

    def __init__(self, mu=0.02, bins=10, momentum=0.0, loss_weight=1.0):
        super().__init__()
        self.mu = mu
        self.bins = bins
        self.loss_weight = loss_weight
        self.register_buffer('edges', _ghm_edges(bins, 1e3),
                             persistent=False)

    def forward(self, pred, target, label_weight=None, avg_factor=None,
                **kwargs):
        mu = self.mu
        diff = pred.float() - target.float()
        root = torch.sqrt(diff * diff + mu * mu)
        loss = root - mu
        g = (diff / root).abs()
        if label_weight is None:
            label_weight = torch.ones_like(loss)
        return _ghm_loss(loss, g, label_weight > 0, self.edges, self.bins,
                         self.loss_weight)
