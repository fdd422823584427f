"""PISA's prime-sample reweighting (port of `ld_tpu/models/losses/
pisa_loss.py:25-67`) on a fixed budget of gathered positives, (P,) each,
with a validity mask in place of index lists.

  * `isr_p`: each positive's rank by IoU inside its (label, gt) group, its
    IoU plus (the largest label group's size - that rank) ranked again
    inside its label group; the rank maps linearly to (max - rank) / max,
    then (bias + (1 - bias) w)^k, rescaled so that the positives'
    classification loss keeps its sum. The ranks count strictly larger
    keys, as the JAX function does, so two keys a float32 ulp apart can
    rank apart.
  * `carl_weights`: (bias + (1 - bias) p)^k of the gradient-carrying class
    probabilities, normalised to sum to the positive count.
"""
from __future__ import annotations

import torch

EPS = 1e-6


def _rank_desc_within(group_ok: torch.Tensor, key: torch.Tensor
                      ) -> torch.Tensor:
    """Each element's rank (0 the best) by `key` descending among the
    elements its row of `group_ok` (P, P) admits."""
    return (group_ok & (key[None, :] > key[:, None])).sum(-1)


def isr_p(pos_ious, pos_labels, pos_gts, pos_valid, pos_label_weights,
          pos_cls_loss, k=2.0, bias=0.0) -> torch.Tensor:
    """(P,) importance label weights of the positives (0 where invalid);
    `pos_cls_loss` is the detached per-positive classification loss."""
    v = pos_valid
    same_label = (pos_labels[:, None] == pos_labels[None, :]) & v[None, :]
    same_gt = same_label & (pos_gts[:, None] == pos_gts[None, :])
    max_l_num = same_label.sum(-1).max().clamp(min=1).float()
    t_rank = _rank_desc_within(same_gt, pos_ious).float()
    boosted = pos_ious + (max_l_num - t_rank)
    l_rank = _rank_desc_within(same_label, boosted).float()
    w = pos_label_weights * (max_l_num - l_rank) / max_l_num
    w = (bias + w * (1.0 - bias)) ** k
    ori = (pos_cls_loss * pos_label_weights * v).sum()
    new = (pos_cls_loss * w * v).sum()
    ratio = ori / new.clamp(min=EPS)
    return torch.where(v, w * ratio, torch.zeros_like(w))


def carl_weights(pos_cls_prob, pos_valid, k=1.0, bias=0.2) -> torch.Tensor:
    """(P,) CARL weights of the positives' class probabilities."""
    w = (bias + (1.0 - bias) * pos_cls_prob) ** k
    w = torch.where(pos_valid, w, torch.zeros_like(w))
    num_pos = pos_valid.float().sum()
    return w * num_pos / w.sum().clamp(min=EPS)
