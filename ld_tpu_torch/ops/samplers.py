"""Static-shape box samplers (port of `ld_tpu/ops/samplers.py` and of the RPN
sampler, `ld_tpu/models/heads/rpn_head.py:52-60`), batched over images on
the last dimension.

A sampler scores each candidate with a key and keeps the top-k keys among
the candidates of a mask: a boolean selection of the candidate axis, never a
variable-length index list. `sample` draws the uniform numbers from the
`torch.Generator` the caller passes in, on the candidates' device (the
positives' draw, then the negatives', then the floor quota's where
`IoUBalancedNegSampler` has one), and hands them to `select`, which is
deterministic: the key functions `pos_keys` / `neg_keys` take their draws
as tensors, so the same draws give the same picks in both packages (the
JAX key functions draw through `_uniform_keys`). A given generator state
gives the same picks again; `jax.random` draws other numbers.

  * `RandomSampler`: uniform keys; up to num x pos_fraction positives, up
    to `num` in all (capped by `neg_pos_ub` x positives).
  * `InstanceBalancedPosSampler`: a positive's key is minus its random rank
    among its gt's positives plus its draw, so the gts are taken round
    robin.
  * `IoUBalancedNegSampler` (Libra R-CNN): negatives at or above
    `floor_thr` binned by IoU into `num_bins` equal bins up to the largest
    (the bin index truncated toward zero, the width floored at 1e-6) and
    keyed by minus their random rank in their bin plus their draw; below
    `floor_thr` (when it is >= 0), the first num x floor_fraction of a
    second draw's order outrank every binned one.
  * `OHEMSampler`: keys are the caller's per-candidate `loss` plus 1e-4 x
    the draw.
  * `ScoreHLRSampler`: a negative whose `scores` pass `score_thr` is keyed
    10 + importance, importance = (valid count - the count of valid,
    higher-scored candidates above `iou_thr` IoU) + score; the rest by their
    draw. It returns label weights decayed linearly with the importance
    rank, (bias + (1 - bias) w)^k; the rest take the least valid weight.
  * `CombinedSampler`: the positives' keys of its `pos_sampler`, the
    negatives' of its `neg_sampler`.

The ranks within a group are the O(N^2) pairwise count of the JAX package,
per image; ranks of a descending order put ties at the higher index first,
as `argsort(keys)[::-1]` does there, and the top-k masks the lower index,
as `lax.top_k`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.utils.registry import Registry

SAMPLERS = Registry('bbox_sampler')

_NEG_INF = -1e9


def uniform_keys(generator: torch.Generator, like: torch.Tensor
                 ) -> torch.Tensor:
    """U(0, 1) keys of `like`'s shape, drawn from `generator`."""
    return torch.rand(like.shape, generator=generator, device=like.device)


def select_topk_mask(keys: torch.Tensor, mask: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k keys among the `mask` candidates of each row (..., N):
    (selection, count selected). Never selects a masked-out slot; selects
    fewer than k where fewer candidates exist; ties past the k-th key go to
    the lower index (`ld_tpu/ops/samplers.py:32-49`)."""
    keys = torch.where(mask, keys, torch.full_like(keys, _NEG_INF))
    if k >= keys.shape[-1]:
        return mask, mask.sum(-1)
    if k <= 0:
        sel = torch.zeros_like(mask)
        return sel, sel.sum(-1)
    kth = torch.topk(keys, k, dim=-1).values[..., k - 1:k]
    sel = mask & (keys >= kth)
    sel = sel & ~(torch.cumsum(sel.long(), -1) > k)
    return sel, sel.sum(-1)


def descending_rank(keys: torch.Tensor) -> torch.Tensor:
    """Each key's rank in its row's descending order, ties at the higher
    index first (`argsort(keys)[::-1]`, `ld_tpu/ops/samplers.py:86-90`)."""
    order = torch.argsort(keys, dim=-1, stable=True).flip(-1)
    rank = torch.empty_like(order)
    return rank.scatter_(-1, order, torch.arange(
        keys.shape[-1], device=keys.device).expand_as(order).contiguous())


def rank_below(keys: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Whether each key's descending rank in its row is below `count` (...),
    the dynamic-k top-k of `ld_tpu/ops/samplers.py:86-91`."""
    return descending_rank(keys) < count[..., None]


def rank_within_group(group_id: torch.Tensor, rand: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """(..., N): each candidate's rank among the `mask` candidates of its
    group under the order of `rand` (the count of smaller draws), the O(N^2)
    pairwise form of `ld_tpu/ops/samplers.py:53-61`."""
    same = (group_id[..., :, None] == group_id[..., None, :]) & \
        mask[..., None, :]
    return (same & (rand[..., None, :] < rand[..., :, None])).sum(-1)


def randomized_topk_mask(mask: torch.Tensor, k: int,
                         generator: torch.Generator) -> torch.Tensor:
    """Up to `k` uniformly chosen True entries of each row of `mask` (the RPN
    sampler's positives, `rpn_head.py:52-60`): the candidates whose key
    reaches the k-th largest (ties at the k-th key are all kept, as in the
    JAX op)."""
    keys = torch.where(mask, uniform_keys(generator, mask),
                       torch.full(mask.shape, -1.0, device=mask.device))
    kth = torch.topk(keys, min(k, mask.shape[-1]), dim=-1).values[..., -1:]
    return mask & (keys >= kth.clamp(min=0.0))


@SAMPLERS.register_module()
class RandomSampler:
    """Uniform random positives, up to num x pos_fraction, and negatives up
    to `num` in all (the mmdet default)."""
    # the uniform draws `neg_keys` takes past its first (a floor quota's)
    extra_neg_draws = 0

    def __init__(self, num=512, pos_fraction=0.25, neg_pos_ub=-1,
                 add_gt_as_proposals=True, **kwargs):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals
        # the most positives a row can hold (the mask branch runs on them)
        self.max_pos = int(num * pos_fraction)

    def pos_keys(self, rand, pos_mask, **kwargs) -> torch.Tensor:
        return rand

    def neg_keys(self, rand, neg_mask, **kwargs) -> torch.Tensor:
        return rand

    def draws(self, generator: torch.Generator, pos_mask, neg_mask):
        """The uniform draws of one `sample`: (positives', negatives', and
        the `extra_neg_draws` more of the negatives')."""
        return (uniform_keys(generator, pos_mask),
                *(uniform_keys(generator, neg_mask)
                  for _ in range(1 + self.extra_neg_draws)))

    def sample(self, generator: torch.Generator, pos_mask: torch.Tensor,
               neg_mask: torch.Tensor, **kwargs
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(..., N) masks -> (pos_sel, neg_sel, negative label weights or
        None). The keyword inputs (`gt_inds`, `max_overlaps`, `boxes`,
        `loss`, `scores`) go to the key functions that read them."""
        return self.select(self.draws(generator, pos_mask, neg_mask),
                           pos_mask, neg_mask, **kwargs)

    def select(self, draws, pos_mask, neg_mask, **kwargs):
        """`sample` on given uniform draws (`draws`)."""
        pos_sel, n_pos = select_topk_mask(
            self.pos_keys(draws[0], pos_mask, **kwargs), pos_mask,
            self.max_pos)
        num_neg = self.num - n_pos
        if self.neg_pos_ub >= 0:
            num_neg = torch.minimum(num_neg, self.neg_pos_ub *
                                    n_pos.clamp(min=1))
        keys = torch.where(neg_mask, self.neg_keys(
            draws[1], neg_mask, *draws[2:], **kwargs),
            torch.full(neg_mask.shape, _NEG_INF, device=neg_mask.device))
        return pos_sel, neg_mask & rank_below(keys, num_neg), None


@SAMPLERS.register_module()
class InstanceBalancedPosSampler(RandomSampler):
    """Equal positives a gt instance (`ld_tpu/ops/samplers.py:94-110`)."""

    def pos_keys(self, rand, pos_mask, gt_inds=None, **kwargs):
        if gt_inds is None:
            return rand
        return -rank_within_group(gt_inds, rand, pos_mask).float() + rand


@SAMPLERS.register_module()
class IoUBalancedNegSampler(RandomSampler):
    """Libra R-CNN's IoU-balanced negatives (`ld_tpu/ops/samplers.py:
    113-154`)."""

    def __init__(self, num=512, pos_fraction=0.25, floor_thr=-1.,
                 floor_fraction=0., num_bins=3, **kwargs):
        super().__init__(num=num, pos_fraction=pos_fraction, **kwargs)
        self.floor_thr = floor_thr
        self.floor_fraction = floor_fraction
        self.num_bins = num_bins
        self.extra_neg_draws = int(floor_thr >= 0)

    def neg_keys(self, rand, neg_mask, floor_rand=None, max_overlaps=None,
                 **kwargs):
        if max_overlaps is None:
            return rand
        in_floor = (max_overlaps < self.floor_thr) & neg_mask \
            if self.floor_thr >= 0 else torch.zeros_like(neg_mask)
        binned = neg_mask & ~in_floor
        zero = torch.zeros((), device=rand.device)
        max_iou = torch.where(binned, max_overlaps, zero).amax(
            -1, keepdim=True)
        lo = max(float(self.floor_thr), 0.0)
        interval = ((max_iou - lo) / self.num_bins).clamp(min=1e-6)
        bin_id = ((max_overlaps - lo) / interval).to(torch.int32).clamp(
            0, self.num_bins - 1)
        rank = rank_within_group(bin_id, rand, binned).float()
        key_binned = -rank + rand
        if self.floor_thr < 0:
            return torch.where(binned, key_binned,
                               torch.full_like(rand, _NEG_INF / 2))
        floor_rank = rank_within_group(torch.zeros_like(bin_id), floor_rand,
                                       in_floor).float()
        key_floor = torch.where(floor_rank < self.num * self.floor_fraction,
                                1.0 + floor_rand, -1e4 - floor_rank)
        return torch.where(in_floor, key_floor, key_binned)


@SAMPLERS.register_module()
class OHEMSampler(RandomSampler):
    """Online hard example mining: the candidates of the largest `loss`
    (`ld_tpu/ops/samplers.py:157-172`), the per-candidate classification
    loss of the current head, computed by the caller without gradient."""

    def pos_keys(self, rand, pos_mask, loss=None, **kwargs):
        if loss is None:
            return rand
        return loss + 1e-4 * rand

    def neg_keys(self, rand, neg_mask, loss=None, **kwargs):
        return self.pos_keys(rand, neg_mask, loss=loss)


@SAMPLERS.register_module()
class ScoreHLRSampler(RandomSampler):
    """Score-based hard negatives with decayed label weights
    (`ld_tpu/ops/samplers.py:175-244`)."""

    def __init__(self, num=512, pos_fraction=0.25, score_thr=0.05,
                 iou_thr=0.5, bias=0., k=0.5, **kwargs):
        super().__init__(num=num, pos_fraction=pos_fraction, **kwargs)
        self.score_thr = score_thr
        self.iou_thr = iou_thr
        self.bias = bias
        self.k = k

    def neg_with_weights(self, rand, neg_mask, boxes=None, scores=None,
                         **kwargs):
        """(keys, label weights) of the negatives (..., N)."""
        if scores is None:
            return rand, torch.ones_like(rand)
        valid = neg_mask & (scores > self.score_thr)
        n_valid = valid.sum(-1, keepdim=True).float()
        stronger = (bbox_overlaps(boxes, boxes) > self.iou_thr) & \
            (scores[..., None, :] > scores[..., :, None])
        rank_in_group = (stronger & valid[..., None, :]).sum(-1).float()
        imp = torch.where(valid, n_valid - rank_in_group + scores,
                          torch.full_like(scores, _NEG_INF))
        imp_rank = descending_rank(imp).float()
        up_bound = n_valid.clamp(min=float(self.num))
        w = ((up_bound - imp_rank) / up_bound).clamp(0.0, 1.0)
        w = (self.bias + (1.0 - self.bias) * w) ** self.k
        keys = torch.where(valid, 10.0 + imp, rand)
        least = torch.where(valid, w, torch.ones_like(w)).amin(
            -1, keepdim=True)
        w = torch.where(valid, w, least)
        return keys, torch.where(neg_mask, w, torch.zeros_like(w))

    def select(self, draws, pos_mask, neg_mask, **kwargs):
        pos_sel, n_pos = select_topk_mask(draws[0], pos_mask, self.max_pos)
        keys, weights = self.neg_with_weights(draws[1], neg_mask, **kwargs)
        keys = torch.where(neg_mask, keys, torch.full_like(keys, _NEG_INF))
        return pos_sel, neg_mask & rank_below(keys, self.num - n_pos), \
            weights


@SAMPLERS.register_module()
class CombinedSampler(RandomSampler):
    """Independent positive and negative samplers (Libra R-CNN's instance-
    balanced positives and IoU-balanced negatives by default)."""

    def __init__(self, pos_sampler=None, neg_sampler=None, **kwargs):
        super().__init__(**kwargs)
        base = dict(num=self.num, pos_fraction=self.pos_fraction)
        self.pos_sampler = SAMPLERS.build({**base, **(pos_sampler or dict(
            type='InstanceBalancedPosSampler'))})
        self.neg_sampler = SAMPLERS.build({**base, **(neg_sampler or dict(
            type='IoUBalancedNegSampler'))})
        self.extra_neg_draws = self.neg_sampler.extra_neg_draws

    def pos_keys(self, rand, pos_mask, **kwargs):
        return self.pos_sampler.pos_keys(rand, pos_mask, **kwargs)

    def neg_keys(self, rand, neg_mask, *extra, **kwargs):
        return self.neg_sampler.neg_keys(rand, neg_mask, *extra, **kwargs)


@SAMPLERS.register_module()
class PseudoSampler:
    """No sampling: every assigned candidate is used."""
    max_pos = None

    def __init__(self, **kwargs):
        pass

    def sample(self, generator, pos_mask, neg_mask, **kwargs):
        return pos_mask, neg_mask, None


def build_sampler(cfg, **default_args):
    cfg = dict(cfg or dict(type='RandomSampler'))
    for k, v in default_args.items():
        cfg.setdefault(k, v)
    return SAMPLERS.build(cfg)
