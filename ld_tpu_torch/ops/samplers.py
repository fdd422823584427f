"""Static-shape box samplers (port of `ld_tpu/ops/samplers.py` and of the RPN
sampler, `ld_tpu/models/heads/rpn_head.py:52-60`), batched over images on
the last dimension.

A sampler scores each candidate with a random key and keeps the top-k keys
among the candidates of a mask: a boolean selection of the candidate axis,
never a variable-length index list. Every key comes from the
`torch.Generator` the caller passes in, on the candidates' device, so a
given generator state gives the same picks again. `jax.random` draws other
numbers, so picks match the JAX package only where every candidate is
picked.

`RandomSampler` and `PseudoSampler` are ported; the instance-balanced,
IoU-balanced, OHEM, score-HLR and combined samplers raise
NotImplementedError (ROADMAP.md A7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ld_tpu_torch.utils.registry import Registry

SAMPLERS = Registry('bbox_sampler')
SAMPLERS.not_ported.update({
    name: 'ROADMAP.md A7' for name in (
        'InstanceBalancedPosSampler', 'IoUBalancedNegSampler', 'OHEMSampler',
        'ScoreHLRSampler', 'CombinedSampler')})

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


def rank_below(keys: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Whether each key's descending rank in its row is below `count` (...),
    the dynamic-k top-k of `ld_tpu/ops/samplers.py:86-91`."""
    order = torch.argsort(keys, dim=-1, descending=True, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(keys.shape[-1], device=keys.device)
                  .expand_as(order).contiguous())
    return rank < count[..., None]


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

    def __init__(self, num=512, pos_fraction=0.25, neg_pos_ub=-1,
                 add_gt_as_proposals=True, **kwargs):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals
        # the most positives a row can hold (the mask branch runs on them)
        self.max_pos = int(num * pos_fraction)

    def sample(self, generator: torch.Generator, pos_mask: torch.Tensor,
               neg_mask: torch.Tensor, **kwargs
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(..., N) masks -> (pos_sel, neg_sel, negative label weights or
        None)."""
        pos_sel, n_pos = select_topk_mask(uniform_keys(generator, pos_mask),
                                          pos_mask, self.max_pos)
        num_neg = self.num - n_pos
        if self.neg_pos_ub >= 0:
            num_neg = torch.minimum(num_neg, self.neg_pos_ub *
                                    n_pos.clamp(min=1))
        keys = torch.where(neg_mask, uniform_keys(generator, neg_mask),
                           torch.full(neg_mask.shape, _NEG_INF,
                                      device=neg_mask.device))
        return pos_sel, neg_mask & rank_below(keys, num_neg), None


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
