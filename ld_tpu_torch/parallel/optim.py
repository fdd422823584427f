"""Optimizer and LR schedule; port of `ld_tpu/parallel/optim.py:26-165`.

  * `build_lr_schedule`: mmcv's step (or cosine) LR with linear warmup from
    `warmup_ratio * lr` over `warmup_iters`, as a function of the number of
    updates already made, so the first step runs at `lr * warmup_ratio` (the
    JAX package evaluates optax's pre-update count).
  * `build_optimizer`: `torch.optim.SGD(momentum, weight_decay)`, whose
    weight decay is added to the gradient before the momentum and whose
    first momentum buffer is the gradient itself: the JAX package's
    `add_decayed_weights` + `trace`. Frozen parameters (`requires_grad`
    False) join no group, so they get neither updates nor decay. mmcv's
    `paramwise_cfg` (bias_lr_mult, bias_decay_mult, norm_decay_mult) makes
    one group per (lr, decay) multiplier pair, and decides what a norm
    parameter is by its module's type: the port's ResNet names one BN
    `downsample.1`.
  * The schedule drives a `LambdaLR` over the groups, each at its own
    lr multiplier.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
from torch import nn


def build_lr_schedule(base_lr: float, lr_config: Dict,
                      steps_per_epoch: int,
                      max_epochs: int) -> Callable[[int], float]:
    """The LR after `count` updates: linear warmup from warmup_ratio * lr
    over warmup_iters, then x gamma at each epoch in `step` (policy
    'step'), or a cosine decay to 0 over max_epochs (policy 'cosine')."""
    policy = lr_config.get('policy', 'step')
    if policy not in ('step', 'cosine'):
        raise ValueError(policy)
    warmup_iters = lr_config.get('warmup_iters', 500)
    warmup_ratio = lr_config.get('warmup_ratio', 0.001)
    gamma = lr_config.get('gamma', 0.1)
    boundaries = [s * steps_per_epoch for s in lr_config.get('step', [8, 11])]
    total = max_epochs * steps_per_epoch

    def schedule(count: int) -> float:
        if policy == 'step':
            regular = base_lr * gamma**sum(count >= b for b in boundaries)
        else:
            regular = base_lr * 0.5 * (1 + math.cos(
                math.pi * min(count, total) / total))
        frac = min(max(count / max(warmup_iters, 1), 0.0), 1.0)
        return regular * (warmup_ratio + (1.0 - warmup_ratio) * frac)

    return schedule


_NORMS = (nn.modules.batchnorm._BatchNorm, nn.GroupNorm, nn.LayerNorm,
          nn.modules.instancenorm._InstanceNorm)


def _param_groups(model: nn.Module, paramwise: Dict):
    """{(lr_mult, decay_mult): [params]} of the trainable parameters."""
    groups: Dict[Tuple[float, float], list] = {}
    seen = set()
    for module in model.modules():
        is_norm = isinstance(module, _NORMS)
        for name, p in module.named_parameters(recurse=False):
            if not p.requires_grad or id(p) in seen:
                continue
            seen.add(id(p))
            lr_mult, decay_mult = 1.0, 1.0
            if is_norm:
                decay_mult = paramwise.get('norm_decay_mult', 1.0)
            elif name == 'bias':
                lr_mult = paramwise.get('bias_lr_mult', 1.0)
                decay_mult = paramwise.get('bias_decay_mult', 1.0)
            groups.setdefault((lr_mult, decay_mult), []).append(p)
    return groups


def build_optimizer(optimizer_cfg: Dict, lr_schedule: Callable[[int], float],
                    model: nn.Module):
    """SGD over the trainable parameters of `model`, and the LambdaLR that
    sets each group to `lr_schedule(count) * lr_mult`; returns
    (optimizer, scheduler)."""
    opt_type = optimizer_cfg.get('type', 'SGD')
    if opt_type != 'SGD':
        raise NotImplementedError(f'optimizer {opt_type!r} is not ported to '
                                  'ld_tpu_torch yet (see ROADMAP.md)')
    base_lr = optimizer_cfg['lr']
    wd = optimizer_cfg.get('weight_decay', 0.0)
    groups = _param_groups(model, optimizer_cfg.get('paramwise_cfg') or {})
    optimizer = torch.optim.SGD(
        [dict(params=ps, lr=base_lr * lr_mult, weight_decay=wd * decay_mult)
         for (lr_mult, decay_mult), ps in groups.items()],
        lr=base_lr, momentum=optimizer_cfg.get('momentum', 0.9),
        dampening=0.0, nesterov=False)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: lr_schedule(count) / base_lr)
    return optimizer, scheduler
