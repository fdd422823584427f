"""Shared conv/norm layer factories (port of `ld_tpu/models/layers.py:122-176`).

The same `conv_cfg` / `norm_cfg` dicts as the JAX package select NCHW PyTorch
modules:
  * conv: `nn.Conv2d` (weight-standardized `ConvWS` is not ported yet);
  * BN / SyncBN: `nn.BatchNorm2d` with eps 1e-5, frozen to its running
    statistics while the owning backbone has `norm_eval` set;
  * GN: `nn.GroupNorm` with min(num_groups, C) groups and eps 1e-5.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def make_conv(conv_cfg, in_channels, out_channels, kernel_size, stride=1, *,
              padding=None, dilation=1, bias=False) -> nn.Conv2d:
    """build_conv_layer equivalent."""
    ctype = (conv_cfg or {}).get('type', 'Conv')
    if ctype not in ('Conv', 'Conv2d'):
        raise NotImplementedError(f'conv_cfg type {ctype!r} is not ported to '
                                  'ld_tpu_torch yet (see ROADMAP.md)')
    if padding is None:
        padding = kernel_size // 2
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                     dilation=dilation, bias=bias)


def make_norm(norm_cfg, num_features) -> nn.Module:
    """build_norm_layer equivalent: BN/SyncBN -> BatchNorm2d, GN -> GroupNorm."""
    t = (norm_cfg or {}).get('type', 'BN')
    if t == 'GN':
        groups = min((norm_cfg or {}).get('num_groups', 32), num_features)
        return nn.GroupNorm(groups, num_features, eps=1e-5)
    if t in ('BN', 'SyncBN'):
        return nn.BatchNorm2d(num_features, eps=1e-5)
    raise NotImplementedError(f'norm_cfg type {t!r} is not ported to '
                              'ld_tpu_torch yet (see ROADMAP.md)')


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's default conv kernel init (variance_scaling(1, 'fan_in',
    'truncated_normal')): a normal truncated to 2 std, rescaled so the
    truncated distribution has variance 1/fan_in."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
