"""Shared conv/norm layer factories (port of `ld_tpu/models/layers.py:122-176`).

The same `conv_cfg` / `norm_cfg` dicts as the JAX package select NCHW PyTorch
modules:
  * conv: `Conv2d`; `ConvWS` / `ConvAWS`: `ConvWS2d`, the JAX `ConvWS`
    (the JAX package takes `ConvAWS` for `ConvWS` too, and so does the
    port: an mmcv ConvAWS checkpoint's `weight_gamma` / `weight_beta` have
    no place here);
  * BN / SyncBN: `BatchNorm2d` with eps 1e-5, frozen to its running
    statistics while the owning backbone has `norm_eval` set;
  * GN: `GroupNorm` with min(num_groups, C) groups and eps 1e-5.

Each takes a compute dtype (`dtype`, the JAX modules' `dtype` field; None
for float32), with flax's rounding points: a conv casts its input, weight
and bias to the compute dtype and returns that dtype; a norm takes its
statistics and affine in float32 and returns the compute dtype. Parameters,
running statistics and gradients stay float32. The DCN layer
(`ops/deform_conv.py`) takes one too, its `conv_offset` a `Conv2d` of
this file. With no compute dtype each
module is the plain `torch.nn` one, bit for bit.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def as_torch_dtype(dtype) -> torch.dtype:
    """A float dtype or its name ('bfloat16', a numpy dtype) as a torch
    dtype."""
    out = dtype if isinstance(dtype, torch.dtype) \
        else getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype) or not out.is_floating_point:
        raise ValueError(f'unknown compute dtype {dtype!r}')
    return out


def lowered_dtype(dtype):
    """The torch dtype a module computes in for a compute dtype (None, a
    torch dtype or its name, e.g. a config's 'bfloat16'), or None for
    float32, the modules' own dtype."""
    if dtype is None:
        return None
    dtype = as_torch_dtype(dtype)
    return None if dtype == torch.float32 else dtype


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in `compute_dtype` (flax `nn.Conv(dtype)`):
    input, weight and bias cast to it, output in it. cuDNN and oneDNN add
    the bias inside the conv's float32 accumulator, where flax adds it
    after rounding the conv; the two differ by at most one ulp of the
    compute dtype."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        return self._conv_forward(
            x.to(d), self.weight.to(d),
            None if self.bias is None else self.bias.to(d))


class ConvWS2d(Conv2d):
    """A weight-standardized `Conv2d` (mmcv's `ConvWS2d`, the JAX `ConvWS`,
    `ld_tpu/models/layers.py:27-66`): in every forward, each output
    channel's kernel over its (in_channels / groups) x kh x kw values has
    its mean taken off and is divided by its unbiased std (ddof 1) plus
    `eps`, in float32; then the conv, with `Conv2d`'s compute dtype."""

    def __init__(self, *args, eps: float = 1e-5, **kwargs):
        super().__init__(*args, **kwargs)
        self.eps = eps

    def standardized_weight(self) -> torch.Tensor:
        flat = self.weight.flatten(1)
        shape = (-1, 1, 1, 1)
        return (self.weight - flat.mean(dim=1).view(shape)) / (
            flat.std(dim=1).view(shape) + self.eps)

    def forward(self, x):
        w, bias, d = self.standardized_weight(), self.bias, self.compute_dtype
        if d is not None:
            x, w = x.to(d), w.to(d)
            bias = None if bias is None else bias.to(d)
        return self._conv_forward(x, w, bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` computing in `compute_dtype` (flax
    `nn.ConvTranspose(dtype)`), with `Conv2d`'s rounding points. Its
    weight is (in, out, kh, kw): a flax kernel (kh, kw, in, out) flipped
    in space (`utils/checkpoint.py`)."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        return torch.nn.functional.conv_transpose2d(
            x.to(d), self.weight.to(d),
            None if self.bias is None else self.bias.to(d), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation)


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` with statistics in float32 and its output in
    `compute_dtype` (flax `nn.GroupNorm(dtype)`).

    A group of one value (a 1x1 top FPN level at 32 channels in 32
    groups), which the functional form refuses, is its bias, exactly, as
    flax's `(x - mean) * rstd * scale + bias` gives it; any other input
    goes to `torch.group_norm`, the op `nn.GroupNorm` calls."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return self._norm(x)
        return self._norm(x.float()).to(self.compute_dtype)

    def _norm(self, x):
        if x.shape[1] // self.num_groups * math.prod(x.shape[2:]) == 1:
            shape = (1, -1) + (1, ) * (x.dim() - 2)
            return (x - x) * self.weight.view(shape) + self.bias.view(shape)
        return torch.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` with statistics in float32 and its output in
    `compute_dtype` (flax `nn.BatchNorm(dtype)`)."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return super().forward(x.float()).to(self.compute_dtype)


def make_conv(conv_cfg, in_channels, out_channels, kernel_size, stride=1, *,
              padding=None, dilation=1, groups=1, bias=False,
              dtype=None) -> Conv2d:
    """build_conv_layer equivalent, computing in `dtype`: a `Conv2d`, or
    for `conv_cfg=dict(type='ConvWS' | 'ConvAWS')` a `ConvWS2d`."""
    ctype = (conv_cfg or {}).get('type', 'Conv')
    if ctype in ('ConvWS', 'ConvAWS'):
        cls = ConvWS2d
    elif ctype in ('Conv', 'Conv2d'):
        cls = Conv2d
    else:
        raise NotImplementedError(f'conv_cfg type {ctype!r} is not ported to '
                                  'ld_tpu_torch yet (see ROADMAP.md)')
    if padding is None:
        padding = kernel_size // 2
    return cls(in_channels, out_channels, kernel_size, stride, padding,
               dilation=dilation, groups=groups, bias=bias,
               compute_dtype=lowered_dtype(dtype))


def norm_name(norm_cfg, postfix='') -> str:
    """mmcv's `build_norm_layer` name of a norm: 'gn' for GN, 'bn' for BN /
    SyncBN, then `postfix` (a block's `bn1`, `gn2`, a ConvModule's
    `gn`)."""
    t = (norm_cfg or {}).get('type', 'BN')
    return ('gn' if t == 'GN' else 'bn') + str(postfix)


def make_norm(norm_cfg, num_features, dtype=None) -> nn.Module:
    """build_norm_layer equivalent: BN/SyncBN -> BatchNorm2d, GN -> GroupNorm,
    with the output in `dtype`."""
    t = (norm_cfg or {}).get('type', 'BN')
    dtype = lowered_dtype(dtype)
    if t == 'GN':
        groups = min((norm_cfg or {}).get('num_groups', 32), num_features)
        return GroupNorm(groups, num_features, eps=1e-5, compute_dtype=dtype)
    if t in ('BN', 'SyncBN'):
        return BatchNorm2d(num_features, eps=1e-5, compute_dtype=dtype)
    raise NotImplementedError(f'norm_cfg type {t!r} is not ported to '
                              'ld_tpu_torch yet (see ROADMAP.md)')


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator,
                  scale: float = 1.0, fan_in: int = None):
    """flax's default conv kernel init (variance_scaling(1, 'fan_in',
    'truncated_normal')): a normal truncated to 2 std, rescaled so the
    truncated distribution has variance scale/fan_in. `fan_in` defaults to
    an (out, in, ...) weight's; a transposed conv's (in, out, kh, kw)
    passes in x kh x kw, flax's."""
    if fan_in is None:
        fan_in = weight[0].numel()
    std = math.sqrt(scale / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def he_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's `he_normal` (variance_scaling(2, 'fan_in',
    'truncated_normal')), the JAX DCN kernel's init."""
    lecun_normal_(weight, generator, scale=2.0)
