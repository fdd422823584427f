"""Darknet-53 (port of `ld_tpu/models/backbones/darknet.py:18-85`), NCHW.

A stem 3x3 conv to 32 channels, then five stages, each a stride-2 3x3
conv and (1, 2, 8, 8, 4) residual units (a 1x1 conv to half the width, a
3x3 back, added to the input) at widths 64 to 1024; the maps of the
`out_indices` stages (3, 4, 5: widths 256, 512, 1024) come out. Every conv
is a `ConvBNLeaky`: conv without bias, BatchNorm, LeakyReLU(0.1). With
`norm_eval` (the default, and the only value a config gives) every BN runs
on its statistics, in training too, as in JAX (ROADMAP.md caveat 86);
`frozen_stages=k` takes the gradient from the stem and the first k stages
(the JAX package's `frozen_param_paths`).

Module names are mmdet's: `conv1.{conv,bn}` (the stem),
`conv_res_block{s}.conv.*` (a stage's downsampling conv),
`conv_res_block{s}.res{b}.conv{1,2}.*`. The JAX converter has no Darknet
rule: `state_dict_from_jax` carries a JAX tree to the port.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import BatchNorm2d, Conv2d, lowered_dtype
from ld_tpu_torch.utils.registry import BACKBONES
from .resnet import init_trunk_weights


class ConvBNLeaky(nn.Module):
    """mmcv's ConvModule of a conv without bias, a BN (`bn`) and
    LeakyReLU(0.1); the BN on its statistics under `norm_eval`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 norm_eval=True, dtype=None):
        super().__init__()
        dtype = lowered_dtype(dtype)
        self.norm_eval = norm_eval
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           kernel_size // 2, bias=False, compute_dtype=dtype)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, compute_dtype=dtype)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            self.bn.eval()
        return self

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class ResBlock(nn.Module):

    def __init__(self, channels, norm_eval=True, dtype=None):
        super().__init__()
        self.conv1 = ConvBNLeaky(channels, channels // 2, 1,
                                 norm_eval=norm_eval, dtype=dtype)
        self.conv2 = ConvBNLeaky(channels // 2, channels, 3,
                                 norm_eval=norm_eval, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


@BACKBONES.register_module()
class Darknet(nn.Module):

    blocks = (1, 2, 8, 8, 4)
    channels = (64, 128, 256, 512, 1024)

    def __init__(self, depth: int = 53,
                 out_indices: Tuple[int, ...] = (3, 4, 5),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 dtype=None):
        super().__init__()
        if depth != 53:
            raise KeyError(f'invalid depth {depth} for darknet')
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.conv1 = ConvBNLeaky(3, 32, 3, norm_eval=norm_eval, dtype=dtype)
        c_in = 32
        for s, (n, c) in enumerate(zip(self.blocks, self.channels), 1):
            stage = nn.Sequential()
            stage.add_module('conv', ConvBNLeaky(c_in, c, 3, 2,
                                                 norm_eval, dtype))
            for b in range(n):
                stage.add_module(f'res{b}', ResBlock(c, norm_eval, dtype))
            self.add_module(f'conv_res_block{s}', stage)
            c_in = c
        if frozen_stages >= 0:
            for m in [self.conv1] + [getattr(self, f'conv_res_block{s}')
                                     for s in range(1, frozen_stages + 1)]:
                m.requires_grad_(False)

    def init_weights(self, generator: torch.Generator):
        init_trunk_weights(self, generator)

    def forward(self, x):
        x = self.conv1(x)
        outs = []
        for s in range(1, len(self.blocks) + 1):
            x = getattr(self, f'conv_res_block{s}')(x)
            if s in self.out_indices:
                outs.append(x)
        return tuple(outs)
