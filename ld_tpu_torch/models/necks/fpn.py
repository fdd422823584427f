"""Feature Pyramid Network neck (port of `ld_tpu/models/necks/fpn.py:35-114`),
NCHW.

Lateral 1x1 convs + top-down nearest-neighbour upsampling (size-matched, so
odd feature sizes work) + 3x3 output convs; extra levels by stride-2 3x3 convs
on input/lateral/output (`add_extra_convs`), or by max-pool without extra
convs. Module names are mmdet's (`lateral_convs.i.conv`, `fpn_convs.i.conv`,
the extra convs continuing the `fpn_convs` indices). With a compute `dtype`
every conv, and the top-down adds between them, compute in it (JAX
`fpn.py:49-66`); the parameters stay float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import lecun_normal_, make_conv
from ld_tpu_torch.utils.registry import NECKS


def upsample_nearest_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour upsample of NCHW `x` to (h, w), picking the source
    pixel `jax.image.resize(method='nearest')` picks:
    floor((i + 0.5) * in / out), computed in float32 as JAX computes it.
    For exact 2x that is i // 2, which plain `nearest` also gives."""
    ih, iw = x.shape[-2:]
    if h == 2 * ih and w == 2 * iw:
        return F.interpolate(x, scale_factor=2, mode='nearest')

    def index(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        return torch.floor(pos).long().to(x.device)

    return x[:, :, index(ih, h)][:, :, :, index(iw, w)]


class ConvModule(nn.Module):
    """mmcv ConvModule without norm/activation: keeps the `.conv` name."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


@NECKS.register_module()
class FPN(nn.Module):

    def __init__(self,
                 in_channels: Sequence[int],
                 out_channels: int = 256,
                 num_outs: int = 5,
                 start_level: int = 0,
                 end_level: int = -1,
                 add_extra_convs=None,
                 extra_convs_on_inputs: bool = True,
                 relu_before_extra_convs: bool = False,
                 no_norm_on_lateral: bool = False,
                 conv_cfg: dict = None,
                 norm_cfg: dict = None,
                 dtype=None):
        super().__init__()
        if norm_cfg is not None:
            raise NotImplementedError('FPN norm_cfg is not ported to '
                                      'ld_tpu_torch yet (see ROADMAP.md)')
        self.in_channels = list(in_channels)
        self.num_outs = num_outs
        end = len(self.in_channels) if end_level in (-1, None) else end_level
        self.used = list(range(start_level, end))
        self.relu_before_extra_convs = relu_before_extra_convs
        if add_extra_convs is True:
            add_extra_convs = 'on_input' if extra_convs_on_inputs \
                else 'on_output'
        self.extra_mode = add_extra_convs or None

        self.lateral_convs = nn.ModuleList(
            ConvModule(make_conv(conv_cfg, self.in_channels[lvl],
                                 out_channels, 1, bias=True, dtype=dtype))
            for lvl in self.used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(make_conv(conv_cfg, out_channels, out_channels, 3,
                                 bias=True, dtype=dtype))
            for _ in self.used)
        if self.extra_mode:
            for j in range(num_outs - len(self.used)):
                cin = self.in_channels[self.used[-1]] \
                    if j == 0 and self.extra_mode == 'on_input' \
                    else out_channels
                self.fpn_convs.append(ConvModule(make_conv(
                    conv_cfg, cin, out_channels, 3, 2, bias=True,
                    dtype=dtype)))

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers: lecun-normal kernels, zero bias."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f'{len(inputs)} inputs for '
                             f'{len(self.in_channels)} in_channels')
        laterals = [conv(inputs[lvl])
                    for conv, lvl in zip(self.lateral_convs, self.used)]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_to(
                laterals[i], h, w)
        n = len(laterals)
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        if self.num_outs > n:
            if not self.extra_mode:
                for _ in range(self.num_outs - n):
                    outs.append(F.max_pool2d(outs[-1], 1, stride=2))
            else:
                extra = {'on_input': inputs[self.used[-1]],
                         'on_lateral': laterals[-1],
                         'on_output': outs[-1]}[self.extra_mode]
                for j in range(self.num_outs - n):
                    if j > 0 and self.relu_before_extra_convs:
                        extra = F.relu(extra)
                    extra = self.fpn_convs[n + j](extra)
                    outs.append(extra)
        return tuple(outs)
