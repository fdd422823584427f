"""HRFPN neck (port of `ld_tpu/models/necks/extra_necks.py:92-122`), NCHW.

Branch i of an HRNet is upsampled by 2^i, bilinear (`F.interpolate` with
`align_corners=False`: `jax.image.resize(..., 'bilinear')` when it
enlarges, edge renormalisation included), the branches are concatenated
and reduced by a 1x1 conv with bias, level i of the pyramid is that map
average- (or max-) pooled by 2^i, and each level gets a 3x3 conv with bias
at `stride` (2 in the FCOS-HRNet configs). Module names are mmdet's
(`reduction_conv.conv`, `fpn_convs.{i}.conv`). With a compute `dtype` the
resizes, pools and convs compute in it; the parameters stay float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import lecun_normal_, make_conv
from ld_tpu_torch.utils.registry import NECKS

from .fpn import ConvModule


@NECKS.register_module()
class HRFPN(nn.Module):

    def __init__(self,
                 in_channels: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 256,
                 num_outs: int = 5,
                 pooling_type: str = 'AVG',
                 stride: int = 1,
                 dtype=None):
        super().__init__()
        if pooling_type not in ('AVG', 'MAX'):
            raise ValueError(f'HRFPN pooling_type={pooling_type!r}')
        self.in_channels = list(in_channels)
        self.num_outs = num_outs
        self.pool = F.avg_pool2d if pooling_type == 'AVG' else F.max_pool2d
        self.reduction_conv = ConvModule(make_conv(
            None, sum(self.in_channels), out_channels, 1, bias=True,
            dtype=dtype))
        self.fpn_convs = nn.ModuleList(
            ConvModule(make_conv(None, out_channels, out_channels, 3, stride,
                                 bias=True, dtype=dtype))
            for _ in range(num_outs))

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
        ups = [inputs[0]] + [
            F.interpolate(x, size=(x.shape[-2] << i, x.shape[-1] << i),
                          mode='bilinear', align_corners=False)
            for i, x in enumerate(inputs) if i > 0]
        out = self.reduction_conv(torch.cat(ups, dim=1))
        outs = [out] + [self.pool(out, 2**i, 2**i)
                        for i in range(1, self.num_outs)]
        return tuple(conv(o) for conv, o in zip(self.fpn_convs, outs))
