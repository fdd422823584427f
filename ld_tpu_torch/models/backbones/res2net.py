"""Res2Net backbone (port of `ld_tpu/models/backbones/res2net.py`), NCHW.

A `Bottle2neck` widens its 1x1 `conv1` to `width * scales` channels
(width = int(planes * base_width / 64)) and splits the result into `scales`
parts. Parts 0 .. scales-2 each run through a 3x3 `convs.i` + `bns.i` +
ReLU; part i first adds the previous branch's output, except in a stage's
first block and for i = 0. The last part passes through, average-pooled
(3x3, padding 1, the padding counted) in a stage's first block when it
strides. Then `conv3` / `bn3`, and the avg-down shortcut
(`resnet.make_shortcut`) on each block that downsamples.

The trunk is mmdet's `res2net101_v1d_26w_4s`: the v1d deep stem (32, 32,
64 channels) and avg-down shortcuts. Its options are the JAX class's:
  * `dcn=dict(type='DCNv2', ...)` with `stage_with_dcn`: every split conv
    of those stages is a `ModulatedDeformConv2d`, the strided ones too (the
    configs set `fallback_on_stride=False`, which, as in the JAX package,
    changes nothing);
  * `norm_eval`: every BatchNorm uses its running statistics, the stem's
    and a frozen stage's too; without it every BN follows the module's mode
    (the JAX Res2Net has no rule of its own for the stem or a frozen stage,
    unlike its ResNet);
  * `frozen_stages=k`: the stem and the first k stages get no gradient
    (the JAX `stop_gradient` points);
  * `dtype`: a compute dtype on every conv, BN and DCN (`models/layers.py`),
    as in the port's ResNet;
  * `norm_cfg` and `style` are accepted and, as in the JAX class, not read.

Module names are mmdet's (`stem.{0,3,6}` / `stem.{1,4,7}`,
`layer1.0.convs.0`, `layer1.0.bns.0`, `layer1.0.bn1`,
`layer1.0.downsample.{1,2}`, a DCN split's `convs.i.conv_offset`), so a
published mmdet checkpoint loads with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ld_tpu_torch.models.layers import lowered_dtype, make_conv, make_norm
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.utils.registry import BACKBONES

from .resnet import init_trunk_weights, make_deep_stem, make_shortcut

ARCH_SETTINGS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 scales=4, base_width=26, stage_block=False, dcn=None,
                 dtype=None):
        super().__init__()
        width = int(planes * base_width / 64.0)
        self.width, self.scales, self.stage_block = width, scales, stage_block
        self.conv1 = make_conv(None, inplanes, width * scales, 1, 1,
                               dtype=dtype)
        self.bn1 = make_norm(None, width * scales, dtype)
        if dcn is not None:
            convs = [ModulatedDeformConv2d(
                width, width, 3, stride,
                deform_groups=dcn.get('deform_groups', 1),
                compute_dtype=lowered_dtype(dtype))
                for _ in range(scales - 1)]
        else:
            convs = [make_conv(None, width, width, 3, stride, dtype=dtype)
                     for _ in range(scales - 1)]
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(make_norm(None, width, dtype)
                                 for _ in range(scales - 1))
        self.pool = nn.AvgPool2d(3, stride, 1) \
            if stage_block and stride != 1 else None
        self.conv3 = make_conv(None, width * scales, planes * self.expansion,
                               1, 1, dtype=dtype)
        self.bn3 = make_norm(None, planes * self.expansion, dtype)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        splits = torch.split(out, self.width, dim=1)
        outs, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = splits[i] if self.stage_block or i == 0 else sp + splits[i]
            sp = self.relu(bn(conv(sp)))
            outs.append(sp)
        outs.append(splits[-1] if self.pool is None
                    else self.pool(splits[-1]))
        out = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        return self.relu(out + identity)


@BACKBONES.register_module()
class Res2Net(nn.Module):
    """Res2Net returning the NCHW feature maps of the `out_indices`
    stages."""

    def __init__(self,
                 depth: int = 50,
                 scales: int = 4,
                 base_width: int = 26,
                 num_stages: int = 4,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 frozen_stages: int = -1,
                 norm_eval: bool = True,
                 norm_cfg: dict = None,
                 style: str = 'pytorch',
                 dcn: dict = None,
                 stage_with_dcn: Sequence[bool] = (False, False, False,
                                                   False),
                 dtype=None):
        super().__init__()
        del norm_cfg, style   # accepted and not read, as in the JAX class
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'invalid depth {depth} for res2net')
        if dcn is not None and dcn.get('type', 'DCNv2') != 'DCNv2':
            raise NotImplementedError(
                f"Res2Net dcn type {dcn['type']!r} is not ported to "
                'ld_tpu_torch yet (see ROADMAP.md Queue A, keys that '
                'still raise)')
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval

        self.stem = make_deep_stem(3, 64, dtype)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        self.res_layers = []
        for i, num_blocks in enumerate(ARCH_SETTINGS[depth][:num_stages]):
            planes = 64 * 2**i
            layers = []
            for b in range(num_blocks):
                s = strides[i] if b == 0 else 1
                downsample = None
                if b == 0 and (s != 1 or inplanes != planes * 4):
                    downsample = make_shortcut(inplanes, planes * 4, s, True,
                                               dtype)
                layers.append(Bottle2neck(
                    inplanes, planes, s, downsample, scales, base_width,
                    stage_block=b == 0,
                    dcn=dcn if dcn is not None and stage_with_dcn[i]
                    else None, dtype=dtype))
                inplanes = planes * 4
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layers))
            self.res_layers.append(name)
        if frozen_stages >= 0:
            self.stem.requires_grad_(False)
        for i in range(1, frozen_stages + 1):
            getattr(self, f'layer{i}').requires_grad_(False)

    def init_weights(self, generator: torch.Generator):
        init_trunk_weights(self, generator)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
