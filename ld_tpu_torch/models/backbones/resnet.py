"""ResNet backbones (port of `ld_tpu/models/backbones/resnet.py:63-334`), NCHW.

'pytorch'-style blocks (stride on the 3x3 conv of a bottleneck) with the
detection semantics of the JAX package:

  * `norm_eval=True`: every BatchNorm uses its running statistics, also when
    the module is in training mode (`train()` keeps the BNs in eval).
  * `frozen_stages=k`: the stem and the first k stages get no gradient
    (`requires_grad=False`) and keep their BNs in eval.

Module names are mmdet's (`conv1`, `bn1`, `layer1.0.conv1`,
`layer1.0.downsample.{0,1}`, ...), so a published mmdet/torchvision
checkpoint loads with `load_state_dict(strict=True)`.

The stem is a plain 7x7/2 conv. The JAX stem is `SpaceToDepthStem`, a TPU
reformulation of the same conv with the same (7, 7, 3, 64) parameter; the two
differ only by fp32 summation order.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ld_tpu_torch.models.layers import lecun_normal_, make_conv, make_norm
from ld_tpu_torch.utils.registry import BACKBONES


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, conv_cfg=None, norm_cfg=None):
        super().__init__()
        self.conv1 = make_conv(conv_cfg, inplanes, planes, 3, stride)
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = make_conv(conv_cfg, planes, planes, 3, 1)
        self.bn2 = make_norm(norm_cfg, planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, conv_cfg=None, norm_cfg=None):
        super().__init__()
        self.conv1 = make_conv(conv_cfg, inplanes, planes, 1, 1)
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = make_conv(conv_cfg, planes, planes, 3, stride,
                               padding=dilation, dilation=dilation)
        self.bn2 = make_norm(norm_cfg, planes)
        self.conv3 = make_conv(conv_cfg, planes, planes * self.expansion, 1, 1)
        self.bn3 = make_norm(norm_cfg, planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}

# config keys of the JAX ResNet that select variants not ported yet, with the
# value that means "off"
_UNPORTED_KEYS = dict(deep_stem=False, avg_down=False, dcn=None, sac=None,
                      plugins=None, zero_init_residual=False, groups=1,
                      base_width=64)
# where the port's plan has them
_ROADMAP_ITEMS = dict(dcn='ROADMAP.md item 21', groups='ROADMAP.md item 22',
                      base_width='ROADMAP.md item 22')


@BACKBONES.register_module()
class ResNet(nn.Module):
    """ResNet returning the NCHW feature maps of the `out_indices` stages."""

    def __init__(self,
                 depth: int,
                 num_stages: int = 4,
                 base_channels: int = 64,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 frozen_stages: int = -1,
                 norm_eval: bool = True,
                 norm_cfg: dict = None,
                 conv_cfg: dict = None,
                 style: str = 'pytorch',
                 in_channels: int = 3,
                 **kwargs):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'invalid depth {depth} for resnet')
        if style != 'pytorch':
            raise NotImplementedError(f'ResNet style={style!r} is not ported '
                                      'to ld_tpu_torch yet (see ROADMAP.md)')
        for key, value in kwargs.items():
            if key in _UNPORTED_KEYS and value != _UNPORTED_KEYS[key]:
                raise NotImplementedError(
                    f'ResNet {key}={value!r} is not ported to ld_tpu_torch '
                    f'yet (see {_ROADMAP_ITEMS.get(key, "ROADMAP.md")})')
            # stage_with_dcn / stage_with_sac only matter with dcn / sac set
            if key not in _UNPORTED_KEYS and key not in ('stage_with_dcn',
                                                         'stage_with_sac'):
                raise TypeError(f'unexpected ResNet argument {key!r}')
        if (norm_cfg or {}).get('type', 'BN') not in ('BN', 'SyncBN'):
            raise NotImplementedError('ResNet norm_cfg other than BN is not '
                                      'ported to ld_tpu_torch yet')
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval

        self.conv1 = nn.Conv2d(in_channels, base_channels, 7, 2, 3,
                               bias=False)
        self.bn1 = make_norm(norm_cfg, base_channels)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)

        inplanes = base_channels
        self.res_layers = []
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = base_channels * 2**i
            stride, dilation = strides[i], dilations[i]
            layers = []
            for b in range(num_blocks):
                s = stride if b == 0 else 1
                downsample = None
                if b == 0 and (s != 1 or inplanes != planes * block.expansion):
                    downsample = nn.Sequential(
                        make_conv(conv_cfg, inplanes, planes * block.expansion,
                                  1, s),
                        make_norm(norm_cfg, planes * block.expansion))
                layers.append(block(inplanes, planes, s, dilation,
                                    downsample, conv_cfg, norm_cfg))
                inplanes = planes * block.expansion
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layers))
            self.res_layers.append(name)
        self._freeze_stages()

    def _freeze_stages(self):
        if self.frozen_stages >= 0:
            for m in (self.conv1, self.bn1):
                for p in m.parameters():
                    p.requires_grad = False
        for i in range(1, self.frozen_stages + 1):
            for p in getattr(self, f'layer{i}').parameters():
                p.requires_grad = False

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers: lecun-normal conv kernels, BN
        scale 1 / bias 0 / running mean 0 / running var 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def train(self, mode: bool = True):
        super().train(mode)
        if mode:
            frozen = [self.bn1] if self.frozen_stages >= 0 else []
            frozen += [getattr(self, f'layer{i}')
                       for i in range(1, self.frozen_stages + 1)]
            for mod in ([self] if self.norm_eval else frozen):
                for m in mod.modules():
                    if isinstance(m, nn.modules.batchnorm._BatchNorm):
                        m.eval()
        return self

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
