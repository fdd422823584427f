"""ResNet backbones (port of `ld_tpu/models/backbones/resnet.py:63-334`), NCHW.

'pytorch'-style blocks put a bottleneck's stride on its 3x3 conv2,
'caffe'-style ones (the Detectron-lineage weights of the FCOS-GFL teachers)
on its 1x1 conv1. The detection semantics of the JAX package:

  * `norm_eval=True`: every BatchNorm uses its running statistics, also when
    the module is in training mode (`train()` keeps the BNs in eval).
  * `frozen_stages=k`: the stem and the first k stages get no gradient
    (`requires_grad=False`) and keep their BNs in eval.
  * `norm_cfg=dict(type='BN', requires_grad=False)`: no BN affine of the
    backbone gets a gradient.
  * `groups` / `base_width` (ResNeXt): a bottleneck of width
    int(planes * base_width / 64) * groups with a grouped conv2.
  * `dcn=dict(type='DCNv2', deform_groups=g)` with `stage_with_dcn`: the
    conv2 of every bottleneck of those stages is a `ModulatedDeformConv2d`
    (`ops/deform_conv.py`), grouped like the plain one. `fallback_on_stride`
    is accepted and, as in the JAX package, changes nothing.
  * `deep_stem` (ResNet-V1d): three 3x3 convs (base/2, base/2, base;
    strides 2, 1, 1), each with its BN and ReLU, as the `stem` Sequential.
  * `avg_down` (ResNet-V1d): a downsampling shortcut average-pools by its
    stride (floor, as the JAX `nn.avg_pool`; mmdet's `ceil_mode=True`
    agrees on every even map, ROADMAP.md Queue C caveat 15), then runs its
    1x1 conv at stride 1: `downsample = Sequential(pool, conv, BN)`, the
    pool an identity at stride 1.

Module names are mmdet's (`conv1`, `bn1`, `layer1.0.conv1`,
`layer1.0.downsample.{0,1}`, with `deep_stem` `stem.{0,3,6}` and
`stem.{1,4,7}`, with `avg_down` `layer1.0.downsample.{1,2}`, ...), so a
published mmdet/torchvision checkpoint loads with
`load_state_dict(strict=True)`.

The plain stem is a 7x7/2 conv. The JAX stem is `SpaceToDepthStem`, a TPU
reformulation of the same conv with the same (7, 7, 3, 64) parameter; the two
differ only by summation order.

`dtype` (a config's compute dtype, e.g. 'bfloat16') lowers every conv and BN
of the trunk (`models/layers.py`): the stem, the blocks and their shortcuts
then compute in it, and so do the ReLUs, the max-pool and the residual adds
between them; the parameters and running statistics stay float32.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ld_tpu_torch.models.layers import (Conv2d, lecun_normal_,
                                        lowered_dtype, make_conv, make_norm)
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.utils.registry import BACKBONES


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, conv_cfg=None, norm_cfg=None,
                 style='pytorch', dtype=None):
        super().__init__()
        # one stride placement: `style` changes nothing here, as in mmdet
        del style
        self.conv1 = make_conv(conv_cfg, inplanes, planes, 3, stride,
                               dtype=dtype)
        self.bn1 = make_norm(norm_cfg, planes, dtype)
        self.conv2 = make_conv(conv_cfg, planes, planes, 3, 1, dtype=dtype)
        self.bn2 = make_norm(norm_cfg, planes, dtype)
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
                 downsample=None, conv_cfg=None, norm_cfg=None,
                 style='pytorch', dtype=None, groups=1, base_width=64,
                 dcn=None):
        super().__init__()
        s1, s2 = (stride, 1) if style == 'caffe' else (1, stride)
        # ResNeXt widens the bottleneck by groups * base_width / 64
        width = int(planes * (base_width / 64.0)) * groups \
            if groups > 1 else planes
        self.conv1 = make_conv(conv_cfg, inplanes, width, 1, s1, dtype=dtype)
        self.bn1 = make_norm(norm_cfg, width, dtype)
        if dcn is not None:
            # the DCN conv2 of a ResNeXt stays grouped
            self.conv2 = ModulatedDeformConv2d(
                width, width, 3, s2, dilation=dilation, groups=groups,
                deform_groups=dcn.get('deform_groups', 1),
                compute_dtype=lowered_dtype(dtype))
        else:
            self.conv2 = make_conv(conv_cfg, width, width, 3, s2,
                                   padding=dilation, dilation=dilation,
                                   groups=groups, dtype=dtype)
        self.bn2 = make_norm(norm_cfg, width, dtype)
        self.conv3 = make_conv(conv_cfg, width, planes * self.expansion, 1, 1,
                               dtype=dtype)
        self.bn3 = make_norm(norm_cfg, planes * self.expansion, dtype)
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
# value that means "off" (ROADMAP.md A7)
_UNPORTED_KEYS = dict(sac=None, plugins=None, zero_init_residual=False)


def make_deep_stem(in_channels, channels, dtype=None, conv_cfg=None,
                   norm_cfg=None) -> nn.Sequential:
    """The v1d deep stem: 3x3 convs to channels/2, channels/2 and
    channels at strides 2, 1, 1, each followed by its BN and a ReLU."""
    layers, c_in = [], in_channels
    for c_out, stride in ((channels // 2, 2), (channels // 2, 1),
                          (channels, 1)):
        layers += [make_conv(conv_cfg, c_in, c_out, 3, stride, dtype=dtype),
                   make_norm(norm_cfg, c_out, dtype), nn.ReLU(inplace=True)]
        c_in = c_out
    return nn.Sequential(*layers)


def make_shortcut(inplanes, out_channels, stride, avg_down, dtype=None,
                  conv_cfg=None, norm_cfg=None) -> nn.Sequential:
    """A block's downsampling shortcut (port of `_shortcut`,
    `ld_tpu/models/backbones/resnet.py:93-99`): a strided 1x1 conv and its
    BN; with `avg_down`, an average pool by the stride, then the conv at
    stride 1."""
    if not avg_down:
        return nn.Sequential(
            make_conv(conv_cfg, inplanes, out_channels, 1, stride,
                      dtype=dtype),
            make_norm(norm_cfg, out_channels, dtype))
    return nn.Sequential(
        nn.AvgPool2d(stride, stride) if stride > 1 else nn.Identity(),
        make_conv(conv_cfg, inplanes, out_channels, 1, 1, dtype=dtype),
        make_norm(norm_cfg, out_channels, dtype))


def init_trunk_weights(module: nn.Module, generator: torch.Generator):
    """The JAX package's initializers over a backbone: lecun-normal conv
    kernels, BN scale 1 / bias 0 / running mean 0 / running var 1; a DCN
    conv he-normal, its `conv_offset` zero."""
    offset_convs = {id(m.conv_offset) for m in module.modules()
                    if isinstance(m, ModulatedDeformConv2d)}
    for m in module.modules():
        if isinstance(m, ModulatedDeformConv2d):
            m.init_weights(generator)
        elif isinstance(m, nn.Conv2d) and id(m) not in offset_convs:
            lecun_normal_(m.weight, generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


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
                 groups: int = 1,
                 base_width: int = 64,
                 dcn: dict = None,
                 stage_with_dcn: Sequence[bool] = (False, False, False,
                                                   False),
                 deep_stem: bool = False,
                 avg_down: bool = False,
                 dtype=None,
                 **kwargs):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'invalid depth {depth} for resnet')
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'ResNet style={style!r}')
        for key, value in kwargs.items():
            if key in _UNPORTED_KEYS and value != _UNPORTED_KEYS[key]:
                raise NotImplementedError(
                    f'ResNet {key}={value!r} is not ported to ld_tpu_torch '
                    'yet (see ROADMAP.md A7)')
            # stage_with_sac only matters with sac set
            if key not in _UNPORTED_KEYS and key != 'stage_with_sac':
                raise TypeError(f'unexpected ResNet argument {key!r}')
        if (norm_cfg or {}).get('type', 'BN') not in ('BN', 'SyncBN'):
            raise NotImplementedError('ResNet norm_cfg other than BN is not '
                                      'ported to ld_tpu_torch yet')
        block, stage_blocks = ARCH_SETTINGS[depth]
        if dcn is not None and dcn.get('type', 'DCNv2') != 'DCNv2':
            # the JAX layer is DCNv2 whatever the type; mmcv's DCNv1 ('DCN')
            # has no mask and another conv_offset width
            raise NotImplementedError(
                f"ResNet dcn type {dcn['type']!r} is not ported to "
                'ld_tpu_torch yet (see ROADMAP.md A7)')
        if block is BasicBlock and (groups != 1 or (
                dcn is not None and any(stage_with_dcn))):
            # mmdet asserts the same: BasicBlock takes no groups or DCN
            raise ValueError(f'ResNet-{depth} (BasicBlock) takes no groups '
                             'or dcn')
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval

        self.deep_stem = deep_stem
        if deep_stem:
            self.stem = make_deep_stem(in_channels, base_channels, dtype,
                                       conv_cfg, norm_cfg)
        else:
            self.conv1 = Conv2d(in_channels, base_channels, 7, 2, 3,
                                bias=False,
                                compute_dtype=lowered_dtype(dtype))
            self.bn1 = make_norm(norm_cfg, base_channels, dtype)
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
                    downsample = make_shortcut(
                        inplanes, planes * block.expansion, s, avg_down,
                        dtype, conv_cfg, norm_cfg)
                extra = {} if block is BasicBlock else dict(
                    groups=groups, base_width=base_width,
                    dcn=dcn if dcn is not None and stage_with_dcn[i]
                    else None)
                layers.append(block(inplanes, planes, s, dilation,
                                    downsample, conv_cfg, norm_cfg, style,
                                    dtype, **extra))
                inplanes = planes * block.expansion
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layers))
            self.res_layers.append(name)
        self._freeze_stages()
        if (norm_cfg or {}).get('requires_grad', True) is False:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.requires_grad_(False)

    def _stem_modules(self):
        return [self.stem] if self.deep_stem else [self.conv1, self.bn1]

    def _freeze_stages(self):
        if self.frozen_stages >= 0:
            for m in self._stem_modules():
                for p in m.parameters():
                    p.requires_grad = False
        for i in range(1, self.frozen_stages + 1):
            for p in getattr(self, f'layer{i}').parameters():
                p.requires_grad = False

    def init_weights(self, generator: torch.Generator):
        init_trunk_weights(self, generator)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode:
            # the stem's BNs run on their statistics with norm_eval or any
            # frozen_stages >= 0, a frozen stage's too
            frozen = self._stem_modules() if self.frozen_stages >= 0 else []
            frozen += [getattr(self, f'layer{i}')
                       for i in range(1, self.frozen_stages + 1)]
            for mod in ([self] if self.norm_eval else frozen):
                for m in mod.modules():
                    if isinstance(m, nn.modules.batchnorm._BatchNorm):
                        m.eval()
        return self

    def forward(self, x):
        x = self.stem(x) if self.deep_stem else \
            self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """ResNeXt: the ResNet with grouped bottlenecks, by default 32 groups of
    base width 4 (X-101-32x4d; port of `ld_tpu/models/backbones/resnet.py:
    338-345`)."""

    def __init__(self, depth: int, groups: int = 32, base_width: int = 4,
                 **kwargs):
        super().__init__(depth, groups=groups, base_width=base_width,
                         **kwargs)


@BACKBONES.register_module()
class ResNetV1d(ResNet):
    """ResNet-V1d: the deep 3x3 stem and avg-down shortcuts (port of
    `ld_tpu/models/backbones/resnet.py:348-352`)."""

    def __init__(self, depth: int, deep_stem: bool = True,
                 avg_down: bool = True, **kwargs):
        super().__init__(depth, deep_stem=deep_stem, avg_down=avg_down,
                         **kwargs)
