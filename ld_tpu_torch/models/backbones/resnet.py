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
  * `dcn=dict(type='DCNv2' | 'DCN', deform_groups=g)` with
    `stage_with_dcn`: the conv2 of every bottleneck of those stages is a
    `ModulatedDeformConv2d` (`ops/deform_conv.py`), grouped like the plain
    one. The JAX ResNet builds that DCNv2 layer for any `dcn` dict, mmcv's
    DCNv1 type 'DCN' too, and so does the port (ROADMAP.md Queue C, caveat
    36: an mmcv DCNv1 checkpoint's `conv_offset` of 2 x k^2 x g rows then
    does not load, and the load says so). `fallback_on_stride` is accepted
    and, as in the JAX package, changes nothing.
  * `deep_stem` (ResNet-V1d): three 3x3 convs (base/2, base/2, base;
    strides 2, 1, 1), each with its BN and ReLU, as the `stem` Sequential.
  * `avg_down` (ResNet-V1d): a downsampling shortcut average-pools by its
    stride (floor, as the JAX `nn.avg_pool`; mmdet's `ceil_mode=True`
    agrees on every even map, ROADMAP.md Queue C caveat 15), then runs its
    1x1 conv at stride 1: `downsample = Sequential(pool, conv, BN)`, the
    pool an identity at stride 1.
  * `norm_cfg=dict(type='GN', num_groups=32)`: every norm of the trunk a
    GroupNorm of min(32, C) groups (`models/layers.py`), under mmdet's
    names by type (`gn1`, `layer1.0.gn3`, `downsample.1`); `norm_eval`
    then freezes nothing, `frozen_stages` still freezes the affine
    parameters of the stem and the frozen stages.
  * `conv_cfg=dict(type='ConvWS')`: every conv of the trunk weight-
    standardized (`ConvWS2d`), the 7x7 stem too; a DCN conv2 stays a DCN.
  * `plugins` (GCNet's `ContextBlock`, `GeneralizedAttention`;
    `plugins.py`): each plugin dict's `cfg` builds a block after a
    bottleneck's conv1, conv2 or conv3 (`position`; after the norm and
    ReLU, before the residual add), in config order, in the stages its
    `stages` flags select, under mmcv's names
    (`layer3.0.context_block`, `layer3.0.gen_attention_block`; a second
    plugin of one type in a block gets `_<i>`, its index among the
    stage's plugins). A BasicBlock takes none: ResNet-18/34 drop them with
    a warning, as the JAX package drops them silently (ROADMAP.md Queue C,
    caveat 39).
  * `zero_init_residual`: `init_weights` zeroes the scale of each block's
    last norm (the JAX `zero_init_final`).
  * `sac=dict(type='SAC')` with `stage_with_sac` (DetectoRS): the conv2 of
    every bottleneck of those stages is the JAX package's `SAConv2d`
    (below), neither grouped nor dilated; SAC takes precedence over DCN, as
    in JAX (`if with_sac ... elif with_dcn`). `DetectoRS_ResNet` is the
    ResNet with `stage_with_sac=(False, True, True, True)` by default;
    with `sac=None` it is the plain ResNet.

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
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import (Conv2d, he_normal_, lecun_normal_,
                                        lowered_dtype, make_conv, make_norm,
                                        norm_name)
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.utils.registry import BACKBONES
from .plugins import (PLUGIN_POSITIONS, PLUGINS, build_plugin,
                      stage_plugins, warn_basic_block_plugins)

# the `dcn` types that build the JAX package's DCNv2 layer (caveat 36)
DCN_TYPES = ('DCNv2', 'DCN')


class SAConv2d(nn.Module):
    """Switchable Atrous Convolution as the JAX package writes it (port of
    `ld_tpu/models/backbones/resnet.py:355-394`), under mmcv's SAConv2d
    names (`weight`, `pre_context`, `switch`, `post_context`), NCHW.

    x += pre_context(GAP(x)); the switch S = sigmoid(switch(avg5x5(x))),
    the pool counting its zero padding (flax `avg_pool`), taken at full
    resolution and then subsampled by the stride; one shared 3x3 `weight`
    run at dilation 1 and at dilation 3, both in float32; out = S * out1 +
    (1 - S) * out3, then out += post_context(GAP(out)), cast back to the
    input's dtype. mmcv's layer differs (ROADMAP.md caveat 61): a separate
    `weight_diff` for the dilated branch, weight standardization and
    optional deformable offsets, none of which JAX has. The contexts and
    the switch start at zero, so S starts at 0.5."""

    def __init__(self, in_channels, out_channels, stride=1, dtype=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.pre_context = Conv2d(in_channels, in_channels, 1,
                                  compute_dtype=dtype)
        self.switch = Conv2d(in_channels, 1, 1, compute_dtype=dtype)
        self.post_context = Conv2d(out_channels, out_channels, 1,
                                   compute_dtype=dtype)

    def init_weights(self, generator: torch.Generator):
        """The JAX initializers: a he-normal `weight`, zero contexts and
        switch."""
        he_normal_(self.weight, generator)
        for m in (self.pre_context, self.switch, self.post_context):
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)

    def forward(self, x):
        x = x + self.pre_context(x.mean(dim=(2, 3), keepdim=True))
        switch = torch.sigmoid(self.switch(F.avg_pool2d(
            x, 5, 1, 2, count_include_pad=True)))
        xf, w = x.float(), self.weight.float()
        out1 = F.conv2d(xf, w, None, self.stride, 1)
        out3 = F.conv2d(xf, w, None, self.stride, 3, 3)
        switch = switch[:, :, ::self.stride, ::self.stride].float()
        out = switch * out1 + (1 - switch) * out3
        out = out + self.post_context(out.mean(dim=(2, 3), keepdim=True))
        return out.to(x.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, conv_cfg=None, norm_cfg=None,
                 style='pytorch', dtype=None):
        super().__init__()
        # one stride placement: `style` changes nothing here, as in mmdet
        del style
        self.norm1_name, self.norm2_name = (norm_name(norm_cfg, i)
                                            for i in (1, 2))
        self.conv1 = make_conv(conv_cfg, inplanes, planes, 3, stride,
                               dtype=dtype)
        self.add_module(self.norm1_name, make_norm(norm_cfg, planes, dtype))
        self.conv2 = make_conv(conv_cfg, planes, planes, 3, 1, dtype=dtype)
        self.add_module(self.norm2_name, make_norm(norm_cfg, planes, dtype))
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    @property
    def norm1(self):
        return getattr(self, self.norm1_name)

    @property
    def norm2(self):
        return getattr(self, self.norm2_name)

    @property
    def last_norm(self):
        return self.norm2

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, conv_cfg=None, norm_cfg=None,
                 style='pytorch', dtype=None, groups=1, base_width=64,
                 dcn=None, base_channels=64, expansion=None, plugins=None,
                 sac=None):
        super().__init__()
        if expansion is not None:
            # RegNet's blocks: expansion 1, output width `planes`
            self.expansion = expansion
        s1, s2 = (stride, 1) if style == 'caffe' else (1, stride)
        # ResNeXt widens the bottleneck by groups * base_width /
        # base_channels (64; RegNet passes its stage width)
        width = int(planes * (base_width / base_channels)) * groups \
            if groups > 1 else planes
        self.norm1_name, self.norm2_name, self.norm3_name = (
            norm_name(norm_cfg, i) for i in (1, 2, 3))
        self.conv1 = make_conv(conv_cfg, inplanes, width, 1, s1, dtype=dtype)
        self.add_module(self.norm1_name, make_norm(norm_cfg, width, dtype))
        if sac is not None:
            # SAC before DCN, as the JAX block; neither grouped nor dilated
            self.conv2 = SAConv2d(width, width, s2, lowered_dtype(dtype))
        elif dcn is not None:
            # the DCN conv2 of a ResNeXt stays grouped
            self.conv2 = ModulatedDeformConv2d(
                width, width, 3, s2, dilation=dilation, groups=groups,
                deform_groups=dcn.get('deform_groups', 1),
                compute_dtype=lowered_dtype(dtype))
        else:
            self.conv2 = make_conv(conv_cfg, width, width, 3, s2,
                                   padding=dilation, dilation=dilation,
                                   groups=groups, dtype=dtype)
        self.add_module(self.norm2_name, make_norm(norm_cfg, width, dtype))
        self.conv3 = make_conv(conv_cfg, width, planes * self.expansion, 1, 1,
                               dtype=dtype)
        self.add_module(self.norm3_name,
                        make_norm(norm_cfg, planes * self.expansion, dtype))
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample
        # plugin module names by position, each list in config order
        self.plugin_names = {pos: [] for pos in PLUGIN_POSITIONS}
        for i, p in enumerate(plugins or ()):
            plugin = build_plugin(p['cfg'], planes * self.expansion
                                  if p['position'] == 'after_conv3'
                                  else width)
            name = plugin.abbr if not hasattr(self, plugin.abbr) else \
                f'{plugin.abbr}_{i}'
            self.add_module(name, plugin)
            self.plugin_names[p['position']].append(name)

    @property
    def norm1(self):
        return getattr(self, self.norm1_name)

    @property
    def norm2(self):
        return getattr(self, self.norm2_name)

    @property
    def norm3(self):
        return getattr(self, self.norm3_name)

    @property
    def last_norm(self):
        return self.norm3

    def _plugins(self, x, position):
        for name in self.plugin_names[position]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.norm1(self.conv1(x)))
        out = self._plugins(out, 'after_conv1')
        out = self.relu(self.norm2(self.conv2(out)))
        out = self._plugins(out, 'after_conv2')
        out = self.norm3(self.conv3(out))
        out = self._plugins(out, 'after_conv3')
        return self.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}

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
    kernels, BN scale 1 / bias 0 / running mean 0 / running var 1, GN
    scale 1 / bias 0; a DCN conv he-normal, its `conv_offset` zero; a
    plugin and an SAConv2d their own (`plugins.py`, above)."""
    kinds = tuple(PLUGINS.values()) + (SAConv2d, )
    skip = {id(m.conv_offset) for m in module.modules()
            if isinstance(m, ModulatedDeformConv2d)}
    skip |= {id(sub) for m in module.modules() if isinstance(m, kinds)
             for sub in m.modules()}
    for m in module.modules():
        if isinstance(m, (ModulatedDeformConv2d, *kinds)):
            m.init_weights(generator)
        elif id(m) in skip:
            continue
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
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
                 plugins: Sequence[dict] = None,
                 zero_init_residual: bool = False,
                 sac: dict = None,
                 stage_with_sac: Sequence[bool] = (False, False, False,
                                                   False),
                 dtype=None):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'invalid depth {depth} for resnet')
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'ResNet style={style!r}')
        block, stage_blocks = ARCH_SETTINGS[depth]
        if dcn is not None and dcn.get('type', 'DCNv2') not in DCN_TYPES:
            raise ValueError(f"ResNet dcn type {dcn['type']!r}: one of "
                             f'{DCN_TYPES}')
        if block is BasicBlock and (groups != 1 or any(
                cfg is not None and any(stages) for cfg, stages in (
                    (dcn, stage_with_dcn), (sac, stage_with_sac)))):
            # mmdet asserts the same: BasicBlock takes no groups, DCN or SAC
            raise ValueError(f'ResNet-{depth} (BasicBlock) takes no groups, '
                             'dcn or sac')
        if block is BasicBlock and plugins:
            warn_basic_block_plugins(depth)
            plugins = None
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.zero_init_residual = zero_init_residual

        self.deep_stem = deep_stem
        if deep_stem:
            self.stem = make_deep_stem(in_channels, base_channels, dtype,
                                       conv_cfg, norm_cfg)
        else:
            # a 7x7/2 conv; weight-standardized under a ConvWS conv_cfg
            self.conv1 = make_conv(conv_cfg, in_channels, base_channels, 7, 2,
                                   dtype=dtype)
            self.norm1_name = norm_name(norm_cfg, 1)
            self.add_module(self.norm1_name,
                            make_norm(norm_cfg, base_channels, dtype))
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
                    else None, plugins=stage_plugins(plugins, i),
                    sac=sac if sac is not None and stage_with_sac[i]
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

    @property
    def norm1(self):
        return getattr(self, self.norm1_name)

    def _stem_modules(self):
        return [self.stem] if self.deep_stem else [self.conv1, self.norm1]

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
        if self.zero_init_residual:
            for name in self.res_layers:
                for block in getattr(self, name):
                    nn.init.zeros_(block.last_norm.weight)

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
            self.relu(self.norm1(self.conv1(x)))
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


@BACKBONES.register_module()
class DetectoRS_ResNet(ResNet):
    """The ResNet whose bottleneck 3x3s are `SAConv2d`s on the stages
    `stage_with_sac` selects, when `sac` is set (port of
    `ld_tpu/models/backbones/resnet.py:397-402`); the RFP neck's recursion
    never re-runs it (ROADMAP.md caveat 62)."""

    def __init__(self, depth: int,
                 stage_with_sac: Sequence[bool] = (False, True, True, True),
                 **kwargs):
        super().__init__(depth, stage_with_sac=stage_with_sac, **kwargs)


class TridentConv(nn.Module):
    """One 3x3 `weight` run at each branch's dilation (padding the same) on
    that branch's chunk of the batch, in float32, the output cast back
    (port of the shared `conv2_kernel` of `ld_tpu/models/backbones/
    resnet.py:404-447`)."""

    def __init__(self, in_channels, out_channels, stride=1,
                 dilations=(1, 2, 3)):
        super().__init__()
        self.stride, self.dilations = stride, tuple(dilations)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))

    def init_weights(self, generator: torch.Generator):
        """The JAX kernel's he-normal init."""
        he_normal_(self.weight, generator)

    def forward(self, x):
        w = self.weight.float()
        outs = [F.conv2d(c.float(), w, None, self.stride, d, d)
                for c, d in zip(x.chunk(len(self.dilations), 0),
                                self.dilations)]
        return torch.cat(outs, 0).to(x.dtype)


class TridentBottleneck(nn.Module):
    """A bottleneck over the branch-folded batch (3B, C, H, W): 1x1, the
    shared-weight `TridentConv` (the stride on it), 1x1 to 4x, each with its
    BN, the shortcut, ReLU; mmdet's names (`conv2.weight` the shared 3x3)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilations=(1, 2, 3),
                 downsample=None, norm_cfg=None, dtype=None):
        super().__init__()
        self.norm1_name, self.norm2_name, self.norm3_name = (
            norm_name(norm_cfg, i) for i in (1, 2, 3))
        self.conv1 = make_conv(None, inplanes, planes, 1, dtype=dtype)
        self.add_module(self.norm1_name, make_norm(norm_cfg, planes, dtype))
        self.conv2 = TridentConv(planes, planes, stride, dilations)
        self.add_module(self.norm2_name, make_norm(norm_cfg, planes, dtype))
        self.conv3 = make_conv(None, planes, planes * 4, 1, dtype=dtype)
        self.add_module(self.norm3_name,
                        make_norm(norm_cfg, planes * 4, dtype))
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(getattr(self, self.norm1_name)(self.conv1(x)))
        out = self.relu(getattr(self, self.norm2_name)(self.conv2(out)))
        out = getattr(self, self.norm3_name)(self.conv3(out))
        return self.relu(out + identity)


@BACKBONES.register_module()
class TridentResNet(ResNet):
    """The ResNet whose last built stage runs `num_branch` weight-shared
    branches at `trident_dilations`, the branches folded into the batch
    (B -> 3B) as the stage is entered (port of `ld_tpu/models/backbones/
    resnet.py:449-505`). The C4 configs build three stages, so the trident
    stage is res4 (`layer3`) and the output is (3B, 1024, H/16, W/16),
    branch-major. As in the JAX backbone (ROADMAP.md caveat 90) every block
    is 'pytorch'-style, whatever `style` the config gives, and the stem is
    the plain 7x7 conv; `test_branch_idx` is read by the detector."""

    def __init__(self, depth: int, num_branch: int = 3,
                 test_branch_idx: int = 1,
                 trident_dilations: Sequence[int] = (1, 2, 3),
                 style: str = 'pytorch', **kwargs):
        super().__init__(depth, style='pytorch', **kwargs)
        del style
        self.num_branch = num_branch
        self.test_branch_idx = test_branch_idx
        last = len(self.res_layers) - 1
        expansion = ARCH_SETTINGS[depth][0].expansion
        inplanes = 64 * 2 ** (last - 1) * expansion if last else 64
        planes = 64 * 2 ** last
        stride = kwargs.get('strides', (1, 2, 2, 2))[last]
        norm_cfg, dtype = kwargs.get('norm_cfg'), kwargs.get('dtype')
        blocks = []
        for b in range(len(getattr(self, self.res_layers[-1]))):
            s = stride if b == 0 else 1
            downsample = None
            if b == 0 and (s != 1 or inplanes != planes * 4):
                downsample = make_shortcut(inplanes, planes * 4, s, False,
                                           dtype, None, norm_cfg)
            blocks.append(TridentBottleneck(inplanes, planes, s,
                                            trident_dilations, downsample,
                                            norm_cfg, dtype))
            inplanes = planes * 4
        self.add_module(self.res_layers[-1], nn.Sequential(*blocks))
        self._freeze_stages()
        if (norm_cfg or {}).get('requires_grad', True) is False:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.requires_grad_(False)

    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        for m in self.modules():
            if isinstance(m, TridentConv):
                m.init_weights(generator)

    def forward(self, x):
        x = self.relu(self.norm1(self.conv1(x)))
        x = self.maxpool(x)
        outs = []
        for i, name in enumerate(self.res_layers):
            if i == len(self.res_layers) - 1:
                x = x.repeat(self.num_branch, 1, 1, 1)
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
