"""RegNetX backbone (port of `ld_tpu/models/backbones/regnet.py`), NCHW.

The arch's (w0, wa, wm, depth) give a quantised linear width a block
(`generate_regnet`), runs of equal width are the stages
(`get_stages_from_blocks`), and the stage widths are made divisible by the
group width (`adjust_width_group`): the port's own copies of the JAX
package's numpy helpers. A 3x3/2 stem conv at `base_channels`, then in each
stage expansion-1 bottlenecks of the stage width (the port's `Bottleneck`
with `expansion=1`): a 1x1, a 3x3 of `width * bot_mul // group_w` groups
carrying the stage's stride in the stage's first block, and a 1x1 back to
the width; a 1x1 + BN shortcut where the stride or the width changes.

Options are the JAX class's: `out_indices`, `strides`, `frozen_stages`
(the stem and the first k stages get no gradient), `norm_eval` (every BN on
its running statistics), a compute `dtype` (`models/layers.py`), and
`dcn=dict(type='DCNv2', deform_groups=g)` with `stage_with_dcn`: conv2 of
those stages is a `ModulatedDeformConv2d` with the conv groups inside it
(mmcv's `build_conv_layer(dcn, ..., groups=groups)`, JAX `:132-142`);
`fallback_on_stride` is accepted and changes nothing. `norm_cfg` and
`style` are accepted and, as in the JAX class, not read (BN, 'pytorch').

Module names are mmdet's (`conv1`, `bn1`, `layer{s}.{b}.conv1..bn3`,
`layer{s}.{b}.downsample.{0,1}`), so a published mmdet checkpoint loads
with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ld_tpu_torch.models.layers import make_conv, make_norm
from ld_tpu_torch.utils.registry import BACKBONES

from .resnet import Bottleneck, init_trunk_weights, make_shortcut

ARCH_SETTINGS = {
    'regnetx_400mf':
    dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22, bot_mul=1.0),
    'regnetx_800mf':
    dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16, bot_mul=1.0),
    'regnetx_1.6gf':
    dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18, bot_mul=1.0),
    'regnetx_3.2gf':
    dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25, bot_mul=1.0),
    'regnetx_4.0gf':
    dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23, bot_mul=1.0),
    'regnetx_6.4gf':
    dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17, bot_mul=1.0),
    'regnetx_8.0gf':
    dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23, bot_mul=1.0),
    'regnetx_12gf':
    dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19, bot_mul=1.0),
}


def generate_regnet(w0, wa, wm, depth, divisor=8):
    """Per-block widths from the RegNet linear parameterization, and the
    number of stages."""
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = (np.round(widths / divisor) * divisor).astype(int)
    num_stages = len(np.unique(widths))
    return widths.tolist(), num_stages


def quantize_float(number, divisor):
    return int(round(number / divisor) * divisor)


def adjust_width_group(widths, bottleneck_ratio, groups):
    """Stage widths made divisible by their (quantised) group widths."""
    bottleneck_width = [int(w * b) for w, b in zip(widths, bottleneck_ratio)]
    groups = [min(g, w_bot) for g, w_bot in zip(groups, bottleneck_width)]
    bottleneck_width = [
        quantize_float(w_bot, g) for w_bot, g in zip(bottleneck_width, groups)
    ]
    widths = [
        int(w_bot / b) for w_bot, b in zip(bottleneck_width, bottleneck_ratio)
    ]
    return widths, groups


def get_stages_from_blocks(widths):
    """Equal-width runs of blocks collapsed into stages: (widths, blocks)."""
    width_diff = [
        w != wp for w, wp in zip(widths + [0], [0] + widths)
    ]
    stage_widths = [w for w, d in zip(widths, width_diff[:-1]) if d]
    stage_blocks = np.diff(
        [i for i, d in enumerate(width_diff) if d]).tolist()
    return stage_widths, stage_blocks


def regnet_layout(arch):
    """An arch name of `ARCH_SETTINGS` or a dict of its keys -> (stage
    widths, stage blocks, group widths, bottleneck multipliers), as the
    JAX `RegNet._layout` gives them."""
    arch = ARCH_SETTINGS[arch] if isinstance(arch, str) else dict(arch)
    widths, num_stages = generate_regnet(arch['w0'], arch['wa'], arch['wm'],
                                         arch['depth'])
    stage_widths, stage_blocks = get_stages_from_blocks(widths)
    group_widths = [arch['group_w']] * num_stages
    bot_muls = [arch.get('bot_mul', 1.0)] * num_stages
    stage_widths, group_widths = adjust_width_group(stage_widths, bot_muls,
                                                    group_widths)
    return stage_widths, stage_blocks, group_widths, bot_muls


@BACKBONES.register_module()
class RegNet(nn.Module):
    """RegNetX returning the NCHW maps of the `out_indices` stages (port of
    `ld_tpu/models/backbones/regnet.py:79-185`)."""

    def __init__(self,
                 arch='regnetx_3.2gf',
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 strides: Sequence[int] = (2, 2, 2, 2),
                 base_channels: int = 32,
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
        if dcn is not None and dcn.get('type', 'DCNv2') != 'DCNv2':
            raise NotImplementedError(
                f"RegNet dcn type {dcn['type']!r} is not ported to "
                'ld_tpu_torch yet (see ROADMAP.md Queue A, keys that '
                'still raise)')
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.conv1 = make_conv(None, 3, base_channels, 3, 2, dtype=dtype)
        self.bn1 = make_norm(None, base_channels, dtype)
        self.relu = nn.ReLU(inplace=True)

        inplanes = base_channels
        self.res_layers = []
        for i, (width, blocks, group_w, bot_mul) in enumerate(
                zip(*regnet_layout(arch))):
            groups = int(width * bot_mul) // group_w
            layers = []
            for b in range(blocks):
                s = strides[i] if b == 0 else 1
                shortcut = make_shortcut(inplanes, width, s, False, dtype) \
                    if b == 0 and (s != 1 or inplanes != width) else None
                # mmdet's ResNeXt block at base_channels = width: a conv2
                # of groups * group_w = int(width * bot_mul) channels
                layers.append(Bottleneck(
                    inplanes, width, s, 1, shortcut, dtype=dtype,
                    groups=groups, base_width=group_w,
                    base_channels=width, expansion=1,
                    dcn=dcn if dcn is not None and stage_with_dcn[i]
                    else None))
                inplanes = width
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layers))
            self.res_layers.append(name)
        if frozen_stages >= 0:
            self.conv1.requires_grad_(False)
            self.bn1.requires_grad_(False)
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
        x = self.relu(self.bn1(self.conv1(x)))
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
