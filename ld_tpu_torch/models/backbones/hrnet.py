"""HRNet backbone (port of `ld_tpu/models/backbones/hrnet.py`), NCHW.

A stem of two 3x3/2 convs at width 64, a Bottleneck stage 1, then stages
2-4: a transition adds one half-resolution branch (a chain of 3x3/2 convs
from the last branch) and adapts the width of an existing branch that
changes (a 3x3 conv), and `num_modules` `HRModule`s run `num_blocks` blocks
on each branch and exchange information across branches:
  * from a lower-resolution branch j to branch i (j > i): a 1x1 conv and
    BN, then a nearest x2^(j-i) upsample;
  * from a higher-resolution branch j (j < i): a chain of i-j stride-2 3x3
    convs, each with its BN, a ReLU after every link but the last;
  * branch i's output is the ReLU of its own features plus the others, added
    in the JAX order: its own first, then j = 0, 1, ... (mmdet starts from
    branch 0; the two sums differ only in rounding).
Every branch's final map is returned (the HRFPN neck takes them).

Options are the JAX class's: `extra` (the stage layouts; `DEFAULT_EXTRA`,
HRNetV2-W32, when None), `norm_eval` (every BN on its running
statistics), `frozen_stages` (>= 0 freezes the stem alone, as the JAX
`stop_gradient` after it does), a compute `dtype` on every conv and BN
(`models/layers.py`); `norm_cfg` is accepted and, as in the JAX class, not
read (BN only).

Module names are mmdet's (`conv1`/`bn1`, `conv2`/`bn2`, `layer1.{b}`,
`transition{s}.{i}.{0,1}` and `transition{s}.{i}.{j}.{0,1}`,
`stage{s}.{m}.branches.{i}.{b}`, `stage{s}.{m}.fuse_layers.{i}.{j}.{0,1}`
and `.{i}.{j}.{k}.{0,1}`), so a published mmdet checkpoint loads with
`load_state_dict(strict=True)`.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ld_tpu_torch.models.layers import make_conv, make_norm
from ld_tpu_torch.utils.registry import BACKBONES

from .resnet import BasicBlock, Bottleneck, init_trunk_weights, make_shortcut

# HRNetV2-W32's layout (the JAX `DEFAULT_EXTRA`; the configs pass theirs)
DEFAULT_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                num_blocks=(4, ), num_channels=(64, )),
    stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                num_blocks=(4, 4), num_channels=(32, 64)),
    stage3=dict(num_modules=4, num_branches=3, block='BASIC',
                num_blocks=(4, 4, 4), num_channels=(32, 64, 128)),
    stage4=dict(num_modules=3, num_branches=4, block='BASIC',
                num_blocks=(4, 4, 4, 4), num_channels=(32, 64, 128, 256)))

BLOCKS = {'BASIC': BasicBlock, 'BOTTLENECK': Bottleneck}


def conv_bn(c_in, c_out, k, stride, dtype, relu):
    """`Sequential(conv, BN[, ReLU])`, mmdet's `.0` / `.1` names."""
    layers = [make_conv(None, c_in, c_out, k, stride, dtype=dtype),
              make_norm(None, c_out, dtype)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


def make_blocks(block, inplanes, planes, num_blocks, dtype):
    """`num_blocks` stride-1 blocks of `planes`, the first with a 1x1 + BN
    shortcut when `inplanes` is not `planes * expansion`."""
    out = planes * block.expansion
    layers = []
    for b in range(num_blocks):
        shortcut = make_shortcut(inplanes, out, 1, False, dtype) \
            if b == 0 and inplanes != out else None
        layers.append(block(inplanes, planes, 1, 1, shortcut, dtype=dtype))
        inplanes = out
    return nn.Sequential(*layers)


class HRModule(nn.Module):
    """Parallel branches and their exchange (port of `HRModule`,
    `ld_tpu/models/backbones/hrnet.py:40-96`). `in_channels` are the
    branches' input widths; each branch outputs `num_channels[i] *
    expansion`. Takes and returns a list of NCHW maps, highest resolution
    first."""

    def __init__(self, num_branches: int, block: str,
                 num_blocks: Sequence[int], in_channels: Sequence[int],
                 num_channels: Sequence[int], dtype=None):
        super().__init__()
        block = BLOCKS[block]
        self.branches = nn.ModuleList(
            make_blocks(block, in_channels[i], num_channels[i],
                        num_blocks[i], dtype)
            for i in range(num_branches))
        widths = [c * block.expansion for c in num_channels]
        self.fuse_layers = None
        if num_branches > 1:
            self.fuse_layers = nn.ModuleList(
                nn.ModuleList(self._fuse(widths, i, j, dtype)
                              for j in range(num_branches))
                for i in range(num_branches))
        self.relu = nn.ReLU()

    @staticmethod
    def _fuse(widths, i, j, dtype):
        if j == i:
            return None
        if j > i:
            return nn.Sequential(
                make_conv(None, widths[j], widths[i], 1, dtype=dtype),
                make_norm(None, widths[i], dtype),
                nn.Upsample(scale_factor=2**(j - i), mode='nearest'))
        return nn.Sequential(*(
            conv_bn(widths[j], widths[i] if k == i - j - 1 else widths[j], 3,
                    2, dtype, relu=k < i - j - 1) for k in range(i - j)))

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, fuse in enumerate(self.fuse_layers):
            acc = ys[i]
            for j, layer in enumerate(fuse):
                if layer is not None:
                    acc = acc + layer(ys[j])
            fused.append(self.relu(acc))
        return fused


@BACKBONES.register_module()
class HRNet(nn.Module):
    """HRNet returning every branch's NCHW map of the last stage (port of
    `ld_tpu/models/backbones/hrnet.py:99-182`)."""

    def __init__(self, extra: dict = None, norm_eval: bool = True,
                 norm_cfg: dict = None, frozen_stages: int = -1,
                 dtype=None):
        super().__init__()
        if (norm_cfg or {}).get('type', 'BN') not in ('BN', 'SyncBN'):
            # accepted and not read by the JAX class, whose BNs are BN
            raise NotImplementedError('HRNet norm_cfg other than BN is not '
                                      'ported to ld_tpu_torch')
        extra = extra or DEFAULT_EXTRA
        self.norm_eval = norm_eval
        self.conv1 = make_conv(None, 3, 64, 3, 2, dtype=dtype)
        self.bn1 = make_norm(None, 64, dtype)
        self.conv2 = make_conv(None, 64, 64, 3, 2, dtype=dtype)
        self.bn2 = make_norm(None, 64, dtype)
        self.relu = nn.ReLU()

        s1 = extra['stage1']
        block = BLOCKS[s1['block']]
        self.layer1 = make_blocks(block, 64, s1['num_channels'][0],
                                  s1['num_blocks'][0], dtype)
        widths = [s1['num_channels'][0] * block.expansion]
        for s in (2, 3, 4):
            cfg = extra[f'stage{s}']
            exp = BLOCKS[cfg['block']].expansion
            targets = [c * exp for c in cfg['num_channels']]
            self.add_module(f'transition{s - 1}', self._transition(
                widths, targets, dtype))
            self.add_module(f'stage{s}', nn.Sequential(*(
                HRModule(cfg['num_branches'], cfg['block'],
                         cfg['num_blocks'], targets, cfg['num_channels'],
                         dtype) for _ in range(cfg['num_modules']))))
            widths = targets
        if frozen_stages >= 0:
            for m in (self.conv1, self.bn1, self.conv2, self.bn2):
                m.requires_grad_(False)

    @staticmethod
    def _transition(widths, targets, dtype):
        """A branch that exists and changes width: 3x3 + BN + ReLU; a new
        branch: a chain of 3x3/2 + BN + ReLU from the last branch."""
        layers = []
        for i, target in enumerate(targets):
            if i < len(widths):
                layers.append(None if widths[i] == target else
                              conv_bn(widths[i], target, 3, 1, dtype, True))
                continue
            n = i + 1 - len(widths)
            layers.append(nn.Sequential(*(
                conv_bn(widths[-1], target if j == n - 1 else widths[-1], 3,
                        2, dtype, True) for j in range(n))))
        return nn.ModuleList(layers)

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
        x = self.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in (2, 3, 4):
            transition = getattr(self, f'transition{s - 1}')
            # a new branch starts from the last one
            inputs = xs + [xs[-1]] * (len(transition) - len(xs))
            xs = getattr(self, f'stage{s}')([
                x if layer is None else layer(x)
                for layer, x in zip(transition, inputs)])
        return tuple(xs)
