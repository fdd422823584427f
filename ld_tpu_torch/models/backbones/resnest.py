"""ResNeSt backbone (split-attention networks); port of
`ld_tpu/models/backbones/resnest.py:34-199`, NCHW.

  * `SplitAttentionConv` (mmdet's `SplitAttentionConv2d`): a 3x3 conv of
    `groups * radix` groups to `width * radix` channels (no bias), `bn0`
    and ReLU; the global average pool of the radix sum; `fc1` (a biased
    1x1 conv of `groups` groups to max(in * radix / reduction_factor,
    32)), `bn1` and ReLU; `fc2` (biased, `groups` groups) back to `width *
    radix` attention logits. The conv's output is radix-major (channel
    r * width + g * K + k, K = width / groups), the logits group-major
    (g * R * K + r * K + k): they are viewed (B, G, R, K), softmaxed over
    R and transposed to (B, R, G * K), mmdet's `RSoftmax`; at radix 1 a
    sigmoid takes the softmax's place.
  * `ResNeStBottleneck`: `conv1` / `bn1` / ReLU, the split-attention
    `conv2` (at stride 1 under `avg_down_stride`, followed by a 3x3 average
    pool at the stride with padding 1 that counts the pad, mmdet's
    `avd_layer`), `conv3` / `bn3`, and the V1d shortcut: an average pool
    by the stride (floor, as the JAX `nn.avg_pool`: ROADMAP.md caveat 56),
    then a 1x1 conv and its BN (`downsample.{1,2}`).
  * `ResNeSt`: the V1d deep stem (3x3 convs to stem/2, stem/2 and stem, at
    strides 2, 1, 1, each with BN and ReLU; `stem.{0,1,3,4,6,7}`) and its
    3x3/2 max pool, then the stages of `ARCH[depth]`, planes 64 * 2^i.
    `frozen_stages` and `norm_eval` as the port's ResNet: the stem and the
    first k stages get no gradient and keep their BNs on their running
    statistics; with `norm_eval=False` (every ResNeSt config) every other
    BN takes the batch's statistics in training, the pooled map's `bn1`
    included. `norm_cfg` (the configs' SyncBN), `style`, `deep_stem` and
    `avg_down` are accepted and not read, as in the JAX class: a V1d
    trunk, with BN over each device's own batch.

The BNs are torch's: in training their running variance takes the
unbiased batch variance, where the JAX package's flax BN takes the biased
one (n / (n - 1) apart, n the values of a channel: 2 for `bn1` at batch
2), and a channel of one value (`bn1` at batch 1) raises where flax gives
the BN's bias (ROADMAP.md caveat 56).

Module names are mmdet's (`stem.*`, `layerS.B.{conv1, bn1, conv2.{conv,
bn0, fc1, bn1, fc2}, conv3, bn3, downsample.{1,2}}`). A compute `dtype`
lowers every conv and BN, as the port's ResNet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ld_tpu_torch.models.layers import make_conv, make_norm
from ld_tpu_torch.utils.registry import BACKBONES
from .resnet import init_trunk_weights, make_deep_stem, make_shortcut

ARCH = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
    200: (3, 24, 36, 3),
}


class SplitAttentionConv(nn.Module):
    """The split-attention 3x3 conv: `channels` (the block's width) per
    radix in and out."""

    def __init__(self, in_channels, channels, stride=1, dilation=1,
                 groups=1, radix=2, reduction_factor=4, dtype=None):
        super().__init__()
        self.radix, self.groups, self.channels = radix, groups, channels
        inter = max(in_channels * radix // reduction_factor, 32)
        self.conv = make_conv(None, in_channels, channels * radix, 3, stride,
                              padding=dilation, dilation=dilation,
                              groups=groups * radix, dtype=dtype)
        self.bn0 = make_norm(None, channels * radix, dtype)
        self.fc1 = make_conv(None, channels, inter, 1, groups=groups,
                             bias=True, dtype=dtype)
        self.bn1 = make_norm(None, inter, dtype)
        self.fc2 = make_conv(None, inter, channels * radix, 1, groups=groups,
                             bias=True, dtype=dtype)

    def forward(self, x):
        out = torch.relu(self.bn0(self.conv(x)))
        b, _, h, w = out.shape
        r, c = self.radix, self.channels
        splits = out.view(b, r, c, h, w)                 # radix-major
        gap = splits.sum(1).mean(dim=(2, 3), keepdim=True)
        gap = torch.relu(self.bn1(self.fc1(gap)))
        atten = self.fc2(gap)                            # (B, R * C, 1, 1)
        if r == 1:
            return splits[:, 0] * torch.sigmoid(atten)
        a = atten.view(b, self.groups, r, c // self.groups).softmax(dim=2)
        a = a.transpose(1, 2).reshape(b, r, c, 1, 1)
        return (splits * a).sum(1)


class ResNeStBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, groups=1, base_width=4, radix=2,
                 reduction_factor=4, avg_down_stride=True, dtype=None):
        super().__init__()
        width = planes if groups == 1 else \
            int(planes * (base_width / 64.0)) * groups
        avd = avg_down_stride and stride > 1
        self.conv1 = make_conv(None, inplanes, width, 1, dtype=dtype)
        self.bn1 = make_norm(None, width, dtype)
        self.conv2 = SplitAttentionConv(
            width, width, stride=1 if avd else stride, dilation=dilation,
            groups=groups, radix=radix, reduction_factor=reduction_factor,
            dtype=dtype)
        self.avd_layer = nn.AvgPool2d(3, stride, padding=1) if avd else None
        self.conv3 = make_conv(None, width, planes * self.expansion, 1,
                               dtype=dtype)
        self.bn3 = make_norm(None, planes * self.expansion, dtype)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.conv2(out)
        if self.avd_layer is not None:
            out = self.avd_layer(out)
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


@BACKBONES.register_module()
class ResNeSt(nn.Module):
    """ResNeSt returning the NCHW feature maps of the `out_indices`
    stages."""

    def __init__(self, depth: int = 50, stem_channels: int = 64,
                 num_stages: int = 4,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 norm_cfg: dict = None, groups: int = 1,
                 base_width: int = 4, radix: int = 2,
                 reduction_factor: int = 4, avg_down_stride: bool = True,
                 style: str = 'pytorch', deep_stem: bool = True,
                 avg_down: bool = True, in_channels: int = 3, dtype=None,
                 **kwargs):
        super().__init__()
        if depth not in ARCH:
            raise KeyError(f'invalid depth {depth} for ResNeSt')
        if kwargs:
            raise TypeError(f'unexpected ResNeSt arguments {sorted(kwargs)}')
        # read by neither package: the trunk is always V1d with BN
        # (caveat 56)
        del norm_cfg, style, deep_stem, avg_down
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.stem = make_deep_stem(in_channels, stem_channels, dtype)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = stem_channels
        self.res_layers = []
        for i, num_blocks in enumerate(ARCH[depth][:num_stages]):
            planes = 64 * 2**i
            layers = []
            for b in range(num_blocks):
                s = strides[i] if b == 0 else 1
                downsample = None
                if b == 0 and (s != 1 or inplanes != planes * 4):
                    downsample = make_shortcut(inplanes, planes * 4, s, True,
                                               dtype)
                layers.append(ResNeStBottleneck(
                    inplanes, planes, s, dilations[i], downsample, groups,
                    base_width, radix, reduction_factor, avg_down_stride,
                    dtype))
                inplanes = planes * 4
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layers))
            self.res_layers.append(name)
        self._freeze_stages()

    def _frozen_modules(self):
        if self.frozen_stages < 0:
            return []
        return [self.stem] + [getattr(self, f'layer{i}')
                              for i in range(1, self.frozen_stages + 1)]

    def _freeze_stages(self):
        for m in self._frozen_modules():
            for p in m.parameters():
                p.requires_grad = False

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers: lecun-normal conv kernels, zero
        `fc1` / `fc2` biases, BN scale 1 / bias 0 / mean 0 / var 1."""
        init_trunk_weights(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, SplitAttentionConv):
                    nn.init.zeros_(m.fc1.bias)
                    nn.init.zeros_(m.fc2.bias)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode:
            for mod in [self] if self.norm_eval else self._frozen_modules():
                for m in mod.modules():
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


__all__ = ['ResNeSt', 'ResNeStBottleneck', 'SplitAttentionConv']
