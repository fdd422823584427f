"""SSD-VGG16 backbone; port of `ld_tpu/models/backbones/ssd_vgg.py:21-95`,
NCHW.

  * `L2Norm`: gamma * x / sqrt(sum_c x^2 + 1e-10) over the channels,
    `weight` (gamma) initialised to `scale` (20), in float32 (the JAX
    package's form: the 1e-10 under the root).
  * `SSDVGG`: VGG-16's convs (3x3, ReLU) through conv5_3 with 2x2/2 max
    pools after the first four blocks, the third in ceil mode (75 -> 38 at
    300, as the JAX pad of one row and column); a 3x3/1 pool5 with padding
    1; fc6 (3x3, dilation 6) and fc7 (1x1), each with ReLU. The outputs are
    the L2-normed conv4_3 map, fc7, and the extra levels: a 1x1 squeeze and
    a 3x3 expand each, strides (2, 2, valid, valid) at 300, four stride-2
    pairs plus a final 1x1 and 4x4 pad-1 conv at 512. 6 levels at 300 (38,
    19, 10, 5, 3, 1), 7 at 512.

Module names are mmdet's (`features.N` for the VGG's layers, ReLUs and
pools counted, `extra.N` for the extra convs, `l2_norm.weight`), which
`ld_tpu.utils.checkpoint.convert_torch_state_dict` maps to the JAX
names. A compute `dtype` lowers every conv; L2Norm computes in float32
and returns the compute dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d, lecun_normal_, lowered_dtype
from ld_tpu_torch.utils.registry import BACKBONES

# VGG-16 through conv5_3: channels, 'M' a 2x2/2 pool, 'C' the same in ceil
# mode
VGG16_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'C', 512, 512, 512,
             'M', 512, 512, 512]
# the index of conv4_3's ReLU in `features`: the L2Norm's input
CONV4_3_RELU = 22
# (squeeze, expand, stride) of the extra pairs; stride 1 a valid 3x3
EXTRA_SETTINGS = {
    300: ((256, 512, 2), (128, 256, 2), (128, 256, 1), (128, 256, 1)),
    512: ((256, 512, 2), (128, 256, 2), (128, 256, 2), (128, 256, 2)),
}


class L2Norm(nn.Module):

    def __init__(self, n_dims: int, scale: float = 20.0, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((n_dims, ), float(scale)))
        self.scale = scale
        self.compute_dtype = dtype

    def forward(self, x):
        xf = x.float()
        norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-10)
        out = self.weight[None, :, None, None] * xf / norm
        return out if self.compute_dtype is None else \
            out.to(self.compute_dtype)


@BACKBONES.register_module()
class SSDVGG(nn.Module):

    def __init__(self, input_size: int = 300, l2_norm_scale: float = 20.0,
                 dtype=None):
        super().__init__()
        if input_size not in EXTRA_SETTINGS:
            raise ValueError(f'SSDVGG input_size {input_size}: 300 or 512')
        self.input_size = input_size
        dtype = lowered_dtype(dtype)

        def conv(c_in, c_out, k, **kw):
            return Conv2d(c_in, c_out, k, compute_dtype=dtype, **kw)
        layers, c = [], 3
        for v in VGG16_CFG:
            if v in ('M', 'C'):
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=v == 'C'))
            else:
                layers += [conv(c, v, 3, padding=1), nn.ReLU(inplace=True)]
                c = v
        layers += [nn.MaxPool2d(3, 1, 1),
                   conv(512, 1024, 3, padding=6, dilation=6),
                   nn.ReLU(inplace=True), conv(1024, 1024, 1),
                   nn.ReLU(inplace=True)]
        self.features = nn.Sequential(*layers)
        extra, c = [], 1024
        for sq, ex, stride in EXTRA_SETTINGS[input_size]:
            extra += [conv(c, sq, 1),
                      conv(sq, ex, 3, stride=stride,
                           padding=1 if stride == 2 else 0)]
            c = ex
        if input_size == 512:
            extra += [conv(c, 128, 1), conv(128, 256, 4, padding=1)]
        self.extra = nn.ModuleList(extra)
        self.l2_norm = L2Norm(512, l2_norm_scale, dtype)

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers: lecun-normal kernels, zero
        biases, the L2Norm's gamma at its scale."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, generator)
                    nn.init.zeros_(m.bias)
            self.l2_norm.weight.fill_(self.l2_norm.scale)

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i == CONV4_3_RELU:
                outs.append(self.l2_norm(x))
        outs.append(x)                                   # fc7
        for i, conv in enumerate(self.extra):
            x = torch.relu(conv(x))
            if i % 2 == 1:
                outs.append(x)
        return tuple(outs)
