"""Modulated deformable convolution, DCNv2 (port of
`ld_tpu/ops/deform_conv.py:24-137`), NCHW, in plain PyTorch.

The JAX op is plain jnp (no Pallas source): a bilinear deformed im2col and
one matrix product. The port computes it the same way:

  1. `conv_offset`, a biased conv, predicts per deform group and tap a
     (dy, dx) offset and a modulation logit; zero-initialised, it gives zero
     offsets and masks of 0.5, so the layer starts as half the plain conv;
  2. the input, as flattened NHWC rows, is sampled at the k*k deformed tap
     positions: four row gathers, one per bilinear corner, weighted by the
     corner's bilinear weight times the sigmoid mask;
  3. the columns (B*oh*ow, k*k*C/G) contract with the weight, one product
     per conv group (ResNeXt's DCN conv2 stays grouped).

Parameter names and layouts are mmcv's `ModulatedDeformConv2dPack`:
`weight` (O, C/groups, k, k) with no bias, and `conv_offset`
(`nn.Conv2d(C, deform_groups*3*k*k, k, stride, padding)`), read mmcv's way:
`o1, o2, mask = chunk(3)`, `offset = cat(o1, o2)` holds interleaved
(dy, dx) pairs per deform group and tap. A published `.pth` strict-loads.
The JAX layer reads the component-major layout that its converter's
`_dcn_offset_perm` makes of the same tensor.

The bilinear sample is the JAX one: a sample counts only where
-1 < y < H and -1 < x < W, each corner outside the map is zero, and the
weights are 1 - frac and frac from `floor`.

Dilation 1 only. The JAX `conv_offset` is an undilated conv padded by
(k//2)*dilation, where mmcv dilates it; the two agree only at dilation 1,
which every config that sets `dcn` keeps (ROADMAP.md Queue C, caveat 12).

`compute_dtype` (a config's compute dtype): `conv_offset` runs in it and
its output goes to float32; the sample, the mask and the product run in
float32 on the float32 weight; the output is rounded to it.
"""
from __future__ import annotations

import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d, he_normal_


def deform_columns(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                   mask: torch.Tensor, stride: int, pad: int,
                   k: int) -> torch.Tensor:
    """The modulated deformed im2col of `x`.

    Args:
        x: (B, C, H, W) float32.
        dy, dx, mask: (B, oh, ow, k*k, g) float32: each output position's
            tap offsets and modulation per deform group (C/g channels each).
    Returns:
        (B*oh*ow, k*k, C) float32 columns, tap-major as the HWIO kernel.
    """
    b, c, h, w = x.shape
    _, oh, ow, kk, g = dy.shape
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    py = torch.arange(oh, **f32) * stride - pad
    px = torch.arange(ow, **f32) * stride - pad
    ky = torch.arange(k, **f32).repeat_interleave(k)
    kx = torch.arange(k, **f32).repeat(k)
    ys = (py[:, None, None] + ky)[..., None] + dy      # (B, oh, ow, kk, g)
    xs = (px[None, :, None] + kx)[..., None] + dx
    inside = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    m = mask * inside
    y0, x0 = y0.long(), x0.long()
    # rows of (C/g) channels: row ((b*H + y)*W + x)*g + deform group,
    # row-major (at B = 1 the reshape alone is a column-strided view, whose
    # row gathers read one float per 32-byte sector)
    flat = x.permute(0, 2, 3, 1).reshape(b * h * w * g, c // g).contiguous()
    img = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1, 1, 1)
    group = torch.arange(g, device=dev)
    cols = None
    for yi, xi, wgt in ((y0, x0, hy * hx), (y0, x0 + 1, hy * lx),
                        (y0 + 1, x0, ly * hx), (y0 + 1, x0 + 1, ly * lx)):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        rows = (img + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)) * g + group
        vals = flat.index_select(0, rows.reshape(-1))   # (B*P*kk*g, C/g)
        weight = (wgt * ok * m).reshape(-1, 1)
        cols = vals * weight if cols is None else \
            torch.addcmul(cols, vals, weight)
    return cols.view(b * oh * ow, kk, c)


def deform_product(cols: torch.Tensor, weight: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """(N, k*k, C) columns times an OIHW (O, C/groups, k, k) weight, each
    conv group's output channels from its own C/groups inputs -> (N, O)."""
    n, kk, c = cols.shape
    o = weight.shape[0]
    if groups == 1:
        return cols.reshape(n, kk * c) @ \
            weight.permute(0, 2, 3, 1).reshape(o, kk * c).t()
    cpg, opg = c // groups, o // groups
    colg = cols.view(n, kk, groups, cpg).permute(2, 0, 1, 3).reshape(
        groups, n, kk * cpg)
    wg = weight.reshape(groups, opg, cpg, kk).permute(0, 3, 2, 1).reshape(
        groups, kk * cpg, opg)
    return torch.bmm(colg, wg).permute(1, 0, 2).reshape(n, o)


class ModulatedDeformConv2d(nn.Module):
    """DCNv2 (NCHW) under mmcv's `ModulatedDeformConv2dPack` names: `weight`
    (O, C/groups, k, k), no bias, and the `conv_offset` conv; padded by
    k // 2, as the JAX layer is. `groups` is conv grouping, `deform_groups`
    the number of offset fields."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 groups: int = 1, deform_groups: int = 1, compute_dtype=None):
        super().__init__()
        if dilation != 1:
            raise NotImplementedError(
                f'ModulatedDeformConv2d dilation={dilation}: the JAX '
                'conv_offset is undilated where mmcv dilates it, so the two '
                'agree only at dilation 1 (ROADMAP.md Queue C, caveat 12)')
        if in_channels % groups or out_channels % groups or \
                in_channels % deform_groups:
            raise ValueError(f'channels {in_channels} -> {out_channels} do '
                             f'not split into {groups} groups and '
                             f'{deform_groups} deform groups')
        k = kernel_size
        padding = k // 2
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = k, stride, padding
        self.groups, self.deform_groups = groups, deform_groups
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, k, k))
        self.conv_offset = Conv2d(in_channels, deform_groups * 3 * k * k, k,
                                  stride, padding, bias=True,
                                  compute_dtype=compute_dtype)
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.init_offset()

    def init_offset(self):
        """Zero `conv_offset`: zero offsets and masks of 0.5, half the
        plain conv of `weight`."""
        with torch.no_grad():
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def init_weights(self, generator: torch.Generator):
        """The JAX layer's initializers: he-normal `weight`, zero
        `conv_offset`."""
        he_normal_(self.weight, generator)
        self.init_offset()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, k, g = x.shape[0], self.kernel_size, self.deform_groups
        kk = k * k
        om = self.conv_offset(x).float()            # (B, 3*g*kk, oh, ow)
        oh, ow = om.shape[-2:]
        offset = om[:, :2 * g * kk].reshape(b, g, kk, 2, oh, ow)
        dy = offset[:, :, :, 0].permute(0, 3, 4, 2, 1)   # (B, oh, ow, kk, g)
        dx = offset[:, :, :, 1].permute(0, 3, 4, 2, 1)
        mask = torch.sigmoid(om[:, 2 * g * kk:]).reshape(
            b, g, kk, oh, ow).permute(0, 3, 4, 2, 1)
        cols = deform_columns(x.float(), dy, dx, mask, self.stride,
                              self.padding, k)
        out = deform_product(cols, self.weight.float(), self.groups)
        out = out.view(b, oh, ow, self.out_channels).permute(0, 3, 1, 2)
        return out.to(self.compute_dtype or x.dtype).contiguous()

    def extra_repr(self) -> str:
        return (f'{self.in_channels}, {self.out_channels}, '
                f'kernel_size={self.kernel_size}, stride={self.stride}, '
                f'groups={self.groups}, deform_groups={self.deform_groups}')
