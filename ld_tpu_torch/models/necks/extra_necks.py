"""The long-tail necks (port of `ld_tpu/models/necks/extra_necks.py:33-430`),
NCHW: the BFP of Libra R-CNN, NAS-FPN with its merge cells, CARAFE and
FPN_CARAFE, NASFCOS_FPN, FPG and the RFP of DetectoRS.

Each follows the JAX module's code; where mmdet has the module the names
are mmdet's, where the JAX module is a redesign they keep its layout under
names a reader can map (ROADMAP.md caveats 62-64):

  * `BFP`: every level gathered to `refine_level`'s size (an adaptive max
    pool of the finer levels, mmdet's, which is the JAX module's
    integer-ratio pool wherever the ratio is an integer and also runs where
    it is not, as at 800x1344's 13x21 P6: ROADMAP.md caveat 69; a nearest
    upsample of the coarser) and averaged, refined by nothing, a 3x3 conv (`refine.conv`) or an
    embedded-Gaussian non-local block (reduction 1, no 1/sqrt(C) scale,
    mmcv's `NonLocal2d` names `refine.{g,theta,phi,conv_out}.conv`), then
    scattered back (the inverse resizes) and added to each level. Its
    (HW x HW) attention is one `torch.matmul` a side, as the JAX einsum.
  * `NASFPN`: 1x1 `lateral_convs.i.conv` on the inputs `start_level` to
    `len(in_channels) - 1`, `extra_downsamples.i` (a 1x1 conv, then a 2x2
    stride-2 max pool) up to five levels, then `stack_times` stages of the
    nine merge cells (`fpn_stages.s.<cell>.out_conv.conv`). A merge cell
    resizes both inputs to its output's size (`resize_to`: nearest up, an
    integer-ratio max pool down), sums them, or for a 'gp' cell computes
    x2 + sigmoid(GAP(x2)) * x1, then ReLU and a 3x3 conv. The JAX neck
    reads only `len(in_channels)` inputs, and never the widths the list
    gives: lateral i reads input `start_level + i` and its width is taken
    as `in_channels[i]` (ROADMAP.md caveat 63: the config's list starts at
    C3, so P5 comes from a pool of P4).
  * `CARAFE` / `FPN_CARAFE`: mmcv's CARAFEPack names
    (`channel_compressor`, `content_encoder`); the encoder's s*s*k^2
    channels are pixel-shuffled in mmcv's (k^2, s, s) order, the JAX
    package's (s, s, k^2) order being carried by `state_dict_from_jax`;
    softmax over k^2, the k x k neighbourhood of each source pixel
    weighted per output pixel. Of `upsample_cfg` only `up_kernel`,
    `encoder_kernel` and `compressed_channels` are read, as in JAX
    (caveat 64: `up_group`, `encoder_dilation` are not).
  * `NASFCOS_FPN`: the JAX redesign of four concat-conv cells (a 1x1 conv
    over the concatenation, GN(32), ReLU; `cells.j.conv`, `cells.j.gn`)
    and stride-2 3x3 `extra_convs.k`.
  * `FPG`: `stack_times` columns; each cell sums an across conv + GN, a
    stride-2 conv + GN from the finer level and a conv + GN of the
    nearest-upsampled coarser level, then ReLU (`stages.s.l.across`,
    `.up`, `.down`, each `.conv` / `.gn`); the extra inputs come from a
    2x2 stride-2 max pool.
  * `RFP`: an inner `FPN` (`fpn.*`), then `rfp_steps - 1` refinement
    passes over its levels: ASPP (1x1, 3x3 at dilation 3 and 6, a
    global-pool 1x1 broadcast; ReLU over the concat: `rfp_aspp.s.l.i`), a
    3x3 refine (`rfp_refine.s.l`) and a zero-init sigmoid gate
    (`rfp_weight.s.l`): out * (1 - g) + relu(ref) * g, the even blend at
    init, not the plain FPN the JAX docstring names (caveat 62). The
    recursion never re-runs the backbone, as in JAX.

The GroupNorms normalise in float32 and return float32, as flax's without
a dtype; the convs compute in the config's compute `dtype`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import GroupNorm, lecun_normal_, make_conv
from ld_tpu_torch.utils.registry import NECKS

from .fpn import FPN, ConvModule, upsample_nearest_to


def max_pool_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """An integer-ratio max pool of NCHW `x` to (h, w)."""
    ih, iw = x.shape[-2:]
    if (ih, iw) == (h, w):
        return x
    k = (ih // h, iw // w)
    return F.max_pool2d(x, k, k)


def resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """mmcv BaseMergeCell._resize as the JAX `_resize_to`: nearest up,
    max pool down."""
    if x.shape[-2] < h:
        return upsample_nearest_to(x, h, w)
    return max_pool_to(x, h, w)


def _conv(cin, cout, k, stride=1, dilation=1, dtype=None) -> ConvModule:
    """A biased k x k conv under a ConvModule's `.conv`."""
    return ConvModule(make_conv(None, cin, cout, k, stride,
                                padding=dilation * (k // 2),
                                dilation=dilation, bias=True, dtype=dtype))


def _init_convs(module: nn.Module, generator: torch.Generator):
    """The JAX initializers: lecun-normal kernels, zero biases, GN 1 / 0;
    the RFP gates zero (`RFP.init_weights`)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GroupNorm):
            m.reset_parameters()


def _end_level(in_channels, end_level) -> int:
    return len(in_channels) if end_level in (-1, None) else end_level


class NonLocal2d(nn.Module):
    """mmcv's embedded-Gaussian `NonLocal2d` at reduction 1 without the
    1/sqrt(C) scale: x + conv_out(softmax(theta(x) phi(x)^T) g(x))."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        for name in ('g', 'theta', 'phi', 'conv_out'):
            setattr(self, name, _conv(channels, channels, 1, dtype=dtype))

    def forward(self, x):
        b, c, h, w = x.shape

        def rows(conv):
            return conv(x).reshape(b, c, h * w).transpose(1, 2)
        attn = torch.softmax(torch.matmul(
            rows(self.theta), rows(self.phi).transpose(1, 2)), dim=-1)
        y = torch.matmul(attn, rows(self.g))
        return x + self.conv_out(y.transpose(1, 2).reshape(b, c, h, w))


@NECKS.register_module()
class BFP(nn.Module):

    def __init__(self, in_channels: int = 256, num_levels: int = 5,
                 refine_level: int = 2, refine_type: str = None,
                 dtype=None):
        super().__init__()
        if refine_type not in (None, 'conv', 'non_local'):
            raise ValueError(f'BFP refine_type {refine_type!r}')
        self.in_channels = in_channels
        self.num_levels = num_levels
        self.refine_level = refine_level
        if refine_type == 'conv':
            self.refine = _conv(in_channels, in_channels, 3, dtype=dtype)
        elif refine_type == 'non_local':
            self.refine = NonLocal2d(in_channels, dtype)
        else:
            self.refine = None

    def init_weights(self, generator: torch.Generator):
        _init_convs(self, generator)

    def forward(self, inputs):
        if len(inputs) != self.num_levels:
            raise ValueError(f'{len(inputs)} inputs for {self.num_levels} '
                             'levels')
        gh, gw = inputs[self.refine_level].shape[-2:]
        feats = [F.adaptive_max_pool2d(x, (gh, gw)) if i < self.refine_level
                 else upsample_nearest_to(x, gh, gw)
                 for i, x in enumerate(inputs)]
        bsf = sum(feats) / len(feats)
        if self.refine is not None:
            bsf = self.refine(bsf)
        outs = []
        for i, x in enumerate(inputs):
            oh, ow = x.shape[-2:]
            res = upsample_nearest_to(bsf, oh, ow) if i < self.refine_level \
                else F.adaptive_max_pool2d(bsf, (oh, ow))
            outs.append(x + res)
        return tuple(outs)


class MergeCell(nn.Module):
    """mmcv BaseMergeCell as the JAX one: resize both inputs to `out_hw`,
    merge ('sum' or 'gp'), then ReLU and a 3x3 `out_conv` (no norm)."""

    def __init__(self, channels=256, mode='sum', with_out_conv=True,
                 dtype=None):
        super().__init__()
        self.mode = mode
        if with_out_conv:
            self.out_conv = _conv(channels, channels, 3, dtype=dtype)
        else:
            self.out_conv = None

    def forward(self, x1, x2, out_hw):
        h, w = out_hw
        x1, x2 = resize_to(x1, h, w), resize_to(x2, h, w)
        if self.mode == 'gp':
            x = x2 + torch.sigmoid(x2.mean(dim=(2, 3), keepdim=True)) * x1
        else:
            x = x1 + x2
        if self.out_conv is not None:
            x = self.out_conv(F.relu(x))
        return x


# (name, mode, with_out_conv) of a NAS-FPN stage, in order
NAS_CELLS = (('gp_64_4', 'gp', True), ('sum_44_4', 'sum', True),
             ('sum_43_3', 'sum', True), ('sum_34_4', 'sum', True),
             ('gp_43_5', 'gp', False), ('sum_55_5', 'sum', True),
             ('gp_54_7', 'gp', False), ('sum_77_7', 'sum', True),
             ('gp_75_6', 'gp', True))


@NECKS.register_module()
class NASFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 stack_times: int = 7, start_level: int = 0,
                 end_level: int = -1, norm_cfg: dict = None, dtype=None):
        super().__init__()
        if num_outs != 5:
            raise ValueError(f'NASFPN builds P3-P7: num_outs={num_outs}')
        # as the JAX neck, `norm_cfg` is not read: the cells' out convs
        # have no norm
        self.used = list(range(start_level,
                               _end_level(in_channels, end_level)))
        self.lateral_convs = nn.ModuleList(
            _conv(in_channels[i], out_channels, 1, dtype=dtype)
            for i in range(len(self.used)))
        self.extra_downsamples = nn.ModuleList(
            nn.Sequential(_conv(out_channels, out_channels, 1, dtype=dtype),
                          nn.MaxPool2d(2, 2))
            for _ in range(num_outs - len(self.used)))
        self.fpn_stages = nn.ModuleList(
            nn.ModuleDict({name: MergeCell(out_channels, mode, oc, dtype)
                           for name, mode, oc in NAS_CELLS})
            for _ in range(stack_times))

    def init_weights(self, generator: torch.Generator):
        _init_convs(self, generator)

    def forward(self, inputs):
        feats = [conv(inputs[i])
                 for conv, i in zip(self.lateral_convs, self.used)]
        for down in self.extra_downsamples:
            feats.append(down(feats[-1]))
        p3, p4, p5, p6, p7 = feats
        for stage in self.fpn_stages:
            def hw(p):
                return p.shape[-2:]
            p4_1 = stage['gp_64_4'](p6, p4, hw(p4))
            p4_2 = stage['sum_44_4'](p4_1, p4, hw(p4))
            p3 = stage['sum_43_3'](p4_2, p3, hw(p3))
            p4 = stage['sum_34_4'](p3, p4_2, hw(p4))
            p5_tmp = stage['gp_43_5'](p4, p3, hw(p5))
            p5 = stage['sum_55_5'](p5, p5_tmp, hw(p5))
            p7_tmp = stage['gp_54_7'](p5, p4_2, hw(p7))
            p7 = stage['sum_77_7'](p7, p7_tmp, hw(p7))
            p6 = stage['gp_75_6'](p7, p5, hw(p6))
        return p3, p4, p5, p6, p7


class CARAFE(nn.Module):
    """Content-aware reassembly upsampling by `scale` (mmcv CARAFEPack's
    names; port of `extra_necks.py:193-229`)."""

    def __init__(self, channels: int, scale: int = 2, up_kernel: int = 5,
                 encoder_kernel: int = 3, compressed_channels: int = 64,
                 dtype=None):
        super().__init__()
        self.scale = scale
        self.up_kernel = up_kernel
        self.channel_compressor = make_conv(
            None, channels, compressed_channels, 1, bias=True, dtype=dtype)
        self.content_encoder = make_conv(
            None, compressed_channels, scale * scale * up_kernel ** 2,
            encoder_kernel, bias=True, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        k, s = self.up_kernel, self.scale
        masks = self.content_encoder(self.channel_compressor(x))
        # (B, k2 s s, H, W) -> (B, k2, sH, sW), softmax over the k2 taps
        masks = torch.softmax(F.pixel_shuffle(masks, s), dim=1)
        # each source pixel's k x k neighbourhood (zero padded), tap-major
        views = F.unfold(x, k, padding=k // 2).reshape(b, c, k * k, h, w)
        masks = masks.reshape(b, k * k, h, s, w, s).to(views.dtype)
        out = torch.einsum('bkhiwj,bckhw->bchiwj', masks, views)
        return out.reshape(b, c, h * s, w * s)


@NECKS.register_module()
class FPN_CARAFE(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 upsample_cfg: dict = None, dtype=None):
        super().__init__()
        cfg = dict(upsample_cfg or {})
        self.num_outs = num_outs
        self.used = list(range(start_level,
                               _end_level(in_channels, end_level)))
        self.lateral_convs = nn.ModuleList(
            _conv(in_channels[i], out_channels, 1, dtype=dtype)
            for i in self.used)
        self.upsample_modules = nn.ModuleList(
            CARAFE(out_channels, up_kernel=cfg.get('up_kernel', 5),
                   encoder_kernel=cfg.get('encoder_kernel', 3),
                   compressed_channels=cfg.get('compressed_channels', 64),
                   dtype=dtype)
            for _ in self.used[1:])
        self.fpn_convs = nn.ModuleList(
            _conv(out_channels, out_channels, 3, dtype=dtype)
            for _ in self.used)

    def init_weights(self, generator: torch.Generator):
        _init_convs(self, generator)

    def forward(self, inputs):
        laterals = [conv(inputs[i])
                    for conv, i in zip(self.lateral_convs, self.used)]
        for i in range(len(laterals) - 1, 0, -1):
            up = self.upsample_modules[i - 1](laterals[i])
            h, w = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return tuple(outs)


class _ConvGN(nn.Module):
    """A biased conv, then GroupNorm(min(32, C)) in float32."""

    def __init__(self, cin, cout, k, stride=1, dtype=None):
        super().__init__()
        self.conv = make_conv(None, cin, cout, k, stride, bias=True,
                              dtype=dtype)
        self.gn = GroupNorm(min(32, cout), cout, eps=1e-5)

    def forward(self, x):
        return self.gn(self.conv(x).float())


@NECKS.register_module()
class NASFCOS_FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1, dtype=None):
        super().__init__()
        self.num_outs = num_outs
        self.used = list(range(start_level,
                               _end_level(in_channels, end_level)))
        self.lateral_convs = nn.ModuleList(
            _conv(in_channels[i], out_channels, 1, dtype=dtype)
            for i in self.used)
        self.cells = nn.ModuleList(
            _ConvGN(2 * out_channels, out_channels, 1, dtype=dtype)
            for _ in range(4))
        self.extra_convs = nn.ModuleList(
            _conv(out_channels, out_channels, 3, 2, dtype=dtype)
            for _ in range(num_outs - 3))

    def init_weights(self, generator: torch.Generator):
        _init_convs(self, generator)

    def _cell(self, j, a, b):
        a = resize_to(a, *b.shape[-2:])     # at the second operand's size
        return F.relu(self.cells[j](torch.cat([a, b.to(a.dtype)], dim=1)))

    def forward(self, inputs):
        lats = [conv(inputs[i])
                for conv, i in zip(self.lateral_convs, self.used)]
        p3, p4, p5 = lats[-3:]
        c4 = self._cell(0, p3, p4)
        c5 = self._cell(1, c4, p5)
        o4 = self._cell(2, p4, c4)
        o3 = self._cell(3, o4, p3)
        outs = [o3, o4, c5]
        for conv in self.extra_convs:
            outs.append(conv(outs[-1]))
        return tuple(outs)


class _FPGCell(nn.Module):
    """One FPG grid cell's convs: `across`, and where the level has them
    `up` (stride 2, from the finer level) and `down` (of the upsampled
    coarser level)."""

    def __init__(self, channels, finer, coarser, dtype=None):
        super().__init__()
        self.across = _ConvGN(channels, channels, 3, dtype=dtype)
        self.up = _ConvGN(channels, channels, 3, 2, dtype) if finer \
            else None
        self.down = _ConvGN(channels, channels, 3, dtype=dtype) if coarser \
            else None


@NECKS.register_module()
class FPG(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 stack_times: int = 3, start_level: int = 0,
                 end_level: int = -1, dtype=None):
        super().__init__()
        self.num_outs = num_outs
        self.used = list(range(start_level,
                               _end_level(in_channels, end_level)))
        self.lateral_convs = nn.ModuleList(
            _conv(in_channels[i], out_channels, 1, dtype=dtype)
            for i in self.used)
        n = max(num_outs, len(self.used))
        self.stages = nn.ModuleList(
            nn.ModuleList(_FPGCell(out_channels, lvl > 0, lvl < n - 1, dtype)
                          for lvl in range(n))
            for _ in range(stack_times))

    def init_weights(self, generator: torch.Generator):
        _init_convs(self, generator)

    def forward(self, inputs):
        feats = [conv(inputs[i])
                 for conv, i in zip(self.lateral_convs, self.used)]
        while len(feats) < self.num_outs:
            feats.append(F.max_pool2d(feats[-1], 2, 2))
        for stage in self.stages:
            new = []
            for lvl, cell in enumerate(stage):
                acc = cell.across(feats[lvl])
                if cell.up is not None:
                    acc = acc + cell.up(feats[lvl - 1])
                if cell.down is not None:
                    h, w = feats[lvl].shape[-2:]
                    acc = acc + cell.down(
                        upsample_nearest_to(feats[lvl + 1], h, w))
                new.append(F.relu(acc))
            feats = new
        return tuple(feats)


class _ASPP(nn.Module):
    """RFP's ASPP: 1x1, 3x3 at dilation 3, 3x3 at dilation 6 and a 1x1 on
    the global pool, each to C / 4, broadcast, concatenated, then ReLU."""

    def __init__(self, channels, dtype=None):
        super().__init__()
        c = channels // 4
        self.aspp = nn.ModuleList([
            make_conv(None, channels, c, 1, bias=True, dtype=dtype),
            make_conv(None, channels, c, 3, padding=3, dilation=3,
                      bias=True, dtype=dtype),
            make_conv(None, channels, c, 3, padding=6, dilation=6,
                      bias=True, dtype=dtype),
            make_conv(None, channels, c, 1, bias=True, dtype=dtype)])

    def forward(self, x):
        b1, b2, b3, b4 = self.aspp
        g = b4(x.mean(dim=(2, 3), keepdim=True)).expand(
            -1, -1, *x.shape[-2:])
        return F.relu(torch.cat([b1(x), b2(x), b3(x), g], dim=1))


@NECKS.register_module()
class RFP(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 rfp_steps: int = 2, dtype=None):
        super().__init__()
        self.fpn = FPN(in_channels, out_channels, num_outs, dtype=dtype)
        steps = range(rfp_steps - 1)
        self.rfp_aspp = nn.ModuleList(
            nn.ModuleList(_ASPP(out_channels, dtype) for _ in range(num_outs))
            for _ in steps)
        self.rfp_refine = nn.ModuleList(
            nn.ModuleList(make_conv(None, out_channels, out_channels, 3,
                                    bias=True, dtype=dtype)
                          for _ in range(num_outs))
            for _ in steps)
        self.rfp_weight = nn.ModuleList(
            nn.ModuleList(make_conv(None, out_channels, 1, 1, bias=True,
                                    dtype=dtype)
                          for _ in range(num_outs))
            for _ in steps)

    def init_weights(self, generator: torch.Generator):
        _init_convs(self, generator)
        for gates in self.rfp_weight:
            for m in gates:
                nn.init.zeros_(m.weight)

    def forward(self, inputs):
        outs = list(self.fpn(inputs))
        for asp, ref, gate in zip(self.rfp_aspp, self.rfp_refine,
                                  self.rfp_weight):
            for lvl, x in enumerate(outs):
                r = F.relu(ref[lvl](asp[lvl](x)))
                g = torch.sigmoid(gate[lvl](x))
                outs[lvl] = x * (1 - g) + r * g
        return tuple(outs)
