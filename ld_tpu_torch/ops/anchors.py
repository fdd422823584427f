"""Anchor generation for multi-level dense heads (port of
`ld_tpu/ops/anchors.py:20-132, 151-172`).

Base anchors from octave scales x ratios centred at `center_offset * stride`,
shifted over the feature grid row-major (anchor i*W+j sits at pixel
(j*stride, i*stride)). The anchors are computed in numpy float32 exactly as
the JAX generator computes them, then handed to the caller's device.

`LegacyAnchorGenerator` is mmdet v1's layout (the `legacy_1.x` configs'
GFL-lineage heads, e.g. RetinaNet v1): a base anchor's centre at
0.5 x (size - 1), its corners centre -+ 0.5 x (w - 1), rounded to
integers (`center_offset` is taken and not read). An RPN takes the key and
builds the plain generator, as the JAX RPN does (ROADMAP.md caveat 71).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class AnchorGenerator:
    """Multi-level grid anchors in xyxy.

    Args:
        strides: per-level stride (int or (sx, sy)).
        ratios: h/w aspect ratios.
        scales: explicit scales, or use octave_base_scale/scales_per_octave.
        octave_base_scale, scales_per_octave: scales = base * 2**(i/n).
        center_offset: anchor centre relative to the cell origin, in strides.
    """

    def __init__(self,
                 strides: Sequence,
                 ratios: Sequence[float] = (1.0, ),
                 scales: Sequence[float] = None,
                 base_sizes: Sequence[int] = None,
                 octave_base_scale: int = None,
                 scales_per_octave: int = None,
                 centers=None,
                 center_offset: float = 0.0):
        self.strides = [s if isinstance(s, (tuple, list)) else (s, s)
                        for s in strides]
        self.base_sizes = ([min(s) for s in self.strides]
                           if base_sizes is None else list(base_sizes))
        if scales is not None:
            self.scales = np.array(scales, dtype=np.float32)
        elif octave_base_scale is not None and scales_per_octave is not None:
            octave_scales = np.array(
                [2**(i / scales_per_octave) for i in range(scales_per_octave)],
                dtype=np.float32)
            self.scales = octave_scales * octave_base_scale
        else:
            raise ValueError('either scales or octave_base_scale with '
                             'scales_per_octave must be set')
        self.ratios = np.array(ratios, dtype=np.float32)
        self.centers = centers
        self.center_offset = center_offset
        self.base_anchors = [
            self._single_level_base_anchors(bs, i)
            for i, bs in enumerate(self.base_sizes)
        ]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def _single_level_base_anchors(self, base_size: float,
                                   level: int) -> np.ndarray:
        w = h = float(base_size)
        if self.centers is not None:
            x_c, y_c = self.centers[level]
        else:
            x_c = self.center_offset * w
            y_c = self.center_offset * h
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        # scale-major ordering: ratio-blocks of consecutive scales
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.stack([x_c - 0.5 * ws, y_c - 0.5 * hs,
                         x_c + 0.5 * ws, y_c + 0.5 * hs], axis=-1)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                     device='cpu') -> List[torch.Tensor]:
        """All anchors per level, each (H*W*A, 4), row-major grid order."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f'{len(featmap_sizes)} feature maps for '
                             f'{self.num_levels} anchor levels')
        out = []
        for lvl, (feat_h, feat_w) in enumerate(featmap_sizes):
            sx, sy = self.strides[lvl]
            shift_x = np.arange(feat_w, dtype=np.float32) * sx
            shift_y = np.arange(feat_h, dtype=np.float32) * sy
            xx = np.tile(shift_x, feat_h)
            yy = np.repeat(shift_y, feat_w)
            shifts = np.stack([xx, yy, xx, yy], axis=-1)  # (H*W, 4)
            anchors = (self.base_anchors[lvl][None, :, :] +
                       shifts[:, None, :]).reshape(-1, 4)
            out.append(torch.from_numpy(
                np.ascontiguousarray(anchors, np.float32)).to(device))
        return out

    def valid_flags(self, featmap_sizes, img_hw,
                    device='cpu') -> List[torch.Tensor]:
        """Per-level (H*W*A,) bool flags: anchor cell inside the *image*
        region of a padded batch tensor of one image of size `img_hw`."""
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        h, w = img_hw[0], img_hw[1]
        flags = []
        for lvl, (feat_h, feat_w) in enumerate(featmap_sizes):
            sx, sy = self.strides[lvl]
            valid_w = torch.clamp(torch.ceil(w / sx), max=feat_w)
            valid_h = torch.clamp(torch.ceil(h / sy), max=feat_h)
            vx = torch.arange(feat_w, dtype=torch.float32,
                              device=device) < valid_w
            vy = torch.arange(feat_h, dtype=torch.float32,
                              device=device) < valid_h
            grid = (vy[:, None] & vx[None, :]).reshape(-1)
            a = self.num_base_anchors[lvl]
            flags.append(grid.repeat_interleave(a) if a > 1 else grid)
        return flags


class LegacyAnchorGenerator(AnchorGenerator):
    """mmdet v1.x's base anchors (`ld_tpu/ops/anchors.py:151-172`)."""

    def _single_level_base_anchors(self, base_size: float,
                                   level: int) -> np.ndarray:
        w = h = float(base_size)
        x_center, y_center = 0.5 * (w - 1), 0.5 * (h - 1)
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.round(np.stack([
            x_center - 0.5 * (ws - 1), y_center - 0.5 * (hs - 1),
            x_center + 0.5 * (ws - 1), y_center + 0.5 * (hs - 1)], axis=-1))
