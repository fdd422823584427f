"""RoIAlign in plain PyTorch (port of `ld_tpu/ops/roi_align.py:20-144`), NCHW.

The JAX op's sampling, kept exactly (ROADMAP.md caveat 18): the roi, scaled
to the map and shifted by half a pixel, is divided into out x out bins with
2 x 2 samples a bin (`sampling_ratio` of a config is not read), its sides
floored at 1e-3; each sample is bilinear with its corners clamped to the
map's edge (not zeroed outside it); a bin is the mean of its samples.

`multi_level_roi_align` routes each roi to the FPN level
floor(log2(sqrt(area) / finest_scale + 1e-6)), clipped to the levels, and
pools it at that level only: the JAX op pools every roi at every level and
masks the others away, with the same numbers. Invalid rois give zeros.

Deformable RoI pooling (the dpool / mdpool configs; port of
`roi_align_offsets`, `ld_tpu/ops/roi_align.py:75-167`): `roi_align` with
`offsets` (R, 2, out, out), a (dx, dy) a bin in units of the roi's size
(mmcv's channel order, x first): every sample of bin (i, j) moves by
gamma x (dx x roi_w, dy x roi_h), roi_w and roi_h on the map (after the
scale, floored at 1e-3); the samples then read the map as above, corners
clamped to its edge. `multi_level_roi_align_offsets` is its level-routed
form.
"""
from __future__ import annotations

from typing import Sequence

import torch


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              batch_idx: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = True, offsets: torch.Tensor = None,
              gamma: float = 0.1) -> torch.Tensor:
    """Args:
        features: (B, C, H, W).
        rois: (R, 4) xyxy in image coordinates; batch_idx: (R,) the image
            of each roi.
        offsets: optional (R, 2, out_size, out_size) (dx, dy) a bin, in
            units of gamma x the roi's size (deformable RoI pooling; the
            half-pixel shift is then always taken, as in JAX).
    Returns:
        (R, C, out_size, out_size)
    """
    b, c, h, w = features.shape
    r = rois.shape[0]
    s = sampling_ratio
    boxes = rois * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1 = boxes[:, 0], boxes[:, 1]
    roi_w = (boxes[:, 2] - x1).clamp(min=1e-3)
    roi_h = (boxes[:, 3] - y1).clamp(min=1e-3)
    grid = (torch.arange(out_size * s, device=rois.device,
                         dtype=rois.dtype) + 0.5) / s
    # the sample coordinates, (R, S, 1) rows and (R, 1, S) columns; with
    # offsets each of the (R, S, S) samples has its own
    ys = (y1[:, None] + grid * (roi_h / out_size)[:, None])[:, :, None]
    xs = (x1[:, None] + grid * (roi_w / out_size)[:, None])[:, None, :]
    if offsets is not None:
        # each bin's offset over its s x s samples
        off = offsets.float().repeat_interleave(s, dim=2) \
            .repeat_interleave(s, dim=3)                     # (R, 2, S, S)
        xs = xs + off[:, 0] * (gamma * roi_w)[:, None, None]
        ys = ys + off[:, 1] * (gamma * roi_h)[:, None, None]

    def corners(v, size):
        v0 = torch.floor(v).clamp(0, size - 1)
        hi = (v - v0).clamp(0.0, 1.0)
        return v0.long(), (v0 + 1).clamp(max=size - 1).long(), 1.0 - hi, hi

    y0, y1i, wy0, wy1 = corners(ys, h)
    x0, x1i, wx0, wx1 = corners(xs, w)
    flat = features.permute(0, 2, 3, 1).reshape(b * h * w, c)
    base = (batch_idx * h)[:, None, None]                      # (R, 1, 1)
    out = None
    for yi, wy in ((y0, wy0), (y1i, wy1)):
        for xi, wx in ((x0, wx0), (x1i, wx1)):
            rows = ((base + yi) * w + xi).reshape(-1)
            wgt = (wy * wx).reshape(-1, 1)
            vals = flat.index_select(0, rows).float()          # (R*S*S, C)
            out = vals * wgt if out is None else \
                torch.addcmul(out, vals, wgt)
    out = out.view(r, out_size, s, out_size, s, c).mean(dim=(2, 4))
    return out.permute(0, 3, 1, 2).contiguous()


def roi_levels(rois: torch.Tensor, num_levels: int,
               finest_scale: int = 56) -> torch.Tensor:
    """The FPN level of each roi (SingleRoIExtractor's mapping)."""
    areas = ((rois[..., 2] - rois[..., 0]) *
             (rois[..., 3] - rois[..., 1])).clamp(min=1e-6)
    target = torch.floor(torch.log2(torch.sqrt(areas) / finest_scale + 1e-6))
    return target.clamp(0, num_levels - 1).long()


def multi_level_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                          roi_valid: torch.Tensor, out_size: int = 7,
                          featmap_strides=(4, 8, 16, 32),
                          finest_scale: int = 56,
                          sampling_ratio: int = 2,
                          offsets: torch.Tensor = None,
                          gamma: float = 0.1) -> torch.Tensor:
    """Level-routed RoIAlign of a batch.

    Args:
        feats: (B, C, H_l, W_l) maps, one a level.
        rois: (B, R, 4); roi_valid: (B, R) bool.
        offsets: optional (B*R, 2, out_size, out_size), as `roi_align`'s.
    Returns:
        (B*R, C, out_size, out_size), zeros for invalid rois.
    """
    b, r = rois.shape[:2]
    flat = rois.reshape(-1, 4)
    target = roi_levels(flat, len(featmap_strides), finest_scale)
    valid = roi_valid.reshape(-1)
    batch_idx = torch.arange(b, device=rois.device).repeat_interleave(r)
    # float32, as the JAX op's bilinear weights promote a lowered map
    out = feats[0].new_zeros(b * r, feats[0].shape[1], out_size, out_size,
                             dtype=torch.float32)
    for lvl, stride in enumerate(featmap_strides):
        idx = torch.nonzero(valid & (target == lvl)).squeeze(1)
        if idx.numel():
            out[idx] = roi_align(
                feats[lvl], flat[idx], batch_idx[idx], out_size, 1.0 / stride,
                sampling_ratio, offsets=None if offsets is None
                else offsets[idx], gamma=gamma)
    return out


def multi_level_roi_align_offsets(feats: Sequence[torch.Tensor],
                                  rois: torch.Tensor, roi_valid: torch.Tensor,
                                  offsets: torch.Tensor, out_size: int = 7,
                                  featmap_strides=(4, 8, 16, 32),
                                  finest_scale: int = 56,
                                  sampling_ratio: int = 2,
                                  gamma: float = 0.1) -> torch.Tensor:
    """The deformable second pass (`ld_tpu/ops/roi_align.py:152-167`):
    `multi_level_roi_align` with each roi's (2, out, out) offsets."""
    return multi_level_roi_align(feats, rois, roi_valid, out_size,
                                 featmap_strides, finest_scale,
                                 sampling_ratio, offsets, gamma)
