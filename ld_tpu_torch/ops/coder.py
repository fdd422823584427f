"""Box coders (port of `ld_tpu/ops/coder.py`).

  * `DeltaXYWHBBoxCoder` (`:31`): Faster R-CNN's (dx, dy, dw, dh) of a gt
    box against a proposal, normalised by `target_means` / `target_stds`;
    the decode clamps dw, dh to |log(wh_ratio_clip)| and clips to the
    image. Encode floors both boxes' sides at 1e-6, the decode does not.
  * `LegacyDeltaXYWHBBoxCoder` (`:84`): mmdet v1's `+ 1` pixel widths, the
    decode clipped to `max_shape - 1` and without the -0.5 corner shift.
  * `PseudoBBoxCoder` (`:129`): the identity.

`max_shape` is one image's (h, w), or (B, 2) for boxes of a batch (the JAX
package `vmap`s over images). The TBLR (FSAF) and bucketing (SABL) coders
raise NotImplementedError (ROADMAP.md A7).
"""
from __future__ import annotations

import math

import torch

CODERS = {}
NOT_PORTED = ('TBLRBBoxCoder', 'BucketingBBoxCoder')


def register_coder(cls):
    CODERS[cls.__name__] = cls
    return cls


def build_coder(cfg):
    cfg = dict(cfg)
    name = cfg.pop('type')
    if name in NOT_PORTED:
        raise NotImplementedError(f'{name} is not ported to ld_tpu_torch yet '
                                  '(see ROADMAP.md A7)')
    return CODERS[name](**cfg)


def _clip_bounds(max_shape, like: torch.Tensor):
    """(h, w) of `max_shape` broadcastable against `like` (..., ): one image's
    pair, or a (B, 2) batch against (B, ...) boxes."""
    hw = torch.as_tensor(max_shape, dtype=like.dtype, device=like.device)
    h, w = hw[..., 0], hw[..., 1]
    while h.dim() and h.dim() < like.dim():
        h, w = h[..., None], w[..., None]
    return h, w


@register_coder
class DeltaXYWHBBoxCoder:

    def __init__(self, target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.), clip_border=True):
        self.means = tuple(float(m) for m in target_means)
        self.stds = tuple(float(s) for s in target_stds)
        self.clip_border = clip_border

    def _stats(self, like):
        return (torch.tensor(self.means, dtype=like.dtype, device=like.device),
                torch.tensor(self.stds, dtype=like.dtype, device=like.device))

    def encode(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor
               ) -> torch.Tensor:
        """(dx, dy, dw, dh) of `gt_bboxes` relative to `bboxes` (..., 4)."""
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = (bboxes[..., 2] - bboxes[..., 0]).clamp(min=1e-6)
        ph = (bboxes[..., 3] - bboxes[..., 1]).clamp(min=1e-6)
        gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        gw = (gt_bboxes[..., 2] - gt_bboxes[..., 0]).clamp(min=1e-6)
        gh = (gt_bboxes[..., 3] - gt_bboxes[..., 1]).clamp(min=1e-6)
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph)], -1)
        means, stds = self._stats(deltas)
        return (deltas - means) / stds

    def _sides(self, bboxes):
        return (bboxes[..., 2] - bboxes[..., 0],
                bboxes[..., 3] - bboxes[..., 1])

    def decode(self, bboxes: torch.Tensor, deltas: torch.Tensor,
               max_shape=None, wh_ratio_clip=16 / 1000) -> torch.Tensor:
        means, stds = self._stats(deltas)
        deltas = deltas * stds + means
        max_ratio = abs(math.log(wh_ratio_clip))
        dx, dy = deltas[..., 0], deltas[..., 1]
        dw = deltas[..., 2].clamp(-max_ratio, max_ratio)
        dh = deltas[..., 3].clamp(-max_ratio, max_ratio)
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw, ph = self._sides(bboxes)
        gx = px + pw * dx
        gy = py + ph * dy
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        x1, y1 = gx - gw * 0.5, gy - gh * 0.5
        x2, y2 = gx + gw * 0.5, gy + gh * 0.5
        if max_shape is not None and self.clip_border:
            x1, y1, x2, y2 = self._clip(x1, y1, x2, y2, max_shape)
        return torch.stack([x1, y1, x2, y2], -1)

    def _clip(self, x1, y1, x2, y2, max_shape):
        h, w = _clip_bounds(max_shape, x1)
        zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
        return (torch.minimum(torch.maximum(x1, zero), w),
                torch.minimum(torch.maximum(y1, zero), h),
                torch.minimum(torch.maximum(x2, zero), w),
                torch.minimum(torch.maximum(y2, zero), h))


@register_coder
class LegacyDeltaXYWHBBoxCoder(DeltaXYWHBBoxCoder):
    """mmdet v1's delta coder: `+ 1` pixel widths in both directions, the
    decode without the matching -0.5 corner shift and clipped to
    `max_shape - 1`."""

    def encode(self, bboxes, gt_bboxes):
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = bboxes[..., 2] - bboxes[..., 0] + 1.0
        ph = bboxes[..., 3] - bboxes[..., 1] + 1.0
        gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        gw = gt_bboxes[..., 2] - gt_bboxes[..., 0] + 1.0
        gh = gt_bboxes[..., 3] - gt_bboxes[..., 1] + 1.0
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph)], -1)
        means, stds = self._stats(deltas)
        return (deltas - means) / stds

    def _sides(self, bboxes):
        return (bboxes[..., 2] - bboxes[..., 0] + 1.0,
                bboxes[..., 3] - bboxes[..., 1] + 1.0)

    def _clip(self, x1, y1, x2, y2, max_shape):
        h, w = _clip_bounds(max_shape, x1)
        zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
        return (torch.minimum(torch.maximum(x1, zero), w - 1),
                torch.minimum(torch.maximum(y1, zero), h - 1),
                torch.minimum(torch.maximum(x2, zero), w - 1),
                torch.minimum(torch.maximum(y2, zero), h - 1))


@register_coder
class PseudoBBoxCoder:

    def __init__(self, **kwargs):
        pass

    def encode(self, bboxes, gt_bboxes):
        return gt_bboxes

    def decode(self, bboxes, pred, max_shape=None):
        return pred
