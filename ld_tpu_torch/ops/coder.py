"""Box coders (port of `ld_tpu/ops/coder.py`).

  * `DeltaXYWHBBoxCoder` (`:31`): Faster R-CNN's (dx, dy, dw, dh) of a gt
    box against a proposal, normalised by `target_means` / `target_stds`;
    the decode clamps dw, dh to |log(wh_ratio_clip)| and clips to the
    image. Encode floors both boxes' sides at 1e-6, the decode does not.
  * `LegacyDeltaXYWHBBoxCoder` (`:84`): mmdet v1's `+ 1` pixel widths, the
    decode clipped to `max_shape - 1` and without the -0.5 corner shift.
  * `PseudoBBoxCoder` (`:129`): the identity.
  * `TBLRBBoxCoder` (`:137-176`, FSAF): the (top, bottom, left, right)
    distances of the gt's sides from the anchor's centre over `normalizer`
    times its h / w (floored at 1e-6 in the encode); the decode clips to
    [0, w] / [0, h].
  * `BucketingBBoxCoder` (`:187-284`, SABL): each side of a proposal
    rescaled by `scale_factor` is cut into `ceil(num_buckets / 2)` buckets
    (widths floored at 1e-6, so that a padded zero-size roi stays finite);
    the encode gives each side's offsets from every bucket in bucket
    widths, the regression weights of the `offset_topk` nearest (the k >= 1
    ones only under `offset_upperbound`), the nearest bucket one-hot and
    the classification weights (near-miss neighbours 0 under
    `cls_ignore_neighbor`). The nearest are ranked by a stable sort, so
    that equal distances go to the lower bucket, as `jnp.argsort`; the
    decode takes each side's top-2 softmax buckets by a stable descending
    sort (ties to the lower index, as `lax.top_k`), moves the best bucket
    by its offset, clips to [0, w - 1] / [0, h - 1], and scores the box by
    top1 + top2 where the two buckets are adjacent, meaned over the sides.

`max_shape` is one image's (h, w), or (B, 2) for boxes of a batch (the JAX
package `vmap`s over images).
"""
from __future__ import annotations

import math

import torch

CODERS = {}
def register_coder(cls):
    CODERS[cls.__name__] = cls
    return cls


def build_coder(cfg):
    cfg = dict(cfg)
    name = cfg.pop('type')
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


@register_coder
class TBLRBBoxCoder:

    def __init__(self, normalizer=4.0, clip_border=True):
        self.normalizer = normalizer
        self.clip_border = clip_border

    def encode(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor
               ) -> torch.Tensor:
        """(t, b, l, r) of `gt_bboxes` against `bboxes` (..., 4)."""
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = (bboxes[..., 2] - bboxes[..., 0]).clamp(min=1e-6)
        h = (bboxes[..., 3] - bboxes[..., 1]).clamp(min=1e-6)
        n = self.normalizer
        return torch.stack([(py - gt_bboxes[..., 1]) / (h * n),
                            (gt_bboxes[..., 3] - py) / (h * n),
                            (px - gt_bboxes[..., 0]) / (w * n),
                            (gt_bboxes[..., 2] - px) / (w * n)], -1)

    def decode(self, bboxes: torch.Tensor, deltas: torch.Tensor,
               max_shape=None) -> torch.Tensor:
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = bboxes[..., 2] - bboxes[..., 0]
        h = bboxes[..., 3] - bboxes[..., 1]
        t, b, l, r = deltas.unbind(-1)
        n = self.normalizer
        x1, x2 = px - l * w * n, px + r * w * n
        y1, y2 = py - t * h * n, py + b * h * n
        if max_shape is not None and self.clip_border:
            hh, ww = _clip_bounds(max_shape, x1)
            zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
            x1, x2 = (torch.minimum(torch.maximum(v, zero), ww)
                      for v in (x1, x2))
            y1, y2 = (torch.minimum(torch.maximum(v, zero), hh)
                      for v in (y1, y2))
        return torch.stack([x1, y1, x2, y2], -1)


def bbox_rescale(bboxes: torch.Tensor, scale_factor=1.0) -> torch.Tensor:
    """Boxes (..., 4) scaled about their centres."""
    cx = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
    cy = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
    w = (bboxes[..., 2] - bboxes[..., 0]) * scale_factor
    h = (bboxes[..., 3] - bboxes[..., 1]) * scale_factor
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


@register_coder
class BucketingBBoxCoder:

    def __init__(self, num_buckets=14, scale_factor=1.7, offset_topk=2,
                 offset_upperbound=1.0, cls_ignore_neighbor=True,
                 clip_border=True):
        self.num_buckets = num_buckets
        self.side_num = int(math.ceil(num_buckets / 2.0))
        self.scale_factor = scale_factor
        self.offset_topk = offset_topk
        self.offset_upperbound = offset_upperbound
        self.cls_ignore_neighbor = cls_ignore_neighbor
        self.clip_border = clip_border

    def _buckets(self, proposals):
        """Bucket widths (...,) and each side's bucket centres (...,
        side_num): left, right, top, down, inside-out."""
        p = bbox_rescale(proposals, self.scale_factor)
        bw = ((p[..., 2] - p[..., 0]) / self.num_buckets).clamp(min=1e-6)
        bh = ((p[..., 3] - p[..., 1]) / self.num_buckets).clamp(min=1e-6)
        steps = 0.5 + torch.arange(self.side_num, dtype=torch.float32,
                                   device=proposals.device)
        return (bw, bh, p[..., 0:1] + steps * bw[..., None],
                p[..., 2:3] - steps * bw[..., None],
                p[..., 1:2] + steps * bh[..., None],
                p[..., 3:4] - steps * bh[..., None])

    def encode(self, proposals: torch.Tensor, gt: torch.Tensor):
        """(offsets, offset weights, bucket one-hot labels, bucket cls
        weights) of `gt` against `proposals` (..., 4), each (...,
        4 * side_num) in the side order l, r, t, d."""
        bw, bh, l, r, t, d = self._buckets(proposals)
        offs = [(l - gt[..., 0:1]) / bw[..., None],
                (r - gt[..., 2:3]) / bw[..., None],
                (t - gt[..., 1:2]) / bh[..., None],
                (d - gt[..., 3:4]) / bh[..., None]]
        off_ws, labels, cls_ws = [], [], []
        for o in offs:
            a = o.abs()
            order = torch.argsort(a, dim=-1, stable=True)
            w = torch.zeros_like(o)
            for k in range(self.offset_topk):
                idx = order[..., k:k + 1]
                ok = torch.ones_like(a[..., :1]) if k == 0 else \
                    (a.gather(-1, idx) < self.offset_upperbound).to(o.dtype)
                w = w + torch.zeros_like(o).scatter(-1, idx, ok)
            off_ws.append(w.clamp(max=1.0))
            lab = torch.zeros_like(o).scatter(-1, order[..., :1], 1.0)
            labels.append(lab)
            if self.cls_ignore_neighbor:
                cls_ws.append(torch.where((a < 1.0) & (lab == 0.0),
                                          torch.zeros_like(a),
                                          torch.ones_like(a)))
            else:
                cls_ws.append(torch.ones_like(a))
        return (torch.cat(offs, -1), torch.cat(off_ws, -1),
                torch.cat(labels, -1), torch.cat(cls_ws, -1))

    def decode(self, proposals: torch.Tensor, pred, max_shape=None):
        """(boxes (..., 4), confidence (...,)) of the (bucket logits,
        offsets) pair `pred`, each (..., 4 * side_num)."""
        cls_preds, offset_preds = pred
        shp = proposals.shape[:-1]
        bw, bh, l, r, t, d = self._buckets(proposals)
        scores = torch.softmax(cls_preds.reshape(*shp, 4, self.side_num), -1)
        # the top 2 with ties to the lower index, as lax.top_k
        top, lab = torch.sort(scores, dim=-1, descending=True, stable=True)
        top2, lab2 = top[..., :2], lab[..., :2]
        best = lab2[..., 0]                                    # (..., 4)
        buckets = torch.stack([
            side.gather(-1, best[..., i:i + 1])[..., 0]
            for i, side in enumerate((l, r, t, d))], -1)
        best_off = offset_preds.reshape(*shp, 4, self.side_num).gather(
            -1, best[..., None])[..., 0]
        x1 = buckets[..., 0] - best_off[..., 0] * bw
        x2 = buckets[..., 1] - best_off[..., 1] * bw
        y1 = buckets[..., 2] - best_off[..., 2] * bh
        y2 = buckets[..., 3] - best_off[..., 3] * bh
        if self.clip_border and max_shape is not None:
            hh, ww = _clip_bounds(max_shape, x1)
            zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
            x1, x2 = (torch.minimum(torch.maximum(v, zero), ww - 1)
                      for v in (x1, x2))
            y1, y2 = (torch.minimum(torch.maximum(v, zero), hh - 1)
                      for v in (y1, y2))
        adjacent = ((lab2[..., 0] - lab2[..., 1]).abs() == 1).to(top2.dtype)
        conf = top2[..., 0] + top2[..., 1] * adjacent
        return torch.stack([x1, y1, x2, y2], -1), conf.mean(dim=-1)
