"""The assigners of Guided Anchoring, RepPoints and FSAF; port of
`ld_tpu/ops/extra_assigners.py`, with the images of a batch on a leading
dimension where the JAX package `vmap`s.

  * `PointAssigner` (`:73-117`, RepPoints' init stage): each gt maps to the
    level int(log2(sqrt(w*h) / scale) + 0.5), clipped to the points'
    levels (the cast truncates toward zero, as int32 does), and claims its
    `pos_num` nearest points of that level by stride-normalised distance,
    taken by iterated argmin (`_small_topk_min`), so that of equal
    distances the lowest index goes first; a point two gts claim goes to
    the nearer one, of equal distances to the lower gt index.
  * `ApproxMaxIoUAssigner` (`:176-205`, GA's shape targets): a square's
    overlap with a gt is the largest IoU among its approx anchors; then
    `MaxIoUAssigner`'s thresholds, on that overlap matrix.

  * `CenterRegionAssigner` (`:120-174`, FSAF): an anchor is positive for
    the gts whose box shrunk about its centre by `pos_scale` holds the
    anchor's centre (inclusive bounds), the smallest such gt winning (of
    equal areas the lowest gt index); an anchor inside a gt shrunk by
    `neg_scale` that is not positive is ignored, marked by `max_overlaps`
    -1. `min_pos_iof` is accepted and not read, as in the JAX assigner
    (ROADMAP.md caveat 59).

The file's other JAX assigners (Hungarian, TaskAligned, Grid, Region) are
not ported yet: building one raises, naming its ROADMAP.md Queue A item.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ld_tpu_torch.utils.registry import ASSIGNERS
from .atss_assigner import INF, AssignResult
from .boxes import bbox_overlaps
from .max_iou_assigner import MaxIoUAssigner

ASSIGNERS.not_ported.update({
    'RegionAssigner': 'ROADMAP.md Queue A item 6',
    'TaskAlignedAssigner': 'ROADMAP.md Queue A item 6',
    'GridAssigner': 'ROADMAP.md Queue A item 7',
    'HungarianAssigner': 'ROADMAP.md Queue A item 10'})


def _small_topk_min(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (..., k) of the k smallest entries along the last axis,
    ascending: k passes of argmin (the first minimum) and masking, as the
    JAX helper of `ld_tpu/ops/atss_assigner.py:54-68`, so that ties go to
    the lowest index."""
    vals = values.clone()
    idxs = []
    for _ in range(k):
        i = vals.argmin(dim=-1, keepdim=True)
        idxs.append(i)
        vals.scatter_(-1, i, float('inf'))
    return torch.cat(idxs, dim=-1)


@ASSIGNERS.register_module()
class PointAssigner:
    """Each gt claims the `pos_num` nearest points of its scale's level."""

    def __init__(self, scale=4, pos_num=3, **kwargs):
        self.scale = scale
        self.pos_num = pos_num

    def assign(self, points: torch.Tensor, num_level_points: Sequence[int],
               gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor, valid_mask: torch.Tensor = None,
               num_classes: int = 80) -> AssignResult:
        """points: (N, 3) = (x, y, stride); gt_bboxes (B, G, 4), gt_labels
        and gt_valid (B, G). `num_level_points` and `valid_mask` are not
        used, as in the JAX assigner."""
        n = points.shape[0]
        xy, stride = points[:, :2], points[:, 2]
        lvl = torch.log2(stride).to(torch.int32)
        gw = (gt_bboxes[..., 2] - gt_bboxes[..., 0]).clamp(min=1e-6)
        gh = (gt_bboxes[..., 3] - gt_bboxes[..., 1]).clamp(min=1e-6)
        gt_lvl = (torch.log2(torch.sqrt(gw * gh) / self.scale) + 0.5).to(
            torch.int32).clamp(int(lvl.min()), int(lvl.max()))    # (B, G)
        gc = torch.stack([(gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2,
                          (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2], -1)
        d = (xy[None, :, None, :] - gc[:, None, :, :]) / \
            stride[None, :, None, None]                        # (B, N, G, 2)
        dist = torch.sqrt((d * d).sum(-1))
        same_lvl = lvl[None, :, None] == gt_lvl[:, None, :]
        inf = torch.full((), INF, device=dist.device)
        dist = torch.where(same_lvl & gt_valid[:, None, :], dist, inf)
        idx = _small_topk_min(dist.transpose(1, 2), min(self.pos_num, n))
        claimed = torch.zeros(dist.transpose(1, 2).shape, dtype=torch.bool,
                              device=dist.device)
        claimed.scatter_(-1, idx, True)                      # (B, G, N)
        claimed = claimed.transpose(1, 2) & (dist < INF / 2)
        d_masked = torch.where(claimed, dist, inf)
        best = d_masked.argmin(dim=-1)            # the first gt on a tie
        pos = d_masked.amin(dim=-1) < INF / 2
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best),
                             torch.full_like(best, num_classes))
        return AssignResult(
            assigned_gt_inds=torch.where(pos, best, torch.full_like(best, -1)),
            max_overlaps=pos.to(torch.float32), labels=labels, pos_mask=pos)


@ASSIGNERS.register_module()
class CenterRegionAssigner:
    """Positives in the gts' centre regions, an ignore band around them."""

    def __init__(self, pos_scale=0.2, neg_scale=0.5, min_pos_iof=1e-2,
                 **kwargs):
        self.pos_scale = pos_scale
        self.neg_scale = neg_scale

    @staticmethod
    def _in_scaled(points: torch.Tensor, gtb: torch.Tensor, scale: float):
        """points (N, 2), gtb (B, G, 4) -> (B, N, G): the point lies in the
        gt shrunk by `scale` about its centre, bounds included."""
        cx = (gtb[..., 0] + gtb[..., 2]) / 2
        cy = (gtb[..., 1] + gtb[..., 3]) / 2
        w = (gtb[..., 2] - gtb[..., 0]) * scale
        h = (gtb[..., 3] - gtb[..., 1]) * scale
        px, py = points[None, :, 0:1], points[None, :, 1:2]
        return ((px >= (cx - w / 2)[:, None]) & (px <= (cx + w / 2)[:, None])
                & (py >= (cy - h / 2)[:, None]) &
                (py <= (cy + h / 2)[:, None]))

    def assign(self, bboxes: torch.Tensor, num_level_bboxes: Sequence[int],
               gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor, valid_mask: torch.Tensor = None,
               num_classes: int = 80) -> AssignResult:
        """bboxes (N, 4); the gts (B, G, ...); valid_mask (B, N). The
        ignored anchors carry `max_overlaps` -1."""
        n = bboxes.shape[0]
        if valid_mask is None:
            valid_mask = torch.ones((gt_bboxes.shape[0], n), dtype=torch.bool,
                                    device=bboxes.device)
        centers = torch.stack([(bboxes[:, 0] + bboxes[:, 2]) / 2,
                               (bboxes[:, 1] + bboxes[:, 3]) / 2], -1)
        pos_in = self._in_scaled(centers, gt_bboxes, self.pos_scale) & \
            gt_valid[:, None, :] & valid_mask[..., None]
        ign_in = self._in_scaled(centers, gt_bboxes, self.neg_scale) & \
            gt_valid[:, None, :]
        areas = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) * \
            (gt_bboxes[..., 3] - gt_bboxes[..., 1])
        inf = torch.full((), INF, device=areas.device)
        masked = torch.where(pos_in, areas[:, None, :], inf)
        best = masked.argmin(dim=-1)           # the first gt on a tie
        pos = masked.amin(dim=-1) < INF / 2
        ignore = ign_in.any(dim=-1) & ~pos
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best),
                             torch.full_like(best, num_classes))
        one = torch.ones((), device=areas.device)
        overlaps = torch.where(pos, one, torch.where(ignore, -one, 0 * one))
        return AssignResult(
            assigned_gt_inds=torch.where(pos, best, torch.full_like(best, -1)),
            max_overlaps=overlaps, labels=labels, pos_mask=pos)


@ASSIGNERS.register_module()
class ApproxMaxIoUAssigner:
    """MaxIoU assignment of squares, each represented by the best IoU among
    its approx anchors."""

    def __init__(self, pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
                 gt_max_assign_all=True, ignore_iof_thr=-1,
                 match_low_quality=True, **kwargs):
        self._base = MaxIoUAssigner(
            pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
            min_pos_iou=min_pos_iou, gt_max_assign_all=gt_max_assign_all,
            match_low_quality=match_low_quality)

    def assign(self, squares: torch.Tensor, num_level_anchors: Sequence[int],
               gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor, valid_mask: torch.Tensor = None,
               num_classes: int = 80,
               approxs: torch.Tensor = None) -> AssignResult:
        """squares (N, 4); approxs (N, K, 4), K approx anchors a square
        (None: the squares' own IoU); the gts (B, G, ...)."""
        overlaps = None
        if approxs is not None:
            n, k, _ = approxs.shape
            overlaps = bbox_overlaps(approxs.reshape(n * k, 4), gt_bboxes)
            overlaps = overlaps.view(gt_bboxes.shape[0], n, k, -1).amax(2)
        return self._base.assign(squares, num_level_anchors, gt_bboxes,
                                 gt_labels, gt_valid, valid_mask,
                                 num_classes, overlaps=overlaps)
