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

  * `RegionAssigner` (`:302-362`, Cascade RPN's first stage): each gt maps
    to the level floor(log2(sqrt(w*h) / (anchor_scale x strides[0])) +
    0.5), clipped to the levels; an anchor of that level whose centre lies
    in the gt's centre `center_ratio` region (bounds included) is positive,
    the smallest such gt winning (of equal areas the lowest index); an
    anchor in the `ignore_ratio` region on the level or a neighbour that is
    not positive is ignored (`max_overlaps` -1).
  * `TaskAlignedAssigner` (`:208-258`, TOOD): the alignment metric
    cls_prob[gt label]^alpha x IoU(prediction, gt)^beta over the anchors
    whose centre lies strictly inside the gt; each gt takes its `topk`
    anchors by metric (those above 0), an anchor two gts take goes to the
    one of larger IoU. `assign` also returns the (B, N, G) metric of the
    candidates, 0 elsewhere. The JAX assigner is the paper's: the
    reference ships none (ROADMAP.md caveat 81).
  * `GridAssigner` (`:261-299`, YOLOv3's, which its head never calls, as in
    JAX): MaxIoU thresholds over the anchors responsible for each gt, and
    each gt claims its best responsible anchor.

The file's other JAX assigner (Hungarian) is not ported yet: building it
raises, naming its ROADMAP.md Queue A item.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ld_tpu_torch.utils.registry import ASSIGNERS
from .atss_assigner import INF, AssignResult
from .boxes import bbox_overlaps
from .max_iou_assigner import MaxIoUAssigner

ASSIGNERS.not_ported['HungarianAssigner'] = 'ROADMAP.md Queue A item 10'


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


@ASSIGNERS.register_module()
class RegionAssigner:
    """Cascade RPN's stage-1 assignment: a gt's centre region on its
    scale's level."""

    def __init__(self, center_ratio=0.2, ignore_ratio=0.5, **kwargs):
        self.center_ratio = center_ratio
        self.ignore_ratio = ignore_ratio

    def assign(self, anchors: torch.Tensor, num_level_anchors: Sequence[int],
               gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor, valid_mask: torch.Tensor = None,
               num_classes: int = 1, anchor_scale: float = 8,
               strides: Sequence[int] = (8, 16, 32, 64, 128)
               ) -> AssignResult:
        """anchors (N, 4); the gts (B, G, ...); valid_mask (B, N). The
        ignored anchors carry `max_overlaps` -1."""
        n, dev = anchors.shape[0], anchors.device
        if valid_mask is None:
            valid_mask = torch.ones((gt_bboxes.shape[0], n), dtype=torch.bool,
                                    device=dev)
        level_id = torch.cat([torch.full((c, ), i, dtype=torch.int64,
                                         device=dev)
                              for i, c in enumerate(num_level_anchors)])
        gx1, gy1, gx2, gy2 = gt_bboxes.unbind(-1)
        w, h = gx2 - gx1, gy2 - gy1
        scale = torch.sqrt((w * h).clamp(min=1e-6))
        tgt_lvl = torch.floor(torch.log2(
            scale / (anchor_scale * strides[0])) + 0.5).clamp(
                0, len(num_level_anchors) - 1)                     # (B, G)
        cx = ((anchors[:, 0] + anchors[:, 2]) / 2)[None, :, None]
        cy = ((anchors[:, 1] + anchors[:, 3]) / 2)[None, :, None]

        def in_region(ratio):
            r = (1 - ratio) / 2
            return ((cx >= (gx1 + r * w)[:, None]) &
                    (cx <= (gx2 - r * w)[:, None]) &
                    (cy >= (gy1 + r * h)[:, None]) &
                    (cy <= (gy2 - r * h)[:, None]))               # (B, N, G)

        on_lvl = level_id[None, :, None] == tgt_lvl.long()[:, None, :]
        near = (level_id[None, :, None].float() -
                tgt_lvl[:, None, :]).abs() <= 1
        pos_in = in_region(self.center_ratio) & on_lvl & \
            gt_valid[:, None, :] & valid_mask[..., None]
        ign_in = in_region(self.ignore_ratio) & near & gt_valid[:, None, :]
        inf = torch.full((), INF, device=dev)
        masked = torch.where(pos_in, (w * h)[:, None, :], inf)
        best = masked.argmin(dim=-1)           # the first gt on a tie
        pos = masked.amin(dim=-1) < INF / 2
        ignore = ign_in.any(dim=-1) & ~pos
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best),
                             torch.full_like(best, num_classes))
        one = torch.ones((), device=dev)
        overlaps = torch.where(pos, one, torch.where(ignore, -one, 0 * one))
        return AssignResult(
            assigned_gt_inds=torch.where(pos, best, torch.full_like(best, -1)),
            max_overlaps=overlaps, labels=labels, pos_mask=pos)


@ASSIGNERS.register_module()
class TaskAlignedAssigner:
    """TOOD's task-aligned assignment (the paper's; see the module
    docstring)."""

    def __init__(self, topk=13, alpha=1.0, beta=6.0, **kwargs):
        # `anchor_type` and mmdet's other keys are accepted and not read,
        # as in the JAX assigner (ROADMAP.md caveat 81)
        self.topk = topk
        self.alpha = alpha
        self.beta = beta

    def assign(self, pred_scores: torch.Tensor, decoded_bboxes: torch.Tensor,
               anchors: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor,
               valid_mask: torch.Tensor = None, num_classes: int = 80):
        """pred_scores (B, N, C) probabilities, decoded_bboxes (B, N, 4),
        anchors (N, 4), the gts (B, G, ...), valid_mask (B, N) ->
        (AssignResult, the candidates' (B, N, G) alignment metric)."""
        b, n = pred_scores.shape[:2]
        g = gt_bboxes.shape[1]
        if valid_mask is None:
            valid_mask = torch.ones((b, n), dtype=torch.bool,
                                    device=anchors.device)
        iou = bbox_overlaps(decoded_bboxes, gt_bboxes)            # (B, N, G)
        cls_g = torch.gather(pred_scores, 2, gt_labels.long().clamp(
            min=0)[:, None, :].expand(b, n, g))
        metric = cls_g ** self.alpha * iou ** self.beta
        cx = ((anchors[:, 0] + anchors[:, 2]) / 2)[None, :, None]
        cy = ((anchors[:, 1] + anchors[:, 3]) / 2)[None, :, None]
        gtb = gt_bboxes[:, None]
        inside = (cx > gtb[..., 0]) & (cx < gtb[..., 2]) & \
            (cy > gtb[..., 1]) & (cy < gtb[..., 3])
        ok = inside & gt_valid[:, None, :] & valid_mask[..., None]
        metric = torch.where(ok, metric, torch.full_like(metric, -1.0))
        # each gt's top-k anchors by metric
        _, idx = torch.topk(metric.transpose(1, 2), min(self.topk, n))
        cand = torch.zeros((b, g, n), dtype=torch.bool, device=metric.device)
        cand.scatter_(2, idx, True)
        cand = cand.transpose(1, 2) & (metric > 0)
        # an anchor two gts take goes to the one of larger IoU
        iou_m = torch.where(cand, iou, torch.full_like(iou, -1.0))
        best = iou_m.argmax(dim=-1)
        best_iou = iou_m.amax(dim=-1)
        pos = best_iou > 0
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best),
                             torch.full_like(best, num_classes))
        align = torch.where(cand, metric, torch.zeros_like(metric))
        return AssignResult(
            assigned_gt_inds=torch.where(pos, best, torch.full_like(best, -1)),
            max_overlaps=torch.where(pos, best_iou,
                                     torch.zeros_like(best_iou)),
            labels=labels, pos_mask=pos), align


@ASSIGNERS.register_module()
class GridAssigner:
    """YOLO's grid assignment: MaxIoU among each gt's responsible
    anchors."""

    def __init__(self, pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.0,
                 gt_max_assign_all=True, **kwargs):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all

    def assign(self, bboxes: torch.Tensor,
               box_responsible_flags: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor,
               num_classes: int = 80) -> AssignResult:
        """bboxes (N, 4); box_responsible_flags (B, N, G) bool, the anchor
        responsible for the gt; the gts (B, G, ...)."""
        overlaps = bbox_overlaps(bboxes, gt_bboxes)               # (B, N, G)
        resp = box_responsible_flags & gt_valid[:, None, :]
        ov_resp = torch.where(resp, overlaps, torch.full_like(overlaps, -1.0))
        max_ov = ov_resp.amax(dim=-1)
        argmax = ov_resp.argmax(dim=-1)
        pos = max_ov >= self.pos_iou_thr
        # each gt claims its best responsible anchor
        gt_best = ov_resp.amax(dim=1)                              # (B, G)
        claim_ok = (gt_best >= self.min_pos_iou) & gt_valid
        is_best = (ov_resp == gt_best[:, None, :]) & claim_ok[:, None, :] & \
            resp & (ov_resp > -0.5)
        claimed = is_best.any(dim=-1)
        gt_idx = torch.arange(overlaps.shape[-1], device=overlaps.device)
        claim_gt = torch.where(is_best, gt_idx, torch.full_like(
            gt_idx, -1)).amax(dim=-1)
        argmax = torch.where(claimed, claim_gt, argmax)
        pos = pos | claimed
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1,
                                               argmax.clamp(min=0)),
                             torch.full_like(argmax, num_classes))
        return AssignResult(
            assigned_gt_inds=torch.where(pos, argmax,
                                         torch.full_like(argmax, -1)),
            max_overlaps=torch.where(pos, max_ov, torch.zeros_like(max_ov)),
            labels=labels, pos_mask=pos)
