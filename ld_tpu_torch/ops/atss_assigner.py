"""ATSS assignment and the VLR (valuable localization region); port of
`ld_tpu/ops/atss_assigner.py:45-220`, with the images of a batch on a
leading dimension where the JAX package `vmap`s.

The dense, static-shape formulation of the JAX package:
  * gt boxes are padded to G per image with a validity mask;
  * invalid anchors (outside the image) get a centre distance of INF, so they
    sort behind every valid anchor, and candidate ranks at or past the
    level's count of valid anchors are masked out of the mean/std;
  * the per-gt candidate positivity is scattered back to a dense
    (anchors, gts) grid, and an anchor claimed by several gts keeps the one
    of highest IoU (the first such gt on a tie).

Ties: anchor-centre distances tie whenever a gt centre lies midway between
anchor centres, which integer gt coordinates make common. The JAX package
takes the k nearest by iterated `argmin`, which puts the lowest index first;
`torch.topk` promises no order among ties, so the k nearest here come from a
stable sort, which also puts the lowest index first.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ld_tpu_torch.utils.registry import ASSIGNERS
from .boxes import anchor_center, bbox_overlaps

INF = 1e8


class AssignResult(NamedTuple):
    """Assignment of a batch, one row per image.

    assigned_gt_inds: (B, N) int64, the 0-based gt index of a positive, -1
        else.
    max_overlaps: (B, N) float, IoU with the assigned gt (0 for negatives).
    labels: (B, N) int64, the class of a positive, `num_classes` else.
    pos_mask: (B, N) bool.
    """
    assigned_gt_inds: torch.Tensor
    max_overlaps: torch.Tensor
    labels: torch.Tensor
    pos_mask: torch.Tensor


def _center_distances(anchors: torch.Tensor, gt_bboxes: torch.Tensor):
    """anchors (N, 4), gt_bboxes (B, G, 4) -> (B, N, G)."""
    gt_cx, gt_cy = anchor_center(gt_bboxes).unbind(-1)
    a_cx, a_cy = anchor_center(anchors).unbind(-1)
    return torch.sqrt((a_cx[None, :, None] - gt_cx[:, None, :])**2 +
                      (a_cy[None, :, None] - gt_cy[:, None, :])**2)


def _per_level_topk(distances: torch.Tensor,
                    num_level_anchors: Sequence[int],
                    valid_mask: torch.Tensor,
                    topk: int):
    """The topk anchors nearest each gt in each level.

    Args:
        distances: (B, N, G); valid_mask: (B, N) bool.
    Returns:
        cand_idx: (B, G, K) int64 anchor indices over all levels.
        cand_real: (B, G, K) bool, rank < min(#valid anchors of the level,
            topk): the reference's per-level `min(topk, num_inside)`.
    """
    b, _, num_gt = distances.shape
    masked = torch.where(valid_mask[..., None], distances,
                         torch.full_like(distances, INF))
    idx_parts, real_parts = [], []
    start = 0
    for n_lvl in num_level_anchors:
        k = min(topk, n_lvl)
        d_lvl = masked[:, start:start + n_lvl].transpose(1, 2)  # (B, G, n)
        # stable: the lowest index first among equal distances
        idx = torch.sort(d_lvl, dim=-1, stable=True).indices[..., :k]
        n_valid = valid_mask[:, start:start + n_lvl].sum(dim=1)   # (B,)
        rank = torch.arange(k, device=distances.device)
        real = rank[None, :] < torch.clamp(n_valid, max=k)[:, None]
        real_parts.append(real[:, None, :].expand(b, num_gt, k))
        idx_parts.append(idx + start)
        start += n_lvl
    return torch.cat(idx_parts, dim=-1), torch.cat(real_parts, dim=-1)


def _candidate_threshold(overlaps: torch.Tensor, cand_idx: torch.Tensor,
                         cand_real: torch.Tensor):
    """Mean + (Bessel-corrected) std of the candidates' IoUs, per gt.

    overlaps (B, N, G), cand_idx / cand_real (B, G, K) -> thr (B, G),
    cand_ov (B, G, K), m (B, G, K) float.
    """
    cand_ov = torch.gather(overlaps.transpose(1, 2), 2, cand_idx)
    m = cand_real.to(cand_ov.dtype)
    n = m.sum(dim=-1).clamp(min=1.0)
    mean = (cand_ov * m).sum(dim=-1) / n
    var = (((cand_ov - mean[..., None])**2) * m).sum(dim=-1) / (
        n - 1.0).clamp(min=1.0)
    return mean + torch.sqrt(var), cand_ov, m


@ASSIGNERS.register_module()
class ATSSAssigner:
    """Adaptive Training Sample Selection, dense static-shape formulation."""

    def __init__(self, topk: int = 9, iou_calculator=None, ignore_iof_thr=-1):
        if ignore_iof_thr != -1:
            raise NotImplementedError(
                'ignore regions are not used by any GFL/LD config; pass '
                'ignore boxes as weight-0 gts instead')
        self.topk = topk

    def assign(self,
               anchors: torch.Tensor,
               num_level_anchors: Sequence[int],
               gt_bboxes: torch.Tensor,
               gt_labels: torch.Tensor,
               gt_valid: torch.Tensor,
               valid_mask: torch.Tensor = None,
               num_classes: int = 80) -> AssignResult:
        """ATSS assignment of a batch.

        Args:
            anchors: (N, 4) xyxy, all levels concatenated.
            num_level_anchors: anchors per level.
            gt_bboxes: (B, G, 4) padded gt boxes.
            gt_labels: (B, G) padded labels.
            gt_valid: (B, G) bool validity of the padded gts.
            valid_mask: (B, N) bool anchor validity (inside the image).
        """
        b, num_gt = gt_bboxes.shape[:2]
        num_anchors = anchors.shape[0]
        if valid_mask is None:
            valid_mask = torch.ones((b, num_anchors), dtype=torch.bool,
                                    device=anchors.device)

        overlaps = bbox_overlaps(anchors, gt_bboxes)            # (B, N, G)
        distances = _center_distances(anchors, gt_bboxes)       # (B, N, G)
        cand_idx, cand_real = _per_level_topk(distances, num_level_anchors,
                                              valid_mask, self.topk)
        thr, cand_ov, cand_m = _candidate_threshold(overlaps, cand_idx,
                                                    cand_real)

        # candidate positivity: IoU at or above the threshold AND the anchor
        # centre inside the gt by more than 0.01
        a_cx, a_cy = anchor_center(anchors).unbind(-1)
        cand_cx = a_cx[cand_idx]                                # (B, G, K)
        cand_cy = a_cy[cand_idx]
        l_ = cand_cx - gt_bboxes[..., 0:1]
        t_ = cand_cy - gt_bboxes[..., 1:2]
        r_ = gt_bboxes[..., 2:3] - cand_cx
        b_ = gt_bboxes[..., 3:4] - cand_cy
        in_gt = torch.minimum(torch.minimum(l_, t_),
                              torch.minimum(r_, b_)) > 0.01
        is_pos = ((cand_ov >= thr[..., None]) & in_gt & (cand_m > 0)
                  & gt_valid[..., None])

        # scatter back to the dense grid; a gt's candidates are distinct
        # anchors, so no two writes meet
        pos_grid = torch.zeros((b, num_gt, num_anchors), dtype=torch.bool,
                               device=anchors.device)
        pos_grid.scatter_(2, cand_idx, is_pos)
        pos_grid = pos_grid.transpose(1, 2)                     # (B, N, G)

        # an anchor claimed by several gts keeps the one of highest IoU
        ov_masked = torch.where(pos_grid, overlaps,
                                torch.full_like(overlaps, -INF))
        max_overlaps = ov_masked.amax(dim=-1)
        argmax = ov_masked.argmax(dim=-1)         # the first gt on a tie
        assigned = max_overlaps > -INF / 2

        labels = torch.where(assigned, torch.gather(gt_labels.long(), 1,
                                                    argmax),
                             torch.full_like(argmax, num_classes))
        return AssignResult(
            assigned_gt_inds=torch.where(assigned, argmax,
                                         torch.full_like(argmax, -1)),
            max_overlaps=torch.where(assigned, max_overlaps,
                                     torch.zeros_like(max_overlaps)),
            labels=labels,
            pos_mask=assigned)

    def get_vlr_region(self,
                       anchors: torch.Tensor,
                       num_level_anchors: Sequence[int],
                       gt_bboxes: torch.Tensor,
                       gt_valid: torch.Tensor,
                       valid_mask: torch.Tensor = None) -> torch.Tensor:
        """Valuable-localization-region weights, (B, N) float.

        An anchor is VLR for gt g when 0.25 * thr <= DIoU(a, g) < thr (thr:
        the mean + std of the IoUs of the topk nearest anchors); its weight
        is the plain IoU with the best such gt.
        """
        b = gt_bboxes.shape[0]
        if valid_mask is None:
            valid_mask = torch.ones((b, anchors.shape[0]), dtype=torch.bool,
                                    device=anchors.device)
        overlaps = bbox_overlaps(anchors, gt_bboxes)
        diou = bbox_overlaps(anchors, gt_bboxes, mode='diou')
        distances = _center_distances(anchors, gt_bboxes)
        cand_idx, cand_real = _per_level_topk(distances, num_level_anchors,
                                              valid_mask, self.topk)
        thr, _, _ = _candidate_threshold(overlaps, cand_idx, cand_real)
        thr = thr[:, None, :]                                   # (B, 1, G)
        in_band = ((diou < thr) & (diou >= 0.25 * thr) & valid_mask[..., None]
                   & gt_valid[:, None, :])
        ov_masked = torch.where(in_band, overlaps,
                                torch.full_like(overlaps, -INF))
        max_overlaps = ov_masked.amax(dim=-1)
        return torch.where(max_overlaps > -INF / 2, max_overlaps,
                           torch.zeros_like(max_overlaps))
