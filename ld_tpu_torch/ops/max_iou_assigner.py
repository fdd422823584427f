"""MaxIoU assignment, dense and batched; port of
`ld_tpu/ops/max_iou_assigner.py:23-83`, with the images of a batch on a
leading dimension where the JAX package `vmap`s. The anchors are one (N, 4)
set for the batch or a (B, N, 4) set for each image (GA's guided anchors,
RepPoints' init boxes), and a caller may hand over its own (B, N, G)
overlap matrix (`ApproxMaxIoUAssigner`'s), as the JAX `overlaps=` does.

An anchor is positive for the gt of its highest IoU when that IoU is at
least `pos_iou_thr`. With `match_low_quality`, every gt whose best IoU is at
least `min_pos_iou` also claims its best anchor (every anchor that ties
with that best IoU under `gt_max_assign_all`, else the first). An anchor
claimed by several gts goes to the highest gt index among them: the last
writer of the reference's loop over gts.

As in the JAX package, there is no ignore band: every anchor that is not
positive is a negative, whatever `neg_iou_thr` says (mmdet ignores the
anchors between `neg_iou_thr` and `pos_iou_thr`).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ld_tpu_torch.utils.registry import ASSIGNERS
from .atss_assigner import AssignResult
from .boxes import bbox_overlaps


@ASSIGNERS.register_module()
class MaxIoUAssigner:

    def __init__(self, pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
                 gt_max_assign_all=True, ignore_iof_thr=-1,
                 match_low_quality=True, **kwargs):
        if ignore_iof_thr != -1:
            raise NotImplementedError(
                'ignore regions are not used by any GFL/LD config; pass '
                'ignore boxes as weight-0 gts instead')
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all
        self.match_low_quality = match_low_quality

    def assign(self,
               anchors: torch.Tensor,
               num_level_anchors: Sequence[int],
               gt_bboxes: torch.Tensor,
               gt_labels: torch.Tensor,
               gt_valid: torch.Tensor,
               valid_mask: torch.Tensor = None,
               num_classes: int = 80,
               overlaps: torch.Tensor = None) -> AssignResult:
        """MaxIoU assignment of a batch; the arguments of
        `ATSSAssigner.assign` (`num_level_anchors` is not used).

        Args:
            anchors: (N, 4) xyxy, the same for every image, or (B, N, 4).
            gt_bboxes: (B, G, 4); gt_labels, gt_valid: (B, G).
            valid_mask: (B, N) bool anchor validity.
            overlaps: (B, N, G) in place of the anchors' IoU with the gts.
        """
        b, num_gt = gt_bboxes.shape[:2]
        if valid_mask is None:
            valid_mask = torch.ones((b, anchors.shape[-2]), dtype=torch.bool,
                                    device=anchors.device)
        if overlaps is None:
            overlaps = bbox_overlaps(anchors, gt_bboxes)        # (B, N, G)
        overlaps = torch.where(gt_valid[:, None, :] & valid_mask[..., None],
                               overlaps, torch.full_like(overlaps, -1.0))
        max_overlaps = overlaps.amax(dim=-1)
        argmax = overlaps.argmax(dim=-1)              # the first gt on a tie
        pos = max_overlaps >= self.pos_iou_thr
        if self.match_low_quality:
            gt_best = overlaps.amax(dim=1)                      # (B, G)
            claim_ok = (gt_best >= self.min_pos_iou) & gt_valid
            if self.gt_max_assign_all:
                is_best = ((overlaps == gt_best[:, None, :]) &
                           claim_ok[:, None, :] & (overlaps > -0.5))
            else:
                is_best = torch.zeros_like(overlaps, dtype=torch.bool)
                is_best.scatter_(1, overlaps.argmax(dim=1, keepdim=True),
                                 True)
                is_best &= claim_ok[:, None, :]
            gt_ids = torch.arange(num_gt, device=anchors.device)
            claim_gt = torch.where(is_best, gt_ids, -1).amax(dim=-1)
            claimed = claim_gt >= 0
            argmax = torch.where(claimed, claim_gt, argmax)
            pos = pos | claimed
        pos = pos & valid_mask
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1,
                                               argmax.clamp(min=0)),
                             torch.full_like(argmax, num_classes))
        return AssignResult(
            assigned_gt_inds=torch.where(pos, argmax,
                                         torch.full_like(argmax, -1)),
            max_overlaps=torch.where(pos, max_overlaps,
                                     torch.zeros_like(max_overlaps)),
            labels=labels, pos_mask=pos)
