"""The FSAF head (online feature selection); port of
`ld_tpu/models/heads/fsaf_head.py`, NCHW.

  * `FSAFHead(RetinaHead)`: one anchor a location (octave base 1), the
    Retina towers and `retina_cls` / `retina_reg` (mmdet's names); the
    regression clamped at 1e-4 in the loss and the decode is a
    `TBLRBBoxCoder` (normalizer 4) of the anchors.
  * Assignment: `CenterRegionAssigner` (0.2 / 0.2 unless the config says
    otherwise), its ignore band marked by `max_overlaps` -1.
  * Online feature selection: each positive's focal loss (summed over the
    classes) plus its IoU loss, meaned per (image, gt, level) with
    `index_add_`, picks each gt's level by argmin (of equal means the
    lower level; a level without positives counts 1e6); the positives at
    the other levels are dropped from both terms.
  * Losses: focal over the valid negatives outside the ignore band and the
    kept positives, and the IoU loss over the kept positives, both divided
    by max(kept, 1) over every rank.

`score_threshold` and the assigner's `min_pos_iof` are accepted and not
read, as in the JAX head (ROADMAP.md caveat 59).
"""
from __future__ import annotations

from typing import Dict

import torch

from ld_tpu_torch.ops.extra_assigners import CenterRegionAssigner
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .gfl_head import flatten_levels
from .retina_head import RetinaHead

REG_FLOOR = 1e-4


@HEADS.register_module()
class FSAFHead(RetinaHead):

    def __init__(self, num_classes, in_channels, bbox_coder=None,
                 loss_cls=None, loss_bbox=None, score_threshold=None,
                 **kwargs):
        kwargs.setdefault('anchor_generator', dict(
            octave_base_scale=1, scales_per_octave=1, ratios=[1.0],
            strides=[8, 16, 32, 64, 128]))
        super().__init__(
            num_classes, in_channels,
            bbox_coder=bbox_coder or dict(type='TBLRBBoxCoder',
                                          normalizer=4.0),
            loss_cls=loss_cls or dict(type='FocalLoss', use_sigmoid=True,
                                      gamma=2.0, alpha=0.25,
                                      loss_weight=1.0),
            loss_bbox=loss_bbox or dict(type='IoULoss', eps=1e-6,
                                        loss_weight=1.0),
            **kwargs)
        a_cfg = dict(self.train_cfg.get('assigner', dict(
            pos_scale=0.2, neg_scale=0.2, min_pos_iof=0.01)))
        a_cfg.pop('type', None)
        self.assigner = CenterRegionAssigner(**a_cfg)
        self.score_threshold = score_threshold

    def select_levels(self, per_anchor: torch.Tensor, pos: torch.Tensor,
                      gt_inds: torch.Tensor, level_id: torch.Tensor,
                      num_gt: int) -> torch.Tensor:
        """Each gt's level (B, G): the argmin of its positives' mean
        `per_anchor` (B, N) loss a level."""
        b = pos.shape[0]
        num_levels = self.num_levels
        cell = (torch.arange(b, device=pos.device)[:, None] * num_gt +
                gt_inds.clamp(min=0)) * num_levels + level_id[None]
        posf = pos.to(per_anchor.dtype)
        size = b * num_gt * num_levels
        total = per_anchor.new_zeros(size).index_add_(
            0, cell.reshape(-1), (per_anchor * posf).reshape(-1))
        cnt = per_anchor.new_zeros(size).index_add_(0, cell.reshape(-1),
                                                    posf.reshape(-1))
        tab = torch.where(cnt > 0, total / cnt.clamp(min=1),
                          torch.full_like(cnt, 1e6))
        return tab.reshape(b, num_gt, num_levels).argmin(dim=-1)

    def pieces(self, outputs, batch, featmap_sizes) -> Dict:
        """The assignment, each anchor's losses, each gt's level and the
        kept positives of a batch."""
        gt_bboxes = batch['gt_bboxes']
        device = gt_bboxes.device
        anchors, num_lvl, _, level_id = self.level_geometry(featmap_sizes,
                                                            device)
        valid = torch.stack([
            torch.cat(self.anchor_generator.valid_flags(featmap_sizes, hw,
                                                        device))
            for hw in batch['img_hw']])                             # (B, N)
        res = self.assigner.assign(anchors, num_lvl, gt_bboxes,
                                   batch['gt_labels'], batch['gt_valid'],
                                   valid, num_classes=self.num_classes)
        pos = res.pos_mask
        ignore = res.max_overlaps == -1.0
        cls_flat = flatten_levels(outputs[0], self.cls_out_channels)
        reg_flat = flatten_levels(outputs[1], 4).clamp(min=REG_FLOOR)
        safe = res.assigned_gt_inds.clamp(min=0)
        tgt = torch.gather(gt_bboxes, 1, safe[..., None].expand(-1, -1, 4))
        decoded = self.coder.decode(anchors[None], reg_flat)
        cls_none = self.loss_cls(cls_flat, res.labels,
                                 reduction_override='none').sum(-1)
        bbox_none = self.loss_bbox(decoded.reshape(-1, 4), tgt.reshape(-1, 4),
                                   reduction_override='none'
                                   ).reshape(pos.shape)
        with torch.no_grad():
            best_level = self.select_levels(cls_none + bbox_none, pos,
                                            res.assigned_gt_inds, level_id,
                                            gt_bboxes.shape[1])
        keep = pos & (level_id[None] == best_level.gather(1, safe))
        return dict(pos=pos, ignore=ignore, valid=valid, keep=keep,
                    best_level=best_level, cls_none=cls_none,
                    bbox_none=bbox_none)

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        p = self.pieces(outputs, batch, featmap_sizes)
        keepf = p['keep'].to(torch.float32)
        posf = p['pos'].to(torch.float32)
        num_pos = global_sum(keepf.sum()).clamp(min=1.0)
        neg_w = p['valid'].to(torch.float32) * (1.0 - posf) * \
            (1.0 - p['ignore'].to(torch.float32))
        loss_cls = (p['cls_none'] * (neg_w + keepf)).sum() / num_pos
        loss_bbox = (p['bbox_none'] * keepf).sum() / num_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        cls_scores, bbox_preds = outputs
        return super().get_bboxes(
            (cls_scores, [p.clamp(min=REG_FLOOR) for p in bbox_preds]),
            img_hw, scale_factor, rescale, cfg, with_nms, keep_fn)
