"""The Cascade R-CNN RoI head and Cascade Mask R-CNN's mask branch; port of
`ld_tpu/models/heads/cascade_roi_head.py:32-241`, NCHW.

  * `num_stages` class-agnostic `ConvFCBBoxHead`s under mmdet's names
    (`roi_head.bbox_head.{i}.*`), built from `bbox_head` (one config for all
    stages, or a list). As in the JAX net, only the stage's conv / fc counts
    and widths are read: its `norm_cfg`, `conv_cfg` and `with_avg_pool` are
    not.
  * Stage i's `DeltaXYWHBBoxCoder` has the JAX package's hard-coded stds
    (`DEFAULT_STDS`): a stage's own `bbox_coder` is not read (ROADMAP.md
    caveat 27). Its `MaxIoUAssigner` is the first stage's assigner config
    with pos / neg / min-pos IoU set to the stage's IoU (its `train_cfg`
    entry's `pos_iou_thr`, else `DEFAULT_IOUS`): one assigner a stage, where
    the JAX head re-points one shared assigner before each stage (caveat
    26). The sampler and the losses are the first stage's.
  * `forward_train`: each stage samples `num` rois an image from the
    previous stage's rois (the RPN's proposals first) with the gts added
    again, and adds `loss_cls_s{i}` / `loss_bbox_s{i}` (`bbox_losses`)
    times `stage_loss_weights[i]`; its decoded rois, unclipped and
    detached, gt-added rois and padding included, are the next stage's
    proposals (caveat 28).
  * `simple_test`: the stages' softmax scores averaged, the boxes refined
    and clipped stage by stage, one class-aware `multiclass_nms` of the
    last stage's boxes (greedy, through `keep_fn`; the JAX head reads only
    the test config's `iou_threshold`).
  * The stage heads come from `_build_stage_head`: `CascadeSABLRoIHead`
    (`sabl_roi_head.py`) builds SABL heads there.
  * Cascade Mask R-CNN (`mask_head`): one `FCNMaskHead` a stage
    (`roi_head.mask_head.{i}.*`), `loss_mask_s{i}` on each stage's positive
    slice times the stage's weight, and at test time the stages' sigmoid
    masks averaged, pooled on the final detections (a 4th output).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.ops.coder import DeltaXYWHBBoxCoder
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.utils.registry import HEADS
from .roi_head import (ConvFCBBoxHead, StandardRoIHead, _not_ported,
                       convfc_shape)

DEFAULT_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
                (0.033, 0.033, 0.067, 0.067))
DEFAULT_IOUS = (0.5, 0.6, 0.7)
DEFAULT_STAGE_WEIGHTS = (1.0, 0.5, 0.25)


def _per_stage(cfg, num_stages):
    return list(cfg) if isinstance(cfg, list) else [cfg] * num_stages


@HEADS.register_module()
class CascadeRoIHead(StandardRoIHead):

    def __init__(self, num_stages=3, stage_loss_weights=DEFAULT_STAGE_WEIGHTS,
                 bbox_roi_extractor=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, mask_roi_extractor=None, mask_head=None,
                 dtype=None, **kwargs):
        train_cfgs = _per_stage(train_cfg, num_stages)
        bbox_heads = _per_stage(bbox_head, num_stages)
        super().__init__(bbox_roi_extractor=bbox_roi_extractor,
                         bbox_head=bbox_heads[0], train_cfg=train_cfgs[0],
                         test_cfg=test_cfg, dtype=dtype, **kwargs)
        if self.reg_decoded_bbox:
            _not_ported('a cascade stage with reg_decoded_bbox')
        self.num_stages = num_stages
        self.stage_loss_weights = tuple(stage_loss_weights)
        self.reg_class_agnostic = True
        self.coders = [DeltaXYWHBBoxCoder(
            target_stds=DEFAULT_STDS[min(i, len(DEFAULT_STDS) - 1)])
            for i in range(num_stages)]
        a_cfg = dict(self.train_cfg.get('assigner') or {})
        a_cfg.pop('type', None)
        self.assigners = []
        for i, stage_cfg in enumerate(train_cfgs):
            iou = ((stage_cfg or {}).get('assigner') or {}).get(
                'pos_iou_thr', DEFAULT_IOUS[min(i, 2)])
            self.assigners.append(MaxIoUAssigner(**dict(
                a_cfg, pos_iou_thr=iou, neg_iou_thr=iou, min_pos_iou=iou)))
        self.bbox_head = nn.ModuleList(
            self._build_stage_head(i, bh or {})
            for i, bh in enumerate(bbox_heads))
        if mask_head is not None:
            self.mask_head = nn.ModuleList(
                self._build_mask_head(dict(mh), dict(mask_roi_extractor or {}),
                                      dtype)
                for mh in _per_stage(mask_head, num_stages))

    def _build_stage_head(self, i: int, bh: dict) -> nn.Module:
        num_convs, num_fcs = convfc_shape(bh)
        return ConvFCBBoxHead(
            self.num_classes, bh.get('in_channels', 256), self.roi_size,
            num_convs, num_fcs, bh.get('conv_out_channels', 256),
            bh.get('fc_out_channels', 1024), reg_class_agnostic=True)

    def init_weights(self, generator: torch.Generator):
        for head in self.bbox_head:
            head.init_weights(generator)
        for head in self.mask_head or ():
            head.init_weights(generator)

    # ---- training ----------------------------------------------------------
    def sample_stage(self, i, boxes, valid, batch, generator) -> Dict:
        """Stage i's `sample_rois` of `boxes` (B, n, 4): its assigner's IoU,
        its coder's targets."""
        return self.sample_rois(boxes, valid, batch['gt_bboxes'],
                                batch['gt_labels'].long(), batch['gt_valid'],
                                generator, assigner=self.assigners[i],
                                coder=self.coders[i])

    def refine(self, i, s: Dict, reg) -> torch.Tensor:
        """Stage i's sampled rois decoded by its deltas, unclipped and
        detached: the next stage's proposals."""
        b, n = s['rois'].shape[:2]
        with torch.no_grad():
            return self.coders[i].decode(s['rois'].reshape(-1, 4),
                                         reg.detach()).reshape(b, n, 4)

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        losses = {}
        boxes, valid = proposals, prop_valid
        for i in range(self.num_stages):
            s = self.sample_stage(i, boxes, valid, batch, generator)
            cls, reg = self.bbox_head[i](self._extract(feats, s['rois'],
                                                       s['roi_valid']))
            w = self.stage_loss_weights[i]
            for k, v in self.bbox_losses(cls, reg, s).items():
                losses[f'{k}_s{i}'] = w * v
            if self.mask_head is not None and 'gt_masks' in batch:
                losses[f'loss_mask_s{i}'] = w * self.mask_loss(
                    feats, s, batch['gt_masks'], self.mask_head[i])
            boxes, valid = self.refine(i, s, reg), s['roi_valid']
        return losses

    # ---- inference ---------------------------------------------------------
    def simple_test(self, feats, proposals, prop_valid, img_hw,
                    scale_factor=None, rescale=False, cfg=None,
                    keep_fn=nms_keep):
        """(dets (B, max_per_img, 5), labels, valid) of the proposals after
        the last stage, and with mask heads their masks (B, max_per_img,
        28, 28)."""
        cfg = cfg or self.test_cfg
        b, r = proposals.shape[:2]
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32,
                                 device=proposals.device)
        boxes, cls_sum = proposals, 0.0
        for i, head in enumerate(self.bbox_head):
            cls, reg = head(self._extract(feats, boxes, prop_valid))
            cls_sum = cls_sum + F.softmax(cls, dim=-1)
            boxes = self.coders[i].decode(boxes, reg.reshape(b, r, 4),
                                          max_shape=img_hw)
        scores = (cls_sum / self.num_stages)[:, :self.num_classes].reshape(
            b, r, -1) * prop_valid[..., None]
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(
                scale_factor, dtype=torch.float32,
                device=boxes.device)[:, None, :]
        dets, labels, valid = multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            cfg.get('nms', {}).get('iou_threshold', 0.5),
            max_per_img=cfg.get('max_per_img', 100), keep_fn=keep_fn)
        if not self.with_test_masks:
            return dets, labels, valid
        return dets, labels, valid, self.simple_test_mask(
            feats, dets, labels, valid, scale_factor if rescale else None)

    def predict_masks(self, roi_feats, labels) -> torch.Tensor:
        """The stages' sigmoid masks, averaged."""
        return sum(head.predict(roi_feats, labels)
                   for head in self.mask_head) / len(self.mask_head)
