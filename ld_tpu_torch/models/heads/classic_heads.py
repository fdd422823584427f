"""The plain FCOS and ATSS heads (a 4-channel regression, no
distributions); port of `ld_tpu/models/heads/classic_heads.py:34-314`,
NCHW. Both keep their GFL counterparts' towers, targets and names.

  * `FCOSHead(FCOSGFLHead)`: `conv_reg` gives 4 channels and the distances
    are exp(clip(conv x scale, -10, 8)), in strides; the loss decodes them
    times the stride at the points (focal cls over the positives, the
    IoU-family `loss_bbox` weighted by the centerness targets and
    normalised by their sum, BCE centerness over the positives). The
    decode scores sigmoid(cls) x sigmoid(centerness). `norm_on_bbox` is
    read by neither package (ROADMAP.md caveat 17); `dcn_on_last_conv`
    makes each tower's last conv a DCNv2, as in the JAX net.
  * `ATSSHead(ATSSGFLHead)`: `atss_reg` x the level scale gives 4
    `DeltaXYWHBBoxCoder` deltas (stds 0.1, 0.1, 0.2, 0.2) at the anchors;
    GIoU on the decoded boxes weighted by the centerness targets, focal
    cls over the valid anchors, BCE centerness; the decode as FCOS's at
    the anchors, IoU 0.6 unless the config says otherwise.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ld_tpu_torch.ops.boxes import anchor_center, distance2bbox
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .atss_gfl_head import (ATSSGFLHead, _centerness, centerness_bce,
                            centerness_target)
from .fcos_gfl_head import FCOSGFLHead
from .gfl_head import flatten_level, flatten_levels
from .retina_head import classic_decode


def _fused_scores(cls_scores, centernesses, num_classes):
    """sigmoid(cls) x sigmoid(centerness) per level, (B, n, C)."""
    b = cls_scores[0].shape[0]
    return [torch.sigmoid(flatten_level(c).reshape(b, -1, num_classes)) *
            torch.sigmoid(flatten_level(ctr).reshape(b, -1, 1))
            for c, ctr in zip(cls_scores, centernesses)]


@HEADS.register_module()
class FCOSHead(FCOSGFLHead):

    def __init__(self, num_classes, in_channels, loss_bbox=None, **kwargs):
        kwargs.pop('reg_max', None)
        super().__init__(num_classes, in_channels, loss_bbox=loss_bbox or dict(
            type='IoULoss', loss_weight=1.0), **kwargs)

    def _build_predictors(self, feat_channels):
        super()._build_predictors(feat_channels)
        self.conv_reg = self._pred_conv(feat_channels, 4)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls logits, distances in strides,
        centerness logits), NCHW per level."""
        cls_scores, bbox_preds, centernesses = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = self._towers(x)
            cls_scores.append(self.conv_cls(cls_feat).float())
            bbox_preds.append(torch.exp(self.scales[lvl](
                self.conv_reg(reg_feat).float()).clamp(-10.0, 8.0)))
            centernesses.append(self.conv_centerness(
                reg_feat if self.centerness_on_reg else cls_feat).float())
        return cls_scores, bbox_preds, centernesses

    def _fcos_core(self, outputs, batch, featmap_sizes) -> Dict:
        t = self.fcos_targets(featmap_sizes, batch['gt_bboxes'],
                              batch['gt_labels'], batch['gt_valid'])
        cls_flat = flatten_levels(outputs[0])
        dist_flat = flatten_levels(outputs[1])
        ctr_flat = flatten_levels(outputs[2])[..., 0]
        pos = t['pos']
        posf = pos.to(torch.float32)
        num_pos = global_sum(posf.sum()).clamp(min=1.0)
        loss_cls = self.loss_cls(cls_flat, t['labels'], avg_factor=num_pos)
        bt = t['bbox_targets']
        ctr_targets = _centerness(bt, pos)
        pts = t['points'][None]
        decoded = distance2bbox(pts, dist_flat * t['strides'][None, :, None])
        loss_bbox = self.loss_bbox(
            decoded.reshape(-1, 4), distance2bbox(pts, bt).reshape(-1, 4),
            weight=ctr_targets.reshape(-1),
            avg_factor=global_sum(ctr_targets.sum()).clamp(min=1e-6))
        loss_centerness = centerness_bce(ctr_flat, ctr_targets, posf, num_pos,
                                         self.loss_centerness.loss_weight)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_centerness, pos=pos, posf=posf,
                    cls_flat=cls_flat, pred_flat=dist_flat, targets=t)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        cls_scores, bbox_preds, centernesses = outputs
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        points = self.level_centers(featmap_sizes, cls_scores[0].device)
        strides = [float(s[0]) for s in self.anchor_generator.strides]
        dists = [flatten_level(d).reshape(b, -1, 4) * s
                 for d, s in zip(bbox_preds, strides)]
        return classic_decode(
            _fused_scores(cls_scores, centernesses, self.cls_out_channels),
            dists, points,
            lambda p, d, hw: distance2bbox(p, d, max_shape=hw), img_hw,
            scale_factor, rescale, cfg or self.test_cfg, 0.5, keep_fn)


@HEADS.register_module()
class ATSSHead(ATSSGFLHead):

    def __init__(self, num_classes, in_channels, bbox_coder=None, **kwargs):
        kwargs.pop('reg_max', None)
        super().__init__(num_classes, in_channels, **kwargs)
        self.coder = build_coder(bbox_coder or dict(
            type='DeltaXYWHBBoxCoder', target_means=[0.] * 4,
            target_stds=[0.1, 0.1, 0.2, 0.2]))

    def _build_predictors(self, feat_channels):
        super()._build_predictors(feat_channels)
        self.atss_reg = self._pred_conv(feat_channels, 4)

    def _atss_core(self, outputs, t) -> Dict:
        cls_flat = flatten_levels(outputs[0])
        reg_flat = flatten_levels(outputs[1])
        ctr_flat = flatten_levels(outputs[2])[..., 0]
        pos = t['pos_mask']
        posf = pos.to(torch.float32)
        label_weights = t['anchor_valid'].to(torch.float32)
        anchors = t['anchors']
        num_total_samples = global_sum(posf.sum()).clamp(min=1.0)
        loss_cls = self.loss_cls(cls_flat, t['labels'], weight=label_weights,
                                 avg_factor=num_total_samples)
        ctr_targets = centerness_target(anchor_center(anchors)[None],
                                        t['bbox_targets'], pos)
        decoded = self.coder.decode(anchors[None], reg_flat)
        loss_bbox = self.loss_bbox(
            decoded.reshape(-1, 4), t['bbox_targets'].reshape(-1, 4),
            weight=ctr_targets.reshape(-1),
            avg_factor=global_sum(ctr_targets.sum()).clamp(min=1e-6))
        loss_centerness = centerness_bce(
            ctr_flat, ctr_targets, posf, num_total_samples,
            self.loss_centerness.loss_weight)
        zero = torch.zeros((), device=cls_flat.device)
        weight_targets = torch.where(
            pos, torch.sigmoid(cls_flat.detach()).amax(dim=-1), zero)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_centerness, pos=pos, posf=posf,
                    label_weights=label_weights, weight_targets=weight_targets,
                    cls_flat=cls_flat, pred_flat=reg_flat)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        cls_scores, bbox_preds, centernesses = outputs
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        anchors = self.anchor_generator.grid_anchors(
            featmap_sizes, cls_scores[0].device)
        regs = [flatten_level(r).reshape(b, -1, 4) for r in bbox_preds]
        return classic_decode(
            _fused_scores(cls_scores, centernesses, self.cls_out_channels),
            regs, anchors,
            lambda a, r, hw: self.coder.decode(a, r, max_shape=hw), img_hw,
            scale_factor, rescale, cfg or self.test_cfg, 0.6, keep_fn)


@HEADS.register_module()
class NASFCOSHead(FCOSHead):
    """The NAS-FCOS head of the JAX package
    (`ld_tpu/models/heads/centripetal_head.py:229`): `FCOSHead` unchanged;
    the searched wiring is the `NASFCOS_FPN` neck's."""
