"""RetinaNet head with GFL distributional regression, and LD on it; port of
`ld_tpu/models/heads/retina_gfl_head.py:45-254`, NCHW.

  * 9 anchors per location (octave base 4, 3 scales x 3 ratios), plain
    towers of biased 3x3 convs with ReLU (no GroupNorm, no per-level
    scale), `atss_cls` (A x C logits) and `atss_reg` (A x 4 x (reg_max+1)
    bins): mmdet's names, which its RetinaGFLHead shares with the ATSS head;
  * outputs flatten to (B, H*W*A, c) with the anchor minor, the generator's
    (position, anchor) order;
  * loss (MaxIoU targets): focal cls and GIoU on the integral-decoded boxes
    of the positives, both averaged over the batch's positive count; no DFL;
  * get_bboxes: the per-level `nms_pre` top-k on the max class sigmoid.

`LDRetinaHead` distills the WHOLE 4 x (reg_max+1) vector in one KL (the
reference's ld_retina.py, unlike LDHead's per-side KL): over the positives
weighted by the student's max class sigmoid, and over the VLR band of an
`ATSSAssigner(topk=9)` outside the positives, scaled 0.03; plus class KD
normalised by each level's positive count.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d
from ld_tpu_torch.models.losses.kd_loss import \
    knowledge_distillation_kl_div_loss
from ld_tpu_torch.ops.atss_assigner import ATSSAssigner
from ld_tpu_torch.ops.boxes import anchor_center, distance2bbox
from ld_tpu_torch.ops.integral import integral
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import GFLHead, flatten_levels
from .ld_head import class_kd_per_level


class ConvReLU(nn.Module):
    """A biased 3x3 conv + ReLU (mmcv ConvModule without norm: `.conv`),
    in `dtype`."""

    def __init__(self, in_channels, out_channels, dtype=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, padding=1,
                           compute_dtype=dtype)

    def forward(self, x):
        return torch.relu(self.conv(x))


@HEADS.register_module()
class RetinaGFLHead(GFLHead):

    cls_pred_name = 'atss_cls'

    def __init__(self, num_classes, in_channels, loss_cls=None,
                 reg_decoded_bbox=True, bbox_coder=None, **kwargs):
        # the loss is always on decoded boxes and the distributional decode
        # replaces the coder, as in the JAX package
        del reg_decoded_bbox, bbox_coder
        kwargs.setdefault('anchor_generator', dict(
            octave_base_scale=4, scales_per_octave=3,
            ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128]))
        super().__init__(num_classes, in_channels, loss_cls=loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0), **kwargs)

    def _build_towers(self, in_channels, feat_channels, stacked_convs,
                      groups):
        self.cls_convs = nn.ModuleList(
            ConvReLU(in_channels if i == 0 else feat_channels, feat_channels,
                     self.compute_dtype)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvReLU(in_channels if i == 0 else feat_channels, feat_channels,
                     self.compute_dtype)
            for i in range(stacked_convs))

    def _build_predictors(self, feat_channels):
        a = self.num_anchors
        self.atss_cls = self._pred_conv(feat_channels, a * self.num_classes)
        self.atss_reg = self._pred_conv(feat_channels,
                                        a * 4 * (self.reg_max + 1))

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, A*C, H, W), bbox_preds
        (B, A*68, H, W)) per level."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            cls_feat, reg_feat = self._towers(x)
            cls_scores.append(self.atss_cls(cls_feat).float())
            bbox_preds.append(self.atss_reg(reg_feat).float())
        return cls_scores, bbox_preds

    def _flatten(self, cls_scores, bbox_preds):
        return (flatten_levels(cls_scores, self.cls_out_channels),
                flatten_levels(bbox_preds, 4 * (self.reg_max + 1)))

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        core = self._retina_core(*self._flatten(*outputs), t)
        return {k: core[k] for k in ('loss_cls', 'loss_bbox')}

    def _retina_core(self, cls_flat, pred_flat, t) -> Dict:
        pos = t['pos_mask']
        posf = pos.to(torch.float32)
        strides = t['strides']
        num_total_samples = posf.sum().clamp(min=1.0)
        loss_cls = self.loss_cls(cls_flat, t['labels'],
                                 weight=t['anchor_valid'].to(torch.float32),
                                 avg_factor=num_total_samples)
        centers = anchor_center(t['anchors'])[None] / strides[None, :, None]
        decoded = distance2bbox(centers, integral(pred_flat, self.reg_max))
        target_boxes = t['bbox_targets'] / strides[None, :, None]
        loss_bbox = self.loss_bbox(decoded.reshape(-1, 4),
                                   target_boxes.reshape(-1, 4),
                                   weight=posf.reshape(-1),
                                   avg_factor=num_total_samples)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, pos=pos,
                    posf=posf)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """The GFL decode on the class sigmoids (the top-k ranks them)."""
        cls_scores, bbox_preds = outputs
        return super().get_bboxes(
            ([torch.sigmoid(c) for c in cls_scores], bbox_preds), img_hw,
            scale_factor, rescale, cfg, with_nms, keep_fn, use_sigmoid=False)


@HEADS.register_module()
class LDRetinaHead(RetinaGFLHead):

    def __init__(self, num_classes, in_channels, loss_ld=None, loss_kd=None,
                 **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.loss_ld = LOSSES.build(loss_ld or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=5, T=10))
        self.loss_kd = LOSSES.build(loss_kd or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=10, T=8))
        # the VLR band takes the ATSS statistics under MaxIoU assignment
        self.vlr_assigner = ATSSAssigner(topk=9)

    def loss(self, outputs, batch, featmap_sizes, soft_teacher,
             student_feats=None, teacher_feats=None) -> Dict[str, torch.Tensor]:
        """The Retina losses plus LD (whole-vector KL), VLR LD and class KD
        against the teacher's (cls_scores, bbox_preds) per level."""
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        vlr = self.vlr_assigner.get_vlr_region(
            t['anchors'], t['num_level_anchors'], batch['gt_bboxes'],
            batch['gt_valid'], t['anchor_valid'])                  # (B, N)
        cls_flat, pred_flat = self._flatten(outputs[0], outputs[1])
        core = self._retina_core(cls_flat, pred_flat, t)
        losses = dict(loss_cls=core['loss_cls'], loss_bbox=core['loss_bbox'])
        soft_label, soft_target = self._flatten(soft_teacher[0],
                                                soft_teacher[1])

        # one KL over the whole 4 x (reg_max+1) vector of an anchor
        kd_box = knowledge_distillation_kl_div_loss(
            pred_flat, soft_target, reduction='none', T=self.loss_ld.T)
        max_sig = torch.sigmoid(cls_flat.detach()).amax(dim=-1)
        w = self.loss_ld.loss_weight
        losses['loss_ld'] = w * (kd_box * max_sig * core['posf']).sum() / 4.0
        vlr_weights = torch.where(core['pos'], torch.zeros_like(vlr), vlr)
        losses['loss_ld_vlr'] = 0.03 * w * (kd_box * vlr_weights).sum() / 4.0

        kd_el = knowledge_distillation_kl_div_loss(
            cls_flat, soft_label, reduction='none', T=self.loss_kd.T)
        losses['loss_cls_kd'] = class_kd_per_level(
            kd_el, core['posf'], t['level_id'], self.num_levels,
            self.loss_kd.loss_weight)
        return losses
