"""ATSS head with GFL distributional regression, and LD on it; port of
`ld_tpu/models/heads/atss_gfl_head.py:25-251`, NCHW.

  * forward: the GFL towers, then `atss_cls` (class logits), `atss_reg` x a
    per-level scale (4 x (reg_max+1) bins) and `atss_centerness` (one logit,
    from the reg tower): three lists per level;
  * loss (ATSS targets, dense over the batch's anchors): focal cls averaged
    over the batch's positives; GIoU on the integral-decoded boxes weighted
    by the centerness targets and normalised by their sum; BCE centerness
    on the positives. There is no DFL term;
  * get_bboxes: sigmoid(cls) x sigmoid(centerness), probabilities, through
    the GFL decode with the sigmoid off.

`LDATSSHead` adds, over the same targets: main-region LD weighted by the
student's max class sigmoid at avg_factor 4, `loss_ld_neg` = 0.15 x LD on
the assigner's VLR region, and class KD normalised by each level's
positive count.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ld_tpu_torch.models.losses.focal_loss import bce_with_logits
from ld_tpu_torch.models.losses.kd_loss import \
    knowledge_distillation_kl_div_loss
from ld_tpu_torch.ops.boxes import anchor_center, distance2bbox
from ld_tpu_torch.ops.integral import integral
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import GFLHead, Scale, flatten_levels
from .ld_head import class_kd_per_level


def centerness_target(centers, bbox_targets, pos_mask, eps=1e-6):
    """sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b)) of each positive's
    (l, t, r, b) distances from its point to its target box, 0 elsewhere.

    Args:
        centers: (..., 2) points; bbox_targets: (..., 4) xyxy targets;
        pos_mask: (...) bool.
    """
    l_ = centers[..., 0] - bbox_targets[..., 0]
    t_ = centers[..., 1] - bbox_targets[..., 1]
    r_ = bbox_targets[..., 2] - centers[..., 0]
    b_ = bbox_targets[..., 3] - centers[..., 1]
    return _centerness(torch.stack([l_, t_, r_, b_], dim=-1), pos_mask, eps)


def _centerness(dist, pos_mask, eps=1e-6):
    """The centerness of (..., 4) (l, t, r, b) distances, 0 off `pos_mask`."""
    lr_min = torch.minimum(dist[..., 0], dist[..., 2])
    lr_max = torch.maximum(dist[..., 0], dist[..., 2]).clamp(min=eps)
    tb_min = torch.minimum(dist[..., 1], dist[..., 3])
    tb_max = torch.maximum(dist[..., 1], dist[..., 3]).clamp(min=eps)
    ratio = ((lr_min / lr_max) * (tb_min / tb_max)).clamp(min=0.0)
    return torch.where(pos_mask, torch.sqrt(ratio), torch.zeros_like(ratio))


def centerness_bce(ctr_logits, ctr_targets, posf, num_total_samples,
                   loss_weight):
    """The centerness loss: BCE on the logits against the targets, over the
    positives, averaged over the batch's positive count."""
    return loss_weight * (bce_with_logits(ctr_logits, ctr_targets) *
                          posf).sum() / num_total_samples


@HEADS.register_module()
class ATSSGFLHead(GFLHead):

    cls_pred_name = 'atss_cls'

    def __init__(self, num_classes, in_channels, loss_centerness=None,
                 loss_cls=None, bbox_coder=None, **kwargs):
        # bbox_coder: the distributional decode replaces it, as in the JAX
        # package
        del bbox_coder
        super().__init__(num_classes, in_channels, loss_cls=loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0), **kwargs)
        self.loss_centerness = LOSSES.build(loss_centerness or dict(
            type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0))

    def _build_predictors(self, feat_channels):
        self.atss_cls = self._pred_conv(feat_channels, self.num_classes)
        self.atss_reg = self._pred_conv(feat_channels, 4 * (self.reg_max + 1))
        self.atss_centerness = self._pred_conv(feat_channels, 1)
        self.scales = nn.ModuleList(Scale(1.0)
                                    for _ in range(self.num_levels))

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores, bbox_preds, centernesses),
        NCHW per level, all logits."""
        cls_scores, bbox_preds, centernesses = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = self._towers(x)
            cls_scores.append(self.atss_cls(cls_feat).float())
            bbox_preds.append(self.scales[lvl](
                self.atss_reg(reg_feat).float()))
            centernesses.append(self.atss_centerness(reg_feat).float())
        return cls_scores, bbox_preds, centernesses

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        core = self._atss_core(outputs, t)
        return {k: core[k] for k in ('loss_cls', 'loss_bbox',
                                     'loss_centerness')}

    def _atss_core(self, outputs, t) -> Dict:
        """Focal + centerness-weighted GIoU + BCE centerness over (B, N)
        anchors; returns the losses and the intermediates LD reuses."""
        cls_flat = flatten_levels(outputs[0])
        pred_flat = flatten_levels(outputs[1])
        ctr_flat = flatten_levels(outputs[2])[..., 0]
        pos = t['pos_mask']
        posf = pos.to(torch.float32)
        label_weights = t['anchor_valid'].to(torch.float32)
        strides = t['strides']
        # the batch-total positive count, clamped once
        num_total_samples = posf.sum().clamp(min=1.0)
        loss_cls = self.loss_cls(cls_flat, t['labels'], weight=label_weights,
                                 avg_factor=num_total_samples)

        anchor_ctr = anchor_center(t['anchors'])
        ctr_targets = centerness_target(anchor_ctr[None], t['bbox_targets'],
                                        pos)
        centers = anchor_ctr[None] / strides[None, :, None]
        decoded = distance2bbox(centers, integral(pred_flat, self.reg_max))
        target_boxes = t['bbox_targets'] / strides[None, :, None]
        loss_bbox = self.loss_bbox(decoded.reshape(-1, 4),
                                   target_boxes.reshape(-1, 4),
                                   weight=ctr_targets.reshape(-1),
                                   avg_factor=ctr_targets.sum().clamp(
                                       min=1e-6))
        loss_centerness = centerness_bce(
            ctr_flat, ctr_targets, posf, num_total_samples,
            self.loss_centerness.loss_weight)
        zero = torch.zeros((), device=cls_flat.device)
        weight_targets = torch.where(
            pos, torch.sigmoid(cls_flat.detach()).amax(dim=-1), zero)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_centerness, pos=pos, posf=posf,
                    label_weights=label_weights, weight_targets=weight_targets,
                    cls_flat=cls_flat, pred_flat=pred_flat)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """ATSS decode: scores sigmoid(cls) x sigmoid(centerness)."""
        cls_scores, bbox_preds, centernesses = outputs
        fused = [torch.sigmoid(c) * torch.sigmoid(ctr)
                 for c, ctr in zip(cls_scores, centernesses)]
        return super().get_bboxes((fused, bbox_preds), img_hw, scale_factor,
                                  rescale, cfg, with_nms, keep_fn,
                                  use_sigmoid=False)


@HEADS.register_module()
class LDATSSHead(ATSSGFLHead):

    def __init__(self, num_classes, in_channels, loss_ld=None, loss_kd=None,
                 **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.loss_ld = LOSSES.build(loss_ld or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=0.25, T=10))
        self.loss_kd = LOSSES.build(loss_kd or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=10, T=2))

    def loss(self, outputs, batch, featmap_sizes, soft_teacher,
             student_feats=None, teacher_feats=None) -> Dict[str, torch.Tensor]:
        """The ATSS losses plus LD, VLR LD and class KD against the
        teacher's (cls_scores, bbox_preds, ...) per level."""
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        vlr = self.assigner.get_vlr_region(
            t['anchors'], t['num_level_anchors'], batch['gt_bboxes'],
            batch['gt_valid'], t['anchor_valid'])                  # (B, N)
        core = self._atss_core(outputs, t)
        losses = {k: core[k] for k in ('loss_cls', 'loss_bbox',
                                       'loss_centerness')}
        m1 = self.reg_max + 1
        pred_corners = core['pred_flat'].reshape(-1, m1)
        soft_corners = flatten_levels(soft_teacher[1]).reshape(-1, m1)
        w4 = core['weight_targets'][..., None].expand(*vlr.shape, 4)
        losses['loss_ld'] = self.loss_ld(pred_corners, soft_corners,
                                         weight=w4.reshape(-1),
                                         avg_factor=4.0)
        vlr4 = vlr[..., None].expand(*vlr.shape, 4)
        losses['loss_ld_neg'] = 0.15 * self.loss_ld(
            pred_corners, soft_corners, weight=vlr4.reshape(-1),
            avg_factor=4.0)
        kd_el = knowledge_distillation_kl_div_loss(
            core['cls_flat'], flatten_levels(soft_teacher[0]),
            reduction='none', T=self.loss_kd.T)
        losses['loss_cls_kd'] = class_kd_per_level(
            kd_el, core['posf'] * core['label_weights'], t['level_id'],
            self.num_levels, self.loss_kd.loss_weight)
        return losses
