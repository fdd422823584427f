"""FCOS head with GFL distributional regression, and LD on it; port of
`ld_tpu/models/heads/fcos_gfl_head.py:34-337`, NCHW.

  * points: `arange(w) * s + s // 2` (and the same in y), row-major per level;
  * targets, dense over (B, points, gts): a point is positive for a gt when
    it lies inside the gt's centre region (radius 1.5 strides, clipped to
    the gt) with `center_sampling`, else inside the gt, and the gt's largest
    (l, t, r, b) distance falls in the level's regress range; several such
    gts go to the smallest area (the first on a tie);
  * forward: the GFL towers, then `conv_cls`, `conv_reg` x a per-level scale,
    `conv_centerness` (from the reg tower with `centerness_on_reg`, else
    the cls tower): mmdet's names;
  * loss: focal cls averaged over the batch's positives (no anchor
    validity), GIoU on the decoded boxes weighted by the centerness targets
    and normalised by their sum, BCE centerness over the positives;
  * get_bboxes: the ATSS head's, sigmoid(cls) x sigmoid(centerness), at
    the points.

`LDFCOSHead` adds LD on the positives and `loss_ld_neg` (0.25 x LD) on the
points inside some gt that are not positive, both weighted by the student's
max class sigmoid, and class KD per level. `LDFCOSCompareHead` is the
reference's ablation twin: its class KD is zero unless `loss_kd` is given.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from ld_tpu_torch.models.losses.kd_loss import \
    knowledge_distillation_kl_div_loss
from ld_tpu_torch.ops.boxes import distance2bbox
from ld_tpu_torch.ops.integral import integral
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .atss_gfl_head import ATSSGFLHead, _centerness, centerness_bce
from .gfl_head import Scale, flatten_levels
from .ld_head import class_kd_per_level

INF = 1e8
DEFAULT_REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512),
                          (512, INF))


@HEADS.register_module()
class FCOSGFLHead(ATSSGFLHead):
    """The ATSS-GFL head's losses and decode at FCOS's points and targets,
    under FCOS's conv names."""

    cls_pred_name = 'conv_cls'

    def __init__(self, num_classes, in_channels, strides=(8, 16, 32, 64, 128),
                 regress_ranges=DEFAULT_REGRESS_RANGES, center_sampling=True,
                 center_sample_radius=1.5, norm_on_bbox=False,
                 centerness_on_reg=True, loss_cls=None, loss_centerness=None,
                 dcn_on_last_conv=False, conv_bias=True, **kwargs):
        if dcn_on_last_conv:
            raise NotImplementedError('FCOSGFLHead dcn_on_last_conv is not '
                                      'ported to ld_tpu_torch yet (see '
                                      'ROADMAP.md A7)')
        if norm_on_bbox:
            raise NotImplementedError('FCOSGFLHead norm_on_bbox=True is '
                                      'implemented in neither package')
        # conv_bias: the GN towers have no bias, as in the JAX package
        del conv_bias
        kwargs.setdefault('anchor_generator', dict(
            ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
            strides=list(strides)))
        super().__init__(num_classes, in_channels,
                         loss_centerness=loss_centerness, loss_cls=loss_cls,
                         **kwargs)
        self.regress_ranges = tuple(tuple(r) for r in regress_ranges)
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.centerness_on_reg = centerness_on_reg

    def _build_predictors(self, feat_channels):
        self.conv_cls = self._pred_conv(feat_channels, self.num_classes)
        self.conv_reg = self._pred_conv(feat_channels, 4 * (self.reg_max + 1))
        self.conv_centerness = self._pred_conv(feat_channels, 1)
        self.scales = nn.ModuleList(Scale(1.0)
                                    for _ in range(self.num_levels))

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores, bbox_preds, centernesses),
        NCHW per level, all logits."""
        cls_scores, bbox_preds, centernesses = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = self._towers(x)
            cls_scores.append(self.conv_cls(cls_feat).float())
            bbox_preds.append(self.scales[lvl](
                self.conv_reg(reg_feat).float()))
            centernesses.append(self.conv_centerness(
                reg_feat if self.centerness_on_reg else cls_feat).float())
        return cls_scores, bbox_preds, centernesses

    # ---- point geometry ----------------------------------------------------
    def point_geometry(self, featmap_sizes, device):
        """All-level points (N, 2), their strides (N,), level ids (N,) and
        regress ranges (N, 2), computed in numpy float32 as the JAX head
        computes them."""
        pts, strides, level_id, ranges = [], [], [], []
        for lvl, (h, w) in enumerate(featmap_sizes):
            s = self.anchor_generator.strides[lvl][0]
            xs = np.tile(np.arange(w, dtype=np.float32) * s, h) + s // 2
            ys = np.repeat(np.arange(h, dtype=np.float32) * s, w) + s // 2
            pts.append(np.stack([xs, ys], -1))
            strides.append(np.full(h * w, s, np.float32))
            level_id.append(np.full(h * w, lvl, np.int64))
            ranges.append(np.tile(np.asarray(self.regress_ranges[lvl],
                                             np.float32), (h * w, 1)))
        return tuple(torch.from_numpy(np.concatenate(x)).to(device)
                     for x in (pts, strides, level_id, ranges))

    def level_centers(self, featmap_sizes, device) -> List[torch.Tensor]:
        points = self.point_geometry(featmap_sizes, device)[0]
        return list(points.split([h * w for h, w in featmap_sizes]))

    def fcos_targets(self, featmap_sizes, gt_bboxes, gt_labels,
                     gt_valid) -> Dict:
        """FCOS targets of a batch: labels (B, N), bbox_targets (B, N, 4)
        as (l, t, r, b) pixel distances, pos (B, N), in_gt (B, N) (inside
        some gt: the LD 'neg' region), and the point geometry."""
        points, strides, level_id, ranges = self.point_geometry(
            featmap_sizes, gt_bboxes.device)
        xs = points[None, :, None, 0]                          # (1, N, 1)
        ys = points[None, :, None, 1]
        gx1, gy1, gx2, gy2 = (gt_bboxes[:, None, :, i] for i in range(4))
        targets = torch.stack([xs - gx1, ys - gy1, gx2 - xs, gy2 - ys],
                              dim=-1)                           # (B, N, G, 4)
        gtv = gt_valid[:, None, :]
        in_gt = (targets.amin(dim=-1) > 0) & gtv
        if self.center_sampling:
            radius = strides[None, :, None] * self.center_sample_radius
            cx = (gx1 + gx2) / 2
            cy = (gy1 + gy2) / 2
            x0 = torch.maximum(cx - radius, gx1)
            y0 = torch.maximum(cy - radius, gy1)
            x1 = torch.minimum(cx + radius, gx2)
            y1 = torch.minimum(cy + radius, gy2)
            inside = (torch.minimum(torch.minimum(xs - x0, x1 - xs),
                                    torch.minimum(ys - y0, y1 - ys)) > 0) \
                & gtv
        else:
            inside = in_gt
        max_dist = targets.amax(dim=-1)
        in_range = ((max_dist >= ranges[None, :, None, 0]) &
                    (max_dist <= ranges[None, :, None, 1]))
        areas = ((gt_bboxes[..., 2] - gt_bboxes[..., 0]) *
                 (gt_bboxes[..., 3] - gt_bboxes[..., 1]))[:, None, :]
        areas = torch.where(inside & in_range & gtv, areas,
                            torch.full_like(areas, INF))
        min_area = areas.amin(dim=-1)
        min_idx = areas.argmin(dim=-1)                 # the first on a tie
        pos = min_area < INF / 2
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, min_idx),
                             torch.full_like(min_idx, self.num_classes))
        bbox_targets = torch.gather(
            targets, 2, min_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        bbox_targets = torch.where(pos[..., None], bbox_targets,
                                   torch.zeros_like(bbox_targets))
        return dict(labels=labels, bbox_targets=bbox_targets, pos=pos,
                    in_gt=in_gt.any(dim=-1), points=points, strides=strides,
                    level_id=level_id)

    # ---- loss --------------------------------------------------------------
    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        core = self._fcos_core(outputs, batch, featmap_sizes)
        return {k: core[k] for k in ('loss_cls', 'loss_bbox',
                                     'loss_centerness')}

    def _fcos_core(self, outputs, batch, featmap_sizes) -> Dict:
        t = self.fcos_targets(featmap_sizes, batch['gt_bboxes'],
                              batch['gt_labels'], batch['gt_valid'])
        cls_flat = flatten_levels(outputs[0])
        pred_flat = flatten_levels(outputs[1])
        ctr_flat = flatten_levels(outputs[2])[..., 0]
        pos = t['pos']
        posf = pos.to(torch.float32)
        num_pos = posf.sum().clamp(min=1.0)
        loss_cls = self.loss_cls(cls_flat, t['labels'], avg_factor=num_pos)

        bt = t['bbox_targets']
        ctr_targets = _centerness(bt, pos)
        pts_n = t['points'][None] / t['strides'][None, :, None]
        decoded = distance2bbox(pts_n, integral(pred_flat, self.reg_max))
        decoded_targets = distance2bbox(pts_n,
                                        bt / t['strides'][None, :, None])
        loss_bbox = self.loss_bbox(decoded.reshape(-1, 4),
                                   decoded_targets.reshape(-1, 4),
                                   weight=ctr_targets.reshape(-1),
                                   avg_factor=ctr_targets.sum().clamp(
                                       min=1e-6))
        loss_centerness = centerness_bce(ctr_flat, ctr_targets, posf, num_pos,
                                         self.loss_centerness.loss_weight)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_centerness, pos=pos, posf=posf,
                    cls_flat=cls_flat, pred_flat=pred_flat, targets=t)


@HEADS.register_module()
class LDFCOSHead(FCOSGFLHead):

    def __init__(self, num_classes, in_channels, loss_ld=None, loss_kd=None,
                 **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.loss_ld = LOSSES.build(loss_ld or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=0.25, T=10))
        self.loss_kd = LOSSES.build(loss_kd or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=10, T=2))

    def loss(self, outputs, batch, featmap_sizes, soft_teacher,
             student_feats=None, teacher_feats=None) -> Dict[str, torch.Tensor]:
        """The FCOS losses plus LD on the positives, LD on the 'neg' region
        (inside a gt, not positive) and class KD, against the teacher's
        (cls_scores, bbox_preds, ...) per level."""
        core = self._fcos_core(outputs, batch, featmap_sizes)
        losses = {k: core[k] for k in ('loss_cls', 'loss_bbox',
                                       'loss_centerness')}
        t, pos, posf = core['targets'], core['pos'], core['posf']
        m1 = self.reg_max + 1
        kd_side = knowledge_distillation_kl_div_loss(
            core['pred_flat'].reshape(-1, m1),
            flatten_levels(soft_teacher[1]).reshape(-1, m1),
            reduction='none', T=self.loss_ld.T).reshape(*posf.shape, 4)
        max_sig = torch.sigmoid(core['cls_flat'].detach()).amax(dim=-1)
        w = self.loss_ld.loss_weight
        losses['loss_ld'] = w * (
            kd_side * (max_sig * posf)[..., None]).sum() / 4.0
        negf = (t['in_gt'] & ~pos).to(torch.float32)
        losses['loss_ld_neg'] = 0.25 * w * (
            kd_side * (max_sig * negf)[..., None]).sum() / 4.0
        kd_el = knowledge_distillation_kl_div_loss(
            core['cls_flat'], flatten_levels(soft_teacher[0]),
            reduction='none', T=self.loss_kd.T)
        losses['loss_cls_kd'] = class_kd_per_level(
            kd_el, posf, t['level_id'], self.num_levels,
            self.loss_kd.loss_weight)
        return losses


@HEADS.register_module()
class LDFCOSCompareHead(LDFCOSHead):
    """The reference's second LDFCOSHead (compare.py): the same losses, with
    the class KD off unless `loss_kd` is given."""

    def __init__(self, num_classes, in_channels, loss_ld=None, loss_kd=None,
                 **kwargs):
        super().__init__(num_classes, in_channels, loss_ld=loss_ld,
                         loss_kd=loss_kd, **kwargs)
        self.cls_kd_enabled = loss_kd is not None

    def loss(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        losses = super().loss(*args, **kwargs)
        if not self.cls_kd_enabled:
            losses['loss_cls_kd'] = torch.zeros(
                (), device=losses['loss_cls'].device)
        return losses
