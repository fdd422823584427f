"""VarifocalNet head (VFNet, arXiv:2008.13367); port of
`ld_tpu/models/heads/vfnet_head.py:32-247`, NCHW.

  * forward, a level at a time: the GFL head's cls and reg towers (3x3 conv
    + GroupNorm + ReLU; with `dcn_on_last_conv` each tower's last conv a
    DCNv2); the initial distances exp(clip(vfnet_reg(vfnet_reg_conv(reg))
    x scale, -8, 8)) x the level's `reg_denom` (from `regress_ranges`: each
    range's upper end, twice the lower one for the open last range) or its
    stride; the star offsets of those distances (`star_offset`), which
    place the 9 taps of a 3x3 DCNv1 (`ops.deform_conv.DeformConv`) on the
    box's corners, edge middles and centre; the refined distances
    exp(clip(vfnet_reg_refine(relu(dconv(reg))) x scale_refine, -8, 8))
    times the detached initial ones; the IoU-aware class logits
    vfnet_cls(relu(dconv(cls))). The offsets mix (1 - gradient_mul) of the
    detached distances with gradient_mul of the live ones, so that a
    gradient_mul share of the offsets' gradient reaches the regression.
  * loss: the GFL head's ATSS targets on 8-scale square anchors; GIoU on the
    initial boxes and on the refined ones, each weighted (and averaged) by
    its own detached IoU with the target; the varifocal loss against the
    refined IoU at the gt's label, averaged over the positives.
  * get_bboxes: the refined boxes only, the level's `nms_pre` top-k on the
    largest sigmoid score, clipped to the image, then one class-aware
    `multiclass_nms` at the config's `nms.iou_threshold` (0.6 without one),
    whose keep mask is `nms_keep`.

`use_vfl` is stored and never read, as in the JAX package: the varifocal
loss is always the one built from `loss_cls` (ROADMAP.md caveat 44).
Module names are mmdet's (`cls_convs.i`, `reg_convs.i`, `vfnet_reg_conv`,
`vfnet_reg`, `vfnet_reg_refine_dconv`, `vfnet_reg_refine`,
`vfnet_cls_dconv`, `vfnet_cls`, `scales.i.scale`, `scales_refine.i.scale`);
the JAX converter has no rule for them, so weights reach the port from a
JAX tree through `state_dict_from_jax` (ROADMAP.md caveat 45).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.ops.boxes import (anchor_center, bbox_overlaps,
                                    distance2bbox)
from ld_tpu_torch.ops.deform_conv import DeformConv
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import (ConvGNBlock, GFLHead, Scale, _gather_rows,
                       flatten_level, flatten_levels)

INF = 1e8
EPS = 1e-6
DEFAULT_REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512),
                          (512, INF))


def star_offset(bbox_pred: torch.Tensor, stride: int,
                gradient_mul: float) -> torch.Tensor:
    """The star DCN's offsets (B, 18, H, W) of the distances (B, 4, H, W):
    each tap of the 3x3 grid moved from its base position to
    (-t | 0 | b, -l | 0 | r) over the stride, as (dy, dx) pairs, y first."""
    p = ((1 - gradient_mul) * bbox_pred.detach() +
         gradient_mul * bbox_pred) / stride
    l, t, r, b = p.unbind(1)
    z = torch.zeros_like(l)
    ys = (-t, -t, -t, z, z, z, b, b, b)
    xs = (-l, z, r, -l, z, r, -l, z, r)
    taps = []
    for i in range(9):
        ky, kx = i // 3 - 1, i % 3 - 1
        taps += [ys[i] - ky, xs[i] - kx]
    return torch.stack(taps, dim=1)


@HEADS.register_module()
class VFNetHead(GFLHead):

    cls_pred_name = 'vfnet_cls'

    def __init__(self, num_classes, in_channels, stacked_convs=3,
                 strides=(8, 16, 32, 64, 128),
                 regress_ranges=DEFAULT_REGRESS_RANGES,
                 bbox_norm_type='reg_denom', gradient_mul=0.1, use_vfl=True,
                 dcn_on_last_conv=False, loss_cls=None, loss_bbox=None,
                 loss_bbox_refine=None, **kwargs):
        if bbox_norm_type not in ('reg_denom', 'stride'):
            raise ValueError(f'bbox_norm_type {bbox_norm_type!r}')
        # each tower's last conv a DCNv2 (read by `_build_towers`)
        self.dcn_on_last_conv = dcn_on_last_conv
        self.level_strides = tuple(strides)
        self.reg_denoms = tuple(r[1] if r[1] < INF / 2 else r[0] * 2
                                for r in regress_ranges)
        self.bbox_norm_type = bbox_norm_type
        self.gradient_mul = gradient_mul
        kwargs.setdefault('anchor_generator', dict(
            ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
            strides=list(strides)))
        super().__init__(
            num_classes, in_channels, stacked_convs=stacked_convs,
            loss_cls=loss_cls or dict(type='VarifocalLoss', use_sigmoid=True,
                                      alpha=0.75, gamma=2.0,
                                      iou_weighted=True, loss_weight=1.0),
            loss_bbox=loss_bbox or dict(type='GIoULoss', loss_weight=1.5),
            **kwargs)
        # stored and never read, as in the JAX package (ROADMAP.md caveat 44)
        self.use_vfl = use_vfl
        self.loss_bbox_refine = LOSSES.build(loss_bbox_refine or dict(
            type='GIoULoss', loss_weight=2.0))

    def _build_predictors(self, feat_channels):
        self.vfnet_reg_conv = ConvGNBlock(feat_channels, feat_channels,
                                          dtype=self.compute_dtype)
        self.vfnet_reg = self._pred_conv(feat_channels, 4)
        self.vfnet_reg_refine_dconv = DeformConv(feat_channels,
                                                 feat_channels)
        self.vfnet_reg_refine = self._pred_conv(feat_channels, 4)
        self.vfnet_cls_dconv = DeformConv(feat_channels, feat_channels)
        self.vfnet_cls = self._pred_conv(feat_channels, self.num_classes)
        self.scales = nn.ModuleList(Scale(1.0)
                                    for _ in range(self.num_levels))
        self.scales_refine = nn.ModuleList(Scale(1.0)
                                           for _ in range(self.num_levels))

    def init_weights(self, generator: torch.Generator):
        """The GFL head's initializers; he-normal star DCN weights, refine
        scales 1."""
        super().init_weights(generator)
        with torch.no_grad():
            for m in (self.vfnet_reg_refine_dconv, self.vfnet_cls_dconv):
                m.init_weights(generator)
            for s in self.scales_refine:
                s.scale.fill_(1.0)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores, bbox_preds,
        bbox_preds_refine), NCHW per level: class logits and the initial
        and refined (l, t, r, b) distances in pixels."""
        cls_scores, bbox_preds, bbox_preds_refine = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = self._towers(x)
            denom = self.reg_denoms[lvl] \
                if self.bbox_norm_type == 'reg_denom' \
                else self.level_strides[lvl]
            reg = self.vfnet_reg(self.vfnet_reg_conv(reg_feat)).float()
            bbox_pred = torch.exp(self.scales[lvl](reg).clamp(-8, 8)) * denom
            offset = star_offset(bbox_pred, self.level_strides[lvl],
                                 self.gradient_mul)
            refine = self.vfnet_reg_refine(torch.relu(
                self.vfnet_reg_refine_dconv(reg_feat, offset))).float()
            bbox_preds_refine.append(torch.exp(
                self.scales_refine[lvl](refine).clamp(-8, 8)) *
                bbox_pred.detach())
            cls_scores.append(self.vfnet_cls(torch.relu(
                self.vfnet_cls_dconv(cls_feat, offset))).float())
            bbox_preds.append(bbox_pred)
        return cls_scores, bbox_preds, bbox_preds_refine

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        cls_scores, bbox_preds, bbox_preds_refine = outputs
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        cls_flat = flatten_levels(cls_scores)
        points = anchor_center(t['anchors'])[None]
        decoded = distance2bbox(points, flatten_levels(bbox_preds))
        decoded_rf = distance2bbox(points, flatten_levels(bbox_preds_refine))
        tgt = t['bbox_targets']
        pos = t['pos_mask']
        posf = pos.to(torch.float32)
        zero = torch.zeros((), device=cls_flat.device)
        # the positive count of the global batch, clamped once
        num_pos = global_sum(posf.sum()).clamp(min=1.0)

        def giou_loss(loss, boxes):
            """`loss` of `boxes` against the targets, weighted and averaged
            by their detached IoU; returns (loss, the IoU weights)."""
            iou = torch.where(pos, bbox_overlaps(
                boxes.detach(), tgt, is_aligned=True).clamp(min=EPS), zero)
            value = loss(boxes.reshape(-1, 4), tgt.reshape(-1, 4),
                         weight=iou.reshape(-1),
                         avg_factor=global_sum(iou.sum()).clamp(min=1.0))
            return value, iou

        loss_bbox, _ = giou_loss(self.loss_bbox, decoded)
        loss_bbox_rf, iou_rf = giou_loss(self.loss_bbox_refine, decoded_rf)
        # the IoU-aware class target: the refined IoU at the gt's label, 0
        # at every other class and at negatives (label C, the background)
        onehot = F.one_hot(t['labels'], self.cls_out_channels + 1)[
            ..., :self.cls_out_channels].to(cls_flat.dtype)
        cls_iou_targets = onehot * (iou_rf * posf)[..., None]
        loss_cls = self.loss_cls(cls_flat, cls_iou_targets,
                                 avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_bbox_rf=loss_bbox_rf)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """The refined boxes of (cls_scores, bbox_preds, bbox_preds_refine)
        -> dets (B, max_per_img, 5), labels, valid (with_nms=False: boxes
        (B, N, 4) and scores (B, N, C))."""
        cfg = cfg or self.test_cfg
        cls_scores, bbox_preds_refine = outputs[0], outputs[2]
        device = cls_scores[0].device
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        nms_pre = cfg.get('nms_pre', 1000)
        mlvl_centers = self.level_centers(featmap_sizes, device)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        boxes_all: List[torch.Tensor] = []
        scores_all: List[torch.Tensor] = []
        for lvl in range(self.num_levels):
            scores = torch.sigmoid(flatten_level(cls_scores[lvl]))
            reg = flatten_level(bbox_preds_refine[lvl])
            centers = mlvl_centers[lvl].expand(b, -1, 2)
            if nms_pre > 0 and scores.shape[1] > nms_pre:
                _, topk = torch.topk(scores.amax(dim=-1), nms_pre)
                scores = _gather_rows(scores, topk)
                reg = _gather_rows(reg, topk)
                centers = _gather_rows(centers, topk)
            boxes_all.append(distance2bbox(centers, reg, max_shape=img_hw))
            scores_all.append(scores)
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        if rescale and scale_factor is not None:
            sf = torch.as_tensor(scale_factor, dtype=torch.float32,
                                 device=device)
            boxes = boxes / sf[:, None, :]
        if not with_nms:
            return boxes, scores
        return multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            cfg.get('nms', {}).get('iou_threshold', 0.6),
            max_per_img=cfg.get('max_per_img', 100), keep_fn=keep_fn)
