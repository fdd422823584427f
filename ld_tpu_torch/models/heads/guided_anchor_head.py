"""Guided Anchoring heads (GA-RetinaNet, GA-RPN); port of
`ld_tpu/models/heads/guided_anchor_head.py:33-372`, NCHW.

  * forward, a level at a time: towers of `stacked_convs` biased 3x3 convs
    with ReLU (`cls_convs.i.conv`, `reg_convs.i.conv`); `conv_loc`, one
    location logit, on the cls tower and `conv_shape`, the anchor's
    (dw, dh), on the reg tower; in each tower a feature adaption: a biased
    1x1 `conv_offset` (2 -> 18: one deform group of 3x3 (dy, dx) pairs) on
    the DETACHED shape prediction, a 3x3 DCNv1 `conv_adaption`
    (`ops.deform_conv.DeformConv`) on the tower's output, ReLU; then the 3x3
    `retina_cls` / `retina_reg` (class logits, box deltas).
  * geometry: squares (one anchor a location) and 9 approx anchors a
    location from two `AnchorGenerator`s; the guided anchors sit at the
    squares' centres with sides octave_base_scale x stride x
    exp(clip(shape, -4, 4)).
  * loss: `loss_loc`, a focal loss on the location logit (label 0 the gt
    region's centre, label 1 background; weights 1 in the centre, 0 in the
    ignore band on the gt's level and its neighbours, 0.1 elsewhere; the
    regions from floor / ceil of `calc_region`), averaged over the centre
    cells; `loss_shape`, BoundedIoU of the live guided anchors against
    their `ApproxMaxIoUAssigner` gts; `loss_cls` / `loss_bbox`, focal and
    smooth L1 on the deltas against the DETACHED guided anchors, assigned
    by `MaxIoUAssigner` image by image, averaged over the positives.
  * get_bboxes: the class sigmoids zeroed where sigmoid(loc) is under
    `loc_filter_thr` (in place of mmdet's masked conv, ROADMAP.md caveat
    48), ONE `nms_pre` top-k over all levels together, the decode against
    the guided anchors clipped to the image, `multiclass_nms`, whose keep
    mask is `nms_keep`.

`GARPNHead`: one class and one conv a tower, the losses renamed
`loss_rpn_*`, and `get_proposals`: one class-agnostic `nms` over all
levels, one `nms_keep` launch for the batch at K = `nms_pre`.

Module names: mmdet's GA-Retina names (`cls_convs.i.conv`, `conv_loc`,
`conv_shape`, `feature_adaption_{cls,reg}.conv_offset` and
`.conv_adaption`, `retina_cls`, `retina_reg`) with the JAX layout: the
offset conv is biased, one deform group. GA-RPN keeps the same names,
since the JAX GA-RPN is the GA-Retina net with two towers (ROADMAP.md
caveat 47); the JAX converter has no GA rule, so weights reach the port
from a JAX tree through `state_dict_from_jax`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d
from ld_tpu_torch.ops.anchors import AnchorGenerator
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.ops.deform_conv import DeformConv
from ld_tpu_torch.ops.extra_assigners import ApproxMaxIoUAssigner
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.ops.nms import batched_nms, multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import _CLS_BIAS_INIT, _gather_rows, flatten_levels
from .retina_gfl_head import ConvReLU

EPS = 1e-6


def calc_region(boxes: torch.Tensor, ratio: float, h: int, w: int):
    """The centre `ratio` of (..., 4) boxes in feature-map coordinates,
    clamped to the map: (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx1 = (1 - ratio) / 2 * (x2 - x1) + x1
    cy1 = (1 - ratio) / 2 * (y2 - y1) + y1
    cx2 = x2 - (1 - ratio) / 2 * (x2 - x1)
    cy2 = y2 - (1 - ratio) / 2 * (y2 - y1)
    return (cx1.clamp(0, w - 1), cy1.clamp(0, h - 1),
            cx2.clamp(0, w - 1), cy2.clamp(0, h - 1))


class FeatureAdaption(nn.Module):
    """`conv_offset` (1x1, biased) on the detached (dw, dh), then the 3x3
    DCNv1 `conv_adaption` of the tower's features at those offsets, ReLU."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv_offset = Conv2d(2, 18, 1, compute_dtype=dtype)
        self.conv_adaption = DeformConv(channels, channels)

    def forward(self, x, shape):
        return torch.relu(self.conv_adaption(
            x, self.conv_offset(shape.detach())))


@HEADS.register_module()
class GARetinaHead(nn.Module):

    cls_pred_name = 'retina_cls'

    def __init__(self, num_classes=80, in_channels=256, feat_channels=256,
                 stacked_convs=4, approx_anchor_generator=None,
                 square_anchor_generator=None, anchor_coder=None,
                 bbox_coder=None, loc_filter_thr=0.01, loss_loc=None,
                 loss_shape=None, loss_cls=None, loss_bbox=None,
                 train_cfg=None, test_cfg=None, dtype=None, **kwargs):
        super().__init__()
        # `anchor_coder` and the other mmdet keys are accepted and not
        # read, as in the JAX head
        self.num_classes = num_classes
        self.cls_out_channels = num_classes
        aag = dict(approx_anchor_generator or dict(
            octave_base_scale=4, scales_per_octave=3,
            ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128]))
        aag.pop('type', None)
        sag = dict(square_anchor_generator or dict(
            ratios=[1.0], scales=[4], strides=[8, 16, 32, 64, 128]))
        sag.pop('type', None)
        self.approx_gen = AnchorGenerator(**aag)
        self.square_gen = AnchorGenerator(**sag)
        self.approxs_per_loc = self.approx_gen.num_base_anchors[0]
        self.octave_base_scale = aag.get('octave_base_scale', 4)
        self.strides = tuple(s if np.isscalar(s) else s[0]
                             for s in sag['strides'])
        self.loc_filter_thr = loc_filter_thr
        self.loss_loc = LOSSES.build(loss_loc or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        self.loss_shape = LOSSES.build(loss_shape or dict(
            type='BoundedIoULoss', beta=0.2, loss_weight=1.0))
        self.loss_cls = LOSSES.build(loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        self.loss_bbox = LOSSES.build(loss_bbox or dict(
            type='SmoothL1Loss', beta=0.04, loss_weight=1.0))
        self.coder = build_coder(bbox_coder or dict(
            type='DeltaXYWHBBoxCoder', target_means=[0.] * 4,
            target_stds=[1.0, 1.0, 1.0, 1.0]))
        self.train_cfg = train_cfg or {}
        self.center_ratio = self.train_cfg.get('center_ratio', 0.2)
        self.ignore_ratio = self.train_cfg.get('ignore_ratio', 0.5)
        self.test_cfg = test_cfg or dict(
            nms_pre=1000, score_thr=0.05,
            nms=dict(type='nms', iou_threshold=0.5), max_per_img=100)
        ga_cfg = dict(self.train_cfg.get('ga_assigner', dict(
            pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)))
        ga_cfg.pop('type', None)
        self.ga_assigner = ApproxMaxIoUAssigner(**ga_cfg)
        a_cfg = dict(self.train_cfg.get('assigner', dict(
            pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)))
        a_cfg.pop('type', None)
        self.assigner = MaxIoUAssigner(**a_cfg)

        self.cls_convs = nn.ModuleList(
            ConvReLU(in_channels if i == 0 else feat_channels, feat_channels,
                     dtype) for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvReLU(in_channels if i == 0 else feat_channels, feat_channels,
                     dtype) for i in range(stacked_convs))
        self.conv_loc = Conv2d(feat_channels, 1, 1, compute_dtype=dtype)
        self.conv_shape = Conv2d(feat_channels, 2, 1, compute_dtype=dtype)
        self.feature_adaption_cls = FeatureAdaption(feat_channels, dtype)
        self.feature_adaption_reg = FeatureAdaption(feat_channels, dtype)
        self.retina_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                                 compute_dtype=dtype)
        self.retina_reg = Conv2d(feat_channels, 4, 3, padding=1,
                                 compute_dtype=dtype)

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: normal(0.01) conv kernels, zero
        biases but the prior-0.01 ones of `conv_loc` and `retina_cls`,
        zero offset convs, he-normal adaption kernels."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                    nn.init.zeros_(m.bias)
            for m in (self.feature_adaption_cls, self.feature_adaption_reg):
                nn.init.zeros_(m.conv_offset.weight)
                m.conv_adaption.init_weights(generator)
            for m in (self.conv_loc, self.retina_cls):
                nn.init.constant_(m.bias, _CLS_BIAS_INIT)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, C, H, W), bbox_preds
        (B, 4, H, W), shape_preds (B, 2, H, W), loc_preds (B, 1, H, W)) per
        level, float32."""
        cls_out, reg_out, shape_out, loc_out = [], [], [], []
        for x in feats:
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            loc = self.conv_loc(c).float()
            shape = self.conv_shape(r).float()
            c = self.feature_adaption_cls(c, shape)
            r = self.feature_adaption_reg(r, shape)
            cls_out.append(self.retina_cls(c).float())
            reg_out.append(self.retina_reg(r).float())
            shape_out.append(shape)
            loc_out.append(loc)
        return cls_out, reg_out, shape_out, loc_out

    # ---- geometry ------------------------------------------------------------
    def geometry(self, featmap_sizes, device):
        """Squares (N, 4), approxs (N, 9, 4), squares per level and the
        squares' stride (N,)."""
        squares = torch.cat(self.square_gen.grid_anchors(featmap_sizes,
                                                         device))
        approxs = torch.cat([
            a.reshape(-1, self.approxs_per_loc, 4)
            for a in self.approx_gen.grid_anchors(featmap_sizes, device)])
        num_lvl = [h * w * n for (h, w), n in
                   zip(featmap_sizes, self.square_gen.num_base_anchors)]
        strides = torch.from_numpy(np.concatenate([
            np.full(n, s, np.float32)
            for n, s in zip(num_lvl, self.strides)])).to(device)
        return squares, approxs, num_lvl, strides

    def guided_anchors(self, squares, shape_flat, strides):
        """Squares (N, 4) and predicted (B, N, 2) (dw, dh) -> the guided
        anchors (B, N, 4)."""
        cx = (squares[:, 0] + squares[:, 2]) / 2
        cy = (squares[:, 1] + squares[:, 3]) / 2
        base = self.octave_base_scale * strides
        w = base * torch.exp(shape_flat[..., 0].clamp(-4, 4))
        h = base * torch.exp(shape_flat[..., 1].clamp(-4, 4))
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           -1)

    def _loc_targets_level(self, gt_bboxes, gt_valid, lvl, num_lvls, h, w,
                           stride):
        """The (B, H*W) location target and weight of one level."""
        scale = torch.sqrt(((gt_bboxes[..., 2] - gt_bboxes[..., 0]) *
                            (gt_bboxes[..., 3] - gt_bboxes[..., 1])
                            ).clamp(min=EPS))
        min_size = self.octave_base_scale * self.strides[0]
        tgt_lvl = torch.floor(torch.log2(scale / min_size) + 0.5).clamp(
            0, num_lvls - 1)
        on_lvl = (tgt_lvl == lvl) & gt_valid
        near_lvl = ((tgt_lvl - lvl).abs() <= 1) & gt_valid
        g = gt_bboxes / stride
        dev = g.device
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        xs = torch.arange(w, dtype=torch.float32, device=dev)

        def region_mask(frac, member):
            x1, y1, x2, y2 = calc_region(g, frac, h, w)
            inx = (xs >= torch.floor(x1)[..., None]) & \
                (xs <= torch.ceil(x2)[..., None])              # (B, G, W)
            iny = (ys >= torch.floor(y1)[..., None]) & \
                (ys <= torch.ceil(y2)[..., None])              # (B, G, H)
            m = iny[..., :, None] & inx[..., None, :] & \
                member[..., None, None]
            return m.any(dim=1).reshape(m.shape[0], -1)

        pos = region_mask(self.center_ratio, on_lvl)
        ignore = region_mask(self.ignore_ratio, near_lvl) & ~pos
        one = torch.ones((), device=dev)
        weight = torch.where(pos, one, torch.where(ignore, 0.0 * one,
                                                   0.1 * one))
        return pos.to(torch.float32), weight

    # ---- loss ----------------------------------------------------------------
    def loss(self, outputs, batch, featmap_sizes,
             generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """The four losses of a padded batch; `generator` is not used (no
        sampler), and is taken for the two-stage detector's RPN call."""
        cls_scores, bbox_preds, shape_preds, loc_preds = outputs
        device = cls_scores[0].device
        squares, approxs, num_lvl, strides = self.geometry(featmap_sizes,
                                                           device)
        gt_bboxes, gt_labels, gt_valid = (batch['gt_bboxes'],
                                          batch['gt_labels'],
                                          batch['gt_valid'])
        cls_flat = flatten_levels(cls_scores, self.cls_out_channels)
        reg_flat = flatten_levels(bbox_preds, 4)
        shape_flat = flatten_levels(shape_preds, 2)
        loc_flat = flatten_levels(loc_preds, 1)

        # ---- location branch ------------------------------------------------
        with torch.no_grad():
            targets = [self._loc_targets_level(
                gt_bboxes, gt_valid, lvl, len(num_lvl), h, w,
                self.strides[lvl])
                for lvl, (h, w) in enumerate(featmap_sizes)]
        loc_t = torch.cat([t for t, _ in targets], dim=1)
        loc_w = torch.cat([wt for _, wt in targets], dim=1)
        n_loc_pos = global_sum(loc_t.sum()).clamp(min=1.0)
        # one 'objectness' class: label 0 the centre, 1 background
        lab = torch.where(loc_t > 0.5, 0, 1)
        loss_loc = self.loss_loc(loc_flat, lab, weight=loc_w,
                                 avg_factor=n_loc_pos)

        # ---- shape branch ----------------------------------------------------
        guided = self.guided_anchors(squares, shape_flat, strides)
        with torch.no_grad():
            res = self.ga_assigner.assign(
                squares, num_lvl, gt_bboxes, gt_labels, gt_valid,
                num_classes=self.num_classes, approxs=approxs)
        posf_s = res.pos_mask.to(torch.float32)
        tgt_s = _gather_rows(gt_bboxes, res.assigned_gt_inds.clamp(min=0))
        loss_shape = self.loss_shape(
            guided.reshape(-1, 4), tgt_s.reshape(-1, 4),
            weight=posf_s.reshape(-1),
            avg_factor=global_sum(posf_s.sum()).clamp(min=1.0))

        # ---- cls / reg on the detached guided anchors ------------------------
        ganchors = guided.detach()
        res = self.assigner.assign(ganchors, num_lvl, gt_bboxes, gt_labels,
                                   gt_valid, num_classes=self.num_classes)
        posf = res.pos_mask.to(torch.float32)
        num_pos = global_sum(posf.sum()).clamp(min=1.0)
        loss_cls = self.loss_cls(cls_flat, res.labels, avg_factor=num_pos)
        deltas = self.coder.encode(ganchors, _gather_rows(
            gt_bboxes, res.assigned_gt_inds.clamp(min=0)))
        loss_bbox = self.loss_bbox(
            reg_flat.reshape(-1, 4), deltas.reshape(-1, 4),
            weight=posf.reshape(-1, 1).expand(-1, 4), avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_shape=loss_shape, loss_loc=loss_loc)

    # ---- inference -------------------------------------------------------------
    def _flat_outputs(self, outputs):
        """-> guided anchors (B, N, 4), class probabilities zeroed off the
        location filter (B, N, C), deltas (B, N, 4)."""
        cls_scores, bbox_preds, shape_preds, loc_preds = outputs
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        squares, _, _, strides = self.geometry(featmap_sizes,
                                               cls_scores[0].device)
        ganch = self.guided_anchors(squares, flatten_levels(shape_preds, 2),
                                    strides)
        keep = torch.sigmoid(flatten_levels(loc_preds, 1)) >= \
            self.loc_filter_thr
        scores = torch.sigmoid(flatten_levels(
            cls_scores, self.cls_out_channels)) * keep
        return ganch, scores, flatten_levels(bbox_preds, 4)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """Detections (B, max_per_img, 5), labels, valid (with_nms=False:
        boxes (B, k, 4) and scores (B, k, C))."""
        cfg = cfg or self.test_cfg
        ganch, scores, reg = self._flat_outputs(outputs)
        device = scores.device
        npre = min(cfg.get('nms_pre', 1000), scores.shape[1])
        _, idx = torch.topk(scores.amax(dim=-1), npre)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        boxes = self.coder.decode(_gather_rows(ganch, idx),
                                  _gather_rows(reg, idx), max_shape=img_hw)
        scores = _gather_rows(scores, idx)
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(
                scale_factor, dtype=torch.float32, device=device)[:, None, :]
        if not with_nms:
            return boxes, scores
        return multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            cfg.get('nms', {}).get('iou_threshold', 0.5),
            max_per_img=cfg.get('max_per_img', 100), keep_fn=keep_fn)


@HEADS.register_module()
class GARPNHead(GARetinaHead):
    """The class-agnostic guided-anchor RPN: one 'objectness' class, one
    conv a tower; proposals from one class-agnostic NMS. As in the JAX
    head, its cls loss takes the gts' own labels, so that only class-0
    gts make objectness positives (ROADMAP.md caveat 51)."""

    def __init__(self, in_channels=256, **kwargs):
        kwargs.setdefault('num_classes', 1)
        kwargs.setdefault('stacked_convs', 1)
        super().__init__(in_channels=in_channels, **kwargs)

    def loss(self, outputs, batch, featmap_sizes,
             generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """The GA losses under `loss_rpn_*` names, so that the RoI head's
        `loss_cls` / `loss_bbox` keep theirs."""
        raw = super().loss(outputs, batch, featmap_sizes, generator)
        return {k.replace('loss_', 'loss_rpn_', 1): v for k, v in raw.items()}

    def get_proposals(self, outputs, img_hw, cfg=None, keep_fn=nms_keep):
        """(B, max_per_img, 4) proposals (zeros where invalid) and their
        (B, max_per_img) validity: each image's `nms_pre` top-scored
        decoded guided anchors of every level, one NMS for the batch."""
        cfg = cfg or self.test_cfg
        ganch, scores, reg = self._flat_outputs(outputs)
        scores = scores[..., 0]
        npre = min(cfg.get('nms_pre', 1000), scores.shape[1])
        top, idx = torch.topk(scores, npre)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32,
                                 device=scores.device)
        boxes = self.coder.decode(_gather_rows(ganch, idx),
                                  _gather_rows(reg, idx), max_shape=img_hw)
        kidx, valid = batched_nms(
            boxes, top, cfg.get('nms', {}).get('iou_threshold', 0.7),
            cfg.get('max_per_img', 1000), keep_fn=keep_fn)
        props = _gather_rows(boxes, kidx)
        return torch.where(valid[..., None], props,
                           torch.zeros_like(props)), valid
