"""GFL head (Generalized Focal Loss V1, arXiv:2006.04388).

Port of `ld_tpu/models/heads/gfl_head.py:39-104` (towers), `:200-311`
(targets and losses) and `:314-387` (`get_bboxes`), NCHW:

  * forward: one shared stack of 3x3 conv + GroupNorm + ReLU blocks per branch
    applied to every FPN level, `gfl_cls` / `gfl_reg` 3x3 convs, and a
    learnable scalar per level on the reg output (`scales.i.scale`);
  * loss: ATSS targets for the whole batch, then QFL + GIoU + DFL as ONE
    dense masked computation over the flattened (batch, all-level anchors)
    axis, with a per-anchor stride: the same sums as the reference's
    per-level loops over gathered positives. The positive count is the
    batch total, clamped once; the IoU quality target and the max-class
    weight are detached;
  * get_bboxes: per level, the `nms_pre` top-k on the max class score (the
    LOGIT when the sigmoid comes after, as here), integral decode x stride,
    `distance2bbox` clipped to the image, optional rescale, then class-aware
    `multiclass_nms`, batched over images. The sigmoid is applied only when
    the scores are logits (`use_sigmoid_cls`, or the caller's `use_sigmoid`):
    the GFLv2 heads and the heads that fold a centerness in hand over
    probabilities.

Module names are mmdet's (`cls_convs.i.{conv,gn}`, `gfl_cls`, `gfl_reg`,
`scales.i.scale`). The other GFL-family heads subclass this one and replace
`_build_predictors` / `forward` (and the towers, for Retina).

A compute `dtype` lowers the towers' convs and GroupNorms and the
prediction convs (JAX `gfl_head.py:39-104`). Each prediction comes out cast
to float32, and the level scale multiplies the float32 reg output, as JAX
promotes the lowered conv output against its float32 scale before any
rounding. Parameters, predictions and losses stay float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d, GroupNorm, lowered_dtype
from ld_tpu_torch.ops.anchors import AnchorGenerator
from ld_tpu_torch.ops.boxes import (anchor_center, bbox2distance,
                                    bbox_overlaps, distance2bbox)
from ld_tpu_torch.ops.integral import integral
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.utils.registry import ASSIGNERS, HEADS, LOSSES

_CLS_BIAS_INIT = float(-math.log((1 - 0.01) / 0.01))  # prior prob 0.01


class ConvGNBlock(nn.Module):
    """3x3 conv (no bias) + GroupNorm(min(32, C), eps 1e-5) + ReLU, in
    `dtype`."""

    def __init__(self, in_channels, out_channels, groups=32, dtype=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, padding=1,
                           bias=False, compute_dtype=dtype)
        self.gn = GroupNorm(min(groups, out_channels), out_channels,
                            eps=1e-5, compute_dtype=dtype)

    def forward(self, x):
        return torch.relu(self.gn(self.conv(x)))


class Scale(nn.Module):
    """A learnable scalar (mmcv Scale: a 0-dim `scale` parameter). A
    bfloat16 tensor times it stays bfloat16 in torch, where JAX promotes to
    float32: a lowered head casts to float32 first."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32))

    def forward(self, x):
        return x * self.scale


def flatten_level(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (B, H*W, C), the row-major anchor order of the generator."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)


def flatten_levels(xs: Sequence[torch.Tensor], per_anchor: int = None
                   ) -> torch.Tensor:
    """[(B, A*c, H, W)] per level -> (B, sum(H*W*A), c), the anchor minor
    (`c` = `per_anchor`, or all channels with one anchor)."""
    b = xs[0].shape[0]
    return torch.cat([flatten_level(x).reshape(b, -1, per_anchor or
                                               x.shape[1]) for x in xs],
                     dim=1)


@HEADS.register_module()
class GFLHead(nn.Module):

    def __init__(self,
                 num_classes,
                 in_channels,
                 stacked_convs=4,
                 feat_channels=256,
                 anchor_generator=None,
                 loss_cls=None,
                 loss_dfl=None,
                 loss_bbox=None,
                 reg_max=16,
                 train_cfg=None,
                 test_cfg=None,
                 norm_cfg=None,
                 conv_cfg=None,
                 level_pack=False,
                 dtype=None,
                 **kwargs):
        super().__init__()
        if conv_cfg is not None or (norm_cfg or {}).get('type', 'GN') != 'GN':
            raise NotImplementedError('GFLHead conv_cfg / non-GN norm_cfg are '
                                      'not ported to ld_tpu_torch yet')
        if kwargs:
            raise TypeError(f'unexpected GFLHead arguments {sorted(kwargs)}')
        self.num_classes = num_classes
        self.cls_out_channels = num_classes
        self.reg_max = reg_max
        ag = dict(anchor_generator or dict(
            ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
            strides=[8, 16, 32, 64, 128]))
        ag_type = ag.pop('type', 'AnchorGenerator')
        if ag_type != 'AnchorGenerator':
            raise NotImplementedError(f'{ag_type} is not ported to '
                                      'ld_tpu_torch yet (see ROADMAP.md)')
        self.anchor_generator = AnchorGenerator(**ag)
        self.num_levels = self.anchor_generator.num_levels
        loss_cls = loss_cls or dict(
            type='QualityFocalLoss', use_sigmoid=True, beta=2.0,
            loss_weight=1.0)
        self.use_sigmoid_cls = loss_cls.get('use_sigmoid', True)
        self.loss_cls = LOSSES.build(loss_cls)
        self.loss_dfl = LOSSES.build(loss_dfl or dict(
            type='DistributionFocalLoss', loss_weight=0.25))
        self.loss_bbox = LOSSES.build(loss_bbox or dict(
            type='GIoULoss', loss_weight=2.0))
        self.train_cfg = train_cfg or {}
        self.assigner = ASSIGNERS.build(dict(self.train_cfg.get(
            'assigner', dict(type='ATSSAssigner', topk=9))))
        self.test_cfg = test_cfg or dict(
            nms_pre=1000, score_thr=0.05,
            nms=dict(type='nms', iou_threshold=0.6), max_per_img=100)
        # level_pack is the JAX package's one-canvas TPU tower: same
        # parameters and outputs, so there is nothing to port
        del level_pack
        self.num_anchors = self.anchor_generator.num_base_anchors[0]
        # the towers' and prediction convs' compute dtype (None: float32)
        self.compute_dtype = lowered_dtype(dtype)
        self._build_towers(in_channels, feat_channels, stacked_convs,
                           (norm_cfg or {}).get('num_groups', 32))
        self._build_predictors(feat_channels)

    # the prediction conv that carries the prior-0.01 bias
    cls_pred_name = 'gfl_cls'

    def _build_towers(self, in_channels, feat_channels, stacked_convs,
                      groups):
        self.cls_convs = nn.ModuleList(
            ConvGNBlock(in_channels if i == 0 else feat_channels,
                        feat_channels, groups, self.compute_dtype)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvGNBlock(in_channels if i == 0 else feat_channels,
                        feat_channels, groups, self.compute_dtype)
            for i in range(stacked_convs))

    def _pred_conv(self, in_channels, out_channels, kernel_size=3):
        """A biased prediction conv in the head's compute dtype."""
        return Conv2d(in_channels, out_channels, kernel_size,
                      padding=kernel_size // 2,
                      compute_dtype=self.compute_dtype)

    def _build_predictors(self, feat_channels):
        self.gfl_cls = self._pred_conv(feat_channels, self.num_classes)
        self.gfl_reg = self._pred_conv(feat_channels, 4 * (self.reg_max + 1))
        self.scales = nn.ModuleList(Scale(1.0)
                                    for _ in range(self.num_levels))

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers: normal(0.01) conv kernels, zero
        conv biases but the prior-0.01 one of the cls prediction conv, GN
        scale 1 / bias 0, scales 1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    m.reset_parameters()
            nn.init.constant_(getattr(self, self.cls_pred_name).bias,
                              _CLS_BIAS_INIT)
            for s in getattr(self, 'scales', ()):
                s.scale.fill_(1.0)

    def _towers(self, x):
        """One level through the cls and the reg tower."""
        cls_feat, reg_feat = x, x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        return cls_feat, reg_feat

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores, bbox_preds), NCHW per level."""
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = self._towers(x)
            cls_scores.append(self.gfl_cls(cls_feat).float())
            bbox_preds.append(self.scales[lvl](self.gfl_reg(reg_feat).float()))
        return cls_scores, bbox_preds

    # ---- geometry ----------------------------------------------------------
    def level_geometry(self, featmap_sizes, device):
        """All-level anchors (N, 4), anchors per level, and the per-anchor
        stride (N,) float32 and level id (N,) int64."""
        mlvl = self.anchor_generator.grid_anchors(featmap_sizes, device)
        num_lvl = [a.shape[0] for a in mlvl]
        strides = torch.cat([
            torch.full((n, ), float(s[0]), device=device)
            for n, s in zip(num_lvl, self.anchor_generator.strides)])
        level_id = torch.cat([
            torch.full((n, ), i, dtype=torch.int64, device=device)
            for i, n in enumerate(num_lvl)])
        return torch.cat(mlvl), num_lvl, strides, level_id

    # ---- targets -----------------------------------------------------------
    def build_targets(self, featmap_sizes, gt_bboxes, gt_labels, gt_valid,
                      img_hw) -> Dict:
        """ATSS targets of a batch: gt_bboxes (B, G, 4), gt_labels (B, G),
        gt_valid (B, G) bool, img_hw (B, 2)."""
        device = gt_bboxes.device
        anchors, num_lvl, strides, level_id = self.level_geometry(
            featmap_sizes, device)
        valid = torch.stack([
            torch.cat(self.anchor_generator.valid_flags(featmap_sizes, hw,
                                                        device))
            for hw in img_hw])                                      # (B, N)
        res = self.assigner.assign(anchors, num_lvl, gt_bboxes, gt_labels,
                                   gt_valid, valid,
                                   num_classes=self.num_classes)
        safe = res.assigned_gt_inds.clamp(min=0)
        bbox_targets = torch.gather(gt_bboxes, 1,
                                    safe[..., None].expand(-1, -1, 4))
        bbox_targets = torch.where(res.pos_mask[..., None], bbox_targets,
                                   torch.zeros_like(bbox_targets))
        return dict(labels=res.labels, pos_mask=res.pos_mask,
                    bbox_targets=bbox_targets, anchor_valid=valid,
                    anchors=anchors, strides=strides, level_id=level_id,
                    num_level_anchors=num_lvl,
                    assigned_gt_inds=res.assigned_gt_inds)

    # ---- loss --------------------------------------------------------------
    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        """QFL + GIoU + DFL of the head outputs (per-level NCHW lists)
        against the batch's padded gts."""
        cls_scores, bbox_preds = outputs
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        core = self._core_losses(flatten_levels(cls_scores),
                                 flatten_levels(bbox_preds), t)
        return {k: core[k] for k in ('loss_cls', 'loss_bbox', 'loss_dfl')}

    def _core_losses(self, cls_score, bbox_pred, t) -> Dict:
        """Dense masked QFL + GIoU + DFL over (B, N) anchors.

        Returns the loss dict plus the intermediates the LD head reuses.
        """
        pos = t['pos_mask']
        strides = t['strides']                                     # (N,)
        posf = pos.to(torch.float32)
        label_weights = t['anchor_valid'].to(torch.float32)

        # the batch-total positive count, clamped ONCE (the reference's
        # reduce_mean(num_total_pos).clamp(min=1)); a per-image clamp would
        # inflate the denominator whenever an image has no gt
        num_total_samples = posf.sum().clamp(min=1.0)

        centers = anchor_center(t['anchors'])[None] / strides[None, :, None]
        pred_corners = bbox_pred.reshape(*bbox_pred.shape[:-1], 4,
                                         self.reg_max + 1)
        pred_dist = integral(bbox_pred, self.reg_max)              # (B, N, 4)
        decoded = distance2bbox(centers, pred_dist)                # (B, N, 4)
        target_boxes = t['bbox_targets'] / strides[None, :, None]

        zero = torch.zeros((), device=cls_score.device)
        # quality target: IoU(decoded, target) on positives, detached
        score = torch.where(pos, bbox_overlaps(decoded.detach(), target_boxes,
                                               is_aligned=True), zero)
        # weight: the max class score on positives, detached
        cls_prob = torch.sigmoid(cls_score) if self.use_sigmoid_cls \
            else cls_score
        weight_targets = torch.where(pos, cls_prob.detach().amax(dim=-1),
                                     zero)
        avg_factor = weight_targets.sum() + 1e-6

        loss_cls = self.loss_cls(cls_score, (t['labels'], score),
                                 weight=label_weights,
                                 avg_factor=num_total_samples)
        loss_bbox = self.loss_bbox(decoded.reshape(-1, 4),
                                   target_boxes.reshape(-1, 4),
                                   weight=weight_targets.reshape(-1),
                                   avg_factor=avg_factor)
        target_corners = bbox2distance(centers, target_boxes,
                                       max_dis=self.reg_max)       # (B, N, 4)
        w4 = weight_targets[..., None].expand(target_corners.shape)
        loss_dfl = self.loss_dfl(
            pred_corners.reshape(-1, self.reg_max + 1),
            target_corners.reshape(-1), weight=w4.reshape(-1),
            avg_factor=4.0 * avg_factor)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_dfl=loss_dfl,
                    pos=pos, posf=posf, label_weights=label_weights,
                    weight_targets=weight_targets, avg_factor=avg_factor,
                    pred_corners=pred_corners, centers=centers,
                    decoded=decoded, num_total_samples=num_total_samples)

    def level_centers(self, featmap_sizes, device) -> List[torch.Tensor]:
        """The decode's points per level, (H*W*A, 2) each: anchor centres."""
        return [anchor_center(a) for a in
                self.anchor_generator.grid_anchors(featmap_sizes, device)]

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep,
                   use_sigmoid=None):
        """Decode head outputs into final detections.

        Args:
            outputs: (cls_scores, bbox_preds) lists of NCHW tensors.
            img_hw: (B, 2) image (h, w) for box clipping.
            scale_factor: (B, 4) resize factors for rescale to original.
            keep_fn: the keep-mask function handed to `multiclass_nms`,
                `nms_keep` (the kernel on the card).
            use_sigmoid: whether `cls_scores` are logits that want a sigmoid
                (default `use_sigmoid_cls`); False for probabilities.
        Returns:
            dets (B, max_per_img, 5), labels (B, max_per_img), valid mask;
            with_nms=False: boxes (B, N, 4) and scores (B, N, C).
        """
        cfg = cfg or self.test_cfg
        if use_sigmoid is None:
            use_sigmoid = self.use_sigmoid_cls
        cls_scores, bbox_preds = outputs[0], outputs[1]
        device = cls_scores[0].device
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        nms_pre = cfg.get('nms_pre', 1000)
        mlvl_centers = self.level_centers(featmap_sizes, device)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)

        boxes_all: List[torch.Tensor] = []
        scores_all: List[torch.Tensor] = []
        for lvl in range(self.num_levels):
            scores = flatten_level(cls_scores[lvl]).reshape(
                b, -1, self.cls_out_channels)                     # (B, n, C)
            pred = flatten_level(bbox_preds[lvl]).reshape(
                b, -1, 4 * (self.reg_max + 1))                    # (B, n, 68)
            centers = mlvl_centers[lvl].expand(b, -1, 2)
            n = scores.shape[1]
            if nms_pre > 0 and n > nms_pre:
                # top-k BEFORE sigmoid/integral: sigmoid is monotonic, so
                # ranking raw logits picks the same nms_pre set
                _, topk = torch.topk(scores.amax(dim=-1), nms_pre)
                scores = _gather_rows(scores, topk)
                pred = _gather_rows(pred, topk)
                centers = _gather_rows(centers, topk)
            stride = float(self.anchor_generator.strides[lvl][0])
            dist = integral(pred, self.reg_max) * stride
            boxes_all.append(distance2bbox(centers, dist, max_shape=img_hw))
            scores_all.append(torch.sigmoid(scores) if use_sigmoid
                              else scores)
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        if rescale and scale_factor is not None:
            sf = torch.as_tensor(scale_factor, dtype=torch.float32,
                                 device=device)
            boxes = boxes / sf[:, None, :]
        if not with_nms:
            return boxes, scores
        nms_cfg = dict(cfg.get('nms', dict(type='nms', iou_threshold=0.6)))
        return multiclass_nms(boxes, scores, cfg.get('score_thr', 0.05),
                              nms_cfg.pop('iou_threshold', 0.6),
                              max_per_img=cfg.get('max_per_img', 100),
                              nms_cfg=nms_cfg, keep_fn=keep_fn)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, D), idx (B, k) -> (B, k, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
