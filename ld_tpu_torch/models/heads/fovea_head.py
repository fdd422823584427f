"""The FoveaBox head (anchor-free, log-space corner regression); port of
`ld_tpu/models/heads/fovea_head.py:30-220`, NCHW.

  * forward, a level at a time: `stacked_convs` 3x3 conv + GroupNorm +
    ReLU blocks in each tower (`cls_convs.i`, `reg_convs.i`; always GN,
    whatever the config's `norm_cfg` says: ROADMAP.md caveat 54), `conv_reg`
    (4 log offsets) and `conv_cls` (C logits, prior bias 0.01). With
    `with_deform` (FoveaBox-align) the cls tower's output goes through
    `feature_adaption` before `conv_cls`: its `conv_offset` (a biased 1x1
    conv, zero at init) maps exp(clip(reg, -8, 8)) to 18 offsets, a (dy,
    dx) pair a tap, one deform group, and its `conv_adaption` (the port's
    caller-offset `DeformConv`, plain torch as in the JAX package) and a
    ReLU warp the cls features onto the predicted fovea. The offsets are
    not detached: the gradient reaches `conv_reg` through the exp.
  * targets: the points (i + 0.5) x stride of every level; each gt goes to
    every level whose scale range holds sqrt(w x h) (the ranges overlap);
    a point is positive for a gt when it lies in the gt's box shrunk by
    `sigma` (0.4) about its centre, and among several the smallest-area gt
    wins (the first index on a tie, `argmin`); the targets are
    log(clip((point - corner) / base_edge, 1/16, 16)).
  * loss: sigmoid focal (gamma 1.5, alpha 0.4) over the batch's positive
    count, SmoothL1 (beta 0.11, weight 0.75) of the positives' targets
    over 4 x that count.
  * get_bboxes: per level the `nms_pre` top-k on the point's largest class
    score, the boxes point -+ exp(clip(reg, -4, 4)) x base_edge clipped to
    the image, then one class-aware `multiclass_nms` whose keep mask is
    `nms_keep`.

Module names follow mmdet's (`cls_convs.i.{conv,gn}`, `reg_convs.i.
{conv,gn}`, `conv_cls`, `conv_reg`, `feature_adaption.{conv_offset,
conv_adaption}`). The JAX converter has no rule for this head: weights
reach the port from a JAX tree through `state_dict_from_jax` (ROADMAP.md
caveat 54).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d, lowered_dtype
from ld_tpu_torch.ops.deform_conv import DeformConv
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import (_CLS_BIAS_INIT, ConvGNBlock, flatten_level,
                       flatten_levels)
from .retina_head import classic_decode

INF = 1e8
DEFAULT_SCALE_RANGES = ((1, 64), (32, 128), (64, 256), (128, 512),
                        (256, 2048))
DEFAULT_BASE_EDGES = (16, 32, 64, 128, 256)


class FeatureAlign(nn.Module):
    """FoveaBox-align's warp of the cls features: offsets from the
    exponentiated regression (`conv_offset`), a caller-offset 3x3 DCN
    (`conv_adaption`) and a ReLU."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv_offset = Conv2d(4, 18, 1, compute_dtype=dtype)
        self.conv_adaption = DeformConv(channels, channels)

    def forward(self, x, reg):
        offset = self.conv_offset(torch.exp(reg.clamp(-8.0, 8.0)))
        return torch.relu(self.conv_adaption(x, offset))


@HEADS.register_module()
class FoveaHead(nn.Module):

    cls_pred_name = 'conv_cls'

    def __init__(self, num_classes=80, in_channels=256, feat_channels=256,
                 stacked_convs=4, strides=(8, 16, 32, 64, 128),
                 base_edge_list=DEFAULT_BASE_EDGES,
                 scale_ranges=DEFAULT_SCALE_RANGES, sigma=0.4,
                 with_deform=False, loss_cls=None, loss_bbox=None,
                 train_cfg=None, test_cfg=None, dtype=None, **kwargs):
        super().__init__()
        # norm_cfg and mmdet's other keys: the towers are always GN, as in
        # the JAX head (caveat 54)
        del kwargs
        self.num_classes = num_classes
        self.cls_out_channels = num_classes
        self.strides = tuple(strides)
        self.base_edges = tuple(base_edge_list)
        self.scale_ranges = tuple(tuple(r) for r in scale_ranges)
        self.sigma = sigma
        self.with_deform = with_deform
        self.loss_cls = LOSSES.build(loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=1.5, alpha=0.4,
            loss_weight=1.0))
        self.loss_bbox = LOSSES.build(loss_bbox or dict(
            type='SmoothL1Loss', beta=0.11, loss_weight=0.75))
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or dict(
            nms_pre=1000, score_thr=0.05,
            nms=dict(type='nms', iou_threshold=0.5), max_per_img=100)
        dtype = lowered_dtype(dtype)

        def tower():
            return nn.ModuleList(
                ConvGNBlock(in_channels if i == 0 else feat_channels,
                            feat_channels, dtype=dtype)
                for i in range(stacked_convs))
        self.cls_convs = tower()
        self.reg_convs = tower()
        self.conv_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                               compute_dtype=dtype)
        self.conv_reg = Conv2d(feat_channels, 4, 3, padding=1,
                               compute_dtype=dtype)
        if with_deform:
            self.feature_adaption = FeatureAlign(feat_channels, dtype)

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: normal(0.01) tower, cls and reg
        kernels, zero biases but the cls prior, GN 1 / 0; the align's
        offset conv zero, its DCN he-normal."""
        with torch.no_grad():
            for m in (*self.cls_convs, *self.reg_convs):
                nn.init.normal_(m.conv.weight, 0.0, 0.01, generator=generator)
                m.gn.reset_parameters()
            for m in (self.conv_cls, self.conv_reg):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                nn.init.zeros_(m.bias)
            nn.init.constant_(self.conv_cls.bias, _CLS_BIAS_INIT)
            if self.with_deform:
                nn.init.zeros_(self.feature_adaption.conv_offset.weight)
                nn.init.zeros_(self.feature_adaption.conv_offset.bias)
                self.feature_adaption.conv_adaption.init_weights(generator)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, C, H, W), bbox_preds
        (B, 4, H, W) log offsets) per level, float32."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            reg = self.conv_reg(r).float()
            if self.with_deform:
                c = self.feature_adaption(c, reg)
            cls_scores.append(self.conv_cls(c).float())
            bbox_preds.append(reg)
        return cls_scores, bbox_preds

    def level_points(self, featmap_sizes, device) -> List[torch.Tensor]:
        """Per level the (H*W, 3) points: x, y at (i + 0.5) x stride, and
        the level's base edge."""
        out = []
        for lvl, (h, w) in enumerate(featmap_sizes):
            s = self.strides[lvl]
            xs = np.tile((np.arange(w) + 0.5) * s, h)
            ys = np.repeat((np.arange(h) + 0.5) * s, w)
            pts = np.stack([xs, ys, np.full(h * w, self.base_edges[lvl])],
                           -1).astype(np.float32)
            out.append(torch.from_numpy(pts).to(device))
        return out

    def targets(self, featmap_sizes, gt_bboxes, gt_labels, gt_valid):
        """Dense FoveaBox targets of a batch: labels (B, N) (C where
        negative), log-offset targets (B, N, 4) (0 where negative) and the
        positive mask (B, N)."""
        device = gt_bboxes.device
        points = torch.cat(self.level_points(featmap_sizes, device))
        lvl_id = torch.cat([torch.full((h * w, ), lvl, device=device)
                            for lvl, (h, w) in enumerate(featmap_sizes)])
        ranges = torch.tensor(self.scale_ranges, dtype=torch.float32,
                              device=device)[lvl_id]
        w = gt_bboxes[..., 2] - gt_bboxes[..., 0]
        h = gt_bboxes[..., 3] - gt_bboxes[..., 1]
        area = w * h
        edge = torch.sqrt(area.clamp(min=1e-6))[:, None, :]      # (B, 1, G)
        in_range = (edge >= ranges[None, :, 0:1]) & \
            (edge <= ranges[None, :, 1:2])                       # (B, N, G)
        cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
        cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
        half_w, half_h = 0.5 * self.sigma * w, 0.5 * self.sigma * h
        px = points[None, :, 0:1]
        py = points[None, :, 1:2]
        inside = (px >= (cx - half_w)[:, None, :]) & \
            (px <= (cx + half_w)[:, None, :]) & \
            (py >= (cy - half_h)[:, None, :]) & \
            (py <= (cy + half_h)[:, None, :])
        cand = inside & in_range & gt_valid[:, None, :]
        areas = torch.where(cand, area[:, None, :],
                            torch.full_like(cand, INF, dtype=area.dtype))
        best_area, best = areas.min(dim=-1)     # the first index on a tie
        pos = best_area < INF / 2
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best),
                             torch.full_like(best, self.num_classes))
        gb = torch.gather(gt_bboxes, 1, best[..., None].expand(-1, -1, 4))
        x, y, base = points[:, 0], points[:, 1], points[:, 2]
        t = torch.stack([x - gb[..., 0], y - gb[..., 1], gb[..., 2] - x,
                         gb[..., 3] - y], -1) / base[:, None]
        t = torch.log(t.clamp(1.0 / 16, 16.0))
        return labels, torch.where(pos[..., None], t,
                                   torch.zeros_like(t)), pos

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        labels, targets, pos = self.targets(
            featmap_sizes, batch['gt_bboxes'], batch['gt_labels'],
            batch['gt_valid'])
        cls_flat = flatten_levels(outputs[0])
        reg_flat = flatten_levels(outputs[1])
        posf = pos.to(torch.float32)
        # the positive count of the global batch, clamped once
        num_pos = global_sum(posf.sum()).clamp(min=1.0)
        loss_cls = self.loss_cls(cls_flat, labels, avg_factor=num_pos)
        loss_bbox = self.loss_bbox(
            reg_flat.reshape(-1, 4), targets.reshape(-1, 4),
            weight=posf.reshape(-1, 1).expand(-1, 4),
            avg_factor=num_pos * 4.0)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """(cls_scores, bbox_preds) -> dets (B, max_per_img, 5), labels,
        valid. The JAX head has no `with_nms=False` form (so neither
        package runs FoveaBox's test-time augmentation)."""
        if not with_nms:
            raise NotImplementedError('FoveaHead.get_bboxes(with_nms=False)')
        cls_scores, bbox_preds = outputs
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        scores = [torch.sigmoid(flatten_level(c)) for c in cls_scores]
        regs = [flatten_level(r) for r in bbox_preds]
        return classic_decode(
            scores, regs, self.level_points(featmap_sizes,
                                            cls_scores[0].device),
            fovea_decode, img_hw, scale_factor, rescale,
            cfg or self.test_cfg, 0.5, keep_fn)


def fovea_decode(points: torch.Tensor, reg: torch.Tensor,
                 img_hw: torch.Tensor) -> torch.Tensor:
    """Boxes (B, k, 4) of (B, k, 3) points (x, y, base edge) and (B, k, 4)
    log offsets, clipped to each image's (h, w)."""
    t = torch.exp(reg.clamp(-4.0, 4.0)) * points[..., 2:3]
    x, y = points[..., 0], points[..., 1]
    h, w = img_hw[:, 0:1], img_hw[:, 1:2]
    zero = torch.zeros((), dtype=reg.dtype, device=reg.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)
    return torch.stack([clip(x - t[..., 0], w), clip(y - t[..., 1], h),
                        clip(x + t[..., 2], w), clip(y + t[..., 3], h)], -1)
