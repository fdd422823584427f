"""TOOD head (task-aligned one-stage detection); port of
`ld_tpu/models/heads/tood_head.py:32-281`, NCHW.

  * forward, a level at a time: `stacked_convs` (6) shared 3x3 conv + GN +
    ReLU `inter_convs`, their outputs stacked on the channels (sc x C);
    two `TaskDecomposition`s (`cls_decomp`, `reg_decomp`): a per-image layer
    attention (global mean, 1x1 to sc x C / 8, ReLU, 1x1 to sc, sigmoid)
    that scales each stacked feature, then one 1x1 reduction to C (in
    float32), GN and ReLU; `tood_cls` logits and the `cls_prob_module`
    probability map (1x1 to C / 4, ReLU, 3x3 to 1) give the score
    sqrt(sigmoid(logit) x sigmoid(prob) + 1e-12); `tood_reg` distances
    exp(clip(reg x scale, -8, 8)) in stride units about the cell centre
    (x + 0.5, y + 0.5), their box map read again at the
    `reg_offset_module`'s (dy, dx) by a bilinear gather that is zero
    outside the map (`bilinear_shift`), the initial box kept where the
    shifted one is inverted (ROADMAP.md caveat 84).
  * loss: `TaskAlignedAssigner` on the detached scores and decoded boxes
    (ROADMAP.md caveat 85); each positive's metric over its gt's largest,
    times that gt's largest IoU, is the target of an activated QFL written
    inline (`loss_cls`, over the targets' sum) and the weight of the GIoU
    (`loss_bbox`); `QualityFocalLoss(activated=True)` is built and not
    called, as in the JAX head (caveat 83).
  * get_bboxes: per level the `nms_pre` top-k on the largest class score,
    the boxes x stride clipped to the image, optional rescale, then
    class-aware `multiclass_nms` (its keep mask `nms_keep`).

Module names are mmdet's (`inter_convs.i.{conv,gn}`,
`{cls,reg}_decomp.layer_attention.{0,2}`,
`{cls,reg}_decomp.reduction_conv.{conv,gn}`, `tood_cls`, `tood_reg`,
`cls_prob_module.{0,2}`, `reg_offset_module.{0,2}`, `scales.i.scale`); the
JAX (sc x C, C) `reduction_kernel` is the 1x1 conv's weight transposed.
The JAX converter has no TOOD rule: `state_dict_from_jax` carries a JAX
tree to the port.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import (Conv2d, GroupNorm, he_normal_,
                                        lecun_normal_)
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .gfl_head import (_CLS_BIAS_INIT, ConvGNBlock, GFLHead, Scale,
                       _gather_rows, flatten_levels)

EPS = 1e-6


def sigmoid_geometric_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sigmoid(a) * torch.sigmoid(b) + 1e-12)


def bilinear_shift(feat: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """`feat` (B, C, H, W) read bilinearly at (y + dy, x + dx), `off`
    (B, 2, H, W) = (dy, dx); a corner outside the map reads zero."""
    b, c, h, w = feat.shape
    dev = feat.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + off[:, 0]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + off[:, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    flat = feat.reshape(b, c, h * w)

    def gather(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        out = torch.gather(flat, 2, idx.reshape(b, 1, -1).expand(b, c, -1))
        return out.reshape(b, c, h, w) * ok[:, None]

    return (gather(y0, x0) * ((1 - wy) * (1 - wx))[:, None] +
            gather(y0, x0 + 1) * ((1 - wy) * wx)[:, None] +
            gather(y0 + 1, x0) * (wy * (1 - wx))[:, None] +
            gather(y0 + 1, x0 + 1) * (wy * wx)[:, None])


class ConvGN(nn.Module):
    """mmcv's ConvModule of a 1x1 conv without bias and a GN: `conv`,
    `gn`."""

    def __init__(self, in_channels, out_channels, dtype=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1, bias=False,
                           compute_dtype=dtype)
        self.gn = GroupNorm(min(32, out_channels), out_channels, eps=1e-5,
                            compute_dtype=dtype)


class TaskDecomposition(nn.Module):
    """Layer attention over the stacked features, folded into the 1x1
    reduction, then GN and ReLU."""

    def __init__(self, feat_channels, stacked_convs, la_down_rate=8,
                 dtype=None):
        super().__init__()
        c, sc = feat_channels, stacked_convs
        self.feat_channels, self.stacked_convs = c, sc
        self.layer_attention = nn.Sequential(
            Conv2d(sc * c, sc * c // la_down_rate, 1, compute_dtype=dtype),
            nn.ReLU(inplace=True),
            Conv2d(sc * c // la_down_rate, sc, 1, compute_dtype=dtype),
            nn.Sigmoid())
        self.reduction_conv = ConvGN(sc * c, c, dtype)

    def init_weights(self, generator: torch.Generator):
        """The JAX initializers: lecun-normal attention convs with zero
        biases, a he-normal reduction kernel, GN scale 1 / bias 0."""
        for i in (0, 2):
            lecun_normal_(self.layer_attention[i].weight, generator)
            nn.init.zeros_(self.layer_attention[i].bias)
        he_normal_(self.reduction_conv.conv.weight, generator)
        self.reduction_conv.gn.reset_parameters()

    def forward(self, feat: torch.Tensor, avg_feat: torch.Tensor):
        """feat (B, sc x C, H, W), avg_feat (B, sc x C, 1, 1)."""
        b, _, h, w = feat.shape
        sc, c = self.stacked_convs, self.feat_channels
        att = self.layer_attention(avg_feat).float()             # (B, sc, 1, 1)
        scaled = feat.float().reshape(b, sc, c, h, w) * att[:, :, None]
        out = F.conv2d(scaled.reshape(b, sc * c, h, w),
                       self.reduction_conv.conv.weight.float())
        return torch.relu(self.reduction_conv.gn(out))


@HEADS.register_module()
class TOODHead(GFLHead):

    cls_pred_name = 'tood_cls'

    def __init__(self, num_classes, in_channels, stacked_convs=6,
                 anchor_type='anchor_free', loss_cls=None, loss_bbox=None,
                 train_cfg=None, **kwargs):
        # `anchor_type` is accepted and not read, as in the JAX head
        del anchor_type
        kwargs.setdefault('anchor_generator', dict(
            ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
            strides=[8, 16, 32, 64, 128]))
        train_cfg = dict(train_cfg or {})
        a_cfg = dict(train_cfg.get('assigner') or dict(topk=13, alpha=1.0,
                                                       beta=6.0))
        a_cfg.setdefault('type', 'TaskAlignedAssigner')
        train_cfg['assigner'] = a_cfg
        super().__init__(
            num_classes, in_channels, stacked_convs=max(stacked_convs, 2),
            loss_cls=loss_cls or dict(type='QualityFocalLoss',
                                      use_sigmoid=True, activated=True,
                                      beta=2.0, loss_weight=1.0),
            loss_bbox=loss_bbox or dict(type='GIoULoss', loss_weight=2.0),
            train_cfg=train_cfg, **kwargs)

    def _build_towers(self, in_channels, feat_channels, stacked_convs,
                      groups):
        self.stacked_convs = stacked_convs
        self.inter_convs = nn.ModuleList(
            ConvGNBlock(in_channels if i == 0 else feat_channels,
                        feat_channels, 32, self.compute_dtype)
            for i in range(stacked_convs))

    def _build_predictors(self, feat_channels):
        c, sc, d = feat_channels, self.stacked_convs, self.compute_dtype
        self.cls_decomp = TaskDecomposition(c, sc, 8, d)
        self.reg_decomp = TaskDecomposition(c, sc, 8, d)
        self.tood_cls = self._pred_conv(c, self.num_classes)
        self.tood_reg = self._pred_conv(c, 4)
        self.cls_prob_module = nn.Sequential(
            Conv2d(sc * c, c // 4, 1, compute_dtype=d), nn.ReLU(inplace=True),
            Conv2d(c // 4, 1, 3, padding=1, compute_dtype=d))
        self.reg_offset_module = nn.Sequential(
            Conv2d(sc * c, c // 4, 1, compute_dtype=d), nn.ReLU(inplace=True),
            Conv2d(c // 4, 2, 3, padding=1, compute_dtype=d))
        self.scales = nn.ModuleList(Scale(1.0)
                                    for _ in range(self.num_levels))

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: normal(0.01) inter convs and
        predictions (`tood_cls` with the prior-0.01 bias), lecun-normal
        branch convs (`cls_prob_module.2` with the prior bias), a zero
        `reg_offset_module.2`, the decompositions' own, scales 1."""
        with torch.no_grad():
            for m in (*(b.conv for b in self.inter_convs), self.tood_cls,
                      self.tood_reg):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
            for b in self.inter_convs:
                b.gn.reset_parameters()
            for m in (self.cls_prob_module[0], self.cls_prob_module[2],
                      self.reg_offset_module[0]):
                lecun_normal_(m.weight, generator)
            for m in (self.tood_reg, self.cls_prob_module[0],
                      self.reg_offset_module[0]):
                nn.init.zeros_(m.bias)
            for m in (self.tood_cls, self.cls_prob_module[2]):
                nn.init.constant_(m.bias, _CLS_BIAS_INIT)
            nn.init.zeros_(self.reg_offset_module[2].weight)
            nn.init.zeros_(self.reg_offset_module[2].bias)
            self.cls_decomp.init_weights(generator)
            self.reg_decomp.init_weights(generator)
            for s in self.scales:
                s.scale.fill_(1.0)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, C, H, W) probabilities,
        bbox_preds (B, 4, H, W) xyxy boxes in stride units), float32."""
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            inter = []
            for conv in self.inter_convs:
                x = conv(x)
                inter.append(x)
            feat = torch.cat(inter, 1)
            avg = feat.mean(dim=(2, 3), keepdim=True)
            logits = self.tood_cls(self.cls_decomp(feat, avg).to(
                x.dtype)).float()
            prob = self.cls_prob_module(feat).float()
            cls_scores.append(sigmoid_geometric_mean(logits, prob))
            dist = torch.exp(self.scales[lvl](self.tood_reg(
                self.reg_decomp(feat, avg).to(x.dtype)).float()).clamp(-8, 8))
            h, w = dist.shape[-2:]
            dev = dist.device
            cx = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
            cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[
                :, None]
            box = torch.stack([cx - dist[:, 0], cy - dist[:, 1],
                               cx + dist[:, 2], cy + dist[:, 3]], 1)
            box_r = bilinear_shift(box,
                                   self.reg_offset_module(feat).float())
            invalid = (box_r[:, 0] > box_r[:, 2]) | (box_r[:, 1] > box_r[:, 3])
            bbox_preds.append(torch.where(invalid[:, None], box, box_r))
        return cls_scores, bbox_preds

    # ---- loss ----------------------------------------------------------------
    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        cls_scores, bbox_preds = outputs
        device = cls_scores[0].device
        anchors, _, strides, _ = self.level_geometry(featmap_sizes, device)
        cls_flat = flatten_levels(cls_scores)                  # probabilities
        box_flat = flatten_levels(bbox_preds) * strides[None, :, None]
        gtb, gtl, gtv = batch['gt_bboxes'], batch['gt_labels'], \
            batch['gt_valid']
        valid = torch.stack([
            torch.cat(self.anchor_generator.valid_flags(featmap_sizes, hw,
                                                        device))
            for hw in batch['img_hw']])                             # (B, N)
        with torch.no_grad():
            res, align = self.assigner.assign(
                cls_flat.detach(), box_flat.detach(), anchors, gtb, gtl, gtv,
                valid, num_classes=self.num_classes)
            pos = res.pos_mask
            safe = res.assigned_gt_inds.clamp(min=0)
            # the normalised alignment metric of each positive (TOOD's TAL)
            own = torch.where(pos, torch.gather(align, 2, safe[..., None])[
                ..., 0], torch.zeros_like(res.max_overlaps))
            g = gtb.shape[1]
            onehot = (safe[..., None] == torch.arange(g, device=device)) & \
                pos[..., None]
            zero = torch.zeros((), device=device)
            max_t = torch.where(onehot, own[..., None], zero).amax(dim=1)
            max_iou = torch.where(onehot, res.max_overlaps[..., None],
                                  zero).amax(dim=1)
            norm_t = own / torch.gather(max_t, 1, safe).clamp(min=EPS) * \
                torch.gather(max_iou, 1, safe)
            norm_t = torch.where(pos, norm_t, zero)
        avg = global_sum(norm_t.sum()).clamp(min=1.0)
        # the activated QFL, target the normalised metric
        score_t = F.one_hot(res.labels, self.num_classes + 1)[
            ..., :self.num_classes].to(cls_flat.dtype) * norm_t[..., None]
        sig = cls_flat
        mod = (score_t - sig).abs() ** 2.0
        bce = -(score_t * torch.log(sig.clamp(min=EPS)) +
                (1 - score_t) * torch.log((1 - sig).clamp(min=EPS)))
        loss_cls = (bce * mod * valid[..., None]).sum() / avg
        loss_bbox = self.loss_bbox(
            box_flat.reshape(-1, 4), _gather_rows(gtb, safe).reshape(-1, 4),
            weight=norm_t.reshape(-1), avg_factor=avg)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    # ---- inference -------------------------------------------------------------
    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """Detections (B, max_per_img, 5), labels, valid (with_nms=False:
        the candidates' boxes (B, k, 4) and scores (B, k, C))."""
        cfg = cfg or self.test_cfg
        cls_scores, bbox_preds = outputs
        nms_pre = cfg.get('nms_pre', 1000)
        device = cls_scores[0].device
        hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        boxes_all, scores_all = [], []
        for lvl, (cls, box) in enumerate(zip(cls_scores, bbox_preds)):
            scores = flatten_levels([cls])
            boxes = flatten_levels([box]) * float(
                self.anchor_generator.strides[lvl][0])
            if 0 < nms_pre < scores.shape[1]:
                _, top = torch.topk(scores.amax(dim=-1), nms_pre)
                scores, boxes = _gather_rows(scores, top), _gather_rows(
                    boxes, top)
            w, h = hw[:, 1, None], hw[:, 0, None]
            zero = torch.zeros((), device=device)
            boxes = torch.stack([
                torch.minimum(torch.maximum(boxes[..., 0], zero), w),
                torch.minimum(torch.maximum(boxes[..., 1], zero), h),
                torch.minimum(torch.maximum(boxes[..., 2], zero), w),
                torch.minimum(torch.maximum(boxes[..., 3], zero), h)], -1)
            boxes_all.append(boxes)
            scores_all.append(scores)
        boxes = torch.cat(boxes_all, 1)
        scores = torch.cat(scores_all, 1)
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(
                scale_factor, dtype=torch.float32, device=device)[:, None, :]
        if not with_nms:
            return boxes, scores
        return multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            cfg.get('nms', {}).get('iou_threshold', 0.6),
            max_per_img=cfg.get('max_per_img', 100), keep_fn=keep_fn)
