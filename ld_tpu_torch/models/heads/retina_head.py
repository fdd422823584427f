"""The plain RetinaNet head (delta regression, no distributions); port of
`ld_tpu/models/heads/retina_head.py:23-219`, NCHW.

  * `RetinaHead(RetinaGFLHead)`: 9 anchors a location, towers of biased 3x3
    convs with ReLU (`cls_convs.i.conv`, `reg_convs.i.conv`), `retina_cls`
    (A x C logits) and `retina_reg` (A x 4 deltas): mmdet's names;
  * loss (the Retina-GFL targets: MaxIoU under the configs' train_cfg):
    focal cls over the valid anchors and `loss_bbox` (L1 by default) on the
    `DeltaXYWHBBoxCoder` deltas of the positives, both averaged over the
    batch's positive count. As in the JAX head the loss is always on the
    deltas, whatever `reg_decoded_bbox` says;
  * get_bboxes: per level the `nms_pre` top-k on the max class sigmoid, the
    coder's decode clipped to the image, optional rescale, `multiclass_nms`
    (IoU 0.5 unless `test_cfg.nms` says otherwise).

`RetinaSepBNHead` (NAS-FPN's): the tower convs shared by the levels, a
BatchNorm of its own a level.

`classic_decode` is the decode loop the classic heads share.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from ld_tpu_torch.models.layers import BatchNorm2d, Conv2d
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .gfl_head import _gather_rows, flatten_level, flatten_levels
from .retina_gfl_head import RetinaGFLHead


def classic_decode(scores: List[torch.Tensor], regs: List[torch.Tensor],
                   priors: List[torch.Tensor], decode: Callable, img_hw,
                   scale_factor, rescale, cfg, iou_default: float,
                   keep_fn=nms_keep):
    """Detections of per-level (B, n, C) probabilities and (B, n, 4)
    regressions at (n, d) priors (anchors or points): per level the
    `nms_pre` top-k on the max class score, `decode(priors (B, k, d), regs
    (B, k, 4), img_hw (B, 2))`, then `multiclass_nms` over the levels."""
    b = scores[0].shape[0]
    device = scores[0].device
    nms_pre = cfg.get('nms_pre', 1000)
    img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
    boxes_all, scores_all = [], []
    for s, r, p in zip(scores, regs, priors):
        p = p.expand(b, *p.shape)
        if 0 < nms_pre < s.shape[1]:
            _, topk = torch.topk(s.amax(dim=-1), nms_pre)
            s, r, p = (_gather_rows(x, topk) for x in (s, r, p))
        boxes_all.append(decode(p, r, img_hw))
        scores_all.append(s)
    boxes = torch.cat(boxes_all, dim=1)
    if rescale and scale_factor is not None:
        boxes = boxes / torch.as_tensor(scale_factor, dtype=torch.float32,
                                        device=device)[:, None, :]
    return multiclass_nms(boxes, torch.cat(scores_all, dim=1),
                          cfg.get('score_thr', 0.05),
                          cfg.get('nms', {}).get('iou_threshold',
                                                 iou_default),
                          max_per_img=cfg.get('max_per_img', 100),
                          keep_fn=keep_fn)


@HEADS.register_module()
class RetinaHead(RetinaGFLHead):

    cls_pred_name = 'retina_cls'

    def __init__(self, num_classes, in_channels, bbox_coder=None,
                 loss_bbox=None, **kwargs):
        super().__init__(num_classes, in_channels, loss_bbox=loss_bbox or dict(
            type='L1Loss', loss_weight=1.0), **kwargs)
        self.coder = build_coder(bbox_coder or dict(
            type='DeltaXYWHBBoxCoder', target_means=[0., 0., 0., 0.],
            target_stds=[1.0, 1.0, 1.0, 1.0]))

    def _build_predictors(self, feat_channels):
        a = self.num_anchors
        self.retina_cls = self._pred_conv(feat_channels, a * self.num_classes)
        self.retina_reg = self._pred_conv(feat_channels, a * 4)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, A*C, H, W), bbox_preds
        (B, A*4, H, W)) per level."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            cls_feat, reg_feat = self._towers(x)
            cls_scores.append(self.retina_cls(cls_feat).float())
            bbox_preds.append(self.retina_reg(reg_feat).float())
        return cls_scores, bbox_preds

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        cls_flat = flatten_levels(outputs[0], self.cls_out_channels)
        reg_flat = flatten_levels(outputs[1], 4)
        posf = t['pos_mask'].to(torch.float32)
        # the global batch's positive count, clamped once
        num_total = global_sum(posf.sum()).clamp(min=1.0)
        loss_cls = self.loss_cls(cls_flat, t['labels'],
                                 weight=t['anchor_valid'].to(torch.float32),
                                 avg_factor=num_total)
        deltas = self.coder.encode(t['anchors'][None], t['bbox_targets'])
        loss_bbox = self.loss_bbox(
            reg_flat.reshape(-1, 4), deltas.reshape(-1, 4),
            weight=posf.reshape(-1, 1).expand(-1, 4), avg_factor=num_total)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        cls_scores, bbox_preds = outputs
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        anchors = self.anchor_generator.grid_anchors(
            featmap_sizes, cls_scores[0].device)
        scores = [torch.sigmoid(flatten_level(c).reshape(
            b, -1, self.cls_out_channels)) for c in cls_scores]
        regs = [flatten_level(r).reshape(b, -1, 4) for r in bbox_preds]
        return classic_decode(
            scores, regs, anchors,
            lambda a, r, hw: self.coder.decode(a, r, max_shape=hw), img_hw,
            scale_factor, rescale, cfg or self.test_cfg, 0.5, keep_fn)


class ConvBNReLU(nn.Module):
    """A (shared) conv, its level's own BatchNorm, ReLU (mmcv ConvModule:
    `.conv`, `.bn`)."""

    def __init__(self, conv, channels, dtype=None):
        super().__init__()
        self.conv = conv
        self.bn = BatchNorm2d(channels, eps=1e-5, compute_dtype=dtype)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


@HEADS.register_module()
class RetinaSepBNHead(RetinaHead):
    """The NAS-FPN Retina head: each tower conv shared by the levels, a
    BatchNorm of its own a level (`cls_convs.{level}.{i}.{conv,bn}`, the
    conv one module under every level's name, as mmdet aliases it). The
    BatchNorms take the batch's statistics in train mode and their running
    ones in eval, as the JAX net's."""

    def __init__(self, num_classes, num_ins=5, in_channels=256, **kwargs):
        self.num_ins = num_ins
        super().__init__(num_classes, in_channels, **kwargs)

    def _build_towers(self, in_channels, feat_channels, stacked_convs,
                      groups):
        def tower():
            convs = [Conv2d(in_channels if i == 0 else feat_channels,
                            feat_channels, 3, padding=1, bias=False,
                            compute_dtype=self.compute_dtype)
                     for i in range(stacked_convs)]
            return nn.ModuleList(nn.ModuleList(
                ConvBNReLU(conv, feat_channels, self.compute_dtype)
                for conv in convs) for _ in range(self.num_ins))
        self.cls_convs = tower()
        self.reg_convs = tower()

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for m in self.cls_convs[lvl]:
                cls_feat = m(cls_feat)
            for m in self.reg_convs[lvl]:
                reg_feat = m(reg_feat)
            cls_scores.append(self.retina_cls(cls_feat).float())
            bbox_preds.append(self.retina_reg(reg_feat).float())
        return cls_scores, bbox_preds
