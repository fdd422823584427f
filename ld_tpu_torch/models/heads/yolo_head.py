"""YOLOv3 neck and head; port of `ld_tpu/models/heads/yolo_head.py:30-241`,
NCHW.

  * `YOLOV3Neck` (registered in NECKS): the backbone's maps deepest first;
    a `DetectionBlock` (five `ConvBNLeaky`: 1x1, 3x3 at twice the width,
    1x1, 3x3, 1x1) on the deepest; then for each shallower map a 1x1
    lateral conv of the last block's output, nearest x2 upsampling, its
    concatenation before the map, and the next block. Out: the blocks'
    outputs, strides 32, 16, 8.
  * `YOLOV3Head`: per level a 3x3 `ConvBNLeaky` bridge to twice the width
    and a biased 1x1 prediction to A x (5 + C) channels, anchor-major:
    (x, y, w, h, objectness, C classes) for each of the level's A anchors.
  * decode: centre (sigmoid(x) + column) x stride, (sigmoid(y) + row) x
    stride; size exp(clip(w, -10, 8)) x the anchor's width, and so the
    height; score = sigmoid(class) x sigmoid(objectness). `get_bboxes`
    takes per level the `nms_pre` top-k by the largest score (always, so
    the candidates come in score order), then class-aware `multiclass_nms`
    (its keep mask `nms_keep`); `conf_thr` and `min_bbox_size` are not
    read (ROADMAP.md caveat 88).
  * loss: each gt goes to its best anchor of all nine by wh-IoU; on that
    anchor's level the gt's centre cell at that anchor is its positive.
    BCE on the centre offset within the cell (clipped to [1e-4, 1 - 1e-4])
    and on the one-hot class, squared error on log(gt size / anchor size),
    BCE objectness on every cell but the negatives whose decoded box has an
    IoU over `ignore_iou_thr` with a gt; each sum over the batch and the
    levels divided by the batch's positives (caveat 87). `GridAssigner`
    and `MSELoss` are registered and not called, as in JAX.

Every `ConvBNLeaky` of the neck and the head runs its BN on its
statistics, in training too (the JAX default `norm_eval=True`: caveat 86).
Module names are mmdet's: `neck.detect{i}.conv{1..5}.{conv,bn}`,
`neck.conv{i}` (the laterals), `bbox_head.convs_bridge.{i}`,
`bbox_head.convs_pred.{i}`; `state_dict_from_jax` carries a JAX tree to
them (the JAX converter has no YOLO rule).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.backbones.darknet import ConvBNLeaky
from ld_tpu_torch.models.backbones.resnet import init_trunk_weights
from ld_tpu_torch.models.layers import Conv2d, lecun_normal_, lowered_dtype
from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS, NECKS
from .gfl_head import _gather_rows

DEFAULT_ANCHORS = (((116, 90), (156, 198), (373, 326)),
                   ((30, 61), (62, 45), (59, 119)),
                   ((10, 13), (16, 30), (33, 23)))


def _bce(logit: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return logit.clamp(min=0) - logit * target + \
        torch.log1p(torch.exp(-logit.abs()))


class DetectionBlock(nn.Module):

    def __init__(self, in_channels, out_channels, dtype=None):
        super().__init__()
        c = out_channels
        for i, (c_in, c_out, k) in enumerate(((in_channels, c, 1),
                                              (c, 2 * c, 3), (2 * c, c, 1),
                                              (c, 2 * c, 3), (2 * c, c, 1)),
                                             1):
            self.add_module(f'conv{i}', ConvBNLeaky(c_in, c_out, k,
                                                    dtype=dtype))

    def forward(self, x):
        for i in range(1, 6):
            x = getattr(self, f'conv{i}')(x)
        return x


@NECKS.register_module()
class YOLOV3Neck(nn.Module):

    def __init__(self, num_scales=3, in_channels=(1024, 512, 256),
                 out_channels=(512, 256, 128), dtype=None):
        super().__init__()
        self.num_scales = num_scales
        self.detect1 = DetectionBlock(in_channels[0], out_channels[0], dtype)
        for i in range(1, num_scales):
            self.add_module(f'conv{i}', ConvBNLeaky(
                out_channels[i - 1], out_channels[i], 1, dtype=dtype))
            self.add_module(f'detect{i + 1}', DetectionBlock(
                in_channels[i] + out_channels[i], out_channels[i], dtype))

    def init_weights(self, generator: torch.Generator):
        init_trunk_weights(self, generator)

    def forward(self, feats):
        """The backbone's maps, shallowest first -> the blocks' outputs,
        deepest first."""
        feats = list(feats)[::-1]
        x = self.detect1(feats[0])
        outs = [x]
        for i in range(1, self.num_scales):
            t = F.interpolate(getattr(self, f'conv{i}')(x), scale_factor=2,
                              mode='nearest')
            x = getattr(self, f'detect{i + 1}')(torch.cat([t, feats[i]], 1))
            outs.append(x)
        return tuple(outs)


@HEADS.register_module()
class YOLOV3Head(nn.Module):

    def __init__(self, num_classes=80, in_channels=(512, 256, 128),
                 anchor_generator=None, featmap_strides=(32, 16, 8),
                 ignore_iou_thr=0.5, train_cfg=None, test_cfg=None,
                 dtype=None, **kwargs):
        super().__init__()
        # mmdet's other keys (the coder, the loss configs, one_hot_smoother)
        # are accepted and not read, as in the JAX head
        self.num_classes = num_classes
        self.strides = tuple(featmap_strides)
        base = (anchor_generator or {}).get('base_sizes', DEFAULT_ANCHORS)
        self.anchor_sizes = tuple(tuple(tuple(a) for a in lvl)
                                  for lvl in base)
        self.num_anchors = len(self.anchor_sizes[0])
        self.ignore_iou_thr = ignore_iou_thr
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or dict(
            nms_pre=1000, score_thr=0.05, conf_thr=0.005,
            nms=dict(type='nms', iou_threshold=0.45), max_per_img=100)
        dtype = lowered_dtype(dtype)
        self.convs_bridge = nn.ModuleList(
            ConvBNLeaky(c, 2 * c, 3, dtype=dtype) for c in in_channels)
        self.convs_pred = nn.ModuleList(
            Conv2d(2 * c, self.num_anchors * (5 + num_classes), 1,
                   compute_dtype=dtype) for c in in_channels)

    def init_weights(self, generator: torch.Generator):
        """The JAX initializers: lecun-normal convs, zero biases, BN scale
        1 / bias 0 / statistics 0 and 1."""
        init_trunk_weights(self.convs_bridge, generator)
        with torch.no_grad():
            for m in self.convs_pred:
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats deepest first -> ([(B, A x (5 + C), H, W)] float32, )."""
        return ([pred(bridge(x)).float() for x, bridge, pred in
                 zip(feats, self.convs_bridge, self.convs_pred)], )

    # ---- decode ---------------------------------------------------------------
    def _level(self, pred: torch.Tensor) -> torch.Tensor:
        """(B, A x (5 + C), H, W) -> (B, H, W, A, 5 + C)."""
        b, _, h, w = pred.shape
        return pred.permute(0, 2, 3, 1).reshape(b, h, w, self.num_anchors,
                                                5 + self.num_classes)

    def _anchor_wh(self, lvl, device):
        sizes = torch.tensor(self.anchor_sizes[lvl], dtype=torch.float32,
                             device=device)
        return sizes[:, 0], sizes[:, 1]

    def decode_level(self, pred: torch.Tensor, lvl: int):
        """-> boxes (B, H x W x A, 4), objectness (B, N), classes (B, N, C)
        probabilities."""
        p = self._level(pred)
        b, h, w = p.shape[:3]
        stride = self.strides[lvl]
        dev = p.device
        gx = torch.arange(w, dtype=torch.float32, device=dev)[:, None]
        gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
        cx = (torch.sigmoid(p[..., 0]) + gx) * stride
        cy = (torch.sigmoid(p[..., 1]) + gy) * stride
        aw, ah = self._anchor_wh(lvl, dev)
        bw = torch.exp(p[..., 2].clamp(-10, 8)) * aw
        bh = torch.exp(p[..., 3].clamp(-10, 8)) * ah
        boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2], -1).reshape(b, -1, 4)
        obj = torch.sigmoid(p[..., 4]).reshape(b, -1)
        cls = torch.sigmoid(p[..., 5:]).reshape(b, -1, self.num_classes)
        return boxes, obj, cls

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """Detections (B, max_per_img, 5), labels, valid (with_nms=False:
        the candidates' boxes (B, k, 4) and scores (B, k, C))."""
        cfg = cfg or self.test_cfg
        boxes_all, scores_all = [], []
        for lvl, pred in enumerate(outputs[0]):
            boxes, obj, cls = self.decode_level(pred, lvl)
            scores = cls * obj[..., None]
            k = min(cfg.get('nms_pre', 1000), scores.shape[1])
            _, top = torch.topk(scores.amax(dim=-1), k)
            boxes_all.append(_gather_rows(boxes, top))
            scores_all.append(_gather_rows(scores, top))
        boxes = torch.cat(boxes_all, 1)
        scores = torch.cat(scores_all, 1)
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(
                scale_factor, dtype=torch.float32,
                device=boxes.device)[:, None, :]
        if not with_nms:
            return boxes, scores
        return multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            cfg.get('nms', {}).get('iou_threshold', 0.45),
            max_per_img=cfg.get('max_per_img', 100), keep_fn=keep_fn)

    # ---- loss -----------------------------------------------------------------
    def loss(self, outputs, batch, featmap_sizes=None
             ) -> Dict[str, torch.Tensor]:
        losses = dict(loss_xy=0.0, loss_wh=0.0, loss_obj=0.0, loss_cls=0.0)
        total_pos = 0.0
        for lvl, pred in enumerate(outputs[0]):
            out = self._loss_level(pred, batch['gt_bboxes'],
                                   batch['gt_labels'], batch['gt_valid'],
                                   lvl)
            for k in losses:
                losses[k] = losses[k] + out[k]
            total_pos = total_pos + out['num_pos']
        norm = global_sum(total_pos).clamp(min=1.0)
        return {k: v / norm for k, v in losses.items()}

    def _loss_level(self, pred, gt_bboxes, gt_labels, gt_valid, lvl):
        """One level's sums over the batch: each gt is this level's if its
        best anchor of all nine by wh-IoU is one of this level's."""
        p = self._level(pred)
        b, h, w, a = p.shape[:4]
        stride = self.strides[lvl]
        dev = p.device
        gw = (gt_bboxes[..., 2] - gt_bboxes[..., 0]).clamp(min=1e-3)
        gh = (gt_bboxes[..., 3] - gt_bboxes[..., 1]).clamp(min=1e-3)
        sizes = torch.tensor([s for lv in self.anchor_sizes for s in lv],
                             dtype=torch.float32, device=dev)      # (9, 2)
        inter = torch.minimum(gw[..., None], sizes[:, 0]) * \
            torch.minimum(gh[..., None], sizes[:, 1])
        union = (gw * gh)[..., None] + sizes[:, 0] * sizes[:, 1] - inter
        best = (inter / union.clamp(min=1e-6)).argmax(dim=-1)      # (B, G)
        own_anchor = best % a
        responsible = (best // a == lvl) & gt_valid
        rf = responsible.to(torch.float32)

        gcx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2 / stride
        gcy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2 / stride
        gi = gcx.to(torch.int64).clamp(0, w - 1)
        gj = gcy.to(torch.int64).clamp(0, h - 1)
        cell = (gj * w + gi) * a + own_anchor                       # (B, G)
        obj_t = torch.zeros((b, h * w * a), device=dev).scatter_reduce(
            1, cell, rf, 'amax')
        tx = (gcx - gi).clamp(1e-4, 1 - 1e-4)
        ty = (gcy - gj).clamp(1e-4, 1 - 1e-4)
        aw, ah = self._anchor_wh(lvl, dev)
        twh_w = torch.log((gw / aw[own_anchor]).clamp(min=1e-6))
        twh_h = torch.log((gh / ah[own_anchor]).clamp(min=1e-6))

        # the negatives of high IoU with a gt are ignored for objectness
        with torch.no_grad():
            boxes = self.decode_level(pred, lvl)[0]
            ious = bbox_overlaps(boxes, gt_bboxes)
            ious = torch.where(gt_valid[:, None, :], ious,
                               torch.zeros_like(ious)).amax(dim=-1)
        obj_w = ((obj_t > 0) | (ious <= self.ignore_iou_thr)).to(
            torch.float32)
        loss_obj = (_bce(p[..., 4].reshape(b, -1), obj_t) * obj_w).sum()

        # the positives, gathered a gt at a time
        pp = _gather_rows(p.reshape(b, -1, p.shape[-1]), cell)     # (B, G, .)
        loss_xy = ((_bce(pp[..., 0], tx) + _bce(pp[..., 1], ty)) * rf).sum()
        loss_wh = (((pp[..., 2] - twh_w) ** 2 + (pp[..., 3] - twh_h) ** 2) *
                   rf).sum()
        onehot = (gt_labels.long()[..., None] == torch.arange(
            self.num_classes, device=dev)).to(torch.float32)
        loss_cls = (_bce(pp[..., 5:], onehot).sum(-1) * rf).sum()
        return dict(loss_xy=loss_xy, loss_wh=loss_wh, loss_obj=loss_obj,
                    loss_cls=loss_cls, num_pos=rf.sum())
