"""The SSD head and its anchors; port of
`ld_tpu/models/heads/ssd_head.py:30-251`, NCHW.

  * `SSDAnchorGenerator`: per level a min and a max size from
    `basesize_ratio_range` (the first level's pair hard-coded per recipe:
    SSD300 COCO 7 / 15 %, VOC 10 / 20 %, SSD512 COCO 4 / 10 %, VOC 7 / 15
    %), anchors centred at stride / 2: the min size and sqrt(min x max) at
    ratio 1, then min x sqrt(r) by min / sqrt(r) for each other ratio (1 /
    r and r of the level's `ratios`). `LegacySSDAnchorGenerator` (mmdet
    1.x) centres them at (stride - 1) / 2. Both are the port's
    `AnchorGenerator` on their own base anchors.
  * `SSDHead`: on each level one 3x3 conv to A x (C + 1) softmax logits
    (the background last) and one to A x 4 deltas, over the levels' own
    channel counts (mmdet's `cls_convs.i` / `reg_convs.i`, plain convs).
  * loss: `MaxIoUAssigner(0.5, 0.5, min_pos_iou=0, gt_max_assign_all=
    False)` on every anchor, the per-anchor CE, and hard-negative mining
    as a rank threshold: each image's negatives ranked by descending CE
    (a stable sort, so equal losses keep the anchor order, as
    `jnp.argsort` keeps it), those of rank < `neg_pos_ratio` x the
    image's positives kept; SmoothL1 (`smoothl1_beta`) of the positives'
    `DeltaXYWHBBoxCoder` deltas (stds 0.1, 0.1, 0.2, 0.2). Both losses
    are sums over the batch divided by its positive count.
  * get_bboxes: the softmax without the background column, every anchor
    decoded and clipped to the image (`test_cfg.nms_pre` and
    `min_bbox_size` are not read, as in the JAX head: ROADMAP.md caveat
    53), then one class-aware `multiclass_nms` (score_thr 0.02, IoU 0.45,
    200 an image), whose keep mask is `nms_keep`: the top 1024 pairs of
    8732 x 80 at SSD300, 24564 x 80 at SSD512.

The JAX converter has no rule for this head's convs, so weights reach the
port from a JAX tree through `state_dict_from_jax` (ROADMAP.md caveat 53).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import Conv2d, lecun_normal_, lowered_dtype
from ld_tpu_torch.ops.anchors import AnchorGenerator
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .gfl_head import flatten_level


class SSDAnchorGenerator(AnchorGenerator):

    def __init__(self, strides, ratios, input_size=300,
                 basesize_ratio_range=(0.15, 0.9), **kwargs):
        # `scale_major` and the rest of mmdet's keys: the one SSD layout
        del kwargs
        self.input_size = input_size
        self.basesize_ratio_range = tuple(basesize_ratio_range)
        num_levels = len(strides)
        min_ratio, max_ratio = (int(r * 100) for r in basesize_ratio_range)
        step = int(np.floor(max_ratio - min_ratio) / (num_levels - 2))
        min_sizes, max_sizes = [], []
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(int(input_size * ratio / 100))
            max_sizes.append(int(input_size * (ratio + step) / 100))
        if input_size == 512 and basesize_ratio_range[0] == 0.1:
            first = (4, 10)       # SSD512 COCO
        elif basesize_ratio_range[0] == 0.15:
            first = (7, 15)       # SSD300 COCO, SSD512 VOC
        else:
            first = (10, 20)      # SSD300 VOC
        min_sizes.insert(0, int(input_size * first[0] / 100))
        max_sizes.insert(0, int(input_size * first[1] / 100))
        self.strides = [s if isinstance(s, (tuple, list)) else (s, s)
                        for s in strides]
        self.centers = self._centers()
        self.base_sizes = self.min_sizes = min_sizes
        self.max_sizes = max_sizes
        self.level_ratios = ratios
        self.base_anchors = [self._ssd_level_anchors(lvl)
                             for lvl in range(num_levels)]

    def _centers(self):
        return [(sx / 2.0, sy / 2.0) for sx, sy in self.strides]

    def _ssd_level_anchors(self, lvl: int) -> np.ndarray:
        mn, mx = self.min_sizes[lvl], self.max_sizes[lvl]
        cx, cy = self.centers[lvl]
        sides = [(mn * s, mn * s) for s in (1.0, float(np.sqrt(mx / mn)))]
        for r in self.level_ratios[lvl]:
            for rr in (1.0 / r, float(r)):
                sides.append((mn * np.sqrt(rr), mn / np.sqrt(rr)))
        return np.asarray([[cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
                           for w, h in sides], np.float32)


class LegacySSDAnchorGenerator(SSDAnchorGenerator):
    """mmdet 1.x's SSD anchors: centred at (stride - 1) / 2."""

    def _centers(self):
        return [((sx - 1) / 2.0, (sy - 1) / 2.0) for sx, sy in self.strides]


@HEADS.register_module()
class SSDHead(nn.Module):

    def __init__(self, num_classes=80,
                 in_channels=(512, 1024, 512, 256, 256, 256),
                 anchor_generator=None, bbox_coder=None, train_cfg=None,
                 test_cfg=None, neg_pos_ratio=3, dtype=None, **kwargs):
        super().__init__()
        self.num_classes = num_classes
        ag = dict(anchor_generator or dict(
            strides=[8, 16, 32, 64, 100, 300],
            ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
            input_size=300, basesize_ratio_range=(0.15, 0.9)))
        ag_type = ag.pop('type', 'SSDAnchorGenerator')
        self.anchor_generator = (
            LegacySSDAnchorGenerator if ag_type.startswith('Legacy')
            else SSDAnchorGenerator)(**ag)
        self.coder = build_coder(bbox_coder or dict(
            type='DeltaXYWHBBoxCoder', target_means=[0., 0., 0., 0.],
            target_stds=[0.1, 0.1, 0.2, 0.2]))
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or dict(
            nms_pre=1000, score_thr=0.02,
            nms=dict(type='nms', iou_threshold=0.45), max_per_img=200)
        a_cfg = dict(self.train_cfg.get('assigner', dict(
            pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0,
            gt_max_assign_all=False)))
        a_cfg.pop('type', None)
        self.assigner = MaxIoUAssigner(**a_cfg)
        self.neg_pos_ratio = self.train_cfg.get('neg_pos_ratio',
                                                neg_pos_ratio)
        self.smoothl1_beta = self.train_cfg.get('smoothl1_beta', 1.0)
        dtype = lowered_dtype(dtype)
        anchors = self.anchor_generator.num_base_anchors
        self.cls_convs = nn.ModuleList(
            Conv2d(c, a * (num_classes + 1), 3, padding=1,
                   compute_dtype=dtype)
            for c, a in zip(in_channels, anchors))
        self.reg_convs = nn.ModuleList(
            Conv2d(c, a * 4, 3, padding=1, compute_dtype=dtype)
            for c, a in zip(in_channels, anchors))

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: lecun-normal kernels, zero biases."""
        with torch.no_grad():
            for m in (*self.cls_convs, *self.reg_convs):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, A*(C+1), H, W),
        bbox_preds (B, A*4, H, W)) per level, float32."""
        return ([conv(x).float() for conv, x in zip(self.cls_convs, feats)],
                [conv(x).float() for conv, x in zip(self.reg_convs, feats)])

    def _flatten(self, cls_scores, bbox_preds):
        b = cls_scores[0].shape[0]
        cls = torch.cat([flatten_level(c).reshape(b, -1, self.num_classes + 1)
                         for c in cls_scores], dim=1)
        reg = torch.cat([flatten_level(r).reshape(b, -1, 4)
                         for r in bbox_preds], dim=1)
        return cls, reg

    def _anchors(self, featmap_sizes, device) -> torch.Tensor:
        return torch.cat(self.anchor_generator.grid_anchors(featmap_sizes,
                                                            device))

    def loss_pieces(self, outputs, batch, featmap_sizes) -> Dict:
        """Assignment, per-anchor CE, the hard-negative keep mask and the
        per-anchor SmoothL1 of a batch, (B, N) each, with what the PISA head
        reweights by (`ld_tpu/models/heads/ssd_head.py:176-217`): the
        anchors (N, 4), the flat logits (B, N, C + 1) and deltas (B, N, 4),
        the targets (B, N, 4), the assigned gt indices and the global
        positive count (clamped at 1)."""
        cls_flat, reg_flat = self._flatten(*outputs)
        anchors = self._anchors(featmap_sizes, cls_flat.device)
        gtb = batch['gt_bboxes']
        res = self.assigner.assign(anchors, None, gtb,
                                   batch['gt_labels'].long(),
                                   batch['gt_valid'],
                                   num_classes=self.num_classes)
        safe = res.assigned_gt_inds.clamp(min=0)
        deltas = self.coder.encode(anchors[None], torch.gather(
            gtb, 1, safe[..., None].expand(-1, -1, 4)))
        pos = res.pos_mask
        posf = pos.to(torch.float32)
        ce = -torch.gather(F.log_softmax(cls_flat, dim=-1), 2,
                           res.labels[..., None])[..., 0]
        # hard negatives: each image's negatives ranked by descending CE
        neg_ce = torch.where(pos, torch.full_like(ce, -float('inf')),
                             ce.detach())
        order = torch.argsort(-neg_ce, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=order.device)
            .expand_as(order))
        neg_keep = ~pos & (rank < self.neg_pos_ratio *
                           posf.sum(dim=1, keepdim=True))
        diff = (reg_flat - deltas).abs()
        beta = self.smoothl1_beta
        sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta,
                          diff - 0.5 * beta).sum(-1)
        return dict(anchors=anchors, cls_flat=cls_flat, reg_flat=reg_flat,
                    labels=res.labels, pos=pos, posf=posf, deltas=deltas,
                    gt_inds=res.assigned_gt_inds,
                    num_pos=global_sum(posf.sum()).clamp(min=1.0), ce=ce,
                    neg_keep=neg_keep, sl1=sl1)

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        t = self.loss_pieces(outputs, batch, featmap_sizes)
        num_pos = t['num_pos']
        cls_w = t['posf'] + t['neg_keep'].to(torch.float32)
        return dict(loss_cls=(t['ce'] * cls_w).sum() / num_pos,
                    loss_bbox=(t['sl1'] * t['posf']).sum() / num_pos)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """(cls_scores, bbox_preds) -> dets (B, max_per_img, 5), labels,
        valid. The JAX head has no `with_nms=False` form (so neither
        package runs SSD's test-time augmentation)."""
        if not with_nms:
            raise NotImplementedError('SSDHead.get_bboxes(with_nms=False)')
        cfg = cfg or self.test_cfg
        cls_scores, bbox_preds = outputs
        device = cls_scores[0].device
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        cls, reg = self._flatten(cls_scores, bbox_preds)
        scores = F.softmax(cls, dim=-1)[..., :self.num_classes]
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        boxes = self.coder.decode(self._anchors(featmap_sizes, device)[None],
                                  reg, max_shape=img_hw)
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(scale_factor, dtype=torch.float32,
                                            device=device)[:, None, :]
        return multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.02),
            cfg.get('nms', {}).get('iou_threshold', 0.45),
            max_per_img=cfg.get('max_per_img', 200), keep_fn=keep_fn)
