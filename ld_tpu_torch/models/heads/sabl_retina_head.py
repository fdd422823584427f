"""The SABL RetinaNet head (side-aware boundary localization); port of
`ld_tpu/models/heads/sabl_retina_head.py`, NCHW.

  * The net: towers of biased 3x3 convs with ReLU (`cls_convs.i.conv`,
    `reg_convs.i.conv`), `retina_cls` (C logits), `retina_bbox_cls` and
    `retina_bbox_reg` (4 x side_num bucket logits and offsets), one square
    anchor a location.
  * Assignment: `ApproxMaxIoUAssigner` of the squares over their 9 approx
    anchors (0.5 / 0.4 / 0.0 unless the config says otherwise); the
    targets are the `BucketingBBoxCoder` encode of the assigned gt.
  * Losses: focal over the valid squares at the batch's positive count
    (clamped once, over every rank); the bucket BCE and the offsets'
    SmoothL1 over the positives at count x 4 x side_num and
    count x 4 x offset_topk.
  * Decode: per level the `nms_pre` top-k on the max class sigmoid, the
    bucket decode clipped to the image, the scores times its confidence,
    one `multiclass_nms` (IoU 0.5 unless the config says otherwise).

`norm_cfg` is accepted and not read, as in the JAX head, whose net has
plain biased convs: the `*_gn_*` configs compute plain towers (ROADMAP.md
caveat 57); the port warns.
"""
from __future__ import annotations

import warnings
from typing import Dict, Sequence

import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d, lowered_dtype
from ld_tpu_torch.ops.anchors import AnchorGenerator
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.ops.extra_assigners import ApproxMaxIoUAssigner
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import (_CLS_BIAS_INIT, _gather_rows, flatten_level,
                       flatten_levels)
from .retina_gfl_head import ConvReLU


@HEADS.register_module()
class SABLRetinaHead(nn.Module):

    cls_pred_name = 'retina_cls'

    def __init__(self, num_classes=80, in_channels=256, stacked_convs=4,
                 feat_channels=256, approx_anchor_generator=None,
                 square_anchor_generator=None, bbox_coder=None,
                 loss_cls=None, loss_bbox_cls=None, loss_bbox_reg=None,
                 train_cfg=None, test_cfg=None, norm_cfg=None, dtype=None,
                 **kwargs):
        super().__init__()
        if norm_cfg is not None:
            warnings.warn('SABLRetinaHead: norm_cfg is not read, as in the '
                          'JAX head: plain towers (ROADMAP.md caveat 57)')
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
        self.coder = build_coder(bbox_coder or dict(
            type='BucketingBBoxCoder', num_buckets=14, scale_factor=3.0))
        self.side_num = self.coder.side_num
        self.loss_cls = LOSSES.build(loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        self.loss_bbox_cls = LOSSES.build(loss_bbox_cls or dict(
            type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.5))
        self.loss_bbox_reg = LOSSES.build(loss_bbox_reg or dict(
            type='SmoothL1Loss', beta=1.0 / 9.0, loss_weight=1.5))
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or dict(
            nms_pre=1000, score_thr=0.05,
            nms=dict(type='nms', iou_threshold=0.5), max_per_img=100)
        a_cfg = dict(self.train_cfg.get('assigner', dict(
            pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)))
        a_cfg.pop('type', None)
        self.assigner = ApproxMaxIoUAssigner(**a_cfg)
        dtype = lowered_dtype(dtype)
        self.cls_convs = nn.ModuleList(
            ConvReLU(in_channels if i == 0 else feat_channels, feat_channels,
                     dtype) for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvReLU(in_channels if i == 0 else feat_channels, feat_channels,
                     dtype) for i in range(stacked_convs))
        self.retina_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                                 compute_dtype=dtype)
        self.retina_bbox_cls = Conv2d(feat_channels, 4 * self.side_num, 3,
                                      padding=1, compute_dtype=dtype)
        self.retina_bbox_reg = Conv2d(feat_channels, 4 * self.side_num, 3,
                                      padding=1, compute_dtype=dtype)

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: normal(0.01) kernels, zero biases but
        `retina_cls`'s prior-0.01 one."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                    nn.init.zeros_(m.bias)
            nn.init.constant_(self.retina_cls.bias, _CLS_BIAS_INIT)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, C, H, W), bucket logits
        and bucket offsets (B, 4 * side_num, H, W)) per level, float32."""
        cls_scores, bbox_cls_preds, bbox_reg_preds = [], [], []
        for x in feats:
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_scores.append(self.retina_cls(c).float())
            bbox_cls_preds.append(self.retina_bbox_cls(r).float())
            bbox_reg_preds.append(self.retina_bbox_reg(r).float())
        return cls_scores, bbox_cls_preds, bbox_reg_preds

    def geometry(self, featmap_sizes, device):
        """The squares (N, 4), their approx anchors (N, 9, 4) and the
        squares a level."""
        squares = self.square_gen.grid_anchors(featmap_sizes, device)
        approxs = torch.cat([
            a.reshape(-1, self.approxs_per_loc, 4)
            for a in self.approx_gen.grid_anchors(featmap_sizes, device)])
        return torch.cat(squares), approxs, [s.shape[0] for s in squares]

    def targets(self, featmap_sizes, batch) -> Dict[str, torch.Tensor]:
        """The assignment and bucket targets of a batch, (B, N, ...)."""
        gt_bboxes = batch['gt_bboxes']
        device = gt_bboxes.device
        squares, approxs, num_lvl = self.geometry(featmap_sizes, device)
        valid = torch.stack([
            torch.cat(self.square_gen.valid_flags(featmap_sizes, hw, device))
            for hw in batch['img_hw']])
        res = self.assigner.assign(squares, num_lvl, gt_bboxes,
                                   batch['gt_labels'], batch['gt_valid'],
                                   valid, num_classes=self.num_classes,
                                   approxs=approxs)
        safe = res.assigned_gt_inds.clamp(min=0)
        tgt = torch.gather(gt_bboxes, 1, safe[..., None].expand(-1, -1, 4))
        offs, off_w, labels_1h, cls_w = self.coder.encode(squares[None], tgt)
        posf = res.pos_mask.to(torch.float32)[..., None]
        return dict(labels=res.labels, pos=res.pos_mask, valid=valid,
                    offsets=offs, offset_weights=off_w * posf,
                    bucket_labels=labels_1h, bucket_weights=cls_w * posf)

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        cls_scores, bbox_cls_preds, bbox_reg_preds = outputs
        t = self.targets(featmap_sizes, batch)
        n_total = global_sum(t['pos'].to(torch.float32).sum()).clamp(min=1.0)
        loss_cls = self.loss_cls(
            flatten_levels(cls_scores, self.cls_out_channels), t['labels'],
            weight=t['valid'].to(torch.float32), avg_factor=n_total)
        loss_bbox_cls = self.loss_bbox_cls(
            flatten_levels(bbox_cls_preds), t['bucket_labels'],
            weight=t['bucket_weights'],
            avg_factor=n_total * 4 * self.side_num)
        loss_bbox_reg = self.loss_bbox_reg(
            flatten_levels(bbox_reg_preds), t['offsets'],
            weight=t['offset_weights'],
            avg_factor=n_total * 4 * self.coder.offset_topk)
        return dict(loss_cls=loss_cls, loss_bbox_cls=loss_bbox_cls,
                    loss_bbox_reg=loss_bbox_reg)

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        cfg = cfg or self.test_cfg
        cls_scores, bbox_cls_preds, bbox_reg_preds = outputs
        device = cls_scores[0].device
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        mlvl_squares = self.square_gen.grid_anchors(featmap_sizes, device)
        nms_pre = cfg.get('nms_pre', 1000)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        boxes_all, scores_all, conf_all = [], [], []
        for cls, bc, br, sq in zip(cls_scores, bbox_cls_preds,
                                   bbox_reg_preds, mlvl_squares):
            scores = torch.sigmoid(flatten_level(cls))
            bc, br = flatten_level(bc), flatten_level(br)
            sq = sq.expand(b, *sq.shape)
            if 0 < nms_pre < scores.shape[1]:
                _, topk = torch.topk(scores.amax(dim=-1), nms_pre)
                scores, bc, br, sq = (_gather_rows(x, topk)
                                      for x in (scores, bc, br, sq))
            boxes, conf = self.coder.decode(sq, (bc, br), max_shape=img_hw)
            boxes_all.append(boxes)
            scores_all.append(scores)
            conf_all.append(conf)
        boxes = torch.cat(boxes_all, dim=1)
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(scale_factor, dtype=torch.float32,
                                            device=device)[:, None, :]
        scores = torch.cat(scores_all, dim=1) * torch.cat(conf_all,
                                                          dim=1)[..., None]
        return multiclass_nms(boxes, scores, cfg.get('score_thr', 0.05),
                              cfg.get('nms', {}).get('iou_threshold', 0.5),
                              max_per_img=cfg.get('max_per_img', 100),
                              keep_fn=keep_fn)
