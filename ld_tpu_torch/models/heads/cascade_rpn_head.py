"""Cascade RPN head; port of `ld_tpu/models/heads/cascade_rpn_head.py:29-232`,
NCHW.

  * forward: one square anchor a location (scale 8, ratio 1). Stage 1: a
    3x3 `DeformConv` (`stages.0.rpn_conv.conv`, no bias) whose taps spread
    over the location's anchor (`anchor_offsets`), ReLU, a 1x1 `rpn_reg`;
    its deltas decode the anchors (`DeltaXYWHBBoxCoder`, stds 0.1, 0.1,
    0.5, 0.5), detached: the refined anchors. Stage 2: the same on the FPN
    features (not bridged) with the taps spread over the refined anchors,
    then the 1x1 `rpn_cls` objectness and `rpn_reg` deltas, decoded against
    the refined anchors by the same coder. Both stages' convs are
    `DeformConv`s: the config's stage-1 `adapt_cfg` (a dilation) is not
    read, and stage 2 decodes with stage 1's stds, not the config's (0.05,
    0.05, 0.1, 0.1), as in JAX (ROADMAP.md caveats 79 and 80).
  * loss: stage 1 by `RegionAssigner`, stage 2 by `MaxIoUAssigner(0.7,
    0.7, 0.3)` on the refined anchors (the config's equal values, its
    `train_cfg` list is not read); linear IoU losses (x 10) of the decoded
    boxes against their gts, each image's over its positives, averaged
    over the images; stage 2's BCE objectness (positive: MaxIoU's
    positives) over every anchor, no sampler, a mean over them all
    (caveat 81).
  * `get_proposals`: the stage-2 boxes, unclipped, scored by the sigmoid
    objectness, through `multiclass_nms` at `score_thr` 0: its top 1024
    candidates (`max_candidates`) at the head's `test_cfg` IoU, one
    `nms_keep` launch for the batch; `max_per_img` from the caller's
    `cfg` (a detector's `train_cfg.rpn_proposal` in training), else the
    head's `test_cfg`; `nms_pre` is not read (caveat 82).

The JAX head cannot run a Cascade RPN config (ROADMAP.md caveat 93): built
from one it reads no `stages`, so its anchor generator is the default (4
levels at strides 8-64) and fails on the FPN's five maps, and the JAX
detector calls its net without the anchors it needs. Here, without a
top-level `anchor_generator`, the head takes `stages[0]`'s (5 levels at
strides 4-64, scale 8), builds its anchor maps from the feature sizes in
`forward` (as the JAX `CascadeRPNHead.forward`), and the two-stage
detectors drive it through `loss` and `get_proposals`, the JAX
`cascade_rpn_loss` and `cascade_rpn_proposals`. The numerics are the JAX
functions'.

Module names are mmdet's `StageCascadeRPNHead` ones under `stages.{0,1}`;
the JAX converter has no Cascade RPN rule: `state_dict_from_jax` carries a
JAX tree (`rpn_net/rpn/{s1_adapt, s1_reg, s2_adapt, s2_cls, s2_reg}`).
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
from ld_tpu_torch.ops.extra_assigners import RegionAssigner
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import flatten_levels


def anchor_offsets(anchors_map: torch.Tensor, stride: float) -> torch.Tensor:
    """(B, H, W, 4) anchors in image coordinates -> (B, 18, H, W) 3x3 tap
    offsets, (dy, dx) a tap, that put the taps at the anchor's centre plus
    (-1, 0, 1) x half its extent."""
    w = (anchors_map[..., 2] - anchors_map[..., 0]) / stride
    h = (anchors_map[..., 3] - anchors_map[..., 1]) / stride
    cx = (anchors_map[..., 0] + anchors_map[..., 2]) / 2 / stride
    cy = (anchors_map[..., 1] + anchors_map[..., 3]) / 2 / stride
    hh, ww = w.shape[1:]
    dev = w.device
    dcx = cx - torch.arange(ww, dtype=torch.float32, device=dev)
    dcy = cy - torch.arange(hh, dtype=torch.float32, device=dev)[:, None]
    taps = []
    for ky in (-1, 0, 1):
        for kx in (-1, 0, 1):
            taps.append(dcy + ky * (h / 2 - 1.0))
            taps.append(dcx + kx * (w / 2 - 1.0))
    return torch.stack(taps, 1)


class AdaptiveConv(nn.Module):
    """mmdet's AdaptiveConv name (`conv`) over the caller-offset
    `DeformConv`."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = DeformConv(in_channels, out_channels)

    def forward(self, x, offset):
        return self.conv(x, offset)


class CascadeStage(nn.Module):
    """One stage's adaptive conv and 1x1 predictions."""

    def __init__(self, in_channels, feat_channels, with_cls, dtype=None):
        super().__init__()
        self.rpn_conv = AdaptiveConv(in_channels, feat_channels)
        if with_cls:
            self.rpn_cls = Conv2d(feat_channels, 1, 1, compute_dtype=dtype)
        self.rpn_reg = Conv2d(feat_channels, 4, 1, compute_dtype=dtype)


@HEADS.register_module()
class CascadeRPNHead(nn.Module):

    num_classes = 1

    def __init__(self, in_channels=256, feat_channels=256,
                 anchor_generator=None, stages=None, train_cfg=None,
                 test_cfg=None, dtype=None, **kwargs):
        super().__init__()
        # `num_stages` and the stages' other keys are accepted and not read,
        # as in the JAX head (caveats 79-81); the `train_cfg` list too
        ag = anchor_generator or (stages[0].get('anchor_generator')
                                  if stages else None)
        ag = dict(ag or dict(ratios=[1.0], scales=[8],
                             strides=[8, 16, 32, 64]))
        ag.pop('type', None)
        self.anchor_generator = AnchorGenerator(**ag)
        self.strides = tuple(s if np.isscalar(s) else s[0]
                             for s in ag.get('strides', (8, 16, 32, 64)))
        self.anchor_scale = (ag.get('scales') or [8])[0]
        self.coder = build_coder(dict(
            type='DeltaXYWHBBoxCoder', target_means=[0.] * 4,
            target_stds=[0.1, 0.1, 0.5, 0.5]))
        self.loss_reg = LOSSES.build(dict(type='IoULoss', linear=True,
                                          loss_weight=10.0))
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or dict(nms_pre=1000, max_per_img=300,
                                         nms=dict(iou_threshold=0.7))
        self.region_assigner = RegionAssigner()
        self.iou_assigner = MaxIoUAssigner(pos_iou_thr=0.7, neg_iou_thr=0.7,
                                           min_pos_iou=0.3)
        self.stages = nn.ModuleList(
            CascadeStage(in_channels, feat_channels, i == 1, dtype)
            for i in range(2))

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: he-normal adaptive convs,
        normal(0.01) predictions, zero biases."""
        with torch.no_grad():
            for stage in self.stages:
                stage.rpn_conv.conv.init_weights(generator)
                for m in stage.modules():
                    if isinstance(m, nn.Conv2d):
                        nn.init.normal_(m.weight, 0.0, 0.01,
                                        generator=generator)
                        nn.init.zeros_(m.bias)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (stage-1 deltas (B, 4, H, W), the
        detached refined anchors (B, 4, H, W), stage-2 objectness logits
        (B, 1, H, W), stage-2 deltas (B, 4, H, W)) per level, float32."""
        sizes = [tuple(f.shape[-2:]) for f in feats]
        b = feats[0].shape[0]
        s1, s2 = self.stages
        anchors = self.anchor_generator.grid_anchors(sizes, feats[0].device)
        reg1, refined = [], []
        for x, a, (h, w), stride in zip(feats, anchors, sizes, self.strides):
            a = a.reshape(1, h, w, 4).expand(b, h, w, 4)
            f = torch.relu(s1.rpn_conv(x, anchor_offsets(a, stride)))
            r = s1.rpn_reg(f).float()
            reg1.append(r)
            ref = self.coder.decode(a.reshape(b, -1, 4),
                                    r.permute(0, 2, 3, 1).reshape(b, -1, 4))
            refined.append(ref.detach().reshape(b, h, w, 4))
        cls2, reg2 = [], []
        for x, ref, stride in zip(feats, refined, self.strides):
            f = torch.relu(s2.rpn_conv(x, anchor_offsets(ref, stride)))
            cls2.append(s2.rpn_cls(f).float())
            reg2.append(s2.rpn_reg(f).float())
        return reg1, [r.permute(0, 3, 1, 2) for r in refined], cls2, reg2

    # ---- loss ----------------------------------------------------------------
    def _iou_loss(self, pred, target, posf) -> torch.Tensor:
        """Each image's IoU loss over its positives: (B, )."""
        b = pred.shape[0]
        loss = self.loss_reg(pred.reshape(-1, 4), target.reshape(-1, 4),
                             weight=posf.reshape(-1),
                             reduction_override='none').reshape(b, -1)
        return loss.sum(-1) / posf.sum(-1).clamp(min=1.0)

    def loss(self, outputs, batch, featmap_sizes,
             generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """Both stages' losses; `generator` is not used (no sampler)."""
        reg1, refined, cls2, reg2 = outputs
        device = reg1[0].device
        mlvl = self.anchor_generator.grid_anchors(featmap_sizes, device)
        anchors = torch.cat(mlvl)
        num_lvl = [a.shape[0] for a in mlvl]
        gtb, gtl, gtv = batch['gt_bboxes'], batch['gt_labels'], \
            batch['gt_valid']
        ref = flatten_levels(refined, 4).detach()
        with torch.no_grad():
            res1 = self.region_assigner.assign(
                anchors, num_lvl, gtb, gtl, gtv, num_classes=1,
                anchor_scale=self.anchor_scale, strides=self.strides)
            res2 = self.iou_assigner.assign(ref, num_lvl, gtb, gtl, gtv,
                                            num_classes=1)
        dec1 = self.coder.decode(anchors.expand(gtb.shape[0], -1, 4),
                                 flatten_levels(reg1, 4))
        l1 = self._iou_loss(dec1, _gather(gtb, res1.assigned_gt_inds),
                            res1.pos_mask.float())
        dec2 = self.coder.decode(ref, flatten_levels(reg2, 4))
        labs = res2.pos_mask.float()
        l2 = self._iou_loss(dec2, _gather(gtb, res2.assigned_gt_inds), labs)
        cls = flatten_levels(cls2, 1)[..., 0]
        bce = cls.clamp(min=0) - cls * labs + torch.log1p(
            torch.exp(-cls.abs()))
        return dict(loss_rpn_reg_s1=l1.mean(), loss_rpn_reg_s2=l2.mean(),
                    loss_rpn_cls=bce.sum() / max(float(bce.numel()), 1.0))

    # ---- proposals -------------------------------------------------------------
    def get_proposals(self, outputs, img_hw, cfg=None, keep_fn=nms_keep):
        """(B, max_per_img, 4) proposals (zeros where invalid) and their
        validity; `img_hw` is not read (the boxes are not clipped)."""
        _, refined, cls2, reg2 = outputs
        boxes = self.coder.decode(flatten_levels(refined, 4),
                                  flatten_levels(reg2, 4))
        scores = torch.sigmoid(flatten_levels(cls2, 1))
        k = (cfg or {}).get('max_per_img') or \
            self.test_cfg.get('max_per_img', 300)
        dets, _, _ = multiclass_nms(
            boxes, scores, 0.0,
            self.test_cfg.get('nms', {}).get('iou_threshold', 0.7),
            max_per_img=k, keep_fn=keep_fn)
        return dets[..., :4], dets[..., 4] > 0


def _gather(gt_bboxes: torch.Tensor, assigned: torch.Tensor) -> torch.Tensor:
    """The assigned gts' boxes (B, N, 4), gt 0's where unassigned."""
    return torch.gather(gt_bboxes, 1, assigned.clamp(min=0)[..., None].expand(
        -1, -1, 4))
