"""Region proposal network head; port of `ld_tpu/models/heads/rpn_head.py`,
NCHW.

  * forward: `rpn_conv` (3x3, ReLU) on every FPN level, then `rpn_cls` (A
    objectness logits) and `rpn_reg` (A x 4 deltas), 1x1 each: mmdet's names;
  * loss: MaxIoU assignment of every anchor (0.7 / 0.3 / 0.3; no ignore
    band, ROADMAP.md caveat 10), up to num x pos_fraction random positives
    and num minus those of random negatives an image (`ops.samplers`, from
    the generator passed in), sigmoid BCE objectness over the picked
    anchors and L1 on the `DeltaXYWHBBoxCoder` deltas of the picked
    positives, both averaged over the batch's picked count;
  * `loss_with_teacher`: that, plus the JAX package's RPN distillation
    (`rpn_head.py:152-176`): a binary KL of the objectness against the
    teacher's sigmoid (0.1 x its mean) and an L1 of the deltas weighted by
    the teacher's objectness (0.1 x, over 4 x the weights' sum);
  * `get_proposals`: per level the `nms_pre` top-k on the objectness
    sigmoid, the decode clipped to the image, then ONE greedy NMS over all
    levels together (ROADMAP.md caveat 19) of every image of the batch, one
    `nms_keep` launch: (B, max_per_img, 4) proposals and their validity.

An `anchor_generator` of type `LegacyAnchorGenerator` (the `legacy_1.x`
configs) builds the plain generator with the config's `center_offset`, as
the JAX RPN drops the type (ROADMAP.md caveat 71).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d
from ld_tpu_torch.ops.anchors import AnchorGenerator
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.ops.nms import batched_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.ops.samplers import randomized_topk_mask, uniform_keys
from ld_tpu_torch.parallel.dist import global_mean, global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import _gather_rows, flatten_level


@HEADS.register_module()
class RPNHead(nn.Module):

    def __init__(self, in_channels, feat_channels=256, anchor_generator=None,
                 bbox_coder=None, loss_cls=None, loss_bbox=None,
                 train_cfg=None, test_cfg=None, dtype=None, **kwargs):
        super().__init__()
        ag = dict(anchor_generator or dict(
            scales=[8], ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16, 32, 64]))
        # the legacy type builds the plain layout, as in JAX (caveat 71)
        ag_type = ag.pop('type', 'AnchorGenerator')
        if ag_type not in ('AnchorGenerator', 'LegacyAnchorGenerator'):
            raise NotImplementedError(f'{ag_type} is not ported to '
                                      'ld_tpu_torch yet (see ROADMAP.md)')
        self.anchor_generator = AnchorGenerator(**ag)
        self.num_levels = self.anchor_generator.num_levels
        self.num_anchors = self.anchor_generator.num_base_anchors[0]
        self.num_classes = 1
        self.coder = build_coder(bbox_coder or dict(
            type='DeltaXYWHBBoxCoder', target_means=[0., 0., 0., 0.],
            target_stds=[1.0, 1.0, 1.0, 1.0]))
        self.loss_cls = LOSSES.build(loss_cls or dict(
            type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0))
        self.loss_bbox = LOSSES.build(loss_bbox or dict(type='L1Loss',
                                                        loss_weight=1.0))
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or dict(nms_pre=1000, max_per_img=1000,
                                         nms=dict(iou_threshold=0.7),
                                         min_bbox_size=0)
        a_cfg = dict(self.train_cfg.get('assigner', dict(
            type='MaxIoUAssigner', pos_iou_thr=0.7, neg_iou_thr=0.3,
            min_pos_iou=0.3)))
        a_cfg.pop('type', None)
        self.assigner = MaxIoUAssigner(**a_cfg)
        s_cfg = dict(self.train_cfg.get('sampler', dict(num=256,
                                                        pos_fraction=0.5)))
        self.num_samples = s_cfg.get('num', 256)
        self.pos_fraction = s_cfg.get('pos_fraction', 0.5)
        a = self.num_anchors
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, padding=1,
                               compute_dtype=dtype)
        self.rpn_cls = Conv2d(feat_channels, a, 1, compute_dtype=dtype)
        self.rpn_reg = Conv2d(feat_channels, a * 4, 1, compute_dtype=dtype)

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers: normal(0.01) kernels, zero
        biases."""
        with torch.no_grad():
            for m in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, A, H, W), bbox_preds
        (B, A*4, H, W)) per level, float32."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            t = torch.relu(self.rpn_conv(x))
            cls_scores.append(self.rpn_cls(t).float())
            bbox_preds.append(self.rpn_reg(t).float())
        return cls_scores, bbox_preds

    def _flatten(self, cls_scores, bbox_preds):
        """-> (B, N) logits and (B, N, 4) deltas, (position, anchor) order."""
        b = cls_scores[0].shape[0]
        cls = torch.cat([flatten_level(c).reshape(b, -1) for c in cls_scores],
                        dim=1)
        reg = torch.cat([flatten_level(r).reshape(b, -1, 4)
                         for r in bbox_preds], dim=1)
        return cls, reg

    def loss(self, outputs, batch, featmap_sizes,
             generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """The RPN losses of a padded batch; the sampler draws from
        `generator` (default: a fresh one seeded 0 on the outputs' device)."""
        cls_flat, reg_flat = self._flatten(*outputs)
        device = cls_flat.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        anchors = torch.cat(self.anchor_generator.grid_anchors(
            featmap_sizes, device))
        gt_bboxes, gt_valid = batch['gt_bboxes'], batch['gt_valid']
        labels = torch.zeros_like(gt_valid, dtype=torch.long)
        res = self.assigner.assign(anchors, None, gt_bboxes, labels,
                                   gt_valid, num_classes=1)
        pos_sel = randomized_topk_mask(
            res.pos_mask, int(self.num_samples * self.pos_fraction),
            generator)
        n_pos = pos_sel.sum(-1, keepdim=True)
        neg_mask = ~res.pos_mask
        keys = torch.where(neg_mask, uniform_keys(generator, neg_mask),
                           torch.full(neg_mask.shape, -1.0, device=device))
        # the (num - n_pos)-th largest key; at least the first, as in JAX
        kth_idx = (self.num_samples - n_pos - 1).clamp(0, keys.shape[1] - 1)
        kth = torch.gather(torch.sort(keys, dim=-1, descending=True).values,
                           1, kth_idx)
        neg_sel = neg_mask & (keys >= kth.clamp(min=0.0))
        weights = (pos_sel | neg_sel).to(torch.float32)
        safe = res.assigned_gt_inds.clamp(min=0)
        deltas = self.coder.encode(anchors[None], torch.gather(
            gt_bboxes, 1, safe[..., None].expand(-1, -1, 4)))
        avg = global_sum(weights.sum()).clamp(min=1.0)
        loss_cls = self.loss_cls(
            cls_flat.reshape(-1, 1),
            res.pos_mask.to(torch.float32).reshape(-1, 1),
            weight=weights.reshape(-1), avg_factor=avg)
        loss_bbox = self.loss_bbox(
            reg_flat.reshape(-1, 4), deltas.reshape(-1, 4),
            weight=pos_sel.to(torch.float32).reshape(-1, 1).expand(-1, 4),
            avg_factor=avg)
        return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)

    def loss_with_teacher(self, outputs, batch, featmap_sizes, soft_teacher,
                          generator: torch.Generator = None
                          ) -> Dict[str, torch.Tensor]:
        """The RPN losses plus the distillation of the teacher's (detached)
        (cls_scores, bbox_preds): `loss_rpn_kd` and `loss_rpn_ld`."""
        losses = self.loss(outputs, batch, featmap_sizes, generator)
        cls_flat, reg_flat = self._flatten(*outputs)
        t_cls, t_reg = self._flatten(*soft_teacher)
        s = torch.sigmoid(cls_flat)
        t = torch.sigmoid(t_cls).detach()
        eps = 1e-6
        kl = t * (torch.log(t + eps) - torch.log(s + eps)) + \
            (1 - t) * (torch.log(1 - t + eps) - torch.log1p(-s + eps))
        losses['loss_rpn_kd'] = 0.1 * global_mean(kl)
        w = t[..., None]
        losses['loss_rpn_ld'] = 0.1 * (
            torch.abs(reg_flat - t_reg.detach()) * w).sum() / \
            global_sum(w.sum() * 4.0).clamp(min=1.0)
        return losses

    def get_proposals(self, outputs, img_hw, cfg=None, keep_fn=nms_keep):
        """(B, max_per_img, 4) proposals (zeros where invalid) and their
        (B, max_per_img) validity, from one NMS of each image's top-scored
        decoded anchors of every level."""
        cfg = cfg or self.test_cfg
        cls_scores, bbox_preds = outputs
        b = cls_scores[0].shape[0]
        device = cls_scores[0].device
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        mlvl_anchors = self.anchor_generator.grid_anchors(featmap_sizes,
                                                          device)
        nms_pre = cfg.get('nms_pre', 1000)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        boxes_all, scores_all = [], []
        for c, r, anchors in zip(cls_scores, bbox_preds, mlvl_anchors):
            scores = torch.sigmoid(flatten_level(c).reshape(b, -1))
            reg = flatten_level(r).reshape(b, -1, 4)
            anchors = anchors.expand(b, -1, 4)
            if 0 < nms_pre < scores.shape[1]:
                scores, topk = torch.topk(scores, nms_pre)
                reg, anchors = _gather_rows(reg, topk), _gather_rows(anchors,
                                                                     topk)
            boxes_all.append(self.coder.decode(anchors, reg,
                                               max_shape=img_hw))
            scores_all.append(scores)
        boxes = torch.cat(boxes_all, dim=1)
        idx, valid = batched_nms(
            boxes, torch.cat(scores_all, dim=1),
            cfg.get('nms', {}).get('iou_threshold', 0.7),
            cfg.get('max_per_img', 1000), keep_fn=keep_fn)
        props = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        return torch.where(valid[..., None], props,
                           torch.zeros_like(props)), valid
