"""Mask Scoring R-CNN's RoI head; port of the Mask Scoring part of
`ld_tpu/models/heads/roi_variants.py:112-214`, NCHW.

  * `MaskIoUHead` (mmdet's `roi_head.mask_iou_head`): the roi's selected
    mask logits (R, 2S, 2S) max-pooled 2x2 / 2 to (R, 1, S, S) and joined
    to its (R, C, S, S) mask features; four 3x3 convs + ReLU
    (`convs.i.conv`, the last at stride 2); the result flattened CHW, as
    mmdet's; two Linear + ReLU (`fcs.i`) and `fc_mask_iou`, one predicted
    IoU a class. The JAX net flattens HWC; `state_dict_from_jax` permutes
    fc0's rows.
  * `MaskScoringRoIHead(StandardRoIHead)`: training adds `loss_mask_iou`
    on the rois `loss_mask` uses (the one `sample_rois` draw; its positive
    slice, where every positive is): the predicted IoU of each positive's
    class against the IoU of its binarised mask (sigmoid(logit) > 0.5)
    with its RoI-cropped mask target, 0.5 x the squared difference summed
    over the batch's positives and divided by their count, times
    `loss_iou.loss_weight` (0.5). The MaskIoU head reads the mask logits
    detached, the RoI features live: this loss's gradient reaches the FPN
    and the trunk through them, not through the mask head. Testing is the
    `StandardRoIHead`'s: nothing rescores the detections (ROADMAP.md
    caveat 55).

`DoubleHeadRoIHead` and `DynamicRoIHead` wait (ROADMAP.md A7).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import lecun_normal_
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .mask_head import mask_targets
from .roi_head import StandardRoIHead

HEADS.not_ported.update({name: 'ROADMAP.md A7' for name in (
    'DoubleHeadRoIHead', 'DynamicRoIHead')})


class _IoUConv(nn.Module):
    """mmcv ConvModule's `.conv`, its ReLU in `MaskIoUHead.forward`."""

    def __init__(self, in_channels, out_channels, stride):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride,
                              padding=1)


class MaskIoUHead(nn.Module):
    """In float32: the RoI head takes no compute dtype from a config."""

    def __init__(self, num_classes=80, in_channels=256, conv_out_channels=256,
                 fc_out_channels=1024, roi_size=14):
        super().__init__()
        self.convs = nn.ModuleList(
            _IoUConv(in_channels + 1 if i == 0 else conv_out_channels,
                     conv_out_channels, 2 if i == 3 else 1)
            for i in range(4))
        flat = conv_out_channels * ((roi_size + 1) // 2) ** 2
        self.fcs = nn.ModuleList(
            nn.Linear(flat if i == 0 else fc_out_channels, fc_out_channels)
            for i in range(2))
        self.fc_mask_iou = nn.Linear(fc_out_channels, num_classes)

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: lecun-normal kernels, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    lecun_normal_(m.weight, generator)
                    nn.init.zeros_(m.bias)

    def forward(self, mask_feats: torch.Tensor, mask_pred: torch.Tensor
                ) -> torch.Tensor:
        """mask_feats (R, C, S, S), mask_pred (R, 2S, 2S) logits -> (R,
        num_classes) float32 IoUs."""
        pooled = F.max_pool2d(mask_pred[:, None], 2, 2)
        x = torch.cat([mask_feats.float(), pooled], dim=1)
        for m in self.convs:
            x = torch.relu(m.conv(x))
        x = x.flatten(1)
        for fc in self.fcs:
            x = torch.relu(fc(x))
        return self.fc_mask_iou(x)


@HEADS.register_module()
class MaskScoringRoIHead(StandardRoIHead):

    def __init__(self, mask_iou_head=None, **kwargs):
        super().__init__(**kwargs)
        mi = dict(mask_iou_head or {})
        self.loss_iou_weight = (mi.get('loss_iou') or {}).get('loss_weight',
                                                              0.5)
        self.mask_iou_head = None
        if self.mask_head is not None:
            self.mask_iou_head = MaskIoUHead(
                self.num_classes,
                in_channels=self.mask_head.convs[0].conv.in_channels,
                conv_out_channels=mi.get('conv_out_channels', 256),
                fc_out_channels=mi.get('fc_out_channels', 1024),
                roi_size=self.mask_roi_size)

    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        if self.mask_iou_head is not None:
            self.mask_iou_head.init_weights(generator)

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        s = self.sample_rois(proposals, prop_valid, batch['gt_bboxes'],
                             batch['gt_labels'].long(), batch['gt_valid'],
                             generator)
        cls, reg = self.bbox_head(self._extract(feats, s['rois'],
                                                s['roi_valid']))
        losses = self.bbox_losses(cls, reg, s)
        if self.mask_head is None or 'gt_masks' not in batch:
            return losses
        p = self.positive_slice(s)
        mask_feats = self._mask_feats(feats, p['rois'], p['roi_pos'])
        logits = self.mask_head(mask_feats)
        losses['loss_mask'] = self.mask_head.logits_loss(
            logits, p['rois'], p['roi_pos'], p['labels'], p['gt_inds'],
            batch['gt_masks'])
        losses['loss_mask_iou'] = self.mask_iou_loss(
            mask_feats, logits, p, batch['gt_masks'])
        return losses

    def mask_iou_loss(self, mask_feats, logits, p: Dict, gt_masks
                      ) -> torch.Tensor:
        """`loss_mask_iou` of the rois `p` (a positive slice of
        `sample_rois`) from their mask features and (R, K, 2S, 2S) mask
        logits."""
        sel = self.mask_head._select(logits, p['labels'])
        with torch.no_grad():
            pred = (torch.sigmoid(sel) > 0.5).to(torch.float32)
            tgt = mask_targets(gt_masks, p['rois'], p['gt_inds'],
                               sel.shape[-1], self.mask_head.mask_stride)
            inter = (pred * tgt).sum(dim=(1, 2))
            union = pred.sum(dim=(1, 2)) + tgt.sum(dim=(1, 2)) - inter
            iou_target = inter / union.clamp(min=1.0)
        iou = self.mask_iou_head(mask_feats, sel.detach())
        safe = p['labels'].reshape(-1).clamp(0, self.num_classes - 1)
        iou = torch.gather(iou, 1, safe[:, None])[:, 0]
        posf = p['roi_pos'].reshape(-1).to(torch.float32)
        l2 = 0.5 * (iou - iou_target) ** 2
        # a rank's share: its sum over the global batch's positive count
        return self.loss_iou_weight * (l2 * posf).sum() / \
            global_sum(posf.sum()).clamp(min=1.0)
