"""RoI-head variants; port of `ld_tpu/models/heads/roi_variants.py`, NCHW.

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
  * `DoubleConvFCBBoxHead` (the JAX `DoubleBBoxHeadNet`, `:36-92`): a
    conv regression branch, a residual block from `in_channels` to
    `conv_out_channels` (`res_block`: a 1x1 identity conv, `conv1` 1x1 to a
    quarter and `conv2` 3x3 back, each with its GroupNorm) and `num_convs`
    GN bottlenecks (`conv_branch.i.conv{1,2,3}` / `gn{1,2,3}`), averaged
    over the roi and into `fc_reg`; an fc classification branch, two
    Linear + ReLU (`fc_branch.i`) over the roi flattened CHW, then
    `fc_cls`. Its norms are GroupNorm (min(32, C) groups), where mmdet's
    blocks take BN, and both branches read the same 7x7 rois, as in JAX
    (ROADMAP.md caveat 75). `DoubleHeadRoIHead` is the `StandardRoIHead`
    with it as its bbox head (`reg_class_agnostic` False by default).
  * `DynamicRoIHead` (`:217-309`): Dynamic R-CNN without state. Each
    image's positive IoU threshold is the mean over its valid gts of each
    gt's `ktop_iou`-th largest IoU with the candidates (the gts joined to
    the proposals), clipped to [`initial_iou`, 0.6] (`initial_iou` without
    a gt); a candidate is positive where its largest IoU reaches it (its gt
    the first argmax). Up to num x pos_fraction positives, then num minus
    those of negatives, by the top keys of two uniform draws, and the
    sampled set ordered by a third (`dynamic_draws`; `sample_rois(...,
    draws=)` takes them, so that the same draws pick the same rois). The
    regression loss is `DynamicSmoothL1Loss`: SmoothL1 at beta = the
    `ktop_beta`-th smallest mean |target| of the batch's positives (the
    global batch's under data parallelism), clipped to [1e-3,
    `initial_beta`], weight 1. Both are computed a batch at a time, where
    mmdet updates them from a history each iteration (ROADMAP.md caveat
    76).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import GroupNorm, lecun_normal_
from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.ops.samplers import (rank_below, select_topk_mask,
                                       uniform_keys)
from ld_tpu_torch.parallel.dist import all_gather, global_sum
from ld_tpu_torch.utils.registry import HEADS
from .mask_head import mask_targets
from .roi_head import StandardRoIHead


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


def _gn(channels: int) -> GroupNorm:
    return GroupNorm(min(32, channels), channels, eps=1e-5)


class _ConvGN(nn.Module):
    """A bias-free conv and its GroupNorm (`conv`, `gn`)."""

    def __init__(self, in_channels, out_channels, kernel_size):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=kernel_size // 2, bias=False)
        self.gn = _gn(out_channels)

    def forward(self, x):
        return self.gn(self.conv(x))


class _ResBlock(nn.Module):

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv_identity = nn.Module()
        self.conv_identity.conv = nn.Conv2d(in_channels, out_channels, 1,
                                            bias=False)
        self.conv1 = _ConvGN(in_channels, out_channels // 4, 1)
        self.conv2 = _ConvGN(out_channels // 4, out_channels, 3)

    def forward(self, x):
        y = self.conv2(torch.relu(self.conv1(x)))
        return torch.relu(self.conv_identity.conv(x) + y)


class _GNBottleneck(nn.Module):

    def __init__(self, channels):
        super().__init__()
        mid = channels // 4
        self.conv1 = nn.Conv2d(channels, mid, 1, bias=False)
        self.gn1 = _gn(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.gn2 = _gn(mid)
        self.conv3 = nn.Conv2d(mid, channels, 1, bias=False)
        self.gn3 = _gn(channels)

    def forward(self, x):
        y = torch.relu(self.gn1(self.conv1(x)))
        y = torch.relu(self.gn2(self.conv2(y)))
        return torch.relu(x + self.gn3(self.conv3(y)))


class DoubleConvFCBBoxHead(nn.Module):
    """In float32, as the port's other RoI heads."""

    def __init__(self, num_classes, in_channels=256, roi_size=7,
                 conv_out_channels=1024, fc_out_channels=1024, num_convs=4,
                 reg_class_agnostic=False):
        super().__init__()
        self.res_block = _ResBlock(in_channels, conv_out_channels)
        self.conv_branch = nn.ModuleList(
            _GNBottleneck(conv_out_channels) for _ in range(num_convs))
        flat = in_channels * roi_size * roi_size
        self.fc_branch = nn.ModuleList(
            nn.Linear(flat if i == 0 else fc_out_channels, fc_out_channels)
            for i in range(2))
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(conv_out_channels, 4 if reg_class_agnostic
                                else 4 * num_classes)

    def init_weights(self, generator: torch.Generator):
        """The JAX net's: lecun-normal convs and fc-branch Linears, normal
        (0.01) `fc_cls`, normal(0.001) `fc_reg`, zero biases, GN 1 / 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    m.reset_parameters()
            nn.init.normal_(self.fc_cls.weight, 0.0, 0.01,
                            generator=generator)
            nn.init.normal_(self.fc_reg.weight, 0.0, 0.001,
                            generator=generator)

    def forward(self, x: torch.Tensor):
        """x (R, C, S, S) -> cls (R, num_classes + 1), reg (R, 4[*C])."""
        r = self.res_block(x)
        for block in self.conv_branch:
            r = block(r)
        f = x.flatten(1)
        for fc in self.fc_branch:
            f = torch.relu(fc(f))
        return self.fc_cls(f).float(), self.fc_reg(r.mean(dim=(2, 3))).float()


@HEADS.register_module()
class DoubleHeadRoIHead(StandardRoIHead):

    def _build_bbox_head(self, bbox_head: dict) -> nn.Module:
        return DoubleConvFCBBoxHead(
            self.num_classes, bbox_head.get('in_channels', 256),
            self.feat_size, bbox_head.get('conv_out_channels', 1024),
            bbox_head.get('fc_out_channels', 1024),
            bbox_head.get('num_convs', 4), self.reg_class_agnostic)


class DynamicSmoothL1Loss(nn.Module):
    """SmoothL1 at the batch's dynamic beta (the JAX `_DynamicSmoothL1`,
    `roi_variants.py:217-244`)."""

    def __init__(self, ktop=10, initial_beta=1.0, loss_weight=1.0):
        super().__init__()
        self.ktop = ktop
        self.initial_beta = initial_beta
        self.loss_weight = loss_weight

    def beta(self, target: torch.Tensor, weight=None) -> torch.Tensor:
        """clip(the `ktop`-th smallest mean |target| of the positive rows
        (weight[:, 0] > 0) of the global batch, 1e-3, initial_beta)."""
        with torch.no_grad():
            per_box = target.abs().mean(-1)
            if weight is not None:
                per_box = torch.where(weight[:, 0] > 0, per_box,
                                      torch.full_like(per_box, 1e9))
            per_box = all_gather(per_box)
            k = min(self.ktop, per_box.shape[0])
            kth = torch.topk(per_box, k, largest=False).values[-1]
            return kth.clamp(1e-3, self.initial_beta)

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        beta = self.beta(target, weight)
        err = (pred - target).abs()
        loss = torch.where(err < beta, 0.5 * err * err / beta,
                           err - 0.5 * beta)
        if weight is not None:
            loss = loss * weight
        if avg_factor is not None:
            return self.loss_weight * loss.sum() / avg_factor
        return self.loss_weight * loss.mean()


@HEADS.register_module()
class DynamicRoIHead(StandardRoIHead):

    def __init__(self, *args, ktop_iou=75, ktop_beta=10, initial_iou=0.4,
                 initial_beta=1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.ktop_iou = ktop_iou
        self.initial_iou = initial_iou
        self.loss_bbox = DynamicSmoothL1Loss(ktop=ktop_beta,
                                             initial_beta=initial_beta)

    def iou_thresholds(self, proposals, prop_valid, gt_bboxes, gt_valid):
        """Each image's positive IoU threshold (B,), with the candidates'
        IoUs with the gts (B, P, G) (0 where either is invalid), the
        candidates (B, P, 4) and their validity."""
        if self.add_gt_as_proposals:
            proposals = torch.cat([gt_bboxes, proposals], dim=1)
            prop_valid = torch.cat([gt_valid, prop_valid], dim=1)
        iou = torch.where(gt_valid[:, None, :] & prop_valid[:, :, None],
                          bbox_overlaps(proposals, gt_bboxes),
                          torch.zeros((), device=proposals.device))
        k = min(self.ktop_iou, proposals.shape[1])
        kth = torch.topk(iou.transpose(1, 2), k, dim=-1).values[..., -1]
        gv = gt_valid.to(torch.float32)
        thr = torch.where(gt_valid.any(-1),
                          (kth * gv).sum(-1) / gv.sum(-1).clamp(min=1.0),
                          torch.full_like(gv[:, 0], self.initial_iou))
        return thr.clamp(self.initial_iou, 0.6), iou, proposals, prop_valid

    @staticmethod
    def dynamic_draws(generator: torch.Generator, like: torch.Tensor
                      ) -> torch.Tensor:
        """The three (B, P) uniform draws of one `sample_rois`: the
        positives', the negatives' and the sampled set's order."""
        return torch.stack([uniform_keys(generator, like) for _ in range(3)])

    def sample_rois(self, proposals, prop_valid, gt_bboxes, gt_labels,
                    gt_valid, generator: torch.Generator, assigner=None,
                    coder=None, extras=None, draws=None) -> Dict:
        """`StandardRoIHead.sample_rois`'s dict, by the dynamic threshold;
        `draws` (3, B, P) in place of the generator's."""
        thr, iou, cand, valid = self.iou_thresholds(proposals, prop_valid,
                                                    gt_bboxes, gt_valid)
        max_iou = iou.amax(-1)
        argmax = iou.argmax(-1)
        pos = (max_iou >= thr[:, None]) & valid
        if draws is None:
            draws = self.dynamic_draws(generator, pos)
        pos_sel, n_pos = select_topk_mask(draws[0], pos, self.sampler.max_pos)
        neg = valid & ~pos
        keys = torch.where(neg, draws[1], torch.full_like(draws[1], -1e9))
        neg_sel = neg & rank_below(keys, self.num_samples - n_pos)
        sel = pos_sel | neg_sel
        rank_keys = pos_sel.float() + sel.float() + draws[2] * 0.5
        n = min(self.num_samples, rank_keys.shape[1])
        order = torch.topk(rank_keys, n, dim=-1).indices

        def take(x):
            return torch.gather(x, 1, order)
        rois = torch.gather(cand, 1, order[..., None].expand(-1, -1, 4))
        roi_pos = take(pos_sel)
        safe = take(argmax)
        labels = torch.where(roi_pos, torch.gather(gt_labels, 1, safe),
                             torch.full_like(safe, self.num_classes))
        gts = torch.gather(gt_bboxes, 1, safe[..., None].expand(-1, -1, 4))
        return dict(rois=rois, roi_valid=take(sel), roi_pos=roi_pos,
                    labels=labels, targets=(coder or self.coder).encode(
                        rois, gts), gt_inds=safe)
