"""The Hybrid Task Cascade RoI head; port of
`ld_tpu/models/heads/htc_roi_head.py:28-258`, NCHW.

  * `HTCMaskHead`: `FCNMaskHead` with mask information flow: from the
    second stage on, the previous stage's tower output, through a 1x1 conv
    + ReLU (`conv_res.conv`), is added to the roi features before the
    tower. `tower` returns the pre-deconv feature the next stage takes.
  * `FusedSemanticHead`, under mmdet's names, computing what the JAX
    `SemanticHeadNet` computes: a 1x1 lateral conv on each FPN level
    (`lateral_convs.i.conv`), each level resized to the stride-8 level
    with an antialiased bilinear resize (`jax.image.resize`'s) and summed,
    `num_convs` 3x3 convs + ReLU (`convs.i.conv`), then the seg logits
    (`conv_logits`) and a 1x1 feature (`conv_embedding.conv`). It is not
    mmdet's: no ReLU on the laterals or the embedding (ROADMAP.md caveat
    30).
  * `HybridTaskCascadeRoIHead.forward_train`: `loss_semantic_seg` (pixel
    CE of the seg logits, meaned, times `loss_semantic_weight`) against
    the batch's `gt_semantic_seg`, else a foreground map of its
    `gt_masks` (caveat 31); then each cascade stage, the semantic feature
    cropped at 1 / `semantic_stride` (single-level RoIAlign) added to its
    bbox and mask roi features. Its `loss_mask_s{i}` runs the previous
    stages' mask towers on this stage's rois, detached, chained through
    the information flow, then its own; on the positive slice, times the
    stage's weight (no `loss_mask` weight, as in JAX: caveat 32).
  * The test path is `CascadeRoIHead.simple_test` without masks and
    without the semantic feature: the JAX head's (caveat 29). So
    `simple_test` returns three outputs, and `with_test_masks` is False.

Weights: `roi_head.bbox_head.{i}`, `roi_head.mask_head.{i}` (mmdet's
`HTCMaskHead` names) and `roi_head.semantic_head`.

`SCNetRoIHead` (`ld_tpu/models/heads/htc_roi_head.py:261-318`) is this head
plus `GlobalContextHead` (`roi_head.glbctx_head`: the mean of the FPN
levels' spatial means, `fc1` + ReLU, then `fc_cls`, one logit a class, and
`fc_ctx`, a context vector): training adds `loss_glbctx`, `glbctx_weight`
(3) x the mean BCE of the logits against each image's set of valid gt
labels. As in JAX, the context vector is computed and fused into nothing,
and no feature relay runs beyond HTC's information flow (ROADMAP.md caveat
77); the test path is HTC's.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import lecun_normal_
from ld_tpu_torch.ops.roi_align import roi_align
from ld_tpu_torch.parallel.dist import global_mean
from ld_tpu_torch.utils.registry import HEADS
from .cascade_roi_head import CascadeRoIHead
from .mask_head import FCNMaskHead


class ConvModule(nn.Module):
    """mmcv ConvModule's `.conv` (k x k, biased); its ReLU, where there is
    one, is the caller's."""

    def __init__(self, in_channels, out_channels, kernel_size=1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=kernel_size // 2)


def _lecun_init(module: nn.Module, generator: torch.Generator):
    """flax's default init of every conv: lecun-normal kernels (a
    transposed conv's fan-in in x kh x kw), zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.ConvTranspose2d):
                w = m.weight
                lecun_normal_(w, generator,
                              fan_in=w.shape[0] * w[0, 0].numel())
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
            else:
                continue
            nn.init.zeros_(m.bias)


class HTCMaskHead(FCNMaskHead):

    def __init__(self, with_conv_res=True, **kwargs):
        super().__init__(**kwargs)
        if with_conv_res:
            c = self.conv_logits.in_channels
            self.conv_res = ConvModule(c, c)

    def init_weights(self, generator: torch.Generator):
        _lecun_init(self, generator)

    def tower(self, x: torch.Tensor, res_feat=None) -> torch.Tensor:
        if res_feat is not None:
            x = x + torch.relu(self.conv_res.conv(res_feat))
        return super().tower(x)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """`jax.image.resize(..., 'bilinear')` of NCHW maps: half-pixel
    centres, antialiased where it downsamples."""
    return F.interpolate(x, size=tuple(size), mode='bilinear',
                         align_corners=False,
                         antialias=x.shape[-2] > size[0] or
                         x.shape[-1] > size[1])


class FusedSemanticHead(nn.Module):

    def __init__(self, num_ins=5, in_channels=256, conv_out_channels=256,
                 num_classes=183, num_convs=4):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels, conv_out_channels)
            for _ in range(num_ins))
        self.convs = nn.ModuleList(
            ConvModule(conv_out_channels, conv_out_channels, 3)
            for _ in range(num_convs))
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)
        self.conv_embedding = ConvModule(conv_out_channels,
                                         conv_out_channels)

    def init_weights(self, generator: torch.Generator):
        _lecun_init(self, generator)

    def forward(self, feats):
        """FPN levels (B, C, H_l, W_l) -> seg logits (B, K, H_1, W_1)
        float32 and the semantic feature (B, C', H_1, W_1)."""
        size = feats[1].shape[-2:]
        fused = 0.0
        for lateral, f in zip(self.lateral_convs, feats):
            lat = lateral.conv(f)
            if lat.shape[-2] != size[0]:
                lat = resize_bilinear(lat, size)
            fused = fused + lat
        x = fused
        for m in self.convs:
            x = torch.relu(m.conv(x))
        return self.conv_logits(x).float(), self.conv_embedding.conv(x)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """`jax.image.resize(..., 'nearest')` of the last two axes: output
    pixel i reads input floor((i + 0.5) * in / out), in float32."""
    for axis, n in ((-2, size[0]), (-1, size[1])):
        m = x.shape[axis]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device)
                    + 0.5) * m / n).floor().long()
            x = x.index_select(x.dim() + axis, idx)
    return x


def foreground_map(gt_masks, gt_valid, size) -> torch.Tensor:
    """(B, H, W) int64 0 / 1: any valid gt's mask, resized nearest to
    `size` (`ld_tpu/models/heads/htc_roi_head.py:147-158`)."""
    m = resize_nearest(gt_masks, size).float()
    fg = (m * gt_valid.float()[..., None, None]).sum(1).clamp(0, 1)
    return fg.long()


@HEADS.register_module()
class HybridTaskCascadeRoIHead(CascadeRoIHead):

    def __init__(self, num_stages=3, mask_head=None, semantic_head=None,
                 with_semantic=None, loss_semantic_weight=0.2, **kwargs):
        super().__init__(num_stages=num_stages, **kwargs)
        mh = dict(mask_head or {})
        mh.pop('type', None)
        self.mask_roi_size = mh.get('roi_size', 14)
        self.mask_head = nn.ModuleList(HTCMaskHead(
            with_conv_res=i > 0, num_classes=self.num_classes,
            num_convs=mh.get('num_convs', 4),
            in_channels=mh.get('in_channels', 256),
            conv_out_channels=mh.get('conv_out_channels', 256),
            roi_size=self.mask_roi_size,
            mask_stride=mh.get('mask_stride', 4)) for i in range(num_stages))
        self.with_semantic = bool(semantic_head) if with_semantic is None \
            else with_semantic
        sh = dict(semantic_head or {})
        self.semantic_stride = sh.get('stride', 8)
        self.loss_semantic_weight = loss_semantic_weight
        self.semantic_head = FusedSemanticHead(
            num_ins=sh.get('num_ins', 5),
            in_channels=sh.get('in_channels', 256),
            conv_out_channels=sh.get('conv_out_channels', 256),
            num_classes=sh.get('num_classes', self.num_classes + 1)) \
            if self.with_semantic else None

    @property
    def with_test_masks(self) -> bool:
        return False

    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        if self.semantic_head is not None:
            self.semantic_head.init_weights(generator)

    def _semantic_crop(self, sem_feat, rois, valid, out_size):
        """(B * n, C, S, S) crops of the semantic feature, zeros where not
        `valid`."""
        b, n = rois.shape[:2]
        owner = torch.arange(b, device=rois.device).repeat_interleave(n)
        crop = roi_align(sem_feat, rois.reshape(-1, 4), owner, out_size,
                         1.0 / self.semantic_stride)
        return crop * valid.reshape(-1, 1, 1, 1).to(crop.dtype)

    def semantic_loss(self, seg, batch):
        """`loss_semantic_seg` of the (B, K, h, w) seg logits, or None
        where the batch has neither `gt_semantic_seg` nor `gt_masks`."""
        if 'gt_semantic_seg' in batch:
            target = batch['gt_semantic_seg'].long()
        elif 'gt_masks' in batch:
            target = foreground_map(batch['gt_masks'], batch['gt_valid'],
                                    seg.shape[-2:])
        else:
            return None
        ce = F.cross_entropy(seg, target, reduction='none')
        return self.loss_semantic_weight * global_mean(ce.mean(dim=(1, 2)))

    def htc_mask_loss(self, i, feats, sem_feat, s: Dict, gt_masks):
        """Stage i's mask loss on the positive slice of its rois `s`."""
        s = self.positive_slice(s)
        x = self._mask_feats(feats, s['rois'], s['roi_pos'])
        if sem_feat is not None:
            x = x + self._semantic_crop(sem_feat, s['rois'], s['roi_pos'],
                                        self.mask_roi_size)
        last = None
        with torch.no_grad():
            for head in self.mask_head[:i]:
                last = head.tower(x, last)
        head = self.mask_head[i]
        return head.logits_loss(head.logits(head.tower(x, last)), s['rois'],
                                s['roi_pos'], s['labels'], s['gt_inds'],
                                gt_masks)

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        losses = {}
        sem_feat = None
        if self.semantic_head is not None:
            seg, sem_feat = self.semantic_head(feats)
            loss = self.semantic_loss(seg, batch)
            if loss is not None:
                losses['loss_semantic_seg'] = loss
        boxes, valid = proposals, prop_valid
        for i in range(self.num_stages):
            s = self.sample_stage(i, boxes, valid, batch, generator)
            x = self._extract(feats, s['rois'], s['roi_valid'])
            if sem_feat is not None:
                x = x + self._semantic_crop(sem_feat, s['rois'],
                                            s['roi_valid'], self.roi_size)
            cls, reg = self.bbox_head[i](x)
            w = self.stage_loss_weights[i]
            for k, v in self.bbox_losses(cls, reg, s).items():
                losses[f'{k}_s{i}'] = w * v
            if 'gt_masks' in batch:
                losses[f'loss_mask_s{i}'] = w * self.htc_mask_loss(
                    i, feats, sem_feat, s, batch['gt_masks'])
            boxes, valid = self.refine(i, s, reg), s['roi_valid']
        return losses


class GlobalContextHead(nn.Module):
    """SCNet's global-context branch (the JAX `GlobalContextNet`), in
    float32."""

    def __init__(self, num_classes=80, in_channels=256, channels=256):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, channels)
        self.fc_cls = nn.Linear(channels, num_classes)
        self.fc_ctx = nn.Linear(channels, channels)

    def init_weights(self, generator: torch.Generator):
        """flax Dense's init: lecun-normal kernels, zero biases."""
        with torch.no_grad():
            for fc in (self.fc1, self.fc_cls, self.fc_ctx):
                lecun_normal_(fc.weight, generator)
                nn.init.zeros_(fc.bias)

    def forward(self, feats):
        """FPN levels (B, C, H_l, W_l) -> (multilabel logits (B, K), the
        context vector (B, channels))."""
        pooled = sum(f.float().mean(dim=(2, 3)) for f in feats) / len(feats)
        x = torch.relu(self.fc1(pooled))
        return self.fc_cls(x), self.fc_ctx(x)


@HEADS.register_module()
class SCNetRoIHead(HybridTaskCascadeRoIHead):

    def __init__(self, *args, glbctx_weight=3.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.glbctx_weight = glbctx_weight
        # its fc1 reads the FPN's width, the bbox heads' input
        bh = kwargs.get('bbox_head') or {}
        bh = bh[0] if isinstance(bh, (list, tuple)) else bh
        self.glbctx_head = GlobalContextHead(self.num_classes,
                                             bh.get('in_channels', 256))

    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        self.glbctx_head.init_weights(generator)

    def glbctx_loss(self, feats, batch) -> torch.Tensor:
        """`loss_glbctx` of the FPN levels `feats` against each image's
        valid gt labels."""
        logits, _ = self.glbctx_head(feats)
        labels = batch['gt_labels'].long().clamp(0, self.num_classes - 1)
        onehot = F.one_hot(labels, self.num_classes).to(logits.dtype) * \
            batch['gt_valid'].to(logits.dtype)[..., None]
        target = onehot.clamp(0, 1).amax(dim=1)
        bce = F.binary_cross_entropy_with_logits(logits, target,
                                                 reduction='none')
        return self.glbctx_weight * global_mean(bce)

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        losses = super().forward_train(feats, proposals, prop_valid, batch,
                                       generator)
        losses['loss_glbctx'] = self.glbctx_loss(feats, batch)
        return losses
