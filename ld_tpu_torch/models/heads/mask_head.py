"""The FCN mask head of Mask R-CNN and its targets; port of
`ld_tpu/models/heads/mask_head.py`, NCHW.

  * `FCNMaskHead`, under mmdet's `roi_head.mask_head` names: `num_convs`
    3x3 convs + ReLU (`convs.i.conv`), a 2x2 stride-2 transposed conv +
    ReLU (`upsample`) and a 1x1 conv to one mask a class (`conv_logits`;
    one in all with `class_agnostic`): (R, C, 14, 14) roi features ->
    (R, K, 28, 28) float32 logits. With a compute dtype the convs compute
    in it (`models/layers.py`).
  * `mask_targets`: each roi's assigned gt mask, cropped and resized to
    the logits' size by the port's RoIAlign at 1 / `mask_stride` with 2 x 2
    samples a bin (ROADMAP.md caveat 18's sampling). RoIAlign reads the
    batch's (B, G, H/4, W/4) gt stack as (B x G) one-channel maps, each
    roi pointed at its image's gt, so no roi copies a whole mask.
  * `loss`: the BCE with logits of the roi's class channel (clip(label, 0,
    C - 1)) against its target, meaned over the mask's pixels, summed over
    an image's positive rois and divided by their count (at least 1), then
    meaned over the images, times `loss_mask['loss_weight']` (the JAX head
    reads no other key of `loss_mask`, and has no `CrossEntropyLoss(
    use_mask=True)`: ROADMAP.md caveat 24). Over R ranks a rank's share is
    the sum over its images divided by the global image count
    (`parallel/train_step.py`).
  * `predict`: the sigmoid of the detection's class channel.

A `conv_cfg` / `norm_cfg` (the gn, gn+ws and gn-all configs) is accepted
and not read, as the JAX head takes them into `**kwargs` and drops them
(`ld_tpu/models/heads/mask_head.py:75-87`): the convs stay plain, with a
bias, and a warning names ROADMAP.md Queue C caveat 37. A published
gn-all checkpoint's `convs.i.gn.*` keys then have no place to load.
"""
from __future__ import annotations

import warnings

import torch
from torch import nn

from ld_tpu_torch.models.layers import (Conv2d, ConvTranspose2d, he_normal_,
                                        lecun_normal_, lowered_dtype)
from ld_tpu_torch.ops.roi_align import roi_align
from ld_tpu_torch.parallel.dist import global_mean
from ld_tpu_torch.utils.registry import HEADS


def mask_targets(gt_masks: torch.Tensor, rois: torch.Tensor,
                 gt_inds: torch.Tensor, out_size: int,
                 mask_stride: float) -> torch.Tensor:
    """Args:
        gt_masks: (B, G, Hm, Wm) 0/1 (uint8 or float) at 1 / mask_stride.
        rois: (B, n, 4) in image coordinates; gt_inds: (B, n) the gt of
            each roi.
    Returns:
        (B * n, out_size, out_size) float32 targets in [0, 1].
    """
    b, g = gt_masks.shape[:2]
    maps = gt_masks.reshape(b * g, 1, *gt_masks.shape[2:])
    owner = (torch.arange(b, device=rois.device)[:, None] * g +
             gt_inds).reshape(-1)
    return roi_align(maps, rois.reshape(-1, 4).float(), owner, out_size,
                     1.0 / mask_stride, sampling_ratio=2)[:, 0]


class _MaskConv(nn.Module):
    """mmcv ConvModule's `.conv`, its ReLU in `FCNMaskHead.forward`."""

    def __init__(self, in_channels, out_channels, dtype=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, padding=1,
                           compute_dtype=dtype)


@HEADS.register_module()
class FCNMaskHead(nn.Module):

    def __init__(self, num_classes=80, num_convs=4, in_channels=256,
                 conv_out_channels=256, roi_size=14, mask_stride=4,
                 loss_mask=None, class_agnostic=False, dtype=None,
                 conv_cfg=None, norm_cfg=None, upsample_cfg=None, **kwargs):
        super().__init__()
        dropped = [k for k, v in (('conv_cfg', conv_cfg),
                                  ('norm_cfg', norm_cfg)) if v is not None]
        if dropped:
            warnings.warn(
                f'FCNMaskHead {" and ".join(dropped)} not read: its convs '
                'stay plain with a bias, as in the JAX head (ROADMAP.md '
                'Queue C, caveat 37)', stacklevel=2)
        if upsample_cfg is not None and \
                upsample_cfg.get('type', 'deconv') != 'deconv':
            raise NotImplementedError(
                f"mask head upsample {upsample_cfg['type']!r} is not ported "
                'to ld_tpu_torch yet (see ROADMAP.md Queue A, keys that '
                'still raise)')
        self.num_classes = num_classes
        self.roi_size = roi_size
        self.mask_stride = mask_stride
        self.class_agnostic = class_agnostic
        self.loss_weight = (loss_mask or {}).get('loss_weight', 1.0)
        dtype = lowered_dtype(dtype)
        self.convs = nn.ModuleList()
        c = in_channels
        for _ in range(num_convs):
            self.convs.append(_MaskConv(c, conv_out_channels, dtype))
            c = conv_out_channels
        self.upsample = ConvTranspose2d(c, conv_out_channels, 2, stride=2,
                                        compute_dtype=dtype)
        self.conv_logits = Conv2d(conv_out_channels,
                                  1 if class_agnostic else num_classes, 1,
                                  compute_dtype=dtype)

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: he-normal 3x3 convs, lecun-normal
        upsample (fan-in in x 2 x 2) and logits, zero biases."""
        with torch.no_grad():
            for m in self.convs:
                he_normal_(m.conv.weight, generator)
            w = self.upsample.weight
            lecun_normal_(w, generator, fan_in=w.shape[0] * w[0, 0].numel())
            lecun_normal_(self.conv_logits.weight, generator)
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    nn.init.zeros_(m.bias)

    def tower(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, S, S) roi features -> the convs' (R, C', S, S) output."""
        for m in self.convs:
            x = torch.relu(m.conv(x))
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The tower's output -> (R, K, 2S, 2S) float32 logits."""
        return self.conv_logits(torch.relu(self.upsample(x))).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, S, S) roi features -> (R, K, 2S, 2S) float32 logits."""
        return self.logits(self.tower(x))

    def _select(self, logits, labels):
        if self.class_agnostic:
            return logits[:, 0]
        s = logits.shape[-1]
        safe = labels.reshape(-1).clamp(0, self.num_classes - 1)
        return torch.gather(logits, 1, safe[:, None, None, None].expand(
            -1, 1, s, s))[:, 0]

    def loss(self, roi_feats, rois, roi_pos, labels, gt_inds, gt_masks
             ) -> torch.Tensor:
        """Args:
            roi_feats: (B * n, C, S, S), zeros for rois that are not
                positive; rois (B, n, 4); roi_pos, labels, gt_inds (B, n);
            gt_masks: (B, G, H / mask_stride, W / mask_stride).
        Returns:
            the weighted loss, a scalar.
        """
        return self.logits_loss(self(roi_feats), rois, roi_pos, labels,
                                gt_inds, gt_masks)

    def logits_loss(self, logits, rois, roi_pos, labels, gt_inds, gt_masks
                    ) -> torch.Tensor:
        """`loss` of the rois' (B * n, K, 2S, 2S) logits."""
        b, n = roi_pos.shape
        sel = self._select(logits, labels)
        targets = mask_targets(gt_masks, rois, gt_inds, sel.shape[-1],
                               self.mask_stride)
        bce = sel.clamp(min=0) - sel * targets + \
            torch.log1p(torch.exp(-sel.abs()))
        per_roi = bce.mean(dim=(1, 2)).reshape(b, n)
        posf = roi_pos.float()
        per_img = (per_roi * posf).sum(-1) / posf.sum(-1).clamp(min=1.0)
        return self.loss_weight * global_mean(per_img)

    def predict(self, roi_feats, labels) -> torch.Tensor:
        """(R, 2S, 2S) sigmoid masks of the detections' classes."""
        return torch.sigmoid(self._select(self(roi_feats), labels))

