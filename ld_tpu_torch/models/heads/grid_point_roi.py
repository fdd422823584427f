"""Grid R-CNN and PointRend RoI heads (port of
`ld_tpu/models/heads/grid_point_roi.py:34-337`), NCHW.

  * `GridRoIHead`: the standard RoI head plus the JAX grid net
    (`grid_head`: 8 3x3 conv + GN(32) + ReLU, `convs.i.conv` / `.gn`, then
    two 2x2 stride-2 transposed convs `deconv1` (+ ReLU) and `deconv2`):
    14x14 features of the whisker-expanded rois (1 + 2 x 0.25 their extent)
    -> 9 point heatmaps at 56x56. Training adds `loss_grid`: 15 x the BCE
    of each heatmap against a Gaussian (sigma 1 px) at its grid point of
    the assigned gt, meaned over the map, over the points that fall inside
    the roi, summed over the positive rois of a fresh `sample_rois` draw
    (JAX draws one with its own key) and divided by their count. At test
    time each detection's box is rebuilt from its heatmaps: each point at
    its map's argmax (the first index on ties), each edge the
    confidence-weighted mean of its three border points.
  * `PointRendRoIHead`: Mask R-CNN's head plus the JAX point MLP
    (`point_head`: `fcs.i.conv` 1x1 Conv1d + ReLU, each fed the fine
    feature and, after each layer, the point's coarse logit; `fc_logits`).
    Training adds `loss_point`: on a fresh draw's positive rois, the K
    most uncertain points of the class's coarse 28x28 logits (smallest
    |logit|, ties to the lower index, as `lax.top_k` of -|logit|: a stable
    sort), fine features bilinear at those points of the 14x14 roi
    features, the BCE of the refined logit against the gt mask at the
    point. At test time the head is Mask R-CNN's, with coarse masks only:
    the JAX head has no subdivision pass (ROADMAP.md caveat 65).

The weights of both nets go JAX -> port (`state_dict_from_jax`). A
`GenericRoIExtractor` (GRoIE) as `grid_roi_extractor` pools the grid
features at every level (`roi_head.grid_roi_extractor.{pre,post}_module`,
`ld_tpu/models/heads/grid_point_roi.py:75-110`), as the bbox one does.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import (Conv2d, ConvTranspose2d, GroupNorm,
                                        lecun_normal_, lowered_dtype)
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.ops.roi_align import multi_level_roi_align
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .mask_head import mask_targets
from .roi_head import StandardRoIHead, build_roi_extractor

EPS = 1e-6


def whiskered(boxes: torch.Tensor, whisker: float) -> torch.Tensor:
    """Boxes (..., 4) expanded about their centres by 1 + 2 x whisker."""
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    hw = (boxes[..., 2] - boxes[..., 0]) * (0.5 + whisker)
    hh = (boxes[..., 3] - boxes[..., 1]) * (0.5 + whisker)
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)


class _ConvGN(nn.Module):

    def __init__(self, cin, cout, dtype=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1, compute_dtype=dtype)
        self.gn = GroupNorm(min(32, cout), cout, eps=1e-5)


class GridHead(nn.Module):
    """The JAX `GridHeadNet`: (R, C, S, S) -> (R, 9, 4S, 4S) float32
    logits. The GroupNorms normalise in float32 (flax's without a
    dtype)."""

    def __init__(self, in_channels=256, grid_points=9, conv_out_channels=64,
                 num_convs=8, dtype=None):
        super().__init__()
        dtype = lowered_dtype(dtype)
        self.convs = nn.ModuleList(
            _ConvGN(in_channels if i == 0 else conv_out_channels,
                    conv_out_channels, dtype) for i in range(num_convs))
        self.deconv1 = ConvTranspose2d(conv_out_channels, conv_out_channels,
                                       2, stride=2, compute_dtype=dtype)
        self.deconv2 = ConvTranspose2d(conv_out_channels, grid_points, 2,
                                       stride=2, compute_dtype=dtype)

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            for m in self.convs:
                lecun_normal_(m.conv.weight, generator)
                m.gn.reset_parameters()
            for m in (self.deconv1, self.deconv2):
                w = m.weight
                lecun_normal_(w, generator,
                              fan_in=w.shape[0] * w[0, 0].numel())
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    nn.init.zeros_(m.bias)

    def forward(self, x):
        for m in self.convs:
            x = F.relu(m.gn(m.conv(x).float()))
        x = F.relu(self.deconv1(x))
        return self.deconv2(x).float()


@HEADS.register_module()
class GridRoIHead(StandardRoIHead):

    def __init__(self, grid_roi_extractor=None, grid_head=None, **kwargs):
        gext = dict(grid_roi_extractor or {})
        super().__init__(**kwargs)
        gh = dict(grid_head or {})
        self.grid_points = gh.get('grid_points', 9)
        self.grid_side = int(round(self.grid_points ** 0.5))
        self.grid_roi_size = (gext.get('roi_layer') or {}).get(
            'output_size', 14)
        self.whisker = gh.get('whisker', 0.25)
        in_channels = dict(kwargs.get('bbox_head') or {}).get(
            'in_channels', 256)
        self.grid_roi_extractor = build_roi_extractor(
            gext, self.grid_roi_size, self.featmap_strides, in_channels)
        self.grid_head = GridHead(
            in_channels, self.grid_points, gh.get('conv_out_channels', 64),
            gh.get('num_convs', 8), kwargs.get('dtype'))

    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        self.grid_head.init_weights(generator)
        if self.grid_roi_extractor is not None:
            self.grid_roi_extractor.init_weights(generator)

    def _grid_heat(self, feats, boxes, valid):
        """The grid net's (R, 9, S, S) logits of whisker-expanded `boxes`
        (B, n, 4)."""
        if self.grid_roi_extractor is not None:
            return self.grid_head(self.grid_roi_extractor(feats, boxes,
                                                          valid))
        return self.grid_head(multi_level_roi_align(
            feats[:len(self.featmap_strides)], boxes, valid,
            self.grid_roi_size, self.featmap_strides))

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        losses = super().forward_train(feats, proposals, prop_valid, batch,
                                       generator)
        s = self.positive_slice(self.sample_rois(
            proposals, prop_valid, batch['gt_bboxes'],
            batch['gt_labels'].long(), batch['gt_valid'], generator))
        rois = whiskered(s['rois'], self.whisker).reshape(-1, 4)
        heat = self._grid_heat(feats, rois.reshape(s['rois'].shape),
                               s['roi_pos'])
        size = heat.shape[-1]
        gt = torch.gather(batch['gt_bboxes'], 1, s['gt_inds'][..., None]
                          .expand(-1, -1, 4)).reshape(-1, 4)
        # the grid points of each roi's gt, row-major (y_i, x_j), in the
        # heatmap's pixels
        fr = torch.linspace(0.0, 1.0, self.grid_side, device=rois.device)
        gx = gt[:, 0:1] + fr * (gt[:, 2:3] - gt[:, 0:1])
        gy = gt[:, 1:2] + fr * (gt[:, 3:4] - gt[:, 1:2])
        px = gx.repeat(1, self.grid_side)
        py = gy.repeat_interleave(self.grid_side, dim=1)
        rw = (rois[:, 2] - rois[:, 0]).clamp(min=EPS)[:, None]
        rh = (rois[:, 3] - rois[:, 1]).clamp(min=EPS)[:, None]
        u = (px - rois[:, 0:1]) / rw * size
        v = (py - rois[:, 1:2]) / rh * size
        xs = torch.arange(size, dtype=torch.float32, device=rois.device)
        gaussx = torch.exp(-(xs - u[..., None]) ** 2 / 2)
        gaussy = torch.exp(-(xs - v[..., None]) ** 2 / 2)
        target = gaussy[..., :, None] * gaussx[..., None, :]
        inside = ((u >= 0) & (u < size) & (v >= 0) & (v < size)).float()
        bce = heat.clamp(min=0) - heat * target + \
            torch.log1p(torch.exp(-heat.abs()))
        per = (bce.mean(dim=(2, 3)) * inside).sum(1) / \
            inside.sum(1).clamp(min=1.0)
        posf = s['roi_pos'].reshape(-1).float()
        losses['loss_grid'] = 15.0 * (per * posf).sum() / \
            global_sum(posf.sum()).clamp(min=1.0)
        return losses

    def simple_test(self, feats, proposals, prop_valid, img_hw,
                    scale_factor=None, rescale=False, cfg=None,
                    keep_fn=nms_keep):
        """The standard head's detections, each box rebuilt from its grid
        heatmaps (`ld_tpu/models/heads/grid_point_roi.py:164-219`)."""
        dets, labels, valid = super().simple_test(
            feats, proposals, prop_valid, img_hw, cfg=cfg, keep_fn=keep_fn)
        raw = dets[..., :4]
        ok = dets[..., 4] > 0
        boxes = whiskered(raw, self.whisker)
        heat = torch.sigmoid(self._grid_heat(feats, boxes, ok))
        k, p, size = heat.shape[0], heat.shape[1], heat.shape[-1]
        flat = heat.reshape(k, p, size * size)
        idx = flat.argmax(-1)                       # the first on ties
        conf = torch.gather(flat, 2, idx[..., None])[..., 0]
        bx = boxes.reshape(-1, 4)
        rw = (bx[:, 2] - bx[:, 0]).clamp(min=EPS)[:, None]
        rh = (bx[:, 3] - bx[:, 1]).clamp(min=EPS)[:, None]
        x = bx[:, 0:1] + ((idx % size).float() + 0.5) / size * rw
        y = bx[:, 1:2] + ((idx // size).float() + 0.5) / size * rh
        point = torch.arange(p, device=heat.device)
        col, row = point % self.grid_side, point // self.grid_side

        def edge(vals, member):
            w = conf * member.float()
            return (vals * w).sum(-1) / w.sum(-1).clamp(min=EPS)

        n = self.grid_side - 1
        refined = torch.stack([edge(x, col == 0), edge(y, row == 0),
                               edge(x, col == n), edge(y, row == n)],
                              -1).reshape(raw.shape)
        refined = torch.where(ok[..., None], refined, raw)
        if rescale and scale_factor is not None:
            refined = refined / torch.as_tensor(
                scale_factor, dtype=torch.float32,
                device=refined.device)[:, None, :]
        return torch.cat([refined, dets[..., 4:5]], -1), labels, valid


def bilinear_points(fmap: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """The JAX `_bilinear_points` over a batch: fmap (R, C, H, W); u, v
    (R, K) in pixel coordinates (no half-pixel shift, indices clipped to
    the map) -> (R, C, K)."""
    r, c, h, w = fmap.shape
    flat = fmap.reshape(r, c, h * w)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0

    def g(vi, ui):
        i = vi.clamp(0, h - 1).long() * w + ui.clamp(0, w - 1).long()
        return torch.gather(flat, 2, i[:, None, :].expand(-1, c, -1))

    return (g(v0, u0) * ((1 - dv) * (1 - du))[:, None] +
            g(v0, u0 + 1) * ((1 - dv) * du)[:, None] +
            g(v0 + 1, u0) * (dv * (1 - du))[:, None] +
            g(v0 + 1, u0 + 1) * (dv * du)[:, None])


class _PointFC(nn.Module):

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 1)


class MaskPointHead(nn.Module):
    """The JAX `MaskPointHeadNet`: (R, C, K) fine features and (R, 1, K)
    coarse logits -> (R, num_classes, K) float32 logits; every layer is
    fed the coarse logit again."""

    def __init__(self, num_classes, in_channels=256, fc_channels=256,
                 num_fcs=3):
        super().__init__()
        self.fcs = nn.ModuleList(
            _PointFC((in_channels if i == 0 else fc_channels) + 1,
                     fc_channels) for i in range(num_fcs))
        self.fc_logits = nn.Conv1d(fc_channels + 1, num_classes, 1)

    def init_weights(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, fine, coarse):
        x = torch.cat([fine, coarse], 1)
        for m in self.fcs:
            x = torch.cat([F.relu(m.conv(x)), coarse], 1)
        return self.fc_logits(x).float()


@HEADS.register_module()
class PointRendRoIHead(StandardRoIHead):

    def __init__(self, point_head=None, num_points=196, oversample_ratio=3,
                 importance_sample_ratio=0.75, **kwargs):
        # as the JAX head, the sampling ratios are not read
        kwargs.setdefault('mask_head', dict(num_convs=4))
        super().__init__(**kwargs)
        ph = dict(point_head or {})
        self.num_points = ph.get('num_points', num_points)
        self.point_head = MaskPointHead(
            self.num_classes,
            ph.get('in_channels',
                   dict(kwargs['mask_head']).get('in_channels', 256)),
            ph.get('fc_channels', 256), ph.get('num_fcs', 3))

    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        self.point_head.init_weights(generator)

    def point_indices(self, logits: torch.Tensor) -> torch.Tensor:
        """The `num_points` most uncertain cells of each (R, S, S) logit
        map, flat, ties to the lower index: (R, K)."""
        flat = logits.reshape(logits.shape[0], -1)
        order = torch.sort(flat.abs(), dim=1, stable=True).indices
        return order[:, :self.num_points]

    def point_loss(self, feats, s: Dict, gt_masks) -> torch.Tensor:
        """`loss_point` of the sampled rois `s` on their positive slice."""
        s = self.positive_slice(s)
        roi_feats = self._mask_feats(feats, s['rois'], s['roi_pos'])
        labels = s['labels'].reshape(-1)
        sel = self.mask_head._select(self.mask_head(roi_feats), labels)
        out = sel.shape[-1]
        idx = self.point_indices(sel)
        flat = sel.reshape(sel.shape[0], -1)
        pu = (idx % out).float() + 0.5
        pv = torch.div(idx, out, rounding_mode='floor').float() + 0.5
        h, w = roi_feats.shape[-2:]
        fine = bilinear_points(roi_feats, pu / out * w, pv / out * h)
        coarse = torch.gather(flat, 1, idx)[:, None]
        refined = self.point_head(fine.to(coarse.dtype), coarse)
        safe = labels.clamp(0, self.num_classes - 1)
        ref = torch.gather(refined, 1, safe[:, None, None].expand(
            -1, 1, idx.shape[1]))[:, 0]
        target = mask_targets(gt_masks, s['rois'], s['gt_inds'], out,
                              self.mask_head.mask_stride)
        target = torch.gather(target.reshape(target.shape[0], -1), 1, idx)
        bce = ref.clamp(min=0) - ref * target + \
            torch.log1p(torch.exp(-ref.abs()))
        posf = s['roi_pos'].reshape(-1).float()
        return (bce.mean(1) * posf).sum() / \
            global_sum(posf.sum()).clamp(min=1.0)

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        losses = super().forward_train(feats, proposals, prop_valid, batch,
                                       generator)
        if 'gt_masks' in batch:
            s = self.sample_rois(proposals, prop_valid, batch['gt_bboxes'],
                                 batch['gt_labels'].long(),
                                 batch['gt_valid'], generator)
            losses['loss_point'] = self.point_loss(feats, s,
                                                   batch['gt_masks'])
        return losses
