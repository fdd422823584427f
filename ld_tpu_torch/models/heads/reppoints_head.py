"""RepPoints head (point-set representation with DCN); port of
`ld_tpu/models/heads/reppoints_head.py:31-343`, NCHW.

  * forward, a level at a time: GN towers (`cls_convs.i.{conv,gn}`,
    `reg_convs.i.{conv,gn}`, the GFL head's `ConvGNBlock`); the init points
    `reppoints_pts_init_out(relu(reppoints_pts_init_conv(reg)))`: 9 (dy, dx)
    pairs, y first (with `use_grid_points`, a 4-channel box regression
    turned into a 3x3 grid on its box by `gen_grid_from_reg`); the DCN
    offsets are (1 - gradient_mul) of the detached init points plus
    gradient_mul of the live ones, minus the regular grid `dcn_base`
    (y first, y slowest), so that a gradient_mul share of the offsets'
    gradient reaches the init branch; the class logits
    `reppoints_cls_out(relu(reppoints_cls_conv(cls, offsets)))` and the
    refine points: `reppoints_pts_refine_out(relu(
    reppoints_pts_refine_conv(reg, offsets)))` plus the detached init
    points (the grid form: the grid of that regression on the detached
    init box); both point sets become boxes in stride units through
    `points2bbox_shifts` ('minmax', 'partial_minmax' or 'moment', whose
    learnable `moment_transfer` reaches the loss damped by `moment_mul`).
    The two DCNs are `ops.deform_conv.DeformConv` (DCNv1, plain torch).
  * loss: the init boxes against `PointAssigner` targets (or MaxIoU over
    the base-scale boxes when the head's `train_cfg.init.assigner` names
    `MaxIoUAssigner`), the refine boxes against MaxIoU on the detached init
    boxes; smooth L1 on boxes over point_base_scale x stride, averaged over
    4 x the positives; focal over the refine positives.
  * get_bboxes: the level's `nms_pre` top-k on the max class sigmoid, the
    refine boxes clipped to the image, then `multiclass_nms`, whose keep
    mask is `nms_keep`.

`center_init` and `norm_cfg` are stored and never read, as in the JAX head:
the towers are always GN (ROADMAP.md caveat 50). Module names are mmdet's;
the JAX converter has no RepPoints rule, so weights reach the port from a
JAX tree through `state_dict_from_jax`.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ld_tpu_torch.models.layers import Conv2d, lecun_normal_
from ld_tpu_torch.ops.deform_conv import DeformConv
from ld_tpu_torch.ops.extra_assigners import PointAssigner
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import (_CLS_BIAS_INIT, ConvGNBlock, _gather_rows,
                       flatten_level, flatten_levels)


def points2bbox_shifts(pts: torch.Tensor, method: str,
                       moment_transfer: torch.Tensor = None,
                       moment_mul: float = 0.01) -> torch.Tensor:
    """(..., 2P) y-first point shifts -> (..., 4) box in shift units:
    'minmax' (all points), 'partial_minmax' (the first 4) or 'moment' (the
    mean +- the unbiased std, +1e-12 under the root, times
    exp(moment_transfer), whose gradient is scaled by `moment_mul`)."""
    p = pts.reshape(*pts.shape[:-1], -1, 2)
    py, px = p[..., 0], p[..., 1]
    if method in ('minmax', 'partial_minmax'):
        if method == 'partial_minmax':
            py, px = py[..., :4], px[..., :4]
        return torch.stack([px.amin(-1), py.amin(-1), px.amax(-1),
                            py.amax(-1)], -1)
    if method != 'moment':
        raise ValueError(f'transform_method {method!r}')
    my = py.mean(-1)
    mx = px.mean(-1)
    n = py.shape[-1]
    corr = n / max(n - 1, 1)
    sy = torch.sqrt(((py - my[..., None]) ** 2).mean(-1) * corr + 1e-12)
    sx = torch.sqrt(((px - mx[..., None]) ** 2).mean(-1) * corr + 1e-12)
    mt = moment_transfer * moment_mul + \
        moment_transfer.detach() * (1 - moment_mul)
    hw = sx * torch.exp(mt[0])
    hh = sy * torch.exp(mt[1])
    return torch.stack([mx - hw, my - hh, mx + hw, my + hh], -1)


def gen_grid_from_reg(reg: torch.Tensor, prev_box: torch.Tensor, k: int):
    """A (..., 4) [dx, dy, dlog_w, dlog_h] regression relative to
    `prev_box` (..., 4) xyxy -> the k x k grid on the regressed box,
    (..., 2k^2) (y, x) pairs with y slowest, and the box (..., 4)."""
    bxy = (prev_box[..., :2] + prev_box[..., 2:]) * 0.5
    bwh = (prev_box[..., 2:] - prev_box[..., :2]).clamp(min=1e-6)
    wh = bwh * torch.exp(reg[..., 2:])
    topleft = bxy + bwh * reg[..., :2] - 0.5 * wh
    t = torch.linspace(0.0, 1.0, k, dtype=reg.dtype, device=reg.device)
    gx = topleft[..., 0:1] + wh[..., 0:1] * t                  # (..., k)
    gy = topleft[..., 1:2] + wh[..., 1:2] * t
    yy = gy.repeat_interleave(k, dim=-1)                        # (..., k*k)
    xx = gx.repeat(*(1, ) * (gx.dim() - 1), k)
    pts = torch.stack([yy, xx], -1).reshape(*reg.shape[:-1], -1)
    return pts, torch.cat([topleft, topleft + wh], -1)


@HEADS.register_module()
class RepPointsHead(nn.Module):

    cls_pred_name = 'reppoints_cls_out'

    def __init__(self, num_classes=80, in_channels=256, feat_channels=256,
                 point_feat_channels=256, stacked_convs=3, num_points=9,
                 gradient_mul=0.1, point_strides=(8, 16, 32, 64, 128),
                 point_base_scale=4, transform_method='moment',
                 moment_mul=0.01, use_grid_points=False, center_init=True,
                 loss_cls=None, loss_bbox_init=None, loss_bbox_refine=None,
                 train_cfg=None, test_cfg=None, norm_cfg=None, dtype=None,
                 **kwargs):
        super().__init__()
        if transform_method not in ('minmax', 'partial_minmax', 'moment'):
            raise ValueError(f'transform_method {transform_method!r}')
        self.num_classes = num_classes
        self.cls_out_channels = num_classes
        self.strides = tuple(point_strides)
        self.point_base_scale = point_base_scale
        self.gradient_mul = gradient_mul
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        self.use_grid_points = use_grid_points
        # stored and never read, as in the JAX head (ROADMAP.md caveat 50)
        self.center_init, self.norm_cfg = center_init, norm_cfg
        self.loss_cls = LOSSES.build(loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        self.loss_bbox_init = LOSSES.build(loss_bbox_init or dict(
            type='SmoothL1Loss', beta=1.0 / 9.0, loss_weight=0.5))
        self.loss_bbox_refine = LOSSES.build(loss_bbox_refine or dict(
            type='SmoothL1Loss', beta=1.0 / 9.0, loss_weight=1.0))
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or dict(
            nms_pre=1000, score_thr=0.05,
            nms=dict(type='nms', iou_threshold=0.5), max_per_img=100)
        init_cfg = dict(self.train_cfg.get('init', {}).get(
            'assigner', dict(scale=4, pos_num=1)))
        init_type = init_cfg.pop('type', 'PointAssigner')
        self.init_is_maxiou = init_type == 'MaxIoUAssigner'
        self.init_assigner = MaxIoUAssigner(**init_cfg) \
            if self.init_is_maxiou else PointAssigner(**init_cfg)
        refine_cfg = dict(self.train_cfg.get('refine', {}).get(
            'assigner', dict(pos_iou_thr=0.5, neg_iou_thr=0.4,
                             min_pos_iou=0.0)))
        refine_cfg.pop('type', None)
        self.refine_assigner = MaxIoUAssigner(**refine_cfg)

        self.k = int(math.sqrt(num_points))
        k = self.k
        base = np.stack([np.repeat(np.arange(k) - k // 2, k),
                         np.tile(np.arange(k) - k // 2, k)],
                        -1).reshape(-1).astype(np.float32)   # (2P,) y first
        self.register_buffer('dcn_base', torch.from_numpy(base),
                             persistent=False)
        self.cls_convs = nn.ModuleList(
            ConvGNBlock(in_channels if i == 0 else feat_channels,
                        feat_channels, dtype=dtype)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvGNBlock(in_channels if i == 0 else feat_channels,
                        feat_channels, dtype=dtype)
            for i in range(stacked_convs))
        pts_out_dim = 4 if use_grid_points else 2 * num_points
        self.reppoints_pts_init_conv = Conv2d(
            feat_channels, point_feat_channels, 3, padding=1,
            compute_dtype=dtype)
        self.reppoints_pts_init_out = Conv2d(
            point_feat_channels, pts_out_dim, 1, compute_dtype=dtype)
        self.reppoints_cls_conv = DeformConv(feat_channels,
                                             point_feat_channels)
        self.reppoints_cls_out = Conv2d(point_feat_channels, num_classes, 1,
                                        compute_dtype=dtype)
        self.reppoints_pts_refine_conv = DeformConv(feat_channels,
                                                    point_feat_channels)
        self.reppoints_pts_refine_out = Conv2d(
            point_feat_channels, pts_out_dim, 1, compute_dtype=dtype)
        if transform_method == 'moment':
            self.moment_transfer = nn.Parameter(torch.zeros(2))
        else:
            self.moment_transfer = None

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: normal(0.01) tower and output
        kernels, flax's default (lecun-normal) `reppoints_pts_init_conv`,
        he-normal DCN kernels, zero biases but the prior-0.01 class one,
        GN scale 1 / bias 0, a zero `moment_transfer`."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    m.reset_parameters()
            lecun_normal_(self.reppoints_pts_init_conv.weight, generator)
            for m in (self.reppoints_cls_conv,
                      self.reppoints_pts_refine_conv):
                m.init_weights(generator)
            nn.init.constant_(self.reppoints_cls_out.bias, _CLS_BIAS_INIT)
            if self.moment_transfer is not None:
                self.moment_transfer.zero_()

    def _to_box(self, pts):
        return points2bbox_shifts(pts, self.transform_method,
                                  self.moment_transfer, self.moment_mul)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (B, C, H, W), init boxes
        (B, 4, H, W), refine boxes (B, 4, H, W)) per level, float32; the
        boxes in stride units about each location."""
        cls_scores, sbox_inits, sbox_refines = [], [], []
        scale = self.point_base_scale / 2.0
        gm = self.gradient_mul
        for x in feats:
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            raw_init = self.reppoints_pts_init_out(torch.relu(
                self.reppoints_pts_init_conv(r))).float().permute(0, 2, 3, 1)
            if self.use_grid_points:
                prev = torch.tensor([-scale, -scale, scale, scale],
                                    device=x.device).expand(
                                        *raw_init.shape[:-1], 4)
                pts_init, bbox_init = gen_grid_from_reg(raw_init, prev,
                                                        self.k)
            else:
                pts_init = raw_init
            pts_gm = (1 - gm) * pts_init.detach() + gm * pts_init
            offset = (pts_gm - self.dcn_base).permute(0, 3, 1, 2)
            cls = self.reppoints_cls_out(torch.relu(
                self.reppoints_cls_conv(c, offset)))
            raw_refine = self.reppoints_pts_refine_out(torch.relu(
                self.reppoints_pts_refine_conv(r, offset))).float().permute(
                    0, 2, 3, 1)
            if self.use_grid_points:
                pts_refine, _ = gen_grid_from_reg(
                    raw_refine, bbox_init.detach(), self.k)
            else:
                pts_refine = raw_refine + pts_init.detach()
            cls_scores.append(cls.float())
            sbox_inits.append(self._to_box(pts_init).permute(0, 3, 1, 2))
            sbox_refines.append(self._to_box(pts_refine).permute(0, 3, 1, 2))
        return cls_scores, sbox_inits, sbox_refines

    # ---- geometry ------------------------------------------------------------
    def points(self, featmap_sizes, device):
        """Every location's (x, y) (N, 2), stride (N,) and level (N,)."""
        pts, strides, lvl_id = [], [], []
        for lvl, (h, w) in enumerate(featmap_sizes):
            s = float(self.strides[lvl])
            xs = np.tile(np.arange(w) * s, h)
            ys = np.repeat(np.arange(h) * s, w)
            pts.append(np.stack([xs, ys], -1).astype(np.float32))
            strides.append(np.full(h * w, s, np.float32))
            lvl_id.append(np.full(h * w, lvl, np.int64))
        return tuple(torch.from_numpy(np.concatenate(a)).to(device)
                     for a in (pts, strides, lvl_id))

    @staticmethod
    def shift_to_boxes(sbox, centers, strides):
        """(B, N, 4) boxes in stride units -> pixels about the centres."""
        return sbox * strides[None, :, None] + \
            torch.cat([centers, centers], -1)[None]

    # ---- loss ----------------------------------------------------------------
    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        cls_scores, sbox_inits, sbox_refines = outputs
        device = cls_scores[0].device
        centers, strides, _ = self.points(featmap_sizes, device)
        num_lvl = [h * w for h, w in featmap_sizes]
        gt_bboxes, gt_labels, gt_valid = (batch['gt_bboxes'],
                                          batch['gt_labels'],
                                          batch['gt_valid'])
        cls_flat = flatten_levels(cls_scores, self.cls_out_channels)
        box_init = self.shift_to_boxes(flatten_levels(sbox_inits, 4),
                                       centers, strides)
        box_refine = self.shift_to_boxes(flatten_levels(sbox_refines, 4),
                                         centers, strides)
        with torch.no_grad():
            if self.init_is_maxiou:
                half = 0.5 * self.point_base_scale * strides[:, None]
                res_i = self.init_assigner.assign(
                    torch.cat([centers - half, centers + half], -1),
                    num_lvl, gt_bboxes, gt_labels, gt_valid,
                    num_classes=self.num_classes)
            else:
                res_i = self.init_assigner.assign(
                    torch.cat([centers, strides[:, None]], -1), num_lvl,
                    gt_bboxes, gt_labels, gt_valid,
                    num_classes=self.num_classes)
            res_r = self.refine_assigner.assign(
                box_init.detach(), num_lvl, gt_bboxes, gt_labels, gt_valid,
                num_classes=self.num_classes)
        tgt_i = _gather_rows(gt_bboxes, res_i.assigned_gt_inds.clamp(min=0))
        tgt_r = _gather_rows(gt_bboxes, res_r.assigned_gt_inds.clamp(min=0))
        norm = (self.point_base_scale * strides)[None, :, None]
        pos_if = res_i.pos_mask.to(torch.float32)
        pos_rf = res_r.pos_mask.to(torch.float32)
        n_init = global_sum(pos_if.sum()).clamp(min=1.0)
        n_refine = global_sum(pos_rf.sum()).clamp(min=1.0)
        loss_pts_init = self.loss_bbox_init(
            (box_init / norm).reshape(-1, 4), (tgt_i / norm).reshape(-1, 4),
            weight=pos_if.reshape(-1, 1).expand(-1, 4),
            avg_factor=n_init * 4)
        loss_pts_refine = self.loss_bbox_refine(
            (box_refine / norm).reshape(-1, 4),
            (tgt_r / norm).reshape(-1, 4),
            weight=pos_rf.reshape(-1, 1).expand(-1, 4),
            avg_factor=n_refine * 4)
        loss_cls = self.loss_cls(cls_flat, res_r.labels, avg_factor=n_refine)
        return dict(loss_cls=loss_cls, loss_pts_init=loss_pts_init,
                    loss_pts_refine=loss_pts_refine)

    # ---- inference -------------------------------------------------------------
    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """The refine boxes of (cls_scores, sbox_inits, sbox_refines) ->
        dets (B, max_per_img, 5), labels, valid (with_nms=False: boxes
        (B, k, 4) and scores (B, k, C))."""
        cfg = cfg or self.test_cfg
        cls_scores, sbox_refines = outputs[0], outputs[2]
        device = cls_scores[0].device
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        centers, strides, _ = self.points(featmap_sizes, device)
        nms_pre = cfg.get('nms_pre', 1000)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        zero = torch.zeros((), device=device)
        h, w = img_hw[:, None, 0], img_hw[:, None, 1]
        boxes_all, scores_all = [], []
        lo = 0
        for lvl, (fh, fw) in enumerate(featmap_sizes):
            n = fh * fw
            scores = torch.sigmoid(flatten_level(cls_scores[lvl]))
            sbox = flatten_level(sbox_refines[lvl])
            ctr = centers[lo:lo + n].expand(b, -1, 2)
            s = strides[lo:lo + n, None].expand(b, -1, 1)
            if 0 < nms_pre < n:
                _, topk = torch.topk(scores.amax(dim=-1), nms_pre)
                scores, sbox, ctr, s = (_gather_rows(x, topk)
                                        for x in (scores, sbox, ctr, s))
            boxes = sbox * s + torch.cat([ctr, ctr], -1)
            x1, y1, x2, y2 = boxes.unbind(-1)
            boxes_all.append(torch.stack([
                torch.minimum(torch.maximum(x1, zero), w),
                torch.minimum(torch.maximum(y1, zero), h),
                torch.minimum(torch.maximum(x2, zero), w),
                torch.minimum(torch.maximum(y2, zero), h)], -1))
            scores_all.append(scores)
            lo += n
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(
                scale_factor, dtype=torch.float32, device=device)[:, None, :]
        if not with_nms:
            return boxes, scores
        return multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            cfg.get('nms', {}).get('iou_threshold', 0.5),
            max_per_img=cfg.get('max_per_img', 100), keep_fn=keep_fn)
