"""GFL head (Generalized Focal Loss V1, arXiv:2006.04388), inference path.

Port of `ld_tpu/models/heads/gfl_head.py:39-104` (towers) and `:314-387`
(`get_bboxes`), NCHW:

  * forward: one shared stack of 3x3 conv + GroupNorm + ReLU blocks per branch
    applied to every FPN level, `gfl_cls` / `gfl_reg` 3x3 convs, and a
    learnable scalar per level on the reg output (`scales.i.scale`);
  * get_bboxes: per level, the `nms_pre` top-k on the max class LOGIT (before
    the sigmoid), integral decode x stride, `distance2bbox` clipped to the
    image, optional rescale, then class-aware `multiclass_nms`, batched over
    images.

Module names are mmdet's (`cls_convs.i.{conv,gn}`, `gfl_cls`, `gfl_reg`,
`scales.i.scale`). Loss and assigner configs are accepted and kept; training
is not ported yet.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from ld_tpu_torch.ops.anchors import AnchorGenerator
from ld_tpu_torch.ops.boxes import anchor_center, distance2bbox
from ld_tpu_torch.ops.integral import integral
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.utils.registry import HEADS

_CLS_BIAS_INIT = float(-math.log((1 - 0.01) / 0.01))  # prior prob 0.01


class ConvGNBlock(nn.Module):
    """3x3 conv (no bias) + GroupNorm(min(32, C), eps 1e-5) + ReLU."""

    def __init__(self, in_channels, out_channels, groups=32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                              bias=False)
        self.gn = nn.GroupNorm(min(groups, out_channels), out_channels,
                               eps=1e-5)

    def forward(self, x):
        return torch.relu(self.gn(self.conv(x)))


class Scale(nn.Module):
    """A learnable scalar (mmcv Scale: a 0-dim `scale` parameter)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32))

    def forward(self, x):
        return x * self.scale


def flatten_level(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (B, H*W, C), the row-major anchor order of the generator."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)


@HEADS.register_module()
class GFLHead(nn.Module):

    def __init__(self,
                 num_classes,
                 in_channels,
                 stacked_convs=4,
                 feat_channels=256,
                 anchor_generator=None,
                 loss_cls=None,
                 loss_dfl=None,
                 loss_bbox=None,
                 reg_max=16,
                 train_cfg=None,
                 test_cfg=None,
                 norm_cfg=None,
                 conv_cfg=None,
                 level_pack=False,
                 **kwargs):
        super().__init__()
        if conv_cfg is not None or (norm_cfg or {}).get('type', 'GN') != 'GN':
            raise NotImplementedError('GFLHead conv_cfg / non-GN norm_cfg are '
                                      'not ported to ld_tpu_torch yet')
        if kwargs:
            raise TypeError(f'unexpected GFLHead arguments {sorted(kwargs)}')
        self.num_classes = num_classes
        self.cls_out_channels = num_classes
        self.reg_max = reg_max
        ag = dict(anchor_generator or dict(
            ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
            strides=[8, 16, 32, 64, 128]))
        ag_type = ag.pop('type', 'AnchorGenerator')
        if ag_type != 'AnchorGenerator':
            raise NotImplementedError(f'{ag_type} is not ported to '
                                      'ld_tpu_torch yet (see ROADMAP.md)')
        self.anchor_generator = AnchorGenerator(**ag)
        self.num_levels = self.anchor_generator.num_levels
        # losses and assigner belong to training, which is not ported yet
        del loss_cls, loss_dfl, loss_bbox, train_cfg
        self.test_cfg = test_cfg or dict(
            nms_pre=1000, score_thr=0.05,
            nms=dict(type='nms', iou_threshold=0.6), max_per_img=100)
        # level_pack is the JAX package's one-canvas TPU tower: same
        # parameters and outputs, so there is nothing to port
        del level_pack

        groups = (norm_cfg or {}).get('num_groups', 32)
        self.cls_convs = nn.ModuleList(
            ConvGNBlock(in_channels if i == 0 else feat_channels,
                        feat_channels, groups)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvGNBlock(in_channels if i == 0 else feat_channels,
                        feat_channels, groups)
            for i in range(stacked_convs))
        self.gfl_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.gfl_reg = nn.Conv2d(feat_channels, 4 * (reg_max + 1), 3,
                                 padding=1)
        self.scales = nn.ModuleList(Scale(1.0)
                                    for _ in range(self.num_levels))

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers: normal(0.01) conv kernels, the
        prior-0.01 bias on `gfl_cls`, GN scale 1 / bias 0, scales 1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    m.reset_parameters()
            nn.init.constant_(self.gfl_cls.bias, _CLS_BIAS_INIT)
            for s in self.scales:
                s.scale.fill_(1.0)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores, bbox_preds), NCHW per level."""
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            cls_scores.append(self.gfl_cls(cls_feat))
            bbox_preds.append(self.scales[lvl](self.gfl_reg(reg_feat)))
        return cls_scores, bbox_preds

    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        """Decode head outputs into final detections.

        Args:
            outputs: (cls_scores, bbox_preds) lists of NCHW tensors.
            img_hw: (B, 2) image (h, w) for box clipping.
            scale_factor: (B, 4) resize factors for rescale to original.
            keep_fn: the keep-mask function handed to `multiclass_nms`,
                `nms_keep` (the kernel on the card).
        Returns:
            dets (B, max_per_img, 5), labels (B, max_per_img), valid mask;
            with_nms=False: boxes (B, N, 4) and scores (B, N, C).
        """
        cfg = cfg or self.test_cfg
        cls_scores, bbox_preds = outputs
        device = cls_scores[0].device
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        nms_pre = cfg.get('nms_pre', 1000)
        mlvl_anchors = self.anchor_generator.grid_anchors(featmap_sizes,
                                                          device)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)

        boxes_all: List[torch.Tensor] = []
        scores_all: List[torch.Tensor] = []
        for lvl in range(self.num_levels):
            scores = flatten_level(cls_scores[lvl])               # (B, n, C)
            pred = flatten_level(bbox_preds[lvl])                 # (B, n, 68)
            anchors = mlvl_anchors[lvl].expand(b, -1, 4)
            n = scores.shape[1]
            if nms_pre > 0 and n > nms_pre:
                # top-k BEFORE sigmoid/integral: sigmoid is monotonic, so
                # ranking raw logits picks the same nms_pre set
                _, topk = torch.topk(scores.amax(dim=-1), nms_pre)
                scores = _gather_rows(scores, topk)
                pred = _gather_rows(pred, topk)
                anchors = _gather_rows(anchors, topk)
            stride = float(self.anchor_generator.strides[lvl][0])
            dist = integral(pred, self.reg_max) * stride
            boxes_all.append(distance2bbox(anchor_center(anchors), dist,
                                           max_shape=img_hw))
            scores_all.append(torch.sigmoid(scores))
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        if rescale and scale_factor is not None:
            sf = torch.as_tensor(scale_factor, dtype=torch.float32,
                                 device=device)
            boxes = boxes / sf[:, None, :]
        if not with_nms:
            return boxes, scores
        nms_cfg = dict(cfg.get('nms', dict(type='nms', iou_threshold=0.6)))
        return multiclass_nms(boxes, scores, cfg.get('score_thr', 0.05),
                              nms_cfg.pop('iou_threshold', 0.6),
                              max_per_img=cfg.get('max_per_img', 100),
                              nms_cfg=nms_cfg, keep_fn=keep_fn)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, D), idx (B, k) -> (B, k, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
