"""GFocalV2 head (Generalized Focal Loss V2, arXiv:2011.12885): the GFL head
plus Distribution-Guided Quality Prediction (DGQP); port of
`ld_tpu/models/heads/gfocal_head.py:23-122`, NCHW.

Per level, the softmax over the 4 x (reg_max+1) bins of the scaled `gfl_reg`
output gives, per side, its `reg_topk` largest probabilities and (with
`add_mean`) their mean: 4 * (reg_topk + 1) = 20 channels. `reg_conf` (1x1
conv to `reg_channels`, ReLU, 1x1 conv to 1, sigmoid) maps them to a quality
in (0, 1), and the class score is sigmoid(gfl_cls) x quality: a PROBABILITY.

forward returns three lists per level: those probability scores, the box
distributions, and the raw `gfl_cls` logits (which LDv2 distills). `loss`
and `get_bboxes` read the first two; the default `loss_cls` is
QualityFocalLoss(use_sigmoid=False), so neither applies a sigmoid again.

`reg_conf` is `Sequential(conv, ReLU, conv, Sigmoid)`, whose keys
`reg_conf.0.*` / `reg_conf.2.*` are mmdet's. With a compute `dtype`, the
statistics are taken from the float32 distributions and `reg_conf` runs in
the compute dtype; the quality, the logits and the scores come out float32
(JAX `gfocal_head.py:70-83`).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.utils.registry import HEADS
from .gfl_head import GFLHead


@HEADS.register_module()
class GFocalHead(GFLHead):

    def __init__(self, num_classes, in_channels, reg_topk=4, reg_channels=64,
                 add_mean=True, **kwargs):
        kwargs.setdefault('loss_cls', dict(
            type='QualityFocalLoss', use_sigmoid=False, beta=2.0,
            loss_weight=1.0))
        super().__init__(num_classes, in_channels, **kwargs)
        self.reg_topk = reg_topk
        self.add_mean = add_mean
        total_dim = reg_topk + (1 if add_mean else 0)
        self.reg_conf = nn.Sequential(
            self._pred_conv(4 * total_dim, reg_channels, 1),
            nn.ReLU(inplace=True), self._pred_conv(reg_channels, 1, 1),
            nn.Sigmoid())

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW per level -> (cls_scores (probabilities), bbox_preds,
        cls_logits), NCHW per level."""
        cls_scores, bbox_preds, cls_logits = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = self._towers(x)
            bbox_pred = self.scales[lvl](self.gfl_reg(reg_feat).float())
            b, _, h, w = bbox_pred.shape
            prob = F.softmax(bbox_pred.reshape(b, 4, self.reg_max + 1, h, w),
                             dim=2)
            stat = prob.topk(self.reg_topk, dim=2).values       # (b,4,k,h,w)
            if self.add_mean:
                stat = torch.cat([stat, stat.mean(dim=2, keepdim=True)],
                                 dim=2)
            quality = self.reg_conf(stat.reshape(b, -1, h, w)).float()
            logits = self.gfl_cls(cls_feat).float()
            cls_scores.append(torch.sigmoid(logits) * quality)
            bbox_preds.append(bbox_pred)
            cls_logits.append(logits)
        return cls_scores, bbox_preds, cls_logits

    def loss(self, outputs, batch, featmap_sizes):
        # the raw logits serve only LDv2's distillation
        return super().loss(outputs[:2], batch, featmap_sizes)
