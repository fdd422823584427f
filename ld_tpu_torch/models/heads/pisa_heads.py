"""PISA heads (port of `ld_tpu/models/heads/pisa_heads.py:24-246`): the
RetinaNet, RoI and SSD heads with prime-sample attention. The towers and
names are their bases'; the loss gives the positives' classification the
ISR-P importance weights (`models/losses/pisa_loss.py`) and adds
`loss_carl`, each positive's regression loss scaled by its
gradient-carrying class probability.

  * `PISARetinaHead`: the `max_pos` (128) prime positives of the batch,
    keyed pos x (1 + IoU of the decoded prediction with the decoded
    target), in a stable descending sort (ties to the lower index, as
    `lax.top_k`); their focal weights become ISR-P's, the rest keep
    validity x (1 - pos); CARL of the sigmoid at the label on the L1 of the
    deltas.
  * `PISARoIHead`: a `StandardRoIHead` (its names too) whose loss runs
    ISR-P over the batch's flattened sampled rois, the gts grouped by
    gt index + image x rois an image (the JAX head's key); CARL of the
    softmax at the label.
  * `PISASSDHead`: `SSDHead.loss_pieces`, then the prime positives as the
    Retina head's, ISR-P on the per-anchor CE with the mined negatives'
    weights, CARL of the softmax on the SmoothL1.

ISR-P and CARL read `isr` / `carl` from the head's own arguments (the
RetinaNet and SSD heads) or from its `train_cfg` (the RoI head, and the SSD
head without arguments), defaults k 2, bias 0 and k 1, bias 0.2: a config's
top-level `train_cfg` is read by neither package (ROADMAP.md caveat 20).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ld_tpu_torch.models.losses.pisa_loss import carl_weights, isr_p
from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .gfl_head import flatten_levels
from .retina_head import RetinaHead
from .roi_head import StandardRoIHead
from .ssd_head import SSDHead


class _PISAWeights:
    """The ISR-P / CARL settings of a head."""

    def _pisa_init(self, isr=None, carl=None, max_pos=128):
        isr, carl = dict(isr or {}), dict(carl or {})
        self.isr_k = isr.get('k', 2.0)
        self.isr_bias = isr.get('bias', 0.0)
        self.carl_k = carl.get('k', 1.0)
        self.carl_bias = carl.get('bias', 0.2)
        self.max_pos = max_pos

    def prime_positives(self, coder, anchors, reg, deltas, pos):
        """The `max_pos` prime positives of flat (M, 4) anchors, predicted
        and target deltas: (their indices, the IoU of each decoded
        prediction, without gradient, with its decoded target (M,))."""
        ious = bbox_overlaps(coder.decode(anchors, reg.detach()),
                             coder.decode(anchors, deltas), is_aligned=True)
        keys = pos.float() * (1.0 + ious)
        p = min(self.max_pos, pos.shape[0])
        sel = torch.sort(keys, descending=True, stable=True).indices[:p]
        return sel, ious

    def isr(self, ious, labels, gts, valid, cls_loss):
        return isr_p(ious, labels, gts, valid, valid.float(), cls_loss,
                     k=self.isr_k, bias=self.isr_bias)

    def carl(self, p_cls, valid):
        return carl_weights(p_cls, valid, k=self.carl_k, bias=self.carl_bias)


def _batch_gts(gt_inds: torch.Tensor, per_image: int) -> torch.Tensor:
    """(B, N) assigned gt indices -> (B*N,) ids unique across the batch:
    the index (0 where none) + image x `per_image`."""
    b, n = gt_inds.shape
    img = torch.arange(b, device=gt_inds.device).repeat_interleave(n)
    return gt_inds.reshape(-1).clamp(min=0) + img * per_image


@HEADS.register_module()
class PISARetinaHead(_PISAWeights, RetinaHead):

    def __init__(self, num_classes, in_channels, isr=None, carl=None,
                 max_pos=128, **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self._pisa_init(isr, carl, max_pos)

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        cls2 = flatten_levels(outputs[0], self.cls_out_channels).reshape(
            -1, self.cls_out_channels)
        reg2 = flatten_levels(outputs[1], 4).reshape(-1, 4)
        b = t['pos_mask'].shape[0]
        labels = t['labels'].reshape(-1)
        pos = t['pos_mask'].reshape(-1)
        posf = pos.float()
        gts = _batch_gts(t['assigned_gt_inds'], batch['gt_bboxes'].shape[1])
        anchors = t['anchors'].repeat(b, 1)
        deltas = self.coder.encode(t['anchors'][None],
                                   t['bbox_targets']).reshape(-1, 4)
        sel, ious = self.prime_positives(self.coder, anchors, reg2, deltas,
                                         pos)
        sv, s_labels, s_cls = pos[sel], labels[sel], cls2[sel]
        s_reg, s_deltas = reg2[sel], deltas[sel]
        cls_none = self.loss_cls(s_cls.detach(), s_labels,
                                 reduction_override='none').sum(-1)
        imp_w = self.isr(ious[sel], s_labels, gts[sel], sv, cls_none)
        num_pos = global_sum(posf.sum()).clamp(min=1.0)
        w_all = (t['anchor_valid'].reshape(-1).float() * (1.0 - posf)
                 ).index_add(0, sel, imp_w)
        loss_cls = self.loss_cls(cls2, labels, weight=w_all,
                                 avg_factor=num_pos)
        loss_bbox = self.loss_bbox(reg2, deltas,
                                   weight=posf[:, None].expand(-1, 4),
                                   avg_factor=num_pos)
        safe = s_labels.clamp(0, self.num_classes - 1)
        p_cls = torch.sigmoid(torch.gather(s_cls, 1, safe[:, None])[:, 0])
        cw = self.carl(p_cls, sv)
        loss_carl = (cw * (s_reg - s_deltas).abs().sum(-1)).sum() / num_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_carl=loss_carl)


@HEADS.register_module()
class PISARoIHead(_PISAWeights, StandardRoIHead):

    def __init__(self, *args, **kwargs):
        train_cfg = kwargs.get('train_cfg') or {}
        super().__init__(*args, **kwargs)
        self._pisa_init(train_cfg.get('isr'), train_cfg.get('carl'))

    def bbox_losses(self, cls, reg, s) -> Dict[str, torch.Tensor]:
        labels = s['labels'].reshape(-1)
        pos = s['roi_pos'].reshape(-1)
        validf = s['roi_valid'].reshape(-1).float()
        posf = pos.float()
        avg = global_sum(validf.sum()).clamp(min=1.0)
        n_pos = global_sum(posf.sum()).clamp(min=1.0)
        reg_sel = self._select_reg(reg, labels)
        rois = s['rois'].reshape(-1, 4)
        deltas = s['targets'].reshape(-1, 4)
        ious = bbox_overlaps(self.coder.decode(rois, reg_sel.detach()),
                             self.coder.decode(rois, deltas), is_aligned=True)
        # the JAX head's grouping key: gt index + image x rois an image
        gts = _batch_gts(s['gt_inds'], s['labels'].shape[1])
        ce_det = self.loss_cls(cls.detach(), labels,
                               reduction_override='none')
        if ce_det.dim() > 1:
            ce_det = ce_det.sum(-1)
        imp_w = self.isr(ious, labels, gts, pos, ce_det)
        loss_cls = self.loss_cls(cls, labels,
                                 weight=validf * (1.0 - posf) + imp_w,
                                 avg_factor=avg)
        loss_bbox = self.loss_bbox(reg_sel, deltas,
                                   weight=posf[:, None].expand(-1, 4),
                                   avg_factor=n_pos * 4.0)
        safe = labels.clamp(0, self.num_classes - 1)
        p_cls = torch.gather(F.softmax(cls, dim=-1), 1, safe[:, None])[:, 0]
        cw = self.carl(p_cls, pos)
        loss_carl = (cw * (reg_sel - deltas).abs().sum(-1)).sum() / n_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_carl=loss_carl)


@HEADS.register_module()
class PISASSDHead(_PISAWeights, SSDHead):

    def __init__(self, *args, isr=None, carl=None, max_pos=128, **kwargs):
        train_cfg = kwargs.get('train_cfg') or {}
        super().__init__(*args, **kwargs)
        self._pisa_init(isr or train_cfg.get('isr'),
                        carl or train_cfg.get('carl'), max_pos)

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        t = self.loss_pieces(outputs, batch, featmap_sizes)
        b = t['pos'].shape[0]
        pos = t['pos'].reshape(-1)
        labels = t['labels'].reshape(-1)
        ce = t['ce'].reshape(-1)
        sl1 = t['sl1'].reshape(-1)
        gts = _batch_gts(t['gt_inds'], batch['gt_bboxes'].shape[1])
        sel, ious = self.prime_positives(
            self.coder, t['anchors'].repeat(b, 1),
            t['reg_flat'].reshape(-1, 4), t['deltas'].reshape(-1, 4), pos)
        sv = pos[sel]
        imp_w = self.isr(ious[sel], labels[sel], gts[sel], sv,
                         ce.detach()[sel])
        num_pos = t['num_pos']
        w_all = t['neg_keep'].reshape(-1).float().index_add(0, sel, imp_w)
        loss_cls = (ce * w_all).sum() / num_pos
        loss_bbox = (sl1 * pos.float()).sum() / num_pos
        cls2 = t['cls_flat'].reshape(-1, self.num_classes + 1)
        safe = labels[sel].clamp(0, self.num_classes - 1)
        p_cls = torch.gather(F.softmax(cls2[sel], dim=-1), 1,
                             safe[:, None])[:, 0]
        cw = self.carl(p_cls, sv)
        loss_carl = (cw * sl1[sel]).sum() / num_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_carl=loss_carl)
