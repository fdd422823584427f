"""The FreeAnchor RetinaNet head (learning to match by a bag likelihood);
port of `ld_tpu/models/heads/free_anchor_head.py`, NCHW, with the images of
a batch on a leading dimension where the JAX package `vmap`s.

  * The net and the decode are `RetinaHead`'s (9 anchors a location, the
    Delta coder of the config).
  * Negative branch, detached: each (anchor, class)'s probability of being
    in a positive bag, the largest over the class's valid gts of the IoU
    ramp (IoU - bbox_thr) / (max IoU of the gt - bbox_thr) clipped to
    [0, 1], against the decoded boxes (`scatter_reduce` 'amax' in place of
    the JAX `segment_max`; padded gts go to a dummy class).
  * Positive bags: each gt's `pre_anchor_topk` anchors of the largest IoU,
    of equal IoUs the lower anchor first (a stable descending sort, as
    `lax.top_k`: the anchors of a grid tie often); the bag probability is
    the mean-max of P_cls x exp(-SmoothL1) under the weights
    1 / clip(1 - p, 1e-12), normalised.
  * `positive_bag_loss` = alpha x -log(bag) summed over the valid gts over
    their count (not the anchors'); `negative_bag_loss` = (1 - alpha) x
    p^gamma x -log(1 - p) of p = P_cls x (1 - P{in a bag}), summed over
    every (anchor, class), over count x `pre_anchor_topk`. Both counts are
    over every rank.
"""
from __future__ import annotations

from typing import Dict

import torch

from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .gfl_head import flatten_levels
from .retina_head import RetinaHead

EPS = 1e-12


@HEADS.register_module()
class FreeAnchorRetinaHead(RetinaHead):

    def __init__(self, num_classes, in_channels, pre_anchor_topk=50,
                 bbox_thr=0.6, gamma=2.0, alpha=0.5, loss_bbox=None,
                 **kwargs):
        super().__init__(num_classes, in_channels, loss_bbox=loss_bbox or dict(
            type='SmoothL1Loss', beta=0.11, loss_weight=0.75), **kwargs)
        self.pre_anchor_topk = pre_anchor_topk
        self.bbox_thr = bbox_thr
        self.gamma = gamma
        self.alpha = alpha

    def box_prob(self, anchors, reg_flat, gt_bboxes, gt_labels, gt_valid
                 ) -> torch.Tensor:
        """P{anchor in a positive bag} (B, N, C), detached."""
        c = self.cls_out_channels
        with torch.no_grad():
            decoded = self.coder.decode(anchors[None], reg_flat)
            obj_iou = bbox_overlaps(gt_bboxes, decoded)            # (B, G, N)
            t1 = self.bbox_thr
            t2 = obj_iou.amax(-1, keepdim=True).clamp(min=t1 + EPS)
            obj_prob = ((obj_iou - t1) / (t2 - t1)).clamp(0.0, 1.0)
            obj_prob = torch.where(gt_valid[..., None], obj_prob,
                                   torch.zeros_like(obj_prob))
            seg = torch.where(gt_valid, gt_labels.long(),
                              torch.full_like(gt_labels.long(), c))
            prob = obj_prob.new_zeros(obj_prob.shape[0], c + 1,
                                      obj_prob.shape[-1])
            prob.scatter_reduce_(1, seg[..., None].expand_as(obj_prob),
                                 obj_prob, 'amax')
            return prob[:, :c].transpose(1, 2)

    def positive_bags(self, anchors, gt_bboxes, gt_valid, k):
        """Each gt's `k` anchors of the largest IoU (B, G, k), of equal
        IoUs the lower index first."""
        quality = torch.where(gt_valid[..., None],
                              bbox_overlaps(gt_bboxes, anchors[None]),
                              torch.full((), -1.0, device=anchors.device))
        return torch.sort(quality, dim=-1, descending=True,
                          stable=True).indices[..., :k]

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        gt_bboxes, gt_labels = batch['gt_bboxes'], batch['gt_labels'].long()
        gt_valid = batch['gt_valid']
        device = gt_bboxes.device
        anchors = self.level_geometry(featmap_sizes, device)[0]
        cls_flat = flatten_levels(outputs[0], self.cls_out_channels)
        reg_flat = flatten_levels(outputs[1], 4)
        cls_prob = torch.sigmoid(cls_flat)                      # (B, N, C)
        b, n, c = cls_prob.shape
        k = min(self.pre_anchor_topk, n)
        box_prob = self.box_prob(anchors, reg_flat, gt_bboxes, gt_labels,
                                 gt_valid)
        with torch.no_grad():
            matched = self.positive_bags(anchors, gt_bboxes, gt_valid, k)
        g = matched.shape[1]
        flat = matched.reshape(b, -1)
        m_cls_prob = cls_prob.reshape(b, n * c).gather(
            1, (matched * c + gt_labels.clamp(0, c - 1)[..., None]).reshape(
                b, -1)).reshape(b, g, k)
        m_anchors = anchors[matched]                            # (B, G, k, 4)
        m_targets = self.coder.encode(
            m_anchors, gt_bboxes[:, :, None].expand_as(m_anchors))
        m_reg = reg_flat.gather(1, flat[..., None].expand(-1, -1, 4))
        l_bbox = self.loss_bbox(m_reg.reshape(-1, 4), m_targets.reshape(-1, 4),
                                reduction_override='none').reshape(
                                    b, g, k, 4).sum(-1)
        matched_prob = m_cls_prob * torch.exp(-l_bbox)
        w = 1.0 / (1.0 - matched_prob).clamp(min=EPS)
        w = w / w.sum(dim=-1, keepdim=True)
        bag_prob = (w * matched_prob).sum(dim=-1)               # (B, G)
        pos_loss = self.alpha * -torch.log(bag_prob.clamp(min=EPS))
        pos_loss = torch.where(gt_valid, pos_loss, torch.zeros_like(pos_loss))
        prob = (cls_prob * (1.0 - box_prob)).clamp(EPS, 1.0 - EPS)
        neg = (1.0 - self.alpha) * prob ** self.gamma * -torch.log(1.0 - prob)
        num_pos = global_sum(gt_valid.sum().to(torch.float32)).clamp(min=1.0)
        return dict(
            positive_bag_loss=pos_loss.sum() / num_pos,
            negative_bag_loss=neg.sum() /
            (num_pos * self.pre_anchor_topk).clamp(min=1.0))
