"""LD head: localization distillation on top of the GFL head; port of
`ld_tpu/models/heads/ld_head.py:39-260`.

  * main-region LD: the KL between the student's and the teacher's box
    distribution logits on positive anchors, weighted by the student's max
    class score, at avg_factor 4;
  * VLR LD: the same KL on valuable-localization-region anchors, weighted
    by the VLR IoU, at avg_factor 16;
  * classification KD on positive anchors, normalised by each level's
    positive count;
  * `loss_kd_neg`, which the reference multiplies by 0, as an explicit zero;
  * feature imitation in 4 modes (fitnet / finegrained / decouple / gibox)
    as a masked MSE per level.

Regions are dense masks over the flattened (batch, anchors) axis. The GI
region (gibox) runs the greedy NMS of `ops/nms.py` on the `gi_candidates`
highest GI scores of a level, through `keep_fn` (`nms_keep`, the CUDA kernel
on the card): one NMS per FPN level and step. As in the reference, and the
JAX package, that NMS pools the boxes of the WHOLE batch of one level; under
data parallelism, of the global batch (every rank gathers the candidates).

Every count that normalises a loss is a count over the global batch
(`parallel.dist.global_sum`); the constant factors (LD at 4, VLR at 16)
are left to the train step, whose objective at R ranks is R x the rank's
share, so that DDP's gradient mean is the gradient of the global sum.

The losses run in float32 whatever the towers' compute dtype: the student's
and the teacher's predictions and FPN features are cast to float32 first
(JAX `ld_head.py:157-160, 210-211`), so a lowered student distils from a
float32 teacher named by its config path.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ld_tpu_torch.models.losses.kd_loss import \
    knowledge_distillation_kl_div_loss
from ld_tpu_torch.ops.boxes import anchor_center, bbox_overlaps, distance2bbox
from ld_tpu_torch.ops.integral import integral
from ld_tpu_torch.ops.nms import nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import all_gather, get_dist_info, global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .gfl_head import GFLHead, flatten_levels


def class_kd_per_level(kd_el, posf, level_id, num_levels, loss_weight):
    """Class KD summed over the positives, each normalised by its level's
    positive count over the global batch (the reference's per-level
    avg_factor=pos_inds.shape[0]): kd_el, posf (B, N); level_id (N,)."""
    n_pos_level = global_sum(torch.zeros(
        num_levels, device=posf.device).index_add_(0, level_id,
                                                   posf.sum(dim=0)))
    per_anchor_norm = n_pos_level.clamp(min=1.0)[level_id]         # (N,)
    return loss_weight * (kd_el * posf / per_anchor_norm[None, :]).sum()


@HEADS.register_module()
class LDHead(GFLHead):

    def __init__(self,
                 num_classes,
                 in_channels,
                 loss_ld=None,
                 loss_ld_vlr=None,
                 loss_kd=None,
                 loss_im=None,
                 imitation_method='gibox',
                 gi_candidates=512,
                 gi_top=10,
                 **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        # the GI NMS runs on the gi_candidates highest GI scores of a level;
        # exact whenever the <= gi_top greedy picks lie inside that prefix,
        # and always with gi_candidates >= the level's anchor count
        self.gi_candidates = gi_candidates
        self.gi_top = gi_top
        self.loss_ld = LOSSES.build(loss_ld or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=0.25, T=10))
        self.loss_ld_vlr = LOSSES.build(loss_ld_vlr or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=0.25, T=10))
        self.loss_kd = LOSSES.build(loss_kd or dict(
            type='KnowledgeDistillationKLDivLoss', loss_weight=10, T=2))
        self.loss_im = LOSSES.build(loss_im or dict(type='IMLoss',
                                                    loss_weight=0))
        if imitation_method not in ('gibox', 'finegrained', 'fitnet',
                                    'decouple'):
            raise ValueError(f'imitation_method {imitation_method!r}')
        self.imitation_method = imitation_method

    # ---- imitation regions -------------------------------------------------
    def _im_region(self, anchors, gt_bboxes, gt_valid):
        """fitnet/decouple ('centre inside some gt') or finegrained masks,
        (B, N) bool."""
        centers = anchor_center(anchors)[None, :, None, :]      # (1, N, 1, 2)
        gt = gt_bboxes[:, None]                                 # (B, 1, G, 4)
        in_gt = ((centers[..., 0] > gt[..., 0]) &
                 (centers[..., 0] < gt[..., 2]) &
                 (centers[..., 1] > gt[..., 1]) &
                 (centers[..., 1] < gt[..., 3]) &
                 gt_valid[:, None, :])
        if self.imitation_method != 'finegrained':
            return in_gt.any(dim=-1)
        iou = bbox_overlaps(anchors, gt_bboxes)                 # (B, N, G)
        max_per_gt = torch.where(gt_valid, iou.amax(dim=1),
                                 torch.full_like(iou[:, 0], float('inf')))
        return ((iou > 0.5 * max_per_gt[:, None, :]) &
                gt_valid[:, None, :]).any(dim=-1)

    def build_targets(self, featmap_sizes, gt_bboxes, gt_labels, gt_valid,
                      img_hw) -> Dict:
        t = super().build_targets(featmap_sizes, gt_bboxes, gt_labels,
                                  gt_valid, img_hw)
        valid = t['anchor_valid']
        t['vlr_region'] = self.assigner.get_vlr_region(
            t['anchors'], t['num_level_anchors'], gt_bboxes, gt_valid,
            valid)                                              # (B, N)
        # the reference computes im regions over anchors inside the image
        # and unmaps with fill 0
        t['im_region'] = self._im_region(t['anchors'], gt_bboxes,
                                         gt_valid) & valid      # (B, N)
        return t

    # ---- GI region ----------------------------------------------------------
    def gi_scores(self, cls_flat, soft_label_flat):
        """The per-class GI score difference, teacher minus student, on
        class probabilities."""
        return torch.sigmoid(soft_label_flat) - torch.sigmoid(cls_flat)

    @torch.no_grad()
    def _gi_mask(self, cls_flat, soft_label_flat, pred_flat, soft_pred_flat,
                 centers, gi_candidates=512, gi_top=10, keep_fn=nms_keep):
        """GI-region mask of one level, pooled over the global batch: (n,)
        float 0/1 of this rank's rows, with at most gi_top ones over the
        ranks (reference ld_head.py:613-638).

        Args:
            cls_flat, soft_label_flat: (n, C) student / teacher class logits.
            pred_flat, soft_pred_flat: (n, 4 * (reg_max + 1)) box logits.
            centers: (n, 2) anchor centres in units of the level's stride.
            keep_fn: the keep-mask function of the NMS.
        """
        z = self.gi_scores(cls_flat, soft_label_flat)
        gi_score = z.abs().amax(dim=-1)
        cls_idx = z.abs().argmax(dim=-1)      # the first class on a tie
        teacher_bigger = z.gather(-1, cls_idx[:, None])[:, 0] >= 0
        sbox = distance2bbox(centers, integral(pred_flat, self.reg_max))
        tbox = distance2bbox(centers, integral(soft_pred_flat, self.reg_max))
        gibox = torch.where(teacher_bigger[:, None], tbox, sbox)

        n = gi_score.shape[0]
        k = min(gi_candidates, n)
        # stable: equal scores keep the lowest index first, as lax.top_k
        cand_scores, cand_idx = torch.sort(gi_score, descending=True,
                                           stable=True)
        cand_scores, cand_idx = cand_scores[:k], cand_idx[:k]
        cand_boxes = gibox[cand_idx]
        rank, world = get_dist_info()
        if world > 1:
            # JAX pools the level over the global batch. Rank r holds its
            # rows r*n..(r+1)*n-1, and its top k hold its share of the
            # global top k; gathered in rank order, a stable sort keeps
            # equal scores in global index order. Every rank runs the same
            # NMS and keeps the picks in its own rows.
            cand_idx = all_gather(cand_idx + rank * n)
            cand_boxes = all_gather(cand_boxes)
            cand_scores, order = torch.sort(all_gather(cand_scores),
                                            descending=True, stable=True)
            order = order[:min(gi_candidates, world * n)]
            cand_scores = cand_scores[:len(order)]
            cand_idx = cand_idx[order] - rank * n
            cand_boxes = cand_boxes[order]
        idx, valid = nms(cand_boxes, cand_scores, 0.3, gi_top,
                         keep_fn=keep_fn)
        picks = cand_idx[idx]
        mine = (picks >= 0) & (picks < n)
        # the slots past the kept boxes (and another rank's picks) point
        # anywhere and carry 0: amax keeps a pick that such a slot names
        # again, an assignment would not
        return torch.zeros(n, device=gi_score.device).scatter_reduce(
            0, picks.clamp(0, n - 1), (valid & mine).to(torch.float32),
            'amax')

    def gi_levels(self, outputs, soft_teacher):
        """The per-level NCHW maps the GI region compares, from the
        student's and the teacher's outputs: (student cls, teacher cls,
        student box, teacher box)."""
        return outputs[0], soft_teacher[0], outputs[1], soft_teacher[1]

    def gi_masks(self, outputs, soft_teacher, keep_fn=nms_keep
                 ) -> List[torch.Tensor]:
        """The GI-region mask of each level, (B * H_l * W_l,) each, from the
        student's and the teacher's per-level NCHW outputs."""
        levels = self.gi_levels(outputs, soft_teacher)
        featmap_sizes = [tuple(c.shape[-2:]) for c in levels[0]]
        anchors, num_lvl, _, _ = self.level_geometry(
            featmap_sizes, levels[0][0].device)
        return self._gi_masks_flat(*(flatten_levels(x) for x in levels),
                                   anchors, num_lvl, keep_fn)

    def _gi_masks_flat(self, cls_flat, soft_label, pred_flat, soft_target,
                       anchors, num_lvl, keep_fn) -> List[torch.Tensor]:
        b = cls_flat.shape[0]
        strides = [s[0] for s in self.anchor_generator.strides]
        masks, lo = [], 0
        for lvl, n_lvl in enumerate(num_lvl):
            hi = lo + n_lvl
            centers = anchor_center(anchors[lo:hi]) / strides[lvl]
            masks.append(self._gi_mask(
                cls_flat[:, lo:hi].reshape(-1, self.cls_out_channels),
                soft_label[:, lo:hi].reshape(-1, self.cls_out_channels),
                pred_flat[:, lo:hi].reshape(-1, pred_flat.shape[-1]),
                soft_target[:, lo:hi].reshape(-1, pred_flat.shape[-1]),
                centers.repeat(b, 1), gi_candidates=self.gi_candidates,
                gi_top=self.gi_top, keep_fn=keep_fn))
            lo = hi
        return masks

    # ---- loss ----------------------------------------------------------------
    def loss(self, outputs, batch, featmap_sizes, soft_teacher,
             student_feats=None, teacher_feats=None,
             keep_fn=nms_keep, kd_logits=None) -> Dict[str, torch.Tensor]:
        """The full LD loss.

        Args:
            outputs: the student's (cls_scores, bbox_preds), NCHW per level.
            soft_teacher: the teacher's (cls_scores, bbox_preds), detached.
            student_feats / teacher_feats: the FPN features, needed when
                loss_im has a nonzero weight.
            keep_fn: the keep-mask function of the GI NMS.
            kd_logits: the (student, teacher) per-level class maps of the
                class KD, when they are not `outputs[0]` / `soft_teacher[0]`.
        """
        cls_scores, bbox_preds = outputs[0], outputs[1]
        t = self.build_targets(featmap_sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_valid'],
                               batch['img_hw'])
        cls_flat = flatten_levels(cls_scores).float()
        pred_flat = flatten_levels(bbox_preds).float()
        soft_label = flatten_levels(soft_teacher[0]).float()
        soft_target = flatten_levels(soft_teacher[1]).float()
        kd_student, kd_teacher = (cls_flat, soft_label) if kd_logits is None \
            else (flatten_levels(kd_logits[0]).float(),
                  flatten_levels(kd_logits[1]).float())

        core = self._core_losses(cls_flat, pred_flat, t)
        losses = dict(loss_cls=core['loss_cls'], loss_bbox=core['loss_bbox'],
                      loss_dfl=core['loss_dfl'])

        m1 = self.reg_max + 1
        pred_corners = core['pred_corners'].reshape(-1, m1)
        soft_corners = soft_target.reshape(-1, m1)
        weight_targets = core['weight_targets']
        w4 = weight_targets[..., None].expand(*weight_targets.shape, 4)

        # main-region LD at avg_factor 4 (reference ld_head.py:235-239),
        # not divided by the global avg_factor
        losses['loss_ld'] = self.loss_ld(pred_corners, soft_corners,
                                         weight=w4.reshape(-1),
                                         avg_factor=4.0)
        vlr = t['vlr_region']                                     # (B, N)
        vlr4 = vlr[..., None].expand(*vlr.shape, 4)
        losses['loss_ld_vlr'] = self.loss_ld_vlr(pred_corners, soft_corners,
                                                 weight=vlr4.reshape(-1),
                                                 avg_factor=16.0)

        # class KD on positives, normalised by each LEVEL's positive count
        kd_el = knowledge_distillation_kl_div_loss(
            kd_student, kd_teacher, reduction='none',
            T=self.loss_kd.T)                                      # (B, N)
        posf = core['posf'] * core['label_weights']
        losses['loss_kd'] = class_kd_per_level(kd_el, posf, t['level_id'],
                                               self.num_levels,
                                               self.loss_kd.loss_weight)
        # the reference computes a VLR-region KD term and multiplies it by 0
        losses['loss_kd_neg'] = torch.zeros((), device=posf.device)

        if self.loss_im.loss_weight == 0:
            losses['loss_im'] = torch.zeros((), device=posf.device)
            return losses
        if student_feats is None:
            raise ValueError(
                'loss_im has nonzero weight but the detector did not pass '
                'FPN features: set output_feature=True on the KD detector')
        masks = None
        if self.imitation_method == 'gibox':
            masks = self._gi_masks_flat(cls_flat, soft_label, pred_flat,
                                        soft_target, t['anchors'],
                                        t['num_level_anchors'], keep_fn)
        losses['loss_im'] = self._imitation_loss(
            t, flatten_levels(student_feats).float(),
            flatten_levels(teacher_feats).detach().float(), masks)
        return losses

    def _imitation_loss(self, t, x, tx, gi_masks=None):
        """Masked MSE per level over the imitation region, summed over the
        levels; x, tx: (B, N, C_feat) flattened FPN features."""
        cf = x.shape[-1]
        total = torch.zeros((), device=x.device)
        lo = 0
        for lvl, n_lvl in enumerate(t['num_level_anchors']):
            hi = lo + n_lvl
            mse = ((x[:, lo:hi].reshape(-1, cf) -
                    tx[:, lo:hi].reshape(-1, cf))**2).mean(dim=-1)
            if self.imitation_method == 'gibox':
                mask = gi_masks[lvl]
                total = total + (mse * mask).sum() / global_sum(
                    mask.sum()).clamp(min=1.0)
            else:
                fg = t['im_region'][:, lo:hi].reshape(-1).to(torch.float32)
                fg_term = (mse * fg).sum() / global_sum(
                    fg.sum()).clamp(min=1.0)
                if self.imitation_method == 'decouple':
                    # the reference's decouple branch cannot run (it indexes
                    # mismatched fg/bg sets into F.mse_loss, ld_head.py:
                    # 177-183); this is its DeFeat-style intent, as in the
                    # JAX package: fg MSE + 2x bg MSE
                    bg = 1.0 - fg
                    bg_term = (mse * bg).sum() / global_sum(
                        bg.sum()).clamp(min=1.0)
                    total = total + fg_term + 2.0 * bg_term
                else:
                    total = total + fg_term
            lo = hi
        return self.loss_im.loss_weight * total


@HEADS.register_module()
class IMHead(LDHead):
    """The head of the feature-imitation study configs (`configs/im/`): the
    LDHead, whose imitation arm those configs switch on."""
