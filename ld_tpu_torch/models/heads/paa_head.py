"""The PAA head (probabilistic anchor assignment); port of
`ld_tpu/models/heads/paa_head.py`, NCHW, with the images of a batch on a
leading dimension where the JAX package `vmap`s.

  * `PAAHead(ATSSHead)`: the plain ATSS net (`atss_cls`, `atss_reg` x the
    level scale as 4 `DeltaXYWHBBoxCoder` deltas, stds 0.1, 0.1, 0.2, 0.2,
    and `atss_centerness` as the IoU branch), mmdet's names.
  * Candidates: the MaxIoU first match at 0.1 / 0.1 / 0.0 (no ignore band,
    ROADMAP.md caveat 10). Each candidate's loss is the focal loss summed
    over the classes plus the GIoU of its decoded box, detached.
  * Reassignment (`reassign`, JAX `_reassign_single`): for each gt its
    `topk` smallest-loss candidates of each level, in slots level x topk +
    rank, a two-component 1-D GMM fitted on them (`fit_gmm_1d`: a fixed
    10-step EM, caveat 60), the foreground component's candidates ranked by
    loss (the key loss + slot x 1e-9, in float32, as JAX computes it), and
    those ranked up to the one at the foreground density's peak kept; a gt
    with fewer than 2 candidates keeps none. The per-(gt, level) smallest-k
    is one stable sort of the image's losses by (gt, level, loss), so that
    of equal losses the lower anchor goes first, as `lax.top_k` of the
    negated losses: no (G, L, N) table.
  * Losses: focal over the valid anchors at max(kept, batch size), GIoU
    weighted by the detached decoded IoU (clipped at 1e-6) at its sum, the
    IoU branch's BCE against it at max(kept, 1); each count over every rank
    (`global_sum`).
  * Decode: scores sqrt(sigmoid(cls) x sigmoid(iou)), the per-level
    `nms_pre` top-k, the Delta decode clipped to the image, one
    `multiclass_nms`, then score voting: each detection becomes the mean of
    its class's candidate boxes weighted by p x exp(-(1 - IoU)^2 / 0.025)
    over those with IoU > 0.01 and a score above `score_thr`.

`covariance_type` is accepted and not read, as in the JAX head (caveat 60).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS
from .classic_heads import ATSSHead
from .gfl_head import _gather_rows, flatten_level, flatten_levels

EPS = 1e-6
BIG = 1e8


def fit_gmm_1d(x: torch.Tensor, valid: torch.Tensor, iters: int = 10,
               reg: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """A two-component 1-D GMM fitted by `iters` EM steps to each row of
    masked samples (JAX `fit_gmm_1d`, one row a gt).

    Args:
        x: (R, K) samples; valid: (R, K) bool.
    Returns:
        resp0: (R, K), the responsibility of the lower-mean component, 0 at
            masked slots; log_density: (R, K), the mixture's log-density,
            -1e8 at masked slots.
    """
    n_valid = valid.sum(-1, keepdim=True).clamp(min=1).to(x.dtype)
    xv = torch.where(valid, x, torch.zeros_like(x))
    big = torch.full_like(x, BIG)
    mu = torch.stack([torch.where(valid, x, big).amin(-1),
                      torch.where(valid, x, -big).amax(-1)], -1)   # (R, 2)
    var = torch.ones_like(mu)
    w = torch.full_like(mu, 0.5)

    def log_prob(mu, var, w):
        return (torch.log(w[:, None, :] + EPS)
                - 0.5 * torch.log(2 * math.pi * var[:, None, :])
                - 0.5 * (x[..., None] - mu[:, None, :]) ** 2 /
                var[:, None, :])

    for _ in range(iters):
        resp = torch.softmax(log_prob(mu, var, w), dim=-1)
        resp = torch.where(valid[..., None], resp, torch.zeros_like(resp))
        nk = resp.sum(1) + EPS                                      # (R, 2)
        mu = (resp * xv[..., None]).sum(1) / nk
        var = (resp * (x[..., None] - mu[:, None, :]) ** 2).sum(1) / nk + reg
        w = nk / n_valid
    logp = log_prob(mu, var, w)
    # component 0 is the lower mean (a stable order: equal means keep 0, 1)
    order = torch.argsort(mu, dim=-1, stable=True)
    logp = logp.gather(-1, order[:, None, :].expand_as(logp))
    resp0 = torch.softmax(logp, dim=-1)[..., 0]
    log_density = torch.logsumexp(logp, dim=-1)
    return (torch.where(valid, resp0, torch.zeros_like(resp0)),
            torch.where(valid, log_density, torch.full_like(log_density,
                                                            -BIG)))


def smallest_per_group(loss: torch.Tensor, group: torch.Tensor,
                       num_groups: int, k: int):
    """The `k` smallest of each group's losses, ascending, of equal losses
    the lower index first.

    Args:
        loss: (B, N); group: (B, N) int64 in [0, num_groups], num_groups
            meaning none.
    Returns:
        values (B, num_groups, k), BIG past a group's count; indices (B,
        num_groups, k) into N, 0 there.
    """
    b, n = loss.shape
    order = torch.argsort(loss, dim=-1, stable=True)
    order = order.gather(1, torch.argsort(group.gather(1, order), dim=-1,
                                          stable=True))
    g_sorted = group.gather(1, order)
    counts = torch.zeros((b, num_groups + 1), dtype=torch.int64,
                         device=loss.device).scatter_add_(
                             1, group, torch.ones_like(group))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(n, device=loss.device)[None] - starts.gather(
        1, g_sorted)
    take = (rank < k) & (g_sorted < num_groups)
    dump = num_groups * k
    slot = torch.where(take, g_sorted * k + rank, torch.full_like(rank, dump))
    values = torch.full((b, dump + 1), BIG, dtype=loss.dtype,
                        device=loss.device)
    values.scatter_(1, slot, loss.gather(1, order))
    index = torch.zeros((b, dump + 1), dtype=torch.int64, device=loss.device)
    index.scatter_(1, slot, order)
    return (values[:, :dump].reshape(b, num_groups, k),
            index[:, :dump].reshape(b, num_groups, k))


@HEADS.register_module()
class PAAHead(ATSSHead):

    def __init__(self, num_classes, in_channels, topk=9, score_voting=True,
                 covariance_type='diag', bbox_coder=None, loss_bbox=None,
                 loss_centerness=None, **kwargs):
        kwargs.setdefault('train_cfg', dict(assigner=dict(
            type='MaxIoUAssigner', pos_iou_thr=0.1, neg_iou_thr=0.1,
            min_pos_iou=0.0)))
        super().__init__(
            num_classes, in_channels, bbox_coder=bbox_coder,
            loss_bbox=loss_bbox or dict(type='GIoULoss', loss_weight=1.3),
            loss_centerness=loss_centerness or dict(
                type='CrossEntropyLoss', use_sigmoid=True, loss_weight=0.5),
            **kwargs)
        self.topk = topk
        self.with_score_voting = score_voting
        self.loss_iou = self.loss_centerness
        a_cfg = dict(self.train_cfg.get('assigner', {}))
        a_cfg.pop('type', None)
        a_cfg.setdefault('pos_iou_thr', 0.1)
        a_cfg.setdefault('neg_iou_thr', 0.1)
        self.assigner = MaxIoUAssigner(**a_cfg)

    # ---- training ----------------------------------------------------------
    def candidate_losses(self, pos_loss: torch.Tensor, cand: torch.Tensor,
                         gt_inds: torch.Tensor, level_id: torch.Tensor,
                         num_gt: int):
        """Each gt's `topk` smallest candidate losses of each level, (B * G,
        levels x topk) in slots level x topk + rank (BIG past a level's
        count), and their anchors (B, G x levels x topk)."""
        b = pos_loss.shape[0]
        group = torch.where(cand, gt_inds.clamp(min=0) * self.num_levels +
                            level_id[None],
                            torch.full_like(gt_inds, num_gt * self.num_levels))
        loss_gl, idx = smallest_per_group(pos_loss, group,
                                          num_gt * self.num_levels, self.topk)
        return (loss_gl.reshape(b * num_gt, self.num_levels * self.topk),
                idx.reshape(b, -1))

    def select(self, x: torch.Tensor, aidx: torch.Tensor, cand: torch.Tensor
               ) -> torch.Tensor:
        """The kept positives (B, N) of the `candidate_losses` `x`, `aidx`:
        the GMM's foreground up to its density's peak."""
        xv = x < BIG / 2
        resp0, logd = fit_gmm_1d(x, xv)
        enough = xv.sum(-1, keepdim=True) >= 2
        fg = (resp0 > 0.5) & xv
        # rank among the foreground by loss, of equal losses by slot
        key = x + torch.arange(x.shape[1], dtype=torch.float32,
                               device=x.device) * 1e-9
        fg_rank = ((key[:, None, :] < key[:, :, None]) &
                   fg[:, None, :]).sum(-1)
        best = torch.where(fg, logd, torch.full_like(logd, -BIG)).argmax(
            -1, keepdim=True)
        keep = fg & (fg_rank <= fg_rank.gather(1, best)) & enough
        hits = torch.zeros(cand.shape, dtype=torch.int64, device=x.device)
        hits.scatter_add_(1, aidx, keep.reshape(cand.shape[0], -1).long())
        return (hits > 0) & cand

    def reassign(self, pos_loss: torch.Tensor, cand: torch.Tensor,
                 gt_inds: torch.Tensor, level_id: torch.Tensor, num_gt: int
                 ) -> torch.Tensor:
        """The kept positives (B, N) of the candidates `cand` (B, N), each
        of gt `gt_inds` (B, N) and level `level_id` (N,), by their detached
        losses `pos_loss` (B, N)."""
        x, aidx = self.candidate_losses(pos_loss, cand, gt_inds, level_id,
                                        num_gt)
        return self.select(x, aidx, cand)

    def reassigned(self, outputs, batch, featmap_sizes) -> Dict:
        """The candidates and the kept positives (B, N) of a batch, and
        what the losses read of them."""
        cls_scores, bbox_preds, iou_preds = outputs
        gt_bboxes = batch['gt_bboxes']
        device = gt_bboxes.device
        anchors, num_lvl, _, level_id = self.level_geometry(featmap_sizes,
                                                            device)
        cls_flat = flatten_levels(cls_scores)
        reg_flat = flatten_levels(bbox_preds)
        iou_flat = flatten_levels(iou_preds)[..., 0]
        b, n = cls_flat.shape[:2]
        valid = torch.stack([
            torch.cat(self.anchor_generator.valid_flags(featmap_sizes, hw,
                                                        device))
            for hw in batch['img_hw']])                             # (B, N)
        res = self.assigner.assign(anchors, num_lvl, gt_bboxes,
                                   batch['gt_labels'], batch['gt_valid'],
                                   valid, num_classes=self.num_classes)
        cand = res.pos_mask & valid
        safe = res.assigned_gt_inds.clamp(min=0)
        tgt = torch.gather(gt_bboxes, 1, safe[..., None].expand(-1, -1, 4))
        decoded = self.coder.decode(anchors[None], reg_flat)
        with torch.no_grad():
            l_cls = self.loss_cls(cls_flat, res.labels,
                                  reduction_override='none').sum(-1)
            l_box = self.loss_bbox(decoded.reshape(-1, 4),
                                   tgt.reshape(-1, 4),
                                   reduction_override='none').reshape(b, n)
            keep = self.reassign(l_cls + l_box, cand, res.assigned_gt_inds,
                                 level_id, gt_bboxes.shape[1])
        labels = torch.where(keep, res.labels,
                             torch.full_like(res.labels, self.num_classes))
        return dict(cand=cand, keep=keep, labels=labels, valid=valid,
                    targets=tgt, decoded=decoded, cls_flat=cls_flat,
                    iou_flat=iou_flat, pos_loss=l_cls + l_box,
                    gt_inds=res.assigned_gt_inds, level_id=level_id)

    def loss(self, outputs, batch, featmap_sizes) -> Dict[str, torch.Tensor]:
        r = self.reassigned(outputs, batch, featmap_sizes)
        keep, tgt, decoded = r['keep'], r['targets'], r['decoded']
        device = keep.device
        keepf = keep.to(torch.float32)
        num_pos = global_sum(keepf.sum())
        batch_size = global_sum(torch.tensor(float(keep.shape[0]),
                                             device=device))
        loss_cls = self.loss_cls(r['cls_flat'], r['labels'],
                                 weight=r['valid'].to(torch.float32),
                                 avg_factor=torch.maximum(num_pos,
                                                          batch_size))
        zero = torch.zeros((), device=device)
        iou_target = torch.where(keep, bbox_overlaps(
            decoded.detach(), tgt, is_aligned=True), zero)
        loss_bbox = self.loss_bbox(
            decoded.reshape(-1, 4), tgt.reshape(-1, 4),
            weight=(iou_target.clamp(min=EPS) * keepf).reshape(-1),
            avg_factor=global_sum(iou_target.sum()) + EPS)
        loss_iou = self.loss_iou(
            r['iou_flat'].reshape(-1, 1), iou_target.reshape(-1, 1),
            weight=keepf.reshape(-1, 1), avg_factor=num_pos.clamp(min=1.0))
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_iou=loss_iou)

    # ---- inference ---------------------------------------------------------
    def get_bboxes(self, outputs, img_hw, scale_factor=None, rescale=False,
                   cfg=None, with_nms=True, keep_fn=nms_keep):
        cfg = cfg or self.test_cfg
        cls_scores, bbox_preds, iou_preds = outputs
        device = cls_scores[0].device
        b = cls_scores[0].shape[0]
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_scores]
        mlvl_anchors = self.anchor_generator.grid_anchors(featmap_sizes,
                                                          device)
        nms_pre = cfg.get('nms_pre', 1000)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=device)
        boxes_all, scores_all = [], []
        for cls, reg, iou, a in zip(cls_scores, bbox_preds, iou_preds,
                                    mlvl_anchors):
            scores = torch.sigmoid(flatten_level(cls))
            iou_p = torch.sigmoid(flatten_level(iou))
            scores = torch.sqrt((scores * iou_p).clamp(min=0.0))
            reg = flatten_level(reg)
            a = a.expand(b, *a.shape)
            if 0 < nms_pre < scores.shape[1]:
                _, topk = torch.topk(scores.amax(dim=-1), nms_pre)
                scores, reg, a = (_gather_rows(t, topk)
                                  for t in (scores, reg, a))
            boxes_all.append(self.coder.decode(a, reg, max_shape=img_hw))
            scores_all.append(scores)
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(scale_factor, dtype=torch.float32,
                                            device=device)[:, None, :]
        score_thr = cfg.get('score_thr', 0.05)
        dets, labels, valid = multiclass_nms(
            boxes, scores, score_thr,
            cfg.get('nms', {}).get('iou_threshold', 0.6),
            max_per_img=cfg.get('max_per_img', 100), keep_fn=keep_fn)
        if self.with_score_voting:
            dets = score_voting(dets, labels, boxes, scores, score_thr)
        return dets, labels, valid


def score_voting(dets: torch.Tensor, labels: torch.Tensor,
                 boxes: torch.Tensor, scores: torch.Tensor,
                 score_thr: float) -> torch.Tensor:
    """Each detection's box replaced by the mean of its class's candidate
    boxes weighted by p x exp(-(1 - IoU)^2 / 0.025) over those with IoU >
    0.01 and a score above `score_thr` (JAX `_score_voting`).

    Args:
        dets: (B, D, 5); labels: (B, D), -1 at padding; boxes: (B, N, 4);
            scores: (B, N, C).
    """
    safe = labels.clamp(min=0)
    det_cls_scores = scores.transpose(1, 2).gather(
        1, safe[..., None].expand(-1, -1, scores.shape[1]))       # (B, D, N)
    iou = bbox_overlaps(dets[..., :4], boxes)                      # (B, D, N)
    w = det_cls_scores * torch.exp(-(1.0 - iou) ** 2 / 0.025) * \
        (iou > 0.01) * (det_cls_scores > score_thr)
    w_sum = w.sum(-1, keepdim=True)
    # the weighted mean of up to (levels x nms_pre) boxes in float64, so
    # that its summation order (the card's against the CPU's) stays below
    # float32's rounding of the result
    w64 = w.double()
    voted = (torch.bmm(w64, boxes.double()) /
             (w64.sum(-1, keepdim=True) + EPS)).to(boxes.dtype)
    use = (dets[..., 4:5] > 0) & (w_sum > EPS)
    return torch.cat([torch.where(use, voted, dets[..., :4]),
                      dets[..., 4:5]], dim=-1)
