"""Class-aware multiclass NMS with static shapes (port of `ld_tpu/ops/nms.py`).

Outputs are fixed-size with validity masks, as in the JAX package, and the
batch dimension is written out where the JAX package `vmap`s over images.
The greedy keep mask comes from `nms_cuda.nms_keep`: the CUDA kernel on the
card, its plain version on the CPU.

The JAX package's `topk_flat` lane split is a TPU sort device; here
`torch.topk` gives the same indices on untied scores. A reduced `iou_dtype`
(`test_cfg.nms.iou_dtype`) takes the JAX package's class-mask fixpoint in
plain torch (`_nms_keep_classed`). `nms_cfg` type 'voting_cluster_diounms'
takes `multiclass_nms_voting`, the cluster-DIoU fixpoint with Gaussian score
voting, in plain torch: its suppression is not the keep kernel's IoU test.
`approx_topk`, a TPU lowering, and `soft_nms` (not ported yet) raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .boxes import bbox_overlaps
from .nms_cuda import nms_keep


def _not_ported(what: str):
    raise NotImplementedError(f'{what} is not ported to ld_tpu_torch yet '
                              '(see ROADMAP.md)')


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, score_threshold: float = float('-inf'),
        overlap_mode: str = 'iou',
        keep_fn=nms_keep) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of one box set, returning indices of kept boxes.

    The boxes are ordered by a stable descending sort, so equal scores keep
    the input order, as `jax.lax.top_k` keeps it in the JAX package.

    Args:
        keep_fn: the keep-mask function, `nms_keep` (the kernel on the card).
    Returns (static shapes; K = min(max_out, num_boxes)):
        idx: (K,) int64 indices into the input (undefined where invalid).
        valid: (K,) bool.
    """
    if overlap_mode != 'iou':
        _not_ported(f'nms overlap_mode={overlap_mode!r}')
    n = boxes.shape[0]
    order_scores, order = torch.sort(scores, descending=True, stable=True)
    sboxes = boxes[order].contiguous()
    valid = order_scores > score_threshold
    keep = keep_fn(sboxes[None], valid[None].contiguous(), iou_threshold)[0]
    kept_scores = torch.where(keep, order_scores,
                              torch.full_like(order_scores, -float('inf')))
    top_scores, pos = torch.sort(kept_scores, descending=True, stable=True)
    k = min(max_out, n)
    return order[pos[:k]], top_scores[:k] > -float('inf')


def _topk_pairs(masked: torch.Tensor, k: int, exact_preprune: bool = None):
    """Top-k (anchor, class) pairs of thresholded (B, N, C) scores, per image;
    returns (values, flat indices into N*C) like a top-k of the flat array
    (exact on untied scores).

    Exact anchor pre-prune (`ld_tpu/ops/nms.py:222-250`): every pair in the
    global top-k belongs to an anchor whose class max is among the top-k
    anchor maxes, so the flat top-k reads k*C values instead of N*C. The
    selected anchors are re-sorted ascending so that the flat order, and with
    it the tie order, is the original one.
    """
    b, num_anchors, num_classes = masked.shape
    if (exact_preprune if exact_preprune is not None
            else (num_anchors > 2 * k and num_classes > 1)):
        n_anch = min(k, num_anchors)
        _, anch = torch.topk(masked.amax(dim=-1), n_anch)
        anch, _ = torch.sort(anch, dim=-1)
        sub = torch.gather(masked, 1,
                           anch[..., None].expand(b, n_anch, num_classes))
        top_scores, sub_idx = torch.topk(sub.reshape(b, -1), k)
        return top_scores, (torch.gather(anch, 1, sub_idx // num_classes) *
                            num_classes + sub_idx % num_classes)
    return torch.topk(masked.reshape(b, -1), k)


def multiclass_nms(mlvl_bboxes: torch.Tensor,
                   mlvl_scores: torch.Tensor,
                   score_thr: float,
                   iou_threshold: float,
                   max_per_img: int = 100,
                   max_candidates: int = 1024,
                   box_coord_bound: float = 4096.0,
                   nms_cfg: dict = None,
                   iou_dtype=None,
                   approx_topk=None,
                   exact_preprune: bool = None,
                   keep_fn=nms_keep):
    """Class-aware NMS over each image's multi-level candidates.

    Per-(anchor, class) pairs above `score_thr` compete in one NMS where boxes
    of different classes never suppress each other (class-offset trick); the
    top `max_per_img` survivors are returned. The top `max_candidates` pairs
    by score are the candidates (static shape).

    Args:
        mlvl_bboxes: (B, N, 4).
        mlvl_scores: (B, N, C) sigmoid class scores WITHOUT background column.
        nms_cfg: `type` 'voting_cluster_diounms' returns
            `multiclass_nms_voting` (no `keep_fn`, no `iou_dtype`).
        iou_dtype: a dtype other than float32 (or its name) computes the IoU
            matrix in it, by `_nms_keep_classed`, in place of `keep_fn`.
        keep_fn: the keep-mask function, `nms_keep` (the kernel on the card).
    Returns:
        dets: (B, max_per_img, 5) [x1, y1, x2, y2, score], zero-padded.
        labels: (B, max_per_img) int64, -1 where invalid.
        valid: (B, max_per_img) bool.
    """
    nms_cfg = nms_cfg or {}
    if approx_topk is None:
        approx_topk = nms_cfg.get('approx_topk')
    if iou_dtype is None:
        iou_dtype = nms_cfg.get('iou_dtype')
    if iou_dtype is not None:
        iou_dtype = _as_torch_dtype(iou_dtype)
    if approx_topk:
        _not_ported('approx_topk (a TPU approx_max_k lowering)')
    if nms_cfg.get('type') == 'voting_cluster_diounms':
        return multiclass_nms_voting(mlvl_bboxes, mlvl_scores, score_thr,
                                     iou_threshold, max_per_img,
                                     max_candidates, box_coord_bound)
    if nms_cfg.get('type', 'nms') != 'nms':
        _not_ported(f"nms type {nms_cfg['type']!r}")
    b, num_anchors, num_classes = mlvl_scores.shape
    masked = torch.where(mlvl_scores > score_thr, mlvl_scores,
                         torch.zeros_like(mlvl_scores))
    k = min(max_candidates, num_anchors * num_classes)
    top_scores, top_idx = _topk_pairs(masked, k, exact_preprune)
    anchor_idx = top_idx // num_classes
    class_idx = top_idx % num_classes
    cand_boxes = torch.gather(mlvl_bboxes, 1,
                              anchor_idx[..., None].expand(b, k, 4))
    cand_valid = top_scores > 0.0

    # class-offset trick; the offset must exceed every coordinate (the
    # reference derives it from boxes.max()), else giant boxes bleed into the
    # next class's band. Zero-scored candidates tie in the top-k and the card
    # breaks those ties in another order than the CPU, so other invalid boxes
    # may be gathered; they reach the bound only through the max, and boxes
    # clipped to a padded image stay <= 1344 < 4096, so the bound is the same.
    bound = torch.clamp(cand_boxes.amax(dim=(1, 2)) + 1.0,
                        min=box_coord_bound)
    offset_boxes = cand_boxes + (class_idx.to(cand_boxes.dtype) *
                                 bound[:, None])[..., None]
    if iou_dtype not in (None, torch.float32):
        keep = _nms_keep_classed(cand_boxes, class_idx, iou_threshold,
                                 cand_valid, iou_dtype)
    else:
        keep = keep_fn(offset_boxes.contiguous(), cand_valid.contiguous(),
                       iou_threshold)
    return _finalize(keep, top_scores, cand_boxes, class_idx, max_per_img)


def _as_torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _nms_keep_classed(boxes, class_idx, iou_threshold, valid, iou_dtype):
    """Class-aware keep mask with the IoU matrix in a reduced dtype; port of
    `ld_tpu/ops/nms.py:183-215`, batched over images.

    The class offset would destroy the box geometry in bfloat16 (offsets
    reach ~3e5, where its ulp is ~2048), so the IoU is taken on the raw
    boxes in `iou_dtype` and an exact same-class mask gates suppression;
    then the fixpoint of `nms_keep_ref`. The boxes are scaled by 1/32
    first (exact) so that float16 areas stay below its 65504 max. Not exact
    greedy NMS: the JAX package measured det-set agreement with float32 of
    0.980 (float16) and 0.881 (bfloat16) on clustered COCO-scale candidates.

    Args:
        boxes: (B, K, 4) float32, each image sorted by descending score.
        class_idx: (B, K) class of each box; valid: (B, K) bool.
    Returns:
        (B, K) bool keep mask.
    """
    k = boxes.shape[1]
    small = (boxes * (1.0 / 32.0)).to(iou_dtype)
    iou = bbox_overlaps(small, small)                       # (B, K, K)
    tri = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    same = class_idx[:, :, None] == class_idx[:, None, :]
    suppress = ((iou > iou_threshold) & tri & same).float()
    keep = valid
    for _ in range(k):
        killed = torch.bmm(keep.float()[:, None, :], suppress)[:, 0] > 0.5
        new_keep = valid & ~killed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def multiclass_nms_voting(mlvl_bboxes: torch.Tensor,
                          mlvl_scores: torch.Tensor,
                          score_thr: float,
                          iou_threshold: float,
                          max_per_img: int = 100,
                          max_candidates: int = 1024,
                          box_coord_bound: float = 4096.0,
                          beta: float = 0.8,
                          sigma: float = 0.025):
    """Cluster-DIoU NMS with Gaussian score voting over each image's
    candidates (port of `ld_tpu/ops/nms.py:360-423`, the reference's
    `voting_cluster_diounms`).

    The top `max_candidates` (anchor, class) pairs compete on class-offset
    boxes (offset max(box_coord_bound, boxes.max() + 1), as in
    `multiclass_nms`): a candidate is suppressed by a kept higher-scored one
    whose DIoU = IoU - (d²/c²)^beta exceeds `iou_threshold`, iterated to a
    fixpoint of at most K rounds (the stop test reads the keep mask on the
    host once a round). Each kept box is then the average of the candidates
    from itself down (suppressed ones too) whose DIoU with it exceeds 0.7,
    weighted exp(-(1 - DIoU)² / sigma) * score.

    Shapes as `multiclass_nms`. The rounds of the last call are in
    `multiclass_nms_voting.iterations`.
    """
    b, num_anchors, num_classes = mlvl_scores.shape
    masked = torch.where(mlvl_scores > score_thr, mlvl_scores,
                         torch.zeros_like(mlvl_scores))
    k = min(max_candidates, num_anchors * num_classes)
    top_scores, top_idx = _topk_pairs(masked, k)
    class_idx = top_idx % num_classes
    cand_boxes = torch.gather(mlvl_bboxes, 1, (top_idx // num_classes)[
        ..., None].expand(b, k, 4))
    cand_valid = top_scores > 0.0
    bound = torch.clamp(cand_boxes.amax(dim=(1, 2)) + 1.0,
                        min=box_coord_bound)
    ob = cand_boxes + (class_idx.to(cand_boxes.dtype) *
                       bound[:, None])[..., None]

    iou = bbox_overlaps(ob, ob)                              # (B, K, K)
    cx = (ob[..., 0] + ob[..., 2]) / 2
    cy = (ob[..., 1] + ob[..., 3]) / 2
    enc_l = torch.minimum(ob[:, :, None, 0], ob[:, None, :, 0])
    enc_t = torch.minimum(ob[:, :, None, 1], ob[:, None, :, 1])
    enc_r = torch.maximum(ob[:, :, None, 2], ob[:, None, :, 2])
    enc_b = torch.maximum(ob[:, :, None, 3], ob[:, None, :, 3])
    d2 = ((cx[:, None, :] - cx[:, :, None])**2 +
          (cy[:, None, :] - cy[:, :, None])**2)
    c2 = (enc_r - enc_l)**2 + (enc_b - enc_t)**2 + 1e-7
    diou = iou - torch.clamp(d2 / c2, 0.0, 1.0)**beta

    ones = torch.ones(k, k, dtype=torch.bool, device=ob.device)
    suppress = ((diou > iou_threshold) & ones.triu(1)).float()
    keep, rounds = cand_valid, 0
    while rounds < k:
        rounds += 1
        killed = torch.bmm(keep.float()[:, None, :], suppress)[:, 0] > 0.5
        new_keep = cand_valid & ~killed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    multiclass_nms_voting.iterations = rounds

    gate = ones.triu() & (diou > 0.7) & cand_valid[:, None, :]
    w = torch.where(gate, torch.exp(-(1.0 - diou)**2 / sigma) *
                    top_scores[:, None, :], torch.zeros_like(diou))
    voted = torch.bmm(w, cand_boxes) / torch.clamp(
        w.sum(-1, keepdim=True), min=1e-6)
    return _finalize(keep, top_scores, voted, class_idx, max_per_img)


multiclass_nms_voting.iterations = 0


def _finalize(keep, top_scores, boxes, class_idx, max_per_img):
    """Top `max_per_img` surviving candidates per image, zero-padded."""
    b, k = keep.shape
    kept_scores = torch.where(keep, top_scores,
                              torch.full_like(top_scores, -float('inf')))
    m = min(max_per_img, k)
    out_scores, pos = torch.topk(kept_scores, m)
    out_valid = out_scores > 0.0
    out_scores = torch.where(out_valid, out_scores,
                             torch.zeros_like(out_scores))
    out_boxes = torch.gather(boxes, 1, pos[..., None].expand(b, m, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    out_labels = torch.where(out_valid, torch.gather(class_idx, 1, pos),
                             torch.full_like(pos, -1))
    pad = max_per_img - m
    if pad:
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_labels = torch.nn.functional.pad(out_labels, (0, pad), value=-1)
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    dets = torch.cat([out_boxes, out_scores[..., None]], dim=-1)
    return dets, out_labels, out_valid
