"""Class-aware multiclass NMS with static shapes (port of `ld_tpu/ops/nms.py`).

Outputs are fixed-size with validity masks, as in the JAX package, and the
batch dimension is written out where the JAX package `vmap`s over images.
The greedy keep mask comes from `nms_cuda.nms_keep`: the CUDA kernel on the
card, its plain version on the CPU.

The JAX package's `topk_flat` lane split is a TPU sort device; here
`torch.topk` gives the same indices on untied scores. Options that exist only
for the TPU (`approx_topk`, reduced `iou_dtype`) and the NMS variants that are
not ported yet (`soft_nms`, voting NMS) raise NotImplementedError.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .nms_cuda import nms_keep


def _not_ported(what: str):
    raise NotImplementedError(f'{what} is not ported to ld_tpu_torch yet '
                              '(see ROADMAP.md)')


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, score_threshold: float = float('-inf'),
        overlap_mode: str = 'iou') -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of one box set, returning indices of kept boxes.

    Returns (static shapes; K = min(max_out, num_boxes)):
        idx: (K,) int64 indices into the input (undefined where invalid).
        valid: (K,) bool.
    """
    if overlap_mode != 'iou':
        _not_ported(f'nms overlap_mode={overlap_mode!r}')
    n = boxes.shape[0]
    order_scores, order = torch.topk(scores, n)
    sboxes = boxes[order].contiguous()
    valid = order_scores > score_threshold
    keep = nms_keep(sboxes[None], valid[None].contiguous(), iou_threshold)[0]
    kept_scores = torch.where(keep, order_scores,
                              torch.full_like(order_scores, -float('inf')))
    top_scores, pos = torch.topk(kept_scores, min(max_out, n))
    return order[pos], top_scores > -float('inf')


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
    if approx_topk:
        _not_ported('approx_topk (a TPU approx_max_k lowering)')
    if iou_dtype is not None and torch.float32 != _as_torch_dtype(iou_dtype):
        _not_ported(f'iou_dtype={iou_dtype!r}')
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
    keep = keep_fn(offset_boxes.contiguous(), cand_valid.contiguous(),
                   iou_threshold)
    return _finalize(keep, top_scores, cand_boxes, class_idx, max_per_img)


def _as_torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


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
