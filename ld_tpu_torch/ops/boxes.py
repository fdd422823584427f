"""Box geometry primitives (PyTorch port of `ld_tpu/ops/boxes.py`).

Same semantics and the same order of floating-point operations as the JAX
functions, so results agree to the last bit or two:
  - bbox_overlaps: iou / iof / giou / diou / ciou, eps clamps of 1e-6;
  - distance2bbox / bbox2distance, with the per-image `max_shape` clamp.
All functions broadcast over leading batch dims.
"""
from __future__ import annotations

import math

import torch


def bbox_overlaps(bboxes1: torch.Tensor,
                  bboxes2: torch.Tensor,
                  mode: str = 'iou',
                  is_aligned: bool = False,
                  eps: float = 1e-6) -> torch.Tensor:
    """Pairwise (or aligned) overlap between two box sets in xyxy format.

    Args:
        bboxes1: (..., m, 4)
        bboxes2: (..., n, 4)  (n == m when is_aligned)
        mode: 'iou' | 'iof' | 'giou' | 'diou' | 'ciou'
    Returns:
        (..., m, n) overlaps, or (..., m) when is_aligned.
    """
    if mode not in ('iou', 'iof', 'giou', 'diou', 'ciou'):
        raise ValueError(mode)
    area1 = (bboxes1[..., 2] - bboxes1[..., 0]) * (
        bboxes1[..., 3] - bboxes1[..., 1])
    area2 = (bboxes2[..., 2] - bboxes2[..., 0]) * (
        bboxes2[..., 3] - bboxes2[..., 1])

    if not is_aligned:
        bboxes1 = bboxes1[..., :, None, :]
        bboxes2 = bboxes2[..., None, :, :]
        area1 = area1[..., :, None]
        area2 = area2[..., None, :]

    lt = torch.maximum(bboxes1[..., :2], bboxes2[..., :2])
    rb = torch.minimum(bboxes1[..., 2:], bboxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]

    if mode == 'iof':
        union = area1 if is_aligned else area1.expand(overlap.shape)
    else:
        union = area1 + area2 - overlap
    union = union.clamp(min=eps)
    ious = overlap / union

    if mode in ('iou', 'iof'):
        return ious

    enclosed_lt = torch.minimum(bboxes1[..., :2], bboxes2[..., :2])
    enclosed_rb = torch.maximum(bboxes1[..., 2:], bboxes2[..., 2:])
    enclose_wh = (enclosed_rb - enclosed_lt).clamp(min=0)

    if mode == 'giou':
        enclose_area = (enclose_wh[..., 0] * enclose_wh[..., 1]).clamp(
            min=eps)
        return ious - (enclose_area - union) / enclose_area

    # diou / ciou: centre-distance penalty over enclosing-box diagonal
    rho2 = (((bboxes2[..., 0] + bboxes2[..., 2]) -
             (bboxes1[..., 0] + bboxes1[..., 2]))**2 +
            ((bboxes2[..., 1] + bboxes2[..., 3]) -
             (bboxes1[..., 1] + bboxes1[..., 3]))**2) / 4.0
    enclose_c2 = (enclose_wh[..., 0]**2 + enclose_wh[..., 1]**2).clamp(
        min=eps)
    dious = ious - rho2 / enclose_c2
    if mode == 'diou':
        return dious

    # ciou adds the aspect-ratio consistency term (Zheng et al., AAAI 2020)
    w1 = bboxes1[..., 2] - bboxes1[..., 0]
    h1 = (bboxes1[..., 3] - bboxes1[..., 1]).clamp(min=eps)
    w2 = bboxes2[..., 2] - bboxes2[..., 0]
    h2 = (bboxes2[..., 3] - bboxes2[..., 1]).clamp(min=eps)
    factor = 4.0 / (math.pi**2)
    v = factor * (torch.atan(w2 / h2) - torch.atan(w1 / h1))**2
    # alpha is a constant w.r.t. gradients (per the CIoU paper)
    alpha = (v / (1.0 - ious + v).clamp(min=eps)).detach()
    return dious - alpha * v


def anchor_center(anchors: torch.Tensor) -> torch.Tensor:
    """Centres (..., 2) of xyxy anchors (..., 4)."""
    cx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    cy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    return torch.stack([cx, cy], dim=-1)


def distance2bbox(points: torch.Tensor,
                  distance: torch.Tensor,
                  max_shape=None) -> torch.Tensor:
    """Decode (left, top, right, bottom) distances at `points` into xyxy boxes.

    Args:
        points: (..., 2)
        distance: (..., 4)
        max_shape: optional (H, W) clamp: one pair, or a (B, 2) tensor of
            per-image bounds broadcast against (B, N) coordinates.
    """
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        max_shape = torch.as_tensor(max_shape, dtype=x1.dtype,
                                    device=x1.device)
        h = max_shape[..., 0]
        w = max_shape[..., 1]
        # broadcast (B,) image bounds against (B, N) coordinates
        while h.ndim < x1.ndim and h.ndim > 0:
            h = h[..., None]
            w = w[..., None]
        x1 = torch.minimum(x1.clamp(min=0), w)
        y1 = torch.minimum(y1.clamp(min=0), h)
        x2 = torch.minimum(x2.clamp(min=0), w)
        y2 = torch.minimum(y2.clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2distance(points: torch.Tensor,
                  bbox: torch.Tensor,
                  max_dis: float = None,
                  eps: float = 0.1) -> torch.Tensor:
    """Encode xyxy boxes as (left, top, right, bottom) distances from points."""
    left = points[..., 0] - bbox[..., 0]
    top = points[..., 1] - bbox[..., 1]
    right = bbox[..., 2] - points[..., 0]
    bottom = bbox[..., 3] - points[..., 1]
    out = torch.stack([left, top, right, bottom], dim=-1)
    if max_dis is not None:
        out = out.clamp(0, max_dis - eps)
    return out
