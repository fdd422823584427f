"""COCO polygon / RLE masks with pycocotools' semantics (port of
`ld_tpu/evaluation/coco_mask.py`), numpy.

Mask AP is scored against gts rasterised the way pycocotools does it
(maskApi.c `rleFrPoly`): the polygon is walked at 5x resolution, its
column-major y-crossings are kept where the x-cell changes, and even/odd
runs fill between them. A naive `cv2.fillPoly` differs on boundary pixels,
enough to flip IoU matches at high thresholds. Polygon coordinates are
continuous and pixel (i, j) covers [i, i+1) x [j, j+1): an axis-aligned
square from (1, 1) to (3, 3) fills exactly the 2x2 pixels 1..2.

`decode_segmentation` takes any COCO segmentation: a polygon list, an
uncompressed RLE ({'counts': [ints], 'size': [h, w]}) or a compressed one
(the LEB128-like string, `segm_eval.rle_decode`).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _poly_runs(xy: np.ndarray, h: int, w: int) -> np.ndarray:
    """Column-major RLE runs (the first counts zeros) of one polygon."""
    scale = 5.0
    k = len(xy) // 2
    x = np.floor(scale * xy[0::2] + .5).astype(np.int64)
    y = np.floor(scale * xy[1::2] + .5).astype(np.int64)
    x = np.concatenate([x, x[:1]])
    y = np.concatenate([y, y[:1]])

    # the integer points along the upsampled boundary, edge by edge
    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.floor(ys + s * t + .5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.floor(xs + s * t + .5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # the boundary points where the x-cell changes, down to the pixel grid
    # (y is the column's crossing, ceil-clipped to [0, h])
    xs_out, ys_out = [], []
    for j in range(1, len(u)):
        if u[j] == u[j - 1]:
            continue
        xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + .5) / scale - .5
        if np.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(v[j] if v[j] < v[j - 1] else v[j - 1])
        yd = (yd + .5) / scale - .5
        yd = min(max(yd, 0.0), float(h))
        xs_out.append(int(xd))
        ys_out.append(int(np.ceil(yd)))

    # even/odd fill: the sorted column-major crossings -> runs
    a = np.asarray(xs_out, np.int64) * h + np.asarray(ys_out, np.int64)
    a = np.concatenate([np.sort(a), [h * w]])
    runs = np.diff(np.concatenate([[0], a]))
    # a zero-length run merges into the previous one (maskApi.c's tail)
    b = [int(runs[0])]
    j = 1
    while j < len(runs):
        if runs[j] > 0:
            b.append(int(runs[j]))
            j += 1
        else:
            j += 1
            if j < len(runs):
                b[-1] += int(runs[j])
                j += 1
    return np.asarray(b, np.int64)


def _runs_to_mask(runs: np.ndarray, h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for r in runs:
        if val:
            flat[pos:pos + r] = True
        pos += int(r)
        val = not val
    return flat.reshape((w, h)).T       # column-major


def poly_to_mask(polys: Optional[List], h: int, w: int) -> np.ndarray:
    """The union of an object's polygons as an (h, w) bool mask
    (pycocotools' `annToMask`: frPyObjects, then merge)."""
    out = np.zeros((h, w), bool)
    if not polys:
        return out
    for p in polys:
        p = np.asarray(p, np.float64).reshape(-1)
        if len(p) >= 6:
            out |= _runs_to_mask(_poly_runs(p, h, w), h, w)
    return out


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygon list, uncompressed or compressed RLE
    dict) -> an (h, w) bool mask."""
    if seg is None:
        return np.zeros((h, w), bool)
    if isinstance(seg, list):
        return poly_to_mask(seg, h, w)
    counts = seg.get('counts')
    if isinstance(counts, (list, tuple)):       # uncompressed RLE
        return _runs_to_mask(np.asarray(counts, np.int64),
                             *map(int, seg['size'])) \
            if seg.get('size') else np.zeros((h, w), bool)
    from .segm_eval import rle_decode
    return rle_decode(seg).astype(bool)
