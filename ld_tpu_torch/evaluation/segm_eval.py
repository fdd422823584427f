"""Instance-segmentation (mask AP) evaluation (port of
`ld_tpu/evaluation/segm_eval.py`), numpy and cv2.

The COCOeval 'segm' protocol, as the JAX package implements it: the
matching of the bbox evaluation (greedy per image and category over 10
IoU thresholds, crowds matched as ignore by IoF), with the IoU between
binary masks instead of boxes. Masks are compared at 1/`scale` of the image
(default 1/4). Gts are rasterised the pycocotools way
(`coco_mask.poly_to_mask`); detections come as roi-space sigmoid masks
(n, 2s, 2s) with their boxes, pasted into the image by `paste_mask`
(bilinear into the box, then >= 0.5), or as full-size masks or RLEs.

`rle_encode` / `rle_decode` are pycocotools' compressed RLE, byte for byte;
`encode_mask_results` is mmdet's per-class encoding.

`SegmEvaluator` picks a detection mask's path by its shape (ROADMAP.md
caveat 3): an (h, w) mask of an (h, w) image is taken as full size.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .coco_eval import AREA_RNG, IOU_THRS, MAX_DETS, REC_THRS


def _cv2():
    from ld_tpu_torch.data.transforms import _cv2 as load
    return load()


def paste_mask(mask: np.ndarray, box: np.ndarray, out_h: int, out_w: int,
               thr: float = 0.5) -> np.ndarray:
    """Paste one roi-space mask into an (out_h, out_w) bitmap."""
    x1, y1, x2, y2 = box[:4]
    x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
    x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
    x1i, y1i = max(x1i, 0), max(y1i, 0)
    x2i, y2i = min(x2i, out_w), min(y2i, out_h)
    out = np.zeros((out_h, out_w), bool)
    if x2i <= x1i or y2i <= y1i:
        return out
    cv2 = _cv2()
    m = cv2.resize(mask.astype(np.float32), (x2i - x1i, y2i - y1i),
                   interpolation=cv2.INTER_LINEAR)
    out[y1i:y2i, x1i:x2i] = m >= thr
    return out


def rasterize_polygons(polys, h: int, w: int) -> np.ndarray:
    """pycocotools' polygon rasterisation (`coco_mask.poly_to_mask`)."""
    from .coco_mask import poly_to_mask
    return poly_to_mask(polys, h, w)


def mask_iou(det_masks: np.ndarray, gt_masks: np.ndarray,
             iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU between boolean mask stacks; crowd columns use IoF."""
    d = det_masks.reshape(len(det_masks), -1).astype(np.float64)
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float64)
    inter = d @ g.T
    area_d = d.sum(1)[:, None]
    area_g = g.sum(1)[None, :]
    union = np.where(iscrowd[None, :], area_d, area_d + area_g - inter)
    return inter / np.maximum(union, 1e-10)


def _match_with_ious(ious, det_areas, gt_ignore, gt_crowd, area_rng,
                     max_det):
    """Greedy matching on a precomputed IoU matrix (dets score-sorted)."""
    T = len(IOU_THRS)
    D, G = ious.shape
    dtm = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    for ti, thr in enumerate(IOU_THRS):
        gt_matched = np.zeros(G, bool)
        for d in range(D):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                if gt_matched[g] and not gt_crowd[g]:
                    continue
                if best_g > -1 and not gt_ignore[best_g] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g == -1:
                continue
            gt_matched[best_g] = True
            dtm[ti, d] = True
            dt_ig[ti, d] = gt_ignore[best_g]
    out_of_rng = (det_areas < area_rng[0]) | (det_areas > area_rng[1])
    dt_ig = dt_ig | (~dtm & out_of_rng[None, :])
    return dtm, dt_ig


class SegmEvaluator:
    """Mask AP over a dataset with polygon gts.

    det_results, per image: dict(boxes (n, 5), labels (n, ), masks (n, s, s)
    roi-space sigmoid masks), boxes in the original image's coordinates.
    """

    def __init__(self, dataset, scale: int = 4):
        self.dataset = dataset
        self.scale = scale
        self.num_classes = len(dataset.CLASSES)

    def _down(self, m, h, w):
        s = self.scale
        if s == 1:
            return m.astype(bool)
        cv2 = _cv2()
        return cv2.resize(m.astype(np.uint8),
                          (max(1, w // s), max(1, h // s)),
                          interpolation=cv2.INTER_NEAREST).astype(bool)

    def _gt_bitmaps(self, i, h, w):
        """The non-crowd masks (polygons), the crowd masks (the
        segmentations of `masks_ignore`), their areas and the annotation.
        A gt's area is the json 'area' where the dataset carries it
        (pycocotools filters gts by segmentation area), else its
        full-resolution pixel count."""
        from .coco_mask import decode_segmentation
        ann = self.dataset.get_ann_info(i)
        full = [rasterize_polygons(p, h, w) for p in ann.get('masks', [])]
        areas = ann.get('areas')
        if areas is None:
            areas = np.asarray([m.sum() for m in full], np.float64)
        gts = [self._down(m, h, w) for m in full]
        crowd_full = [decode_segmentation(s_, h, w)
                      for s_ in (ann.get('masks_ignore') or [])]
        crowd_areas = ann.get('areas_ignore')
        if crowd_areas is None or len(crowd_areas) != len(crowd_full):
            crowd_areas = np.asarray([m.sum() for m in crowd_full],
                                     np.float64)
        crowds = [self._down(m, h, w) for m in crowd_full]
        return gts, np.asarray(areas, np.float64), crowds, \
            np.asarray(crowd_areas, np.float64), ann

    def _det_bitmaps(self, masks, boxes, h, w):
        s = self.scale
        if isinstance(masks, (list, tuple)) and len(masks) and (
                isinstance(masks[0], dict)
                or np.asarray(masks[0]).shape == (h, w)):
            # RLEs or full-size bitmaps (mmdet's own segm results): decoded
            # and scaled down, no paste; a float full-size mask binarises
            # at 0.5, as a pasted one does
            from .coco_mask import decode_segmentation

            def to_bitmap(m):
                if isinstance(m, dict):
                    return decode_segmentation(m, h, w)
                m = np.asarray(m)
                return m >= 0.5 if m.dtype.kind == 'f' else m.astype(bool)
            return [self._down(to_bitmap(m), h, w) for m in masks]
        masks = np.asarray(masks if masks is not None
                           else np.zeros((0, 1, 1)))
        sh, sw = max(1, h // s), max(1, w // s)
        return [paste_mask(masks[d], boxes[d] / s, sh, sw)
                for d in range(len(boxes))]

    def evaluate(self, det_results: List[Dict]) -> Dict[str, float]:
        num_imgs = len(det_results)
        T, R, K = len(IOU_THRS), len(REC_THRS), self.num_classes
        A, M = len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        # every image's gts and detections as bitmaps, once
        per_img = []
        for i in range(num_imgs):
            info = self.dataset.img_infos[i]
            h, w = info['height'], info['width']
            gt_bitmaps, gt_areas, crowd_bitmaps, crowd_areas, ann = \
                self._gt_bitmaps(i, h, w)
            res = det_results[i]
            boxes = np.asarray(res['boxes'])
            labels = np.asarray(res['labels'])
            det_bitmaps = self._det_bitmaps(res.get('masks'), boxes, h, w)
            per_img.append((gt_bitmaps, gt_areas, crowd_bitmaps,
                            crowd_areas, ann, boxes, labels, det_bitmaps))

        area_items = list(AREA_RNG.items())
        s2 = float(self.scale)**2
        for k in range(K):
            for ai, (aname, arng) in enumerate(area_items):
                for mi, max_det in enumerate(MAX_DETS):
                    dtm_all, dtig_all, scores_all = [], [], []
                    npig = 0
                    for i in range(num_imgs):
                        (gt_bitmaps, gt_areas, crowd_bitmaps, crowd_areas,
                         ann, boxes, labels, det_bitmaps) = per_img[i]
                        gsel = [j for j, l in enumerate(ann['labels'])
                                if l == k]
                        ig_labels = ann.get('labels_ignore', [])
                        csel = [j for j, l in enumerate(ig_labels)
                                if l == k and j < len(crowd_bitmaps)]
                        dsel = [j for j in range(len(labels))
                                if labels[j] == k]
                        if not gsel and not csel and not dsel:
                            continue
                        order = np.argsort(
                            -boxes[dsel, 4],
                            kind='mergesort')[:max_det] if dsel else []
                        dsel = [dsel[o] for o in order]
                        dmask = np.stack([det_bitmaps[j] for j in dsel]) \
                            if dsel else np.zeros((0, 1, 1), bool)
                        if len(dmask):
                            shape = dmask.shape[1:]
                        elif gt_bitmaps:
                            shape = gt_bitmaps[0].shape
                        elif crowd_bitmaps:
                            shape = crowd_bitmaps[0].shape
                        else:
                            shape = (1, 1)
                        stack = [gt_bitmaps[j] for j in gsel] + \
                            [crowd_bitmaps[j] for j in csel]
                        gmask = np.stack(stack) if stack else \
                            np.zeros((0, ) + shape, bool)
                        # a gt's range by its annotation area (full-res
                        # px^2); a crowd is always ignored
                        g_areas = np.concatenate([
                            gt_areas[gsel] if gsel else np.zeros(0),
                            crowd_areas[csel] if csel else np.zeros(0)])
                        crowd = np.zeros(len(gmask), bool)
                        crowd[len(gsel):] = True
                        gt_ignore = crowd | (g_areas < arng[0]) | \
                            (g_areas > arng[1])
                        g_order = np.argsort(gt_ignore, kind='mergesort')
                        gmask = gmask[g_order]
                        gt_ignore = gt_ignore[g_order]
                        crowd = crowd[g_order]
                        if len(dmask) and len(gmask):
                            ious = mask_iou(dmask, gmask, crowd)
                        else:
                            ious = np.zeros((len(dmask), len(gmask)))
                        # a detection's range by its pasted pixel count,
                        # scaled back to full-res px^2
                        d_areas = dmask.reshape(len(dmask), -1).sum(1) * s2 \
                            if len(dmask) else np.zeros(0)
                        dtm, dtig = _match_with_ious(
                            ious, d_areas, gt_ignore, crowd, arng, max_det)
                        dtm_all.append(dtm)
                        dtig_all.append(dtig)
                        scores_all.append(boxes[dsel, 4] if dsel else
                                          np.zeros(0))
                        npig += int((~gt_ignore).sum())
                    if npig == 0:
                        continue
                    dtm = np.concatenate(dtm_all, 1) if dtm_all else \
                        np.zeros((T, 0), bool)
                    dtig = np.concatenate(dtig_all, 1) if dtig_all else \
                        np.zeros((T, 0), bool)
                    scores = np.concatenate(scores_all) if scores_all else \
                        np.zeros(0)
                    order = np.argsort(-scores, kind='mergesort')
                    dtm, dtig = dtm[:, order], dtig[:, order]
                    tps = (dtm & ~dtig).astype(np.float64)
                    fps = (~dtm & ~dtig).astype(np.float64)
                    tp_sum = tps.cumsum(1)
                    fp_sum = fps.cumsum(1)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, 1e-10)
                        recall[ti, k, ai, mi] = rc[-1] if len(rc) else 0.0
                        q = np.zeros(R)
                        if len(pr):
                            for d in range(len(pr) - 1, 0, -1):
                                pr[d - 1] = max(pr[d - 1], pr[d])
                            inds = np.searchsorted(rc, REC_THRS, side='left')
                            valid = inds < len(pr)
                            q[valid] = pr[inds[valid]]
                        precision[ti, :, k, ai, mi] = q

        def summ(iou=None, area='all', max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            s = precision[:, :, :, ai, mi]
            if iou is not None:
                s = s[[np.argmin(np.abs(IOU_THRS - iou))]]
            s = s[s > -1]
            return float(s.mean()) if s.size else float('nan')

        def summ_ar(area='all', max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            s = recall[:, :, ai, mi]
            s = s[s > -1]
            return float(s.mean()) if s.size else float('nan')

        return {
            'segm_mAP': summ(),
            'segm_mAP_50': summ(iou=0.5),
            'segm_mAP_75': summ(iou=0.75),
            'segm_mAP_s': summ(area='small'),
            'segm_mAP_m': summ(area='medium'),
            'segm_mAP_l': summ(area='large'),
            'segm_AR@1': summ_ar(max_det=1),
            'segm_AR@10': summ_ar(max_det=10),
            'segm_AR@100': summ_ar(max_det=100),
            'segm_AR_s@100': summ_ar(area='small'),
            'segm_AR_m@100': summ_ar(area='medium'),
            'segm_AR_l@100': summ_ar(area='large'),
        }


def rle_encode(mask) -> Dict:
    """pycocotools' compressed RLE of a binary (H, W) mask: dict(size,
    counts). Column-major run lengths starting with a 0-run, the runs from
    the third on coded as differences, in 5-bit groups with a continuation
    bit, each byte + 48."""
    m = np.asfortranarray(np.asarray(mask, dtype=np.uint8))
    h, w = m.shape
    flat = m.flatten(order='F')
    diffs = np.nonzero(np.diff(flat))[0]
    bounds = np.concatenate([[0], diffs + 1, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat.size == 0:
        runs = []
    elif flat[0] == 1:
        runs = [0] + runs
    out = bytearray()
    for i, run in enumerate(runs):
        x = int(run)
        if i > 2:
            x -= int(runs[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or
                        (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return dict(size=[h, w], counts=bytes(out))


def rle_decode(rle) -> np.ndarray:
    """The (H, W) uint8 mask of a compressed RLE (`rle_encode`'s inverse;
    takes pycocotools' dicts, `counts` as bytes or str)."""
    h, w = rle['size']
    s = rle['counts']
    if isinstance(s, str):
        s = s.encode()
    runs = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in runs:
        flat[pos:pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape((h, w), order='F')


def encode_mask_results(mask_results):
    """A per-class list of binary masks -> a per-class list of RLEs
    (mmdet's `encode_mask_results`)."""
    return [[rle_encode(m) for m in cls_masks] for cls_masks in mask_results]
