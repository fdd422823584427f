"""COCO detection evaluation, AP@[.5:.95] (port of
`ld_tpu/evaluation/coco_eval.py`; pycocotools' COCOeval protocol without
pycocotools): 10 IoU thresholds 0.50:0.05:0.95, 101-point interpolated
precision, the all / small / medium / large area ranges, maxDets (1, 10,
100), crowd regions matched as ignore with IoF overlap, greedy matching in
score order per (image, category).

The matching runs in the native matcher (`csrc/host/coco_match.cpp`, built
by `ld_tpu_torch.native`); `_match_numpy` is its plain version.
"""
from __future__ import annotations

import ctypes
from collections import defaultdict
from typing import Dict, List

import numpy as np

from ld_tpu_torch import native

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0**2),
    'medium': (32.0**2, 96.0**2),
    'large': (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xyxy(dets: np.ndarray, gts: np.ndarray,
              iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; crowd gt columns use intersection / det-area (IoF)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:4], gts[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = ((dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1]))[:, None]
    area_g = ((gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]))[None, :]
    union = np.where(iscrowd[None, :], area_d, area_d + area_g - inter)
    return inter / np.maximum(union, 1e-10)


def _match_numpy(det_boxes, gt_boxes, gt_crowd, gt_ignore, area_rng):
    """The plain matcher: (dtm, dt_ignore), each (T, D) bool, for score-
    sorted dets and ignored-last gts."""
    T, D, G = len(IOU_THRS), len(det_boxes), len(gt_boxes)
    ious = _iou_xyxy(det_boxes, gt_boxes, gt_crowd)
    dtm = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    for ti, thr in enumerate(IOU_THRS):
        gt_matched = np.zeros(G, bool)
        for d in range(D):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                # crowd gts may match many dets; others only once
                if gt_matched[g] and not gt_crowd[g]:
                    continue
                # gts are sorted counted-first: once a counted match is
                # held, stop at the first ignored gt
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
    # unmatched dets outside the area range are ignored, not FPs
    d_area = (det_boxes[:, 2] - det_boxes[:, 0]) * \
        (det_boxes[:, 3] - det_boxes[:, 1])
    out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
    return dtm, dt_ig | (~dtm & out_of_rng[None, :])


def _match_native(det_boxes, gt_boxes, gt_crowd, gt_ignore, area_rng):
    """`_match_numpy` in C++."""
    lib = native.load('coco_match')
    T, D, G = len(IOU_THRS), len(det_boxes), len(gt_boxes)
    db = np.ascontiguousarray(det_boxes, np.float64)
    gb = np.ascontiguousarray(gt_boxes, np.float64)
    gc = np.ascontiguousarray(gt_crowd, np.uint8)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    thrs = np.ascontiguousarray(IOU_THRS, np.float64)
    rng = np.ascontiguousarray(area_rng, np.float64)
    dtm = np.zeros((T, D), np.uint8)
    dt_ig = np.zeros((T, D), np.uint8)
    f64, u8 = ctypes.c_double, ctypes.c_uint8
    lib.coco_match(native.ptr(db, f64), D, native.ptr(gb, f64),
                   native.ptr(gc, u8), native.ptr(gi, u8), G,
                   native.ptr(thrs, f64), T, native.ptr(rng, f64),
                   native.ptr(dtm, u8), native.ptr(dt_ig, u8))
    return dtm.astype(bool), dt_ig.astype(bool)


def _match_single(det_boxes, det_scores, gt_boxes, gt_crowd, area_rng,
                  max_det, gt_areas=None, matcher=None):
    """Greedy matching for one (image, category, area range).

    Returns (dtm, dt_ignore, scores, npig): the (T, D) matched flag per IoU
    threshold, the (T, D) ignored flag, the dets' scores in matching order,
    and the number of counted (not ignored) gts. `gt_areas` is the
    annotation 'area' (pycocotools filters gts by it), else the box area.
    `matcher` defaults to the native one.
    """
    order = np.argsort(-det_scores, kind='mergesort')[:max_det]
    det_boxes = det_boxes[order]
    det_scores = det_scores[order]
    if gt_areas is None:
        gt_areas = (gt_boxes[:, 2] - gt_boxes[:, 0]) * \
            (gt_boxes[:, 3] - gt_boxes[:, 1]) if len(gt_boxes) else \
            np.zeros((0, ))
    gt_ignore = gt_crowd | (gt_areas < area_rng[0]) | \
        (gt_areas > area_rng[1])
    # counted gts first, ignored last (pycocotools sorts by the ignore flag)
    g_order = np.argsort(gt_ignore, kind='mergesort')
    gt_boxes = gt_boxes[g_order]
    gt_crowd = gt_crowd[g_order]
    gt_ignore = gt_ignore[g_order]
    npig = int((~gt_ignore).sum())
    dtm, dt_ig = (matcher or _match_native)(det_boxes, gt_boxes, gt_crowd,
                                            gt_ignore, area_rng)
    return dtm, dt_ig, det_scores, npig


class CocoEvaluator:
    """Accumulates detections and computes the 12 standard COCO metrics."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.num_classes = len(dataset.CLASSES) if hasattr(
            dataset, 'CLASSES') else 80

    def evaluate(self, det_results: List, classwise: bool = False
                 ) -> Dict[str, float]:
        """det_results: per image, dict(boxes=(n,5) xyxy+score, labels=(n,)
        [, valid=(n,)]) or a per-class list of (n,5) arrays."""
        num_imgs = len(det_results)
        if num_imgs != len(self.dataset):
            raise ValueError(f'{num_imgs} results for {len(self.dataset)} '
                             'images')

        # detections and gts by (image, class)
        per_img_cls_det = defaultdict(lambda: (np.zeros((0, 4)),
                                               np.zeros((0, ))))
        gts_by_img_cls = {}
        for i in range(num_imgs):
            res = det_results[i]
            if isinstance(res, dict):
                boxes = np.asarray(res['boxes'], np.float64)
                labels = np.asarray(res['labels'])
                if 'valid' in res:
                    m = np.asarray(res['valid'], bool)
                    boxes, labels = boxes[m], labels[m]
            else:
                boxes = np.concatenate(res) if len(res) else np.zeros((0, 5))
                labels = np.concatenate([
                    np.full(len(r), c) for c, r in enumerate(res)
                ]) if len(res) else np.zeros((0, ))
            for c in np.unique(labels).astype(int):
                m = labels == c
                per_img_cls_det[(i, c)] = (boxes[m, :4], boxes[m, 4])
            ann = self.dataset.get_ann_info(i)
            ann_areas = ann.get('areas')
            for c in np.unique(ann['labels']).astype(int):
                m = ann['labels'] == c
                gts_by_img_cls[(i, c)] = (
                    ann['bboxes'][m].astype(np.float64),
                    np.asarray(ann_areas, np.float64)[m]
                    if ann_areas is not None else None)
            ignore = ann.get('bboxes_ignore', np.zeros((0, 4)))
            if len(ignore):
                ig_labels = ann.get('labels_ignore')
                ig_areas = ann.get('areas_ignore')
                if ig_labels is not None:
                    # per-category crowd regions: a crowd ignores only the
                    # dets of its own class (pycocotools)
                    ig_labels = np.asarray(ig_labels)
                    for c in np.unique(ig_labels).astype(int):
                        m = ig_labels == c
                        gts_by_img_cls[(i, -1 - c)] = (
                            np.asarray(ignore, np.float64)[m],
                            np.asarray(ig_areas, np.float64)[m]
                            if ig_areas is not None else None)
                else:
                    # classless crowds apply to every class
                    gts_by_img_cls[(i, None)] = (
                        ignore.astype(np.float64), None)

        T, R, K = len(IOU_THRS), len(REC_THRS), self.num_classes
        A, M = len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        area_items = list(AREA_RNG.items())
        for k in range(K):
            for ai, (_, arng) in enumerate(area_items):
                for mi, max_det in enumerate(MAX_DETS):
                    dtm_all, dtig_all, scores_all = [], [], []
                    npig = 0
                    for i in range(num_imgs):
                        gt, gt_areas = gts_by_img_cls.get(
                            (i, k), (np.zeros((0, 4)), None))
                        crowd, crowd_areas = gts_by_img_cls.get(
                            (i, -1 - k),
                            gts_by_img_cls.get((i, None),
                                               (np.zeros((0, 4)), None)))
                        det_b, det_s = per_img_cls_det[(i, k)]
                        if len(gt) == 0 and len(det_b) == 0 and \
                                len(crowd) == 0:
                            continue
                        gtb = np.concatenate([gt, crowd]) if len(crowd) \
                            else gt
                        crowd_flag = np.concatenate([
                            np.zeros(len(gt), bool),
                            np.ones(len(crowd), bool)
                        ]) if len(crowd) else np.zeros(len(gt), bool)
                        if gt_areas is not None or crowd_areas is not None:
                            def _a(boxes, areas):
                                if areas is not None:
                                    return areas
                                return (boxes[:, 2] - boxes[:, 0]) * \
                                    (boxes[:, 3] - boxes[:, 1])
                            areas = np.concatenate(
                                [_a(gt, gt_areas), _a(crowd, crowd_areas)])
                        else:
                            areas = None
                        dtm, dtig, s, n = _match_single(
                            det_b, det_s, gtb, crowd_flag, arng, max_det,
                            gt_areas=areas)
                        dtm_all.append(dtm)
                        dtig_all.append(dtig)
                        scores_all.append(s)
                        npig += n
                    if npig == 0:
                        continue
                    dtm = np.concatenate(dtm_all, 1) if dtm_all else \
                        np.zeros((T, 0), bool)
                    dtig = np.concatenate(dtig_all, 1) if dtig_all else \
                        np.zeros((T, 0), bool)
                    scores = np.concatenate(scores_all) if scores_all else \
                        np.zeros((0, ))
                    order = np.argsort(-scores, kind='mergesort')
                    dtm, dtig = dtm[:, order], dtig[:, order]
                    tp_sum = (dtm & ~dtig).astype(np.float64).cumsum(1)
                    fp_sum = (~dtm & ~dtig).astype(np.float64).cumsum(1)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, 1e-10)
                        recall[ti, k, ai, mi] = rc[-1] if len(rc) else 0.0
                        # monotone envelope from the right
                        q = np.zeros(R)
                        if len(pr):
                            for d in range(len(pr) - 1, 0, -1):
                                pr[d - 1] = max(pr[d - 1], pr[d])
                            inds = np.searchsorted(rc, REC_THRS, side='left')
                            valid = inds < len(pr)
                            q[valid] = pr[inds[valid]]
                        precision[ti, :, k, ai, mi] = q

        def _summ(prec_or_rec, iou=None, area='all', max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            if prec_or_rec == 'precision':
                s = precision[:, :, :, ai, mi]
            else:
                s = recall[:, :, ai, mi]
            if iou is not None:
                s = s[[np.argmin(np.abs(IOU_THRS - iou))]]
            s = s[s > -1]
            return float(s.mean()) if s.size else float('nan')

        metrics = {
            'bbox_mAP': _summ('precision'),
            'bbox_mAP_50': _summ('precision', iou=0.5),
            'bbox_mAP_75': _summ('precision', iou=0.75),
            'bbox_mAP_s': _summ('precision', area='small'),
            'bbox_mAP_m': _summ('precision', area='medium'),
            'bbox_mAP_l': _summ('precision', area='large'),
            'AR@1': _summ('recall', max_det=1),
            'AR@10': _summ('recall', max_det=10),
            'AR@100': _summ('recall', max_det=100),
            'AR_s@100': _summ('recall', area='small'),
            'AR_m@100': _summ('recall', area='medium'),
            'AR_l@100': _summ('recall', area='large'),
        }
        if classwise:
            per_class = {}
            names = getattr(self.dataset, 'CLASSES',
                            [str(i) for i in range(K)])
            ai, mi = 0, MAX_DETS.index(100)
            for k in range(K):
                s = precision[:, :, k, ai, mi]
                s = s[s > -1]
                if s.size:
                    per_class[names[k]] = float(s.mean())
            metrics['classwise'] = per_class
        return metrics
