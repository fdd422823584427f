"""VOC-style mAP on the host (port of `ld_tpu/evaluation/mean_ap.py`):
per-class greedy tp/fp matching by IoU, then area or 11-point AP; and the
proposal recall matrix. Pure numpy, the same arithmetic as the JAX
package's copy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = 'area') -> float:
    """AP of one precision/recall curve: 'area' (the area under the
    monotone precision envelope) or '11points' (VOC2007's)."""
    recalls = recalls.reshape(1, -1)
    precisions = precisions.reshape(1, -1)
    if mode == 'area':
        zeros = np.zeros((1, 1))
        ones = np.ones((1, 1))
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        idx = np.where(mrec[0, 1:] != mrec[0, :-1])[0]
        return float(((mrec[0, idx + 1] - mrec[0, idx]) *
                      mpre[0, idx + 1]).sum())
    if mode == '11points':
        ap = 0.0
        for thr in np.arange(0, 1.1, 0.1):
            p = precisions[0, recalls[0] >= thr]
            ap += (p.max() if p.size else 0.0) / 11
        return float(ap)
    raise ValueError(mode)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / np.maximum(area_a + area_b - inter, 1e-10)


def tpfp_default(det: np.ndarray, gt: np.ndarray, gt_ignore: np.ndarray,
                 iou_thr: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy matching of one image's detections of one class.

    Real and ignored (difficult) gts are stacked into one pool, and each
    detection matches its single argmax-IoU gt from that pool: a detection
    whose best overlap is an ignored gt is neither tp nor fp, even where a
    real gt also clears the threshold; one whose best overlap is a real gt
    already covered is a false positive (a double detection), whatever it
    overlaps among the ignored gts."""
    nd = len(det)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    num_real = len(gt)
    all_gt = np.vstack([np.asarray(gt, np.float64).reshape(-1, 4),
                        np.asarray(gt_ignore, np.float64).reshape(-1, 4)])
    if len(all_gt) == 0:
        fp[:] = 1
        return tp, fp
    ious = _iou(det[:, :4], all_gt)
    ious_max = ious.max(axis=1) if nd else np.zeros(0)
    ious_argmax = ious.argmax(axis=1) if nd else np.zeros(0, np.int64)
    order = np.argsort(-det[:, 4], kind='mergesort')
    covered = np.zeros(len(all_gt), bool)
    for d in order:
        if ious_max[d] >= iou_thr:
            g = ious_argmax[d]
            if g < num_real:        # the best match is a real gt
                if not covered[g]:
                    covered[g] = True
                    tp[d] = 1
                else:
                    fp[d] = 1       # a double detection
            # the best match is an ignored gt: neither tp nor fp
        else:
            fp[d] = 1
    return tp, fp


def eval_map(det_results: List[List[np.ndarray]],
             annotations: List[Dict],
             iou_thr: float = 0.5,
             mode: str = 'area',
             num_classes: Optional[int] = None) -> Tuple[float, List[Dict]]:
    """VOC mAP.

    Args:
        det_results: per image, per class (n, 5) arrays xyxy + score.
        annotations: per image dicts with bboxes / labels and, where there
            are ignored gts, bboxes_ignore / labels_ignore.
    Returns:
        (mAP over the classes that have gts, per-class dicts of num_gts,
        num_dets, recall and ap).
    """
    num_classes = num_classes or len(det_results[0])
    eval_results = []
    for c in range(num_classes):
        tp_all, fp_all, scores_all = [], [], []
        num_gts = 0
        for dets, ann in zip(det_results, annotations):
            det = np.asarray(dets[c], np.float64).reshape(-1, 5)
            mask = ann['labels'] == c
            gt = ann['bboxes'][mask].astype(np.float64)
            # ignored gts are per class, through labels_ignore; without
            # labels_ignore a class has none
            if ann.get('labels_ignore') is not None:
                ig = np.asarray(ann['bboxes_ignore'], np.float64).reshape(
                    -1, 4)[np.asarray(ann['labels_ignore']) == c]
            else:
                ig = np.zeros((0, 4))
            tp, fp = tpfp_default(det, gt, ig, iou_thr)
            tp_all.append(tp)
            fp_all.append(fp)
            scores_all.append(det[:, 4])
            num_gts += len(gt)
        scores = np.concatenate(scores_all)
        order = np.argsort(-scores, kind='mergesort')
        tp = np.concatenate(tp_all)[order].cumsum()
        fp = np.concatenate(fp_all)[order].cumsum()
        recalls = tp / max(num_gts, 1)
        precisions = tp / np.maximum(tp + fp, 1e-10)
        ap = average_precision(recalls, precisions, mode) if num_gts else 0.0
        eval_results.append(dict(num_gts=num_gts, num_dets=len(scores),
                                 recall=recalls[-1] if len(recalls) else 0.0,
                                 ap=ap))
    valid = [r for r in eval_results if r['num_gts'] > 0]
    mean_ap = float(np.mean([r['ap'] for r in valid])) if valid else 0.0
    return mean_ap, eval_results


def eval_recalls(gts: List[np.ndarray], proposals: List[np.ndarray],
                 proposal_nums=(100, 300, 1000),
                 iou_thrs=(0.5, )) -> np.ndarray:
    """Proposal recall matrix (len(proposal_nums), len(iou_thrs)): the share
    of gts whose best IoU with an image's first `num` proposals reaches the
    threshold."""
    iou_thrs = np.asarray(iou_thrs)
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gts = sum(len(g) for g in gts)
    for pi, num in enumerate(proposal_nums):
        for ti, thr in enumerate(iou_thrs):
            hit = 0
            for gt, prop in zip(gts, proposals):
                if len(gt) == 0:
                    continue
                p = prop[:num]
                if len(p) == 0:
                    continue
                ious = _iou(gt, p[:, :4])
                hit += int((ious.max(axis=1) >= thr).sum())
            recalls[pi, ti] = hit / max(total_gts, 1)
    return recalls
