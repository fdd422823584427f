"""Test-time augmentation: multi-scale and flip inference merged by one NMS
(port of `ld_tpu/apis/aug_test.py`).

Each (scale, flip) view is forwarded on its own, padded to its own /32
shape; its boxes before NMS are mapped back to the original image (divided
by the view's resize factor, then unflipped); the candidates of all views
are pooled, and one class-aware `multiclass_nms` over the pool, at up to
2048 candidates, gives the detections.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ld_tpu_torch.data.transforms import (FusedPreprocess, RandomFlip,
                                          collate_batch)
from ld_tpu_torch.models.detectors.two_stage import reject_mask_head
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep

MERGE_CANDIDATES = 2048


def build_aug_views(img: np.ndarray, img_scales: Sequence[Tuple[int, int]],
                    flip: bool, mean, std, to_rgb=True,
                    size_divisor: int = 32) -> List[Dict]:
    """The views of one BGR uint8 image: for each scale, the image and,
    with `flip`, its mirror, each resized, normalized and padded."""
    views = []
    for scale in img_scales:
        for do_flip in ([False, True] if flip else [False]):
            results = dict(img=img.copy(), img_shape=img.shape,
                           ori_shape=img.shape)
            if do_flip:
                results = RandomFlip(flip_ratio=1.0)(results)
            results = FusedPreprocess(img_scale=scale,
                                      size_divisor=size_divisor, mean=mean,
                                      std=std, to_rgb=to_rgb)(results)
            results['flip'] = do_flip
            views.append(results)
    return views


def aug_test(model: torch.nn.Module, views: List[Dict],
             ori_hw: Tuple[int, int], cfg=None, keep_fn=nms_keep) -> Dict:
    """Merged inference of the views of ONE image on the model's device.

    Args:
        views: outputs of `build_aug_views` (img, scale_factor, flip).
        ori_hw: the original image's (height, width), for the unflip.
        keep_fn: the keep-mask function of the merge NMS, `nms_keep` (the
            kernel on the card).
    Returns:
        dict(boxes (n, 5) in original-image coordinates, labels (n,)),
        numpy.
    """
    reject_mask_head(model, 'aug_test')
    if not hasattr(model, 'bbox_head'):
        raise NotImplementedError(
            'test-time augmentation of a two-stage detector is not ported '
            'to ld_tpu_torch yet (see ROADMAP.md Queue A, keys that '
            'still raise)')
    cfg = cfg or model.bbox_head.test_cfg
    device = next(model.parameters()).device
    all_boxes, all_scores = [], []
    with torch.inference_mode():
        for v in views:
            batch = collate_batch([v], v['img'].shape[:2], max_gts=1)
            image = torch.from_numpy(batch['image']).to(device)
            img_hw = torch.from_numpy(batch['img_hw']).to(device)
            boxes, scores = model.bbox_head.get_bboxes(
                model(image), img_hw, with_nms=False)
            boxes = boxes[0] / torch.from_numpy(v['scale_factor']).to(device)
            if v.get('flip'):
                w = float(ori_hw[1])
                boxes = torch.stack([w - boxes[:, 2], boxes[:, 1],
                                     w - boxes[:, 0], boxes[:, 3]], -1)
            all_boxes.append(boxes)
            all_scores.append(scores[0])
        dets, labels, valid = multiclass_nms(
            torch.cat(all_boxes)[None], torch.cat(all_scores)[None],
            cfg.get('score_thr', 0.05),
            cfg.get('nms', {}).get('iou_threshold', 0.6),
            max_per_img=cfg.get('max_per_img', 100),
            max_candidates=MERGE_CANDIDATES, keep_fn=keep_fn)
    m = valid[0].cpu().numpy()
    return dict(boxes=dets[0].cpu().numpy()[m],
                labels=labels[0].cpu().numpy()[m])
