"""Single-image inference API (port of `ld_tpu/apis/inference.py:21-147`).

The test pipeline (keep-ratio resize to (1333, 800), normalize, pad/32) runs
on the host; forward, decode and NMS run on the model's device. Entry points
run on the card unless the caller passes `device='cpu'`; without a card they
raise instead of moving to the CPU. An image is a BGR HWC uint8 array or a
path, decoded with cv2 (a missing file raises FileNotFoundError).
`show_result` / `imshow_gt_det_bboxes` draw detections (and gts) with cv2;
`async_inference_detector` runs one request in the event loop's executor.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ld_tpu_torch.data.transforms import Compose, _cv2, collate_batch
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.detectors.two_stage import reject_mask_head
from ld_tpu_torch.utils.checkpoint import load_checkpoint
from ld_tpu_torch.utils.config import Config


def resolve_device(device=None) -> torch.device:
    """`None` means the card; a missing card is an error, not the CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           'on the CPU')
    return device


def init_detector(config: Union[str, Config], checkpoint: Optional[str] = None,
                  device=None, seed: int = 0) -> torch.nn.Module:
    """Build a detector from a config, with weights drawn from `seed` (the
    JAX package's initializers) or loaded from an mmdet `.pth` checkpoint,
    in eval mode on `device` (default: the card).

    The towers compute in the config's top-level `dtype`
    (`configs/_base_/default_runtime.py` sets 'bfloat16'; a path teacher
    stays float32), as the JAX package's `init_detector` builds them; the
    parameters and the predictions stay float32. `cfg.dtype = 'float32'`
    gives the float32 detector.
    """
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    if checkpoint is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        load_checkpoint(model, checkpoint)
    model.cfg = cfg
    return model.to(device).eval()


_TEST_PIPELINE = [
    dict(type='Resize', img_scale=(1333, 800), keep_ratio=True),
    dict(type='Normalize', mean=[123.675, 116.28, 103.53],
         std=[58.395, 57.12, 57.375], to_rgb=True),
    dict(type='Pad', size_divisor=32),
]


def _load_img(img: Union[str, np.ndarray]) -> np.ndarray:
    """A BGR image: a path decoded with cv2, or a copy of an array."""
    if isinstance(img, str):
        loaded = _cv2().imread(img)
        if loaded is None:      # cv2.imread returns None instead of raising
            raise FileNotFoundError(img)
        return loaded
    return np.array(img)


def prepare_batch(img: Union[str, np.ndarray], device,
                  pad_hw=((800, 1344), (1344, 800)),
                  img_scale: Optional[Tuple[int, int]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The test pipeline on the host, then image (1, 3, H, W), img_hw and
    scale_factor as tensors on `device`: the batch `forward_test` takes."""
    if isinstance(img, str):
        img = _load_img(img)
    steps = [dict(t) for t in _TEST_PIPELINE]
    if img_scale is not None:
        steps[0]['img_scale'] = tuple(img_scale)
    results = Compose(steps)(dict(img=img, img_shape=img.shape,
                                  ori_shape=img.shape))
    batch = collate_batch([results], pad_hw)
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ('image', 'img_hw', 'scale_factor')}


def inference_detector(model: torch.nn.Module, img: Union[str, np.ndarray],
                       score_thr: float = 0.0,
                       pad_hw=((800, 1344), (1344, 800)),
                       img_scale: Optional[Tuple[int, int]] = None) -> Dict:
    """Detect objects in one image (a path or a BGR HWC array).

    img_scale: keep-ratio resize target (max_long, max_short); defaults to
    the mmdet test scale (1333, 800). Must fit inside `pad_hw` after /32
    padding; pad_hw may be one (H, W) or a list of buckets (default: one per
    orientation — the smallest fitting bucket is used).

    Returns dict(boxes=(n, 5) xyxy+score in original image coords, labels),
    numpy arrays. A detector with a mask head raises NotImplementedError,
    as the JAX function does (ROADMAP.md caveat 21).
    """
    reject_mask_head(model, 'inference_detector')
    inputs = prepare_batch(img, next(model.parameters()).device, pad_hw,
                           img_scale)
    with torch.inference_mode():
        dets, labels, valid = model.forward_test(inputs, rescale=True)
    dets = dets[0].cpu().numpy()
    labels = labels[0].cpu().numpy()
    valid = valid[0].cpu().numpy() & (dets[:, 4] >= score_thr)
    return dict(boxes=dets[valid], labels=labels[valid])


def _draw_boxes(img, boxes, labels, color, class_names=None, scores=None):
    cv2 = _cv2()
    for i, (box, label) in enumerate(zip(boxes, labels)):
        x1, y1, x2, y2 = np.asarray(box[:4]).astype(int)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        name = class_names[int(label)] if class_names else str(int(label))
        if scores is not None:
            name = f'{name}:{scores[i]:.2f}'
        cv2.putText(img, name, (x1, max(y1 - 4, 0)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return img


def show_result(img: Union[str, np.ndarray], result: Dict, class_names=None,
                score_thr: float = 0.3, out_file: Optional[str] = None
                ) -> np.ndarray:
    """Draw the detections of `result` scoring at least `score_thr` (green,
    with class name and score) on a copy of the image; written to
    `out_file` where given. Returns the drawn image."""
    img = _load_img(img)
    boxes = np.asarray(result['boxes']).reshape(-1, 5)
    keep = boxes[:, 4] >= score_thr
    _draw_boxes(img, boxes[keep], np.asarray(result['labels'])[keep],
                (0, 255, 0), class_names, scores=boxes[keep, 4])
    if out_file:
        _cv2().imwrite(out_file, img)
    return img


def imshow_gt_det_bboxes(img: Union[str, np.ndarray], annotation: Dict,
                         result: Dict, class_names=None,
                         score_thr: float = 0.3,
                         out_file: Optional[str] = None) -> np.ndarray:
    """The gt boxes of `annotation` (blue), then the detections as
    `show_result` draws them."""
    img = _load_img(img)
    _draw_boxes(img, annotation.get('bboxes', []),
                annotation.get('labels', []), (255, 144, 30), class_names)
    return show_result(img, result, class_names=class_names,
                       score_thr=score_thr, out_file=out_file)


async def async_inference_detector(model: torch.nn.Module, img, **kwargs):
    """`inference_detector` in the running loop's default executor, so that
    a server's coroutines can overlap the host side of several requests."""
    import asyncio
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        None, lambda: inference_detector(model, img, **kwargs))
