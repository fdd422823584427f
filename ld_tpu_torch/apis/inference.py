"""Single-image inference API (port of `ld_tpu/apis/inference.py:21-80`).

The test pipeline (keep-ratio resize to (1333, 800), normalize, pad/32) runs
on the host; forward, decode and NMS run on the model's device. Entry points
run on the card unless the caller passes `device='cpu'`; without a card they
raise instead of moving to the CPU.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ld_tpu_torch.data.transforms import Compose, collate_batch
from ld_tpu_torch.models import build_detector
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

    The port computes in float32. A config's top-level `dtype`
    (`configs/_base_/default_runtime.py` sets 'bfloat16', the JAX package's
    TPU compute dtype) is reported with a warning and not applied: bf16
    inference is not ported yet.
    """
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    if cfg.get('dtype') not in (None, 'float32'):
        warnings.warn(f"config dtype {cfg.get('dtype')!r} is not applied: "
                      'ld_tpu_torch computes in float32 (bf16 inference is '
                      'not ported yet)', stacklevel=2)
    model = build_detector(cfg.model)
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


def prepare_batch(img: np.ndarray, device,
                  pad_hw=((800, 1344), (1344, 800)),
                  img_scale: Optional[Tuple[int, int]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The test pipeline on the host, then image (1, 3, H, W), img_hw and
    scale_factor as tensors on `device`: the batch `forward_test` takes."""
    if not isinstance(img, np.ndarray):
        raise NotImplementedError('inference_detector takes a decoded BGR '
                                  'image array; image paths are not ported '
                                  'yet (decode a file with '
                                  'ld_tpu_torch.data.LoadImageFromFile)')
    steps = [dict(t) for t in _TEST_PIPELINE]
    if img_scale is not None:
        steps[0]['img_scale'] = tuple(img_scale)
    results = Compose(steps)(dict(img=img, img_shape=img.shape,
                                  ori_shape=img.shape))
    batch = collate_batch([results], pad_hw)
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ('image', 'img_hw', 'scale_factor')}


def inference_detector(model: torch.nn.Module, img: np.ndarray,
                       score_thr: float = 0.0,
                       pad_hw=((800, 1344), (1344, 800)),
                       img_scale: Optional[Tuple[int, int]] = None) -> Dict:
    """Detect objects in one BGR HWC image array.

    img_scale: keep-ratio resize target (max_long, max_short); defaults to
    the mmdet test scale (1333, 800). Must fit inside `pad_hw` after /32
    padding; pad_hw may be one (H, W) or a list of buckets (default: one per
    orientation — the smallest fitting bucket is used).

    Returns dict(boxes=(n, 5) xyxy+score in original image coords, labels),
    numpy arrays.
    """
    inputs = prepare_batch(img, next(model.parameters()).device, pad_hw,
                           img_scale)
    with torch.inference_mode():
        dets, labels, valid = model.forward_test(inputs, rescale=True)
    dets = dets[0].cpu().numpy()
    labels = labels[0].cpu().numpy()
    valid = valid[0].cpu().numpy() & (dets[:, 4] >= score_thr)
    return dict(boxes=dets[valid], labels=labels[valid])
