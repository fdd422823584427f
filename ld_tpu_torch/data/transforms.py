"""Host-side test pipeline: dict-in/dict-out transforms (port of the inference
subset of `ld_tpu/data/transforms.py:114-292,606-694`).

  * Resize keep_ratio: factor = min(long/max(h,w), short/min(h,w)),
    new = int(dim * factor + 0.5), bilinear. The JAX package resizes with
    cv2 INTER_LINEAR; here `F.interpolate(mode='bilinear',
    align_corners=False, antialias=False)` samples the same points, and a
    uint8 image is rounded back to uint8. cv2 rounds its fixed-point weights
    on uint8, so the two differ by at most one grey level.
  * Normalize: BGR->RGB, then the two roundings of the JAX package's
    cv2 calls: f32(f64(img) - mean), then f32(f64(.) * (1/std)).
  * Pad: zero-pad bottom/right to size_divisor.
  * collate_batch: stack into one static-shape NCHW batch, padded to the
    smallest fitting pad bucket.
Options no test pipeline of the port uses (keep_ratio=False, a fixed pad
size, ground truth) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ld_tpu_torch.utils.registry import PIPELINES


def rescale_size(h: int, w: int, scale: Tuple[int, int]) -> float:
    long_side, short_side = max(scale), min(scale)
    return min(long_side / max(h, w), short_side / min(h, w))


def resize_bilinear(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize of an HWC image (cv2.resize INTER_LINEAR sampling)."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    x = x.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(new_h, new_w), mode='bilinear',
                        align_corners=False, antialias=False)
    out = out[0].permute(1, 2, 0).numpy()
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype, copy=False)


@PIPELINES.register_module()
class Resize:
    def __init__(self, img_scale=(1333, 800), keep_ratio=True):
        if not keep_ratio:
            raise NotImplementedError('Resize keep_ratio=False is not ported '
                                      'to ld_tpu_torch yet (see ROADMAP.md)')
        self.img_scale = tuple(img_scale)

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        factor = rescale_size(h, w, self.img_scale)
        new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
        out = resize_bilinear(img, new_w, new_h)
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = out
        results['img_shape'] = out.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results: Dict) -> Dict:
        img = np.asarray(results['img'], np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        mean = np.float64(self.mean.reshape(1, -1))
        stdinv = 1.0 / np.float64(self.std.reshape(1, -1))
        img = (img.astype(np.float64) - mean).astype(np.float32)
        img = (img.astype(np.float64) * stdinv).astype(np.float32)
        results['img'] = np.ascontiguousarray(img)
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    def __init__(self, size_divisor=32, pad_val=0):
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        d = self.size_divisor
        th, tw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
        out = np.full((th, tw) + img.shape[2:], self.pad_val, img.dtype)
        out[:h, :w] = img
        results['img'] = out
        results['pad_shape'] = out.shape
        return results


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [PIPELINES.build(dict(t)) if isinstance(t, dict)
                           else t for t in transforms]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
        return results


def select_pad_bucket(pad_hw, batch_max_hw: Tuple[int, int]):
    """Pick the smallest pad bucket that fits the batch. `pad_hw` is one
    (H, W) shape or a list of them (one per orientation by default)."""
    if isinstance(pad_hw[0], (tuple, list)):
        h, w = batch_max_hw
        fits = [(bh * bw, (bh, bw)) for bh, bw in pad_hw
                if bh >= h and bw >= w]
        if not fits:
            raise ValueError(
                f'no pad bucket in {list(pad_hw)} fits batch max {h}x{w}')
        return min(fits)[1]
    return tuple(pad_hw)


def collate_batch(samples: List[Dict], pad_hw) -> Dict[str, np.ndarray]:
    """Stack per-image dicts into one static-shape batch.

    Images are zero-padded to `pad_hw` (one shape, or a list of buckets —
    the smallest fitting one is used) and laid out NCHW. `img_hw` carries the
    true (resized, un-padded) image shape used for box clipping. (Ground
    truth, which the JAX collate also pads, comes with the training slice.)
    """
    b = len(samples)
    th, tw = select_pad_bucket(
        pad_hw, (max(s['img'].shape[0] for s in samples),
                 max(s['img'].shape[1] for s in samples)))
    images = np.zeros((b, 3, th, tw), np.float32)
    img_hw = np.zeros((b, 2), np.float32)
    scale_factor = np.ones((b, 4), np.float32)
    for i, s in enumerate(samples):
        img = s['img']
        h, w = img.shape[:2]
        if h > th or w > tw:
            raise ValueError(f'image {img.shape} does not fit {(th, tw)}')
        images[i, :, :h, :w] = img.transpose(2, 0, 1)
        img_hw[i] = s['img_shape'][:2]
        scale_factor[i] = s.get('scale_factor', np.ones(4, np.float32))
    return dict(image=images, img_hw=img_hw, scale_factor=scale_factor)
