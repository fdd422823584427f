"""AutoAugment's geometric and colour transforms for detection (port of
`ld_tpu/data/auto_augment.py`), on the host with cv2, imported at first
use.

  * Shear, Rotate, Translate: with probability `prob` (skipped where
    rand() > prob), a 2x3 affine of magnitude `level` / 10 of the largest,
    its sign drawn by `np.random.choice([-1, 1])`, applied by
    `cv2.warpAffine` (bilinear, the border filled with `fill_val`); each
    box's four corners go through the same affine, the box is their
    axis-aligned hull, clipped to the image, and the boxes left with no
    area are dropped with their labels.
  * ColorTransform: 'color' (blend with cv2's grey), 'brightness',
    'contrast' (blend with the image mean) by a factor 1 +/- 0.9 level/10,
    or 'equalize' (`cv2.equalizeHist` a channel), on uint8.
  * AutoAugment: one of `policies` (each a list of transform configs),
    drawn by `np.random.randint`.
Each draws from the global `np.random` in the JAX package's order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ld_tpu_torch.utils.registry import PIPELINES
from .transforms import Compose, _cv2


def _warp_boxes(boxes: np.ndarray, m: np.ndarray, w: int, h: int):
    """xyxy boxes through a 2x3 affine: the hull of their corners, clipped
    to (w, h)."""
    if len(boxes) == 0:
        return boxes
    corners = np.stack([boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [0, 3]],
                        boxes[:, [2, 3]]], axis=1)            # (N, 4, 2)
    ones = np.ones((*corners.shape[:2], 1))
    pts = np.concatenate([corners, ones], -1) @ m.T           # (N, 4, 2)
    out = np.concatenate([pts.min(1), pts.max(1)], -1)
    out[:, 0::2] = out[:, 0::2].clip(0, w)
    out[:, 1::2] = out[:, 1::2].clip(0, h)
    return out.astype(np.float32)


class _GeometricTransform:

    def __init__(self, level=5, prob=0.5, max_mag=None, fill_val=128):
        self.level = level
        self.prob = prob
        self.fill_val = fill_val
        self.max_mag = max_mag

    def _matrix(self, results):
        raise NotImplementedError

    def __call__(self, results: Dict) -> Dict:
        if np.random.rand() > self.prob:
            return results
        img = results['img']
        h, w = img.shape[:2]
        m = self._matrix(results)
        results['img'] = _cv2().warpAffine(
            img, m, (w, h), borderValue=(self.fill_val, ) * 3)
        if 'gt_bboxes' in results:
            boxes = _warp_boxes(results['gt_bboxes'], m, w, h)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            results['gt_bboxes'] = boxes[keep]
            if 'gt_labels' in results:
                results['gt_labels'] = results['gt_labels'][keep]
        return results


@PIPELINES.register_module()
class Shear(_GeometricTransform):

    def __init__(self, level=5, prob=0.5, direction='horizontal', **kw):
        super().__init__(level, prob, **kw)
        self.direction = direction

    def _matrix(self, results):
        mag = self.level / 10 * 0.3 * np.random.choice([-1, 1])
        if self.direction == 'horizontal':
            return np.asarray([[1, mag, 0], [0, 1, 0]], np.float32)
        return np.asarray([[1, 0, 0], [mag, 1, 0]], np.float32)


@PIPELINES.register_module()
class Rotate(_GeometricTransform):

    def __init__(self, level=5, prob=0.5, max_rotate_angle=30, **kw):
        super().__init__(level, prob, **kw)
        self.max_angle = max_rotate_angle

    def _matrix(self, results):
        h, w = results['img'].shape[:2]
        angle = self.level / 10 * self.max_angle * np.random.choice([-1, 1])
        return _cv2().getRotationMatrix2D((w / 2, h / 2), angle, 1.0)


@PIPELINES.register_module()
class Translate(_GeometricTransform):

    def __init__(self, level=5, prob=0.5, direction='horizontal',
                 max_translate_offset=250., **kw):
        super().__init__(level, prob, **kw)
        self.direction = direction
        self.max_offset = max_translate_offset

    def _matrix(self, results):
        off = int(self.level / 10 * self.max_offset) * \
            np.random.choice([-1, 1])
        if self.direction == 'horizontal':
            return np.asarray([[1, 0, off], [0, 1, 0]], np.float32)
        return np.asarray([[1, 0, 0], [0, 1, off]], np.float32)


@PIPELINES.register_module()
class ColorTransform:
    """The colour, brightness, contrast and equalize family (the image
    only)."""

    KINDS = ('color', 'brightness', 'contrast', 'equalize')

    def __init__(self, kind='color', level=5, prob=0.5):
        if kind not in self.KINDS:
            raise ValueError(f'ColorTransform kind {kind!r}')
        self.kind = kind
        self.level = level
        self.prob = prob

    def __call__(self, results: Dict) -> Dict:
        if np.random.rand() > self.prob:
            return results
        cv2 = _cv2()
        img = results['img']
        u8 = img if img.dtype == np.uint8 else \
            np.clip(img, 0, 255).astype(np.uint8)
        f = 1.0 + self.level / 10 * np.random.choice([-1.0, 1.0]) * 0.9
        if self.kind == 'equalize':
            out = np.stack([cv2.equalizeHist(u8[..., c]) for c in range(3)],
                           -1)
        elif self.kind == 'color':
            gray = cv2.cvtColor(u8, cv2.COLOR_BGR2GRAY)[..., None]
            out = np.clip(gray + f * (u8.astype(np.float32) - gray), 0,
                          255).astype(np.uint8)
        elif self.kind == 'brightness':
            out = np.clip(u8.astype(np.float32) * f, 0, 255).astype(np.uint8)
        else:
            mean = u8.mean()
            out = np.clip(mean + f * (u8.astype(np.float32) - mean), 0,
                          255).astype(np.uint8)
        results['img'] = out if img.dtype == np.uint8 else \
            out.astype(img.dtype)
        return results


@PIPELINES.register_module()
class AutoAugment:
    """One randomly chosen policy (a list of transform configs) a sample."""

    def __init__(self, policies):
        self.policies = [Compose(p) for p in policies]

    def __call__(self, results: Dict) -> Dict:
        return self.policies[np.random.randint(len(self.policies))](results)
