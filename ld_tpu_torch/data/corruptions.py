"""Image corruptions for the robustness benchmark (port of
`ld_tpu/data/corruptions.py`): eight of the common corruption families,
each at severities 1-5, in numpy and cv2 (imported at first use), drawing
their noise from the global `np.random` as the JAX package does. The
`Corrupt` transform applies one to a uint8 image (a float image is
clipped to uint8 first); `tools/analysis_tools/test_robustness.py` runs a
detector's evaluation under each.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ld_tpu_torch.utils.registry import PIPELINES
from .transforms import _cv2


def gaussian_noise(img, severity):
    c = [0.04, 0.08, 0.12, 0.18, 0.26][severity - 1]
    x = img.astype(np.float32) / 255.0
    x = x + np.random.normal(size=x.shape, scale=c)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def shot_noise(img, severity):
    c = [250, 100, 50, 30, 15][severity - 1]
    x = img.astype(np.float32) / 255.0
    x = np.random.poisson(x * c) / c
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def gaussian_blur(img, severity):
    c = [1, 2, 3, 4, 6][severity - 1]
    k = 2 * (2 * c) + 1
    return _cv2().GaussianBlur(img, (k, k), sigmaX=c)


def motion_blur(img, severity):
    cv2 = _cv2()
    c = [5, 9, 13, 17, 21][severity - 1]
    kernel = np.zeros((c, c), np.float32)
    kernel[c // 2, :] = 1.0 / c
    angle = np.random.uniform(-45, 45)
    m = cv2.getRotationMatrix2D((c / 2 - 0.5, c / 2 - 0.5), angle, 1.0)
    kernel = cv2.warpAffine(kernel, m, (c, c))
    kernel = kernel / max(kernel.sum(), 1e-6)
    return cv2.filter2D(img, -1, kernel)


def brightness(img, severity):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    x = img.astype(np.float32) / 255.0
    return (np.clip(x + c, 0, 1) * 255).astype(np.uint8)


def contrast(img, severity):
    c = [0.75, 0.5, 0.4, 0.3, 0.15][severity - 1]
    x = img.astype(np.float32)
    mean = x.mean(axis=(0, 1), keepdims=True)
    return np.clip((x - mean) * c + mean, 0, 255).astype(np.uint8)


def pixelate(img, severity):
    cv2 = _cv2()
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = img.shape[:2]
    small = cv2.resize(img, (max(1, int(w * c)), max(1, int(h * c))),
                       interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


def jpeg_compression(img, severity):
    cv2 = _cv2()
    c = [65, 40, 25, 15, 10][severity - 1]
    _, enc = cv2.imencode('.jpg', img, [int(cv2.IMWRITE_JPEG_QUALITY), c])
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)


CORRUPTIONS = {
    'gaussian_noise': gaussian_noise,
    'shot_noise': shot_noise,
    'gaussian_blur': gaussian_blur,
    'motion_blur': motion_blur,
    'brightness': brightness,
    'contrast': contrast,
    'pixelate': pixelate,
    'jpeg_compression': jpeg_compression,
}


@PIPELINES.register_module()
class Corrupt:
    """A named corruption of `CORRUPTIONS` at a severity in 1-5."""

    def __init__(self, corruption: str, severity: int = 1):
        if corruption not in CORRUPTIONS:
            raise ValueError(f'corruption {corruption!r}: one of '
                             f'{sorted(CORRUPTIONS)}')
        if not 1 <= severity <= 5:
            raise ValueError(f'severity {severity}: 1 to 5')
        self.corruption = corruption
        self.severity = severity

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        results['img'] = CORRUPTIONS[self.corruption](img, self.severity)
        return results
