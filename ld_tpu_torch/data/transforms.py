"""Host-side pipeline: dict-in/dict-out transforms (port of
`ld_tpu/data/transforms.py`).

  * LoadImageFromFile / LoadAnnotations: decode an image file (cv2, imported
    at first use) and take the boxes and labels of its annotation; with
    `with_mask`, each gt's polygons as a full-size uint8 bitmap, drawn by
    `cv2.fillPoly` on the points truncated to int32 (a gt without a
    polygon falls back to its box), as the JAX package does (ROADMAP.md
    caveat 23: the segm evaluator rasterises gts otherwise).
  * Resize: keep-ratio factor = min(long/max(h,w), short/min(h,w)),
    new = int(dim * factor + 0.5), bilinear; the `range` / `value` multiscale
    modes, `ratio_range`, a `scale` in the results, `override` and
    `keep_ratio=False`, as the JAX package has them; gt boxes scaled and
    clipped, gt masks resized nearest (`resize_nearest`: cv2 INTER_NEAREST's
    sampling, bit for bit). The JAX package resizes with cv2 INTER_LINEAR; here
    `F.interpolate(mode='bilinear', align_corners=False, antialias=False)`
    samples the same points, and a uint8 image is rounded back to uint8.
    cv2 rounds its fixed-point weights on uint8, so the two differ by at most
    one grey level.
  * RandomFlip: draws from the global `np.random` as the JAX package does;
    flips the gt masks with the image.
  * Normalize: BGR->RGB, then the two roundings of the JAX package's cv2
    calls: f32(f64(img) - mean), then f32(f64(.) * (1/std)).
  * Pad: zero-pad bottom/right to a fixed size or to size_divisor.
  * FusedPreprocess: Resize + BGR->RGB + Normalize + Pad in one native pass
    (`csrc/host/image_prep.cpp`, the JAX package's C++), which normalizes
    the bilinear float sample without rounding it to uint8 first.
  * DefaultFormatBundle (float32 image, typed boxes and labels) and the
    layout steps ImageToTensor / ToTensor / ToDataContainer /
    WrapFieldsToLists, no-ops since `collate_batch` makes the NCHW batch;
    Transpose; FilterAnnotations (drops small gts and their masks, and the
    sample when none is left).
  * MultiScaleFlipAug: the test-time (scale, flip) views of one image.
  * The train-time augmentations (`:295-331`, `:351-530`, `:697-867`,
    `:938-1044`): PhotoMetricDistortion (the HSV round trip through uint8
    with cv2.cvtColor), RandomCrop, Expand, MinIoURandomCrop, CutOut,
    SegRescale, LoadProposals and RandomCenterCropPad, each drawing from the
    global `np.random` in the JAX package's order and only in the branch
    it takes, so that one seed gives the same images, boxes, labels and
    masks bit for bit. RandomCenterCropPad's test mode pastes the image
    top-left with a zero `border`, as the JAX package does on purpose
    (ROADMAP.md caveat 43). Albu and InstaBoost bridge the optional
    albumentations / instaboostfast packages and raise ImportError without
    them.
  * collate_batch: stack into one static-shape NCHW batch, padded to the
    smallest fitting pad bucket, with `max_gts` gt slots and a validity
    mask, optionally into caller-owned (pinned) buffers; gt masks, where
    the samples carry them, as `gt_masks` (B, G, H/4, W/4) uint8: each
    placed in the padded frame and taken nearest at `MASK_STRIDE`, the
    JAX package's bits (it carries them as float32).
"""
from __future__ import annotations

import copy
import os
import threading
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ld_tpu_torch.utils.registry import PIPELINES


def _cv2():
    """cv2, imported at first use: only image files (decoding, drawing) and
    the cv2 colour and warp transforms need it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError('reading or writing image files, and the colour '
                          'and warp transforms, need cv2 (opencv-python), '
                          'and cv2 is not installed') from e
    return cv2


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


def _nearest_index(new: int, old: int) -> np.ndarray:
    """cv2.resize INTER_NEAREST's source index of each of `new` outputs
    along an axis of `old`: min(floor(i * (1 / (new / old))), old - 1)."""
    return np.minimum(np.floor(np.arange(new) * (1.0 / (new / old)))
                      .astype(np.int64), old - 1)


def resize_nearest(m: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Nearest resize of an (H, W) mask, cv2 INTER_NEAREST's bits."""
    h, w = m.shape[:2]
    return m[_nearest_index(new_h, h)[:, None],
             _nearest_index(new_w, w)[None, :]]


def _resize_masks(results: Dict, new_w: int, new_h: int) -> None:
    if 'gt_masks' in results:
        results['gt_masks'] = [resize_nearest(m, new_w, new_h)
                               for m in results['gt_masks']]


@PIPELINES.register_module()
class LoadImageFromFile:
    """Decode `img_prefix/img_info['filename']` with cv2 (BGR, HWC), with
    mmcv's `color_type` flags."""
    _FLAGS = {
        'color': ('IMREAD_COLOR', ),
        'grayscale': ('IMREAD_GRAYSCALE', ),
        'unchanged': ('IMREAD_UNCHANGED', ),
        'color_ignore_orientation': ('IMREAD_COLOR',
                                     'IMREAD_IGNORE_ORIENTATION'),
        'grayscale_ignore_orientation': ('IMREAD_GRAYSCALE',
                                         'IMREAD_IGNORE_ORIENTATION'),
    }

    def __init__(self, to_float32=False, color_type='color'):
        if color_type not in self._FLAGS:
            raise ValueError(f'color_type {color_type!r}')
        self.to_float32 = to_float32
        self.color_type = color_type

    def __call__(self, results: Dict) -> Dict:
        cv2 = _cv2()
        flag = 0
        for name in self._FLAGS[self.color_type]:
            flag |= getattr(cv2, name)
        path = results['img_info']['filename']
        if results.get('img_prefix'):
            path = os.path.join(results['img_prefix'], path)
        img = cv2.imread(path, flag)
        if img is None:
            raise FileNotFoundError(path)
        if self.to_float32:
            img = img.astype(np.float32)
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    def __init__(self, with_bbox=True, with_label=True, with_mask=False,
                 **kwargs):
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask

    def __call__(self, results: Dict) -> Dict:
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = ann['bboxes'].astype(np.float32)
        if self.with_label:
            results['gt_labels'] = ann['labels'].astype(np.int64)
        if self.with_mask and 'masks' in ann:
            h = results['img_info'].get(
                'height', results.get('img_shape', (0, 0))[0])
            w = results['img_info'].get(
                'width', results.get('img_shape', (0, 0))[1])
            results['gt_masks'] = [_polygon_bitmap(polys, box, h, w)
                                   for polys, box in zip(ann['masks'],
                                                         ann['bboxes'])]
        return results


def _polygon_bitmap(polys, box, h: int, w: int) -> np.ndarray:
    """A gt's polygons filled by cv2.fillPoly on their int32-truncated
    points, or its box region where it has none."""
    m = np.zeros((h, w), np.uint8)
    if polys:
        pts = [np.asarray(p, np.float32).reshape(-1, 2).astype(np.int32)
               for p in polys if len(p) >= 6]
        if pts:
            _cv2().fillPoly(m, pts, 1)
    else:
        x1, y1, x2, y2 = box.astype(int)
        m[y1:y2, x1:x2] = 1
    return m


@PIPELINES.register_module()
class Resize:
    def __init__(self, img_scale=(1333, 800), keep_ratio=True,
                 ratio_range=None, multiscale_mode='range',
                 override=False, bbox_clip_border=True):
        if multiscale_mode not in ('range', 'value'):
            raise ValueError(f'multiscale_mode {multiscale_mode!r}')
        self.img_scale = img_scale if isinstance(img_scale, list) \
            else tuple(img_scale)
        self.keep_ratio = keep_ratio
        self.ratio_range = ratio_range
        self.multiscale_mode = multiscale_mode
        # a later Resize resamples its own scale instead of reusing a
        # `scale` in the results (mmdet's crop -> re-resize augmentation)
        self.override = override
        self.bbox_clip_border = bbox_clip_border
        self._tls = threading.local()

    def set_scale_override(self, scale) -> None:
        """Arm a thread-local one-image scale override (the DataLoader's
        per-image or per-batch multi-scale draw): concurrent fetch workers
        never see each other's scales, and the transform's own config is
        left as it is."""
        self._tls.scale = tuple(scale) if scale is not None else None

    def _sample_scale(self) -> Tuple[int, int]:
        """mmdet's Resize._random_scale: ratio_range -> one base scale times
        a uniform ratio; a list in 'range' mode -> long and short edges each
        drawn by randint over the bounds of the scales; a list in 'value'
        mode -> a uniform pick. A thread-local override wins."""
        override = getattr(self._tls, 'scale', None)
        if override is not None:
            return override
        scale = self.img_scale
        if self.ratio_range is not None:
            if isinstance(scale, list):
                if len(scale) != 1:
                    raise ValueError('ratio_range takes one base scale')
                scale = scale[0]
            lo, hi = self.ratio_range
            r = np.random.random_sample() * (hi - lo) + lo
            return (int(scale[0] * r), int(scale[1] * r))
        if isinstance(scale, list):
            if self.multiscale_mode == 'range':
                if len(scale) != 2:
                    raise ValueError('range mode needs exactly two bounding '
                                     'scales')
                longs = [max(s) for s in scale]
                shorts = [min(s) for s in scale]
                return (int(np.random.randint(min(longs), max(longs) + 1)),
                        int(np.random.randint(min(shorts), max(shorts) + 1)))
            return tuple(scale[np.random.randint(len(scale))])
        return tuple(scale)

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        # an explicit 'scale' in the results wins, unless `override`
        scale = (self._sample_scale() if self.override
                 else results.get('scale') or self._sample_scale())
        if self.keep_ratio:
            factor = rescale_size(h, w, scale)
            new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
        else:
            new_w, new_h = scale[0], scale[1]
        out = resize_bilinear(img, new_w, new_h)
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = out
        results['img_shape'] = out.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        if 'gt_bboxes' in results:
            results['gt_bboxes'] = _scale_boxes(
                results['gt_bboxes'], results['scale_factor'], new_w, new_h,
                self.bbox_clip_border)
        _resize_masks(results, new_w, new_h)
        return results


def _scale_boxes(boxes, scale_factor, new_w, new_h, clip=True):
    bb = boxes * scale_factor
    if clip:
        bb[:, 0::2] = bb[:, 0::2].clip(0, new_w)
        bb[:, 1::2] = bb[:, 1::2].clip(0, new_h)
    return bb


@PIPELINES.register_module()
class RandomFlip:
    def __init__(self, flip_ratio=0.5, direction='horizontal'):
        self.flip_ratio = flip_ratio or 0.0
        self.direction = direction

    def __call__(self, results: Dict) -> Dict:
        flip = np.random.rand() < self.flip_ratio
        results['flip'] = flip
        results['flip_direction'] = self.direction
        if not flip:
            return results
        horiz = self.direction == 'horizontal'
        sl = (slice(None), slice(None, None, -1)) if horiz \
            else (slice(None, None, -1), )
        results['img'] = np.ascontiguousarray(results['img'][sl])
        if 'gt_bboxes' in results:
            src = results['gt_bboxes']
            bb = src.copy()
            if horiz:
                w = results['img_shape'][1]
                bb[:, 0] = w - src[:, 2]
                bb[:, 2] = w - src[:, 0]
            else:
                h = results['img_shape'][0]
                bb[:, 1] = h - src[:, 3]
                bb[:, 3] = h - src[:, 1]
            results['gt_bboxes'] = bb
        if 'gt_masks' in results:
            results['gt_masks'] = [np.ascontiguousarray(m[sl])
                                   for m in results['gt_masks']]
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
    def __init__(self, size=None, size_divisor=32, pad_val=0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
        out = np.full((th, tw) + img.shape[2:], self.pad_val, img.dtype)
        out[:h, :w] = img
        results['img'] = out
        results['pad_shape'] = out.shape
        return results


@PIPELINES.register_module()
class Collect:
    def __init__(self, keys=('img', 'gt_bboxes', 'gt_labels'), meta_keys=()):
        self.keys = keys

    def __call__(self, results: Dict) -> Dict:
        out = {k: results[k] for k in self.keys if k in results}
        out['img_shape'] = results.get('img_shape')
        out['ori_shape'] = results.get('ori_shape')
        out['pad_shape'] = results.get('pad_shape', results.get('img_shape'))
        out['scale_factor'] = results.get(
            'scale_factor', np.ones(4, np.float32))
        out['img_id'] = results.get('img_info', {}).get('id', -1)
        return out


@PIPELINES.register_module()
class DefaultFormatBundle:
    """mmdet's to-tensor bundle. The port's pipeline stays HWC numpy up to
    `collate_batch`, which makes the NCHW tensor; here the image becomes
    contiguous float32 and the boxes and labels float32 and int64."""

    def __call__(self, results: Dict) -> Dict:
        if 'img' in results:
            results['img'] = np.ascontiguousarray(
                results['img'].astype(np.float32))
        for k in ('gt_bboxes', 'gt_bboxes_ignore'):
            if k in results:
                results[k] = np.asarray(results[k], np.float32)
        if 'gt_labels' in results:
            results['gt_labels'] = np.asarray(results['gt_labels'], np.int64)
        return results


@PIPELINES.register_module()
class ImageToTensor:
    """mmdet's HWC -> CHW tensor step, a no-op here: `collate_batch` makes
    the NCHW batch. Accepted so that configs build."""

    def __init__(self, keys=('img', )):
        self.keys = keys

    def __call__(self, results: Dict) -> Dict:
        return results


@PIPELINES.register_module()
class ToTensor(ImageToTensor):
    pass


@PIPELINES.register_module()
class ToDataContainer(ImageToTensor):
    pass


@PIPELINES.register_module()
class WrapFieldsToLists(ImageToTensor):
    pass


@PIPELINES.register_module()
class Transpose:
    """Permute the axes of each of `keys` by `order`."""

    def __init__(self, keys, order):
        self.keys = keys
        self.order = order

    def __call__(self, results: Dict) -> Dict:
        for k in self.keys:
            results[k] = results[k].transpose(self.order)
        return results


@PIPELINES.register_module()
class FilterAnnotations:
    """Drop gt boxes whose width or height is not above `min_gt_bbox_wh`;
    the whole sample is dropped (None) when none is left."""

    def __init__(self, min_gt_bbox_wh):
        self.min_gt_bbox_wh = min_gt_bbox_wh

    def __call__(self, results: Dict):
        bb = results['gt_bboxes']
        keep = ((bb[:, 2] - bb[:, 0]) > self.min_gt_bbox_wh[0]) & \
               ((bb[:, 3] - bb[:, 1]) > self.min_gt_bbox_wh[1])
        if not keep.any():
            return None
        for key in ('gt_bboxes', 'gt_labels'):
            if key in results:
                results[key] = results[key][keep]
        if 'gt_masks' in results:
            results['gt_masks'] = [m for m, k in
                                   zip(results['gt_masks'], keep) if k]
        return results


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """mmdet's test-time augmentation wrapper. Each (scale, flip) view runs
    the wrapped transforms on its own copy of the input, the scale handed to
    Resize as `results['scale']` and the flip done first. One view (the
    standard test pipeline) is returned as it is; with several, the first
    view carries the list of all of them under 'aug_views' (the batched
    eval path uses the first; `apis.aug_test` merges them all)."""

    def __init__(self, transforms, img_scale=None, flip=False,
                 flip_direction='horizontal', scale_factor=None):
        self.pipeline = Compose([dict(t) if isinstance(t, dict) else t
                                 for t in transforms])
        scales = img_scale if isinstance(img_scale, list) else [img_scale]
        self.img_scales = [tuple(s) if s else None for s in scales]
        self.flip = flip
        self.flip_direction = flip_direction
        self.scale_factor = scale_factor
        if len(self.img_scales) > 1 or flip:
            warnings.warn(
                'MultiScaleFlipAug with multiple views: the batched eval '
                'path uses only the first (unflipped) view; merged TTA runs '
                "through ld_tpu_torch.apis.aug_test, which reads the "
                "'aug_views' list this transform attaches.", stacklevel=2)

    def __call__(self, results: Dict) -> Dict:
        views = []
        for scale in self.img_scales:
            for do_flip in ([False, True] if self.flip else [False]):
                r = copy.deepcopy(results)
                if scale is not None:
                    r['scale'] = scale
                if do_flip:
                    r = RandomFlip(flip_ratio=1.0,
                                   direction=self.flip_direction)(r)
                r = self.pipeline(r)
                r['flip'] = do_flip
                views.append(r)
        out = views[0]
        if len(views) > 1:
            out['aug_views'] = views
        return out


# ---- train-time augmentations ------------------------------------------------
# Each draws from the global `np.random` in the JAX package's order, and only
# inside the branch it takes: one draw more or fewer would shift every later
# sample of a seeded run.

@PIPELINES.register_module()
class PhotoMetricDistortion:
    """Brightness, contrast, saturation and hue jitter on a float32 copy of
    the image: brightness (p 0.5), contrast before (mode 1) or after (mode
    0) the HSV step (p 0.5), then saturation and hue (p 0.5 each) through
    cv2's uint8 BGR <-> HSV conversion (hue wraps at 180)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results: Dict) -> Dict:
        cv2 = _cv2()
        img = results['img'].astype(np.float32)
        if np.random.randint(2):
            img += np.random.uniform(-self.brightness_delta,
                                     self.brightness_delta)
        mode = np.random.randint(2)
        if mode == 1 and np.random.randint(2):
            img *= np.random.uniform(*self.contrast_range)
        hsv = cv2.cvtColor(img.clip(0, 255).astype(np.uint8),
                           cv2.COLOR_BGR2HSV).astype(np.float32)
        if np.random.randint(2):
            hsv[..., 1] *= np.random.uniform(*self.saturation_range)
        if np.random.randint(2):
            hsv[..., 0] = (hsv[..., 0] +
                           np.random.uniform(-self.hue_delta,
                                             self.hue_delta)) % 180
        img = cv2.cvtColor(hsv.clip(0, 255).astype(np.uint8),
                           cv2.COLOR_HSV2BGR).astype(np.float32)
        if mode == 0 and np.random.randint(2):
            img *= np.random.uniform(*self.contrast_range)
        results['img'] = img
        return results


@PIPELINES.register_module()
class RandomCrop:
    """A random (h, w) crop: `crop_size` absolute, an absolute range, or a
    fraction (range) of the image; boxes shifted and clipped to it, and the
    gts left with no area dropped with their labels and masks. A crop that
    keeps no gt drops the sample (None) unless `allow_negative_crop`."""

    CROP_TYPES = ('absolute', 'absolute_range', 'relative', 'relative_range')

    def __init__(self, crop_size, crop_type='absolute',
                 allow_negative_crop=False):
        if crop_type not in self.CROP_TYPES:
            raise ValueError(f'crop_type {crop_type!r}')
        self.crop_size = crop_size  # (h, w)
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop

    def _sample_crop(self, h, w):
        a, b = self.crop_size
        if self.crop_type == 'absolute':
            return min(int(a), h), min(int(b), w)
        if self.crop_type == 'absolute_range':
            if a > b:
                raise ValueError(f'absolute_range crop {self.crop_size}')
            return (np.random.randint(min(h, a), min(h, b) + 1),
                    np.random.randint(min(w, a), min(w, b) + 1))
        if self.crop_type == 'relative':
            return int(h * a + 0.5), int(w * b + 0.5)
        ch = a + np.random.rand() * (1 - a)
        cw = b + np.random.rand() * (1 - b)
        return int(h * ch + 0.5), int(w * cw + 0.5)

    def __call__(self, results: Dict):
        img = results['img']
        h, w = img.shape[:2]
        ch, cw = self._sample_crop(h, w)
        y0 = np.random.randint(0, h - ch + 1)
        x0 = np.random.randint(0, w - cw + 1)
        results['img'] = img[y0:y0 + ch, x0:x0 + cw]
        results['img_shape'] = results['img'].shape
        keep = None
        if 'gt_bboxes' in results:
            bb = results['gt_bboxes'] - np.asarray([x0, y0, x0, y0],
                                                   np.float32)
            bb[:, 0::2] = bb[:, 0::2].clip(0, cw)
            bb[:, 1::2] = bb[:, 1::2].clip(0, ch)
            keep = (bb[:, 2] > bb[:, 0]) & (bb[:, 3] > bb[:, 1])
            if not keep.any() and not self.allow_negative_crop:
                return None
            results['gt_bboxes'] = bb[keep]
            if 'gt_labels' in results:
                results['gt_labels'] = results['gt_labels'][keep]
        if 'gt_masks' in results:
            masks = [m[y0:y0 + ch, x0:x0 + cw] for m in results['gt_masks']]
            if keep is not None:
                masks = [m for m, k in zip(masks, keep) if k]
            results['gt_masks'] = masks
        return results


@PIPELINES.register_module()
class Expand:
    """With probability `prob` (skipped where rand() > prob), the image on a
    `mean`-filled canvas `ratio` times its size at a random place, the
    boxes shifted with it (SSD). `to_rgb` is accepted and not read: the
    mean fills in the given order, as in the JAX package."""

    def __init__(self, mean=(0, 0, 0), to_rgb=True, ratio_range=(1, 4),
                 prob=0.5):
        self.mean = np.asarray(mean)
        self.ratio_range = ratio_range
        self.prob = prob

    def __call__(self, results: Dict) -> Dict:
        if np.random.rand() > self.prob:
            return results
        img = results['img']
        h, w, c = img.shape
        ratio = np.random.uniform(*self.ratio_range)
        nh, nw = int(h * ratio), int(w * ratio)
        fill = self.mean.astype(np.uint8) if img.dtype == np.uint8 \
            else self.mean
        canvas = np.full((nh, nw, c), fill, img.dtype)
        y0 = np.random.randint(0, nh - h + 1)
        x0 = np.random.randint(0, nw - w + 1)
        canvas[y0:y0 + h, x0:x0 + w] = img
        results['img'] = canvas
        results['img_shape'] = canvas.shape
        if 'gt_bboxes' in results:
            results['gt_bboxes'] = results['gt_bboxes'] + np.asarray(
                [x0, y0, x0, y0], np.float32)
        return results


@PIPELINES.register_module()
class MinIoURandomCrop:
    """SSD's crop: draw a mode from (1, *min_ious, 0); mode 1 keeps the
    image, any other tries up to `max_attempts` crops (sides at least
    `min_crop_size` of the image's, aspect in [0.5, 2]) whose overlap with
    every gt, over the gt's area, reaches the mode and that contain a gt
    centre, and draws a new mode when none does. The gts whose centres fall
    inside are kept, clipped and shifted."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3,
                 max_attempts=50):
        self.sample_modes = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size
        self.max_attempts = max_attempts

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        boxes = results.get('gt_bboxes', np.zeros((0, 4), np.float32))
        while True:
            mode = self.sample_modes[np.random.randint(
                len(self.sample_modes))]
            if mode == 1:
                return results
            for _ in range(self.max_attempts):
                cw = np.random.uniform(self.min_crop_size * w, w)
                ch = np.random.uniform(self.min_crop_size * h, h)
                if ch / cw < 0.5 or ch / cw > 2:
                    continue
                x0 = np.random.uniform(0, w - cw)
                y0 = np.random.uniform(0, h - ch)
                patch = np.asarray([x0, y0, x0 + cw, y0 + ch])
                if len(boxes):
                    lt = np.maximum(boxes[:, :2], patch[:2])
                    rb = np.minimum(boxes[:, 2:], patch[2:])
                    inter = np.clip(rb - lt, 0, None).prod(1)
                    area = (boxes[:, 2] - boxes[:, 0]) * \
                        (boxes[:, 3] - boxes[:, 1])
                    if (inter / np.maximum(area, 1e-6)).min() < mode:
                        continue
                    cx = (boxes[:, 0] + boxes[:, 2]) / 2
                    cy = (boxes[:, 1] + boxes[:, 3]) / 2
                    keep = (cx > patch[0]) & (cx < patch[2]) & \
                        (cy > patch[1]) & (cy < patch[3])
                    if not keep.any():
                        continue
                    bb = boxes[keep].copy()
                    bb[:, 0::2] = bb[:, 0::2].clip(patch[0], patch[2])
                    bb[:, 1::2] = bb[:, 1::2].clip(patch[1], patch[3])
                    bb -= np.asarray([patch[0], patch[1], patch[0],
                                      patch[1]], np.float32)
                    results['gt_bboxes'] = bb.astype(np.float32)
                    if 'gt_labels' in results:
                        results['gt_labels'] = results['gt_labels'][keep]
                results['img'] = img[int(patch[1]):int(patch[3]),
                                     int(patch[0]):int(patch[2])]
                results['img_shape'] = results['img'].shape
                return results


@PIPELINES.register_module()
class CutOut:
    """Fill `n_holes` (a count or a (min, max) range) rectangles of
    `cutout_shape` (h, w), or of `cutout_ratio` of the image, at random
    top-left corners with `fill_in`, in place."""

    def __init__(self, n_holes, cutout_shape=None, cutout_ratio=None,
                 fill_in=(0, 0, 0)):
        self.n_holes = n_holes if isinstance(n_holes, tuple) else \
            (n_holes, n_holes)
        self.cutout_shape = cutout_shape
        self.cutout_ratio = cutout_ratio
        self.fill_in = fill_in

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        n = np.random.randint(self.n_holes[0], self.n_holes[1] + 1)
        for _ in range(n):
            if self.cutout_ratio is not None:
                ch = int(h * self.cutout_ratio[0])
                cw = int(w * self.cutout_ratio[1])
            else:
                ch, cw = self.cutout_shape
            y0 = np.random.randint(0, h)
            x0 = np.random.randint(0, w)
            img[y0:y0 + ch, x0:x0 + cw] = self.fill_in
        results['img'] = img
        return results


@PIPELINES.register_module()
class SegRescale:
    """Resize `gt_semantic_seg` nearest by `scale_factor` (HTC's 1/8
    semantic map), cv2 INTER_NEAREST's bits; no data layer of either
    package gives the map yet."""

    def __init__(self, scale_factor=1, **kwargs):
        self.scale_factor = scale_factor

    def __call__(self, results: Dict) -> Dict:
        if self.scale_factor != 1 and 'gt_semantic_seg' in results:
            seg = results['gt_semantic_seg']
            h, w = seg.shape[:2]
            results['gt_semantic_seg'] = resize_nearest(
                seg, int(w * self.scale_factor), int(h * self.scale_factor))
        return results


@PIPELINES.register_module()
class LoadProposals:
    """Precomputed proposals (n, 4 or 5) from `results['proposals']`, cut
    to (n, 4) and to `num_max_proposals`; none becomes one zero box.
    Neither package's datasets put proposals into the results (their
    CocoDataset takes no `proposal_file`): ROADMAP.md caveat 41."""

    def __init__(self, num_max_proposals=None):
        self.num_max_proposals = num_max_proposals

    def __call__(self, results: Dict) -> Dict:
        proposals = np.asarray(results['proposals'], np.float32)
        if proposals.ndim != 2 or proposals.shape[1] not in (4, 5):
            raise ValueError(
                f'proposals should be (n, 4|5) but got {proposals.shape}')
        proposals = proposals[:, :4]
        if self.num_max_proposals is not None:
            proposals = proposals[:self.num_max_proposals]
        if len(proposals) == 0:
            proposals = np.array([[0, 0, 0, 0]], np.float32)
        results['proposals'] = proposals
        return results


@PIPELINES.register_module()
class RandomCenterCropPad:
    """CornerNet's crop. Train: up to 200 tries of a ratio from `ratios`
    (target = ratio x crop_size) and a random centre at least the (shrunk)
    `border` from the edges; the region around it is pasted, centres
    aligned, onto a canvas filled with the Normalize mean in the image's BGR
    order, and a try counts when it keeps a gt centre (the gts whose centres
    fall in the patch are kept, shifted, clipped); an image no try fits stays
    as it is. Test: padded to `test_pad_mode` ('logical_or' h | 127, or a
    size divisor) with the image at the top left and a zero `border`, the
    JAX package's deliberate change from mmdet's centred paste (ROADMAP.md
    caveat 43)."""

    def __init__(self, crop_size=None, ratios=(0.9, 1.0, 1.1), border=128,
                 mean=None, std=None, to_rgb=None, test_mode=False,
                 test_pad_mode=('logical_or', 127), bbox_clip_border=True):
        if mean is None or std is None or to_rgb is None:
            raise ValueError('RandomCenterCropPad needs mean, std and to_rgb')
        self.crop_size = crop_size
        self.ratios = ratios
        self.border = border
        # the image is BGR at this stage: the (RGB) mean flips
        self.fill = np.asarray(mean[::-1] if to_rgb else mean, np.float32)
        self.test_mode = test_mode
        self.test_pad_mode = test_pad_mode
        self.bbox_clip_border = bbox_clip_border

    @staticmethod
    def _rand_border(border, size):
        """The border shrunk by the smallest power of two that leaves a
        non-empty centre range on a small side."""
        k = 2 * border / size
        i = pow(2, np.ceil(np.log2(np.ceil(k))) + (k == int(k)))
        return int(border // i)

    def _paste(self, img, cy, cx, th, tw):
        h, w, c = img.shape
        x0, x1 = max(0, cx - tw // 2), min(cx + tw // 2, w)
        y0, y1 = max(0, cy - th // 2), min(cy + th // 2, h)
        canvas = np.empty((th, tw, c), img.dtype)
        canvas[:] = self.fill
        ccy, ccx = th // 2, tw // 2
        canvas[ccy - (cy - y0):ccy + (y1 - cy),
               ccx - (cx - x0):ccx + (x1 - cx)] = img[y0:y1, x0:x1]
        return canvas, (x0, y0, x1, y1)

    def _train(self, results):
        img = results['img']
        h, w = img.shape[:2]
        boxes = results.get('gt_bboxes', np.zeros((0, 4), np.float32))
        hb = self._rand_border(self.border, h)
        wb = self._rand_border(self.border, w)
        for _ in range(200):
            ratio = self.ratios[np.random.randint(len(self.ratios))]
            th = int(self.crop_size[0] * ratio)
            tw = int(self.crop_size[1] * ratio)
            cx = int(np.random.randint(wb, max(w - wb, wb + 1)))
            cy = int(np.random.randint(hb, max(h - hb, hb + 1)))
            canvas, (x0, y0, x1, y1) = self._paste(img, cy, cx, th, tw)
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2
            mask = ((centers[:, 0] > x0) & (centers[:, 0] < x1) &
                    (centers[:, 1] > y0) & (centers[:, 1] < y1))
            if len(boxes) > 0 and not mask.any():
                continue
            results['img'] = canvas
            results['img_shape'] = canvas.shape
            results['pad_shape'] = canvas.shape
            shift_x = tw // 2 - (cx - x0) - x0
            shift_y = th // 2 - (cy - y0) - y0
            bb = boxes[mask].copy()
            bb[:, 0::2] += shift_x
            bb[:, 1::2] += shift_y
            if self.bbox_clip_border:
                bb[:, 0::2] = bb[:, 0::2].clip(0, tw)
                bb[:, 1::2] = bb[:, 1::2].clip(0, th)
            keep = (bb[:, 2] > bb[:, 0]) & (bb[:, 3] > bb[:, 1])
            results['gt_bboxes'] = bb[keep]
            if 'gt_labels' in results:
                results['gt_labels'] = results['gt_labels'][mask][keep]
            return results
        return results

    def _test(self, results):
        img = results['img']
        h, w = img.shape[:2]
        results['img_shape'] = img.shape
        if self.test_pad_mode[0] == 'logical_or':
            th, tw = h | self.test_pad_mode[1], w | self.test_pad_mode[1]
        else:
            d = self.test_pad_mode[1]
            th, tw = int(np.ceil(h / d)) * d, int(np.ceil(w / d)) * d
        canvas = np.empty((th, tw, img.shape[2]), img.dtype)
        canvas[:] = self.fill
        canvas[:h, :w] = img
        results['img'] = canvas
        results['pad_shape'] = canvas.shape
        results['border'] = np.zeros(4, np.float32)
        return results

    def __call__(self, results: Dict) -> Dict:
        return self._test(results) if self.test_mode else self._train(results)


@PIPELINES.register_module()
class Albu:
    """mmdet's albumentations bridge. The package is optional: without it
    the transform raises ImportError at construction, as the JAX package's
    does, so that a config that names it fails instead of training without
    its augmentation."""

    def __init__(self, transforms, bbox_params=None, keymap=None,
                 update_pad_shape=False, skip_img_without_anno=False):
        try:
            import albumentations
        except ImportError as e:
            raise ImportError(
                'Albu requires the optional `albumentations` package; '
                'install it or drop the Albu transform from the pipeline.'
            ) from e
        self.keymap = keymap or dict(img='image', gt_bboxes='bboxes')

        def build(cfg):
            cfg = dict(cfg)
            return getattr(albumentations, cfg.pop('type'))(**cfg)
        self.aug = albumentations.Compose([build(t) for t in transforms],
                                          bbox_params=bbox_params)

    def __call__(self, results: Dict) -> Dict:
        mapped = {self.keymap.get(k, k): v for k, v in results.items()
                  if k in self.keymap}
        out = self.aug(**mapped)
        inv = {v: k for k, v in self.keymap.items()}
        results.update({inv.get(k, k): v for k, v in out.items()})
        return results


@PIPELINES.register_module()
class InstaBoost:
    """mmdet's InstaBoost bridge, gated on the optional `instaboostfast`
    package as Albu is on albumentations."""

    def __init__(self, **kwargs):
        try:
            import instaboostfast
        except ImportError as e:
            raise ImportError(
                'InstaBoost requires the optional `instaboostfast` '
                'package.') from e
        self._instaboost = instaboostfast
        self.cfg = instaboostfast.InstaBoostConfig(**kwargs) \
            if kwargs else None

    def __call__(self, results: Dict) -> Dict:
        anns, img = self._instaboost.get_new_data(
            results.get('ann_info'), results['img'], self.cfg,
            background=None)
        results['ann_info'] = anns
        results['img'] = img
        return results


@PIPELINES.register_module()
class FusedPreprocess:
    """Resize + BGR->RGB + Normalize + Pad(size_divisor) in one native pass
    over the output (`csrc/host/image_prep.cpp`) for a uint8 image; any
    other image goes through the unfused Resize, Normalize and Pad, as in
    the JAX package (`ld_tpu/data/transforms.py:556-567`).
    Scale sampling (single, value, range and ratio_range modes) is
    Resize's. `keep_ratio=False` resizes to the scale's (w, h) exactly, as
    Resize does; the JAX package's FusedPreprocess has no such argument,
    so the configs that pass it (the crop640 and WIDER-Face pipelines)
    raise TypeError there (ROADMAP.md caveat 46)."""

    def __init__(self, img_scale=(1333, 800), size_divisor=32,
                 mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375), to_rgb=True,
                 ratio_range=None, multiscale_mode='range', keep_ratio=True):
        self.img_scale = img_scale
        self.keep_ratio = keep_ratio
        self.size_divisor = size_divisor
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb
        self._scale_sampler = Resize(img_scale=img_scale,
                                     keep_ratio=keep_ratio,
                                     ratio_range=ratio_range,
                                     multiscale_mode=multiscale_mode)
        self._fallback = [self._scale_sampler, Normalize(mean, std, to_rgb),
                          Pad(size_divisor=size_divisor)]

    def __call__(self, results: Dict) -> Dict:
        import ctypes

        from ld_tpu_torch import native
        img = results['img']
        if img.dtype != np.uint8:
            # a float image (after PhotoMetricDistortion, the YOLOv3 and
            # WIDER-Face pipelines) takes the unfused Resize, Normalize and
            # Pad, as the JAX FusedPreprocess falls back to them
            for t in self._fallback:
                results = t(results)
            return results
        if img.ndim != 3 or img.shape[2] != 3:
            raise TypeError('FusedPreprocess takes an (H, W, 3) image, got '
                            f'{img.dtype} {img.shape}')
        lib = native.load('image_prep')
        h, w = img.shape[:2]
        scale = results.get('scale') or self._scale_sampler._sample_scale()
        if self.keep_ratio:
            factor = rescale_size(h, w, scale)
            new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
        else:
            new_w, new_h = int(scale[0]), int(scale[1])
        d = self.size_divisor
        dh = ((new_h + d - 1) // d) * d
        dw = ((new_w + d - 1) // d) * d
        out = np.empty((dh, dw, 3), np.float32)
        src = np.ascontiguousarray(img)
        lib.image_prep(native.ptr(src, ctypes.c_uint8), h, w,
                       native.ptr(out, ctypes.c_float), dh, dw, new_h, new_w,
                       native.ptr(self.mean, ctypes.c_float),
                       native.ptr(self.std, ctypes.c_float),
                       1 if self.to_rgb else 0)
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = out
        results['img_shape'] = (new_h, new_w, 3)
        results['pad_shape'] = out.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        if 'gt_bboxes' in results:
            results['gt_bboxes'] = _scale_boxes(
                results['gt_bboxes'], results['scale_factor'], new_w, new_h)
        _resize_masks(results, new_w, new_h)
        return results


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [PIPELINES.build(dict(t)) if isinstance(t, dict)
                           else t for t in transforms]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:     # a transform dropped the sample
                return None
        return results


def collects_masks(pipeline) -> bool:
    """Whether a Compose ends in a Collect that takes 'gt_masks'."""
    return any(isinstance(t, Collect) and 'gt_masks' in t.keys
               for t in getattr(pipeline, 'transforms', []))


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


# the collated batch: key -> (dtype, shape without the batch dimension);
# the layout of `ld_tpu_torch.testing.detection_batch`, plus scale_factor,
# img_ids (the dataset's integer image ids, as COCO's; -1 where an id is not
# an integer, as VOC's '2008_000001'), img_idx (each image's index in the
# dataset, set by the loader; -1 outside it) and gt_masks, present only
# where the samples carry masks (a Collect of 'gt_masks'). 'H', 'W' and 'G'
# stand for the pad bucket and max_gts, 'Hm' and 'Wm' for the bucket over
# MASK_STRIDE.
BATCH_LAYOUT = {
    'image': (np.float32, (3, 'H', 'W')),
    'gt_bboxes': (np.float32, ('G', 4)),
    'gt_labels': (np.int64, ('G', )),
    'gt_valid': (np.bool_, ('G', )),
    'img_hw': (np.float32, (2, )),
    'scale_factor': (np.float32, (4, )),
    'img_ids': (np.int64, ()),
    'img_idx': (np.int64, ()),
    'gt_masks': (np.uint8, ('G', 'Hm', 'Wm')),
}
MASK_STRIDE = 4


def batch_shape(key: str, b: int, hw: Tuple[int, int], max_gts: int):
    """The shape of `key` in a batch of b images padded to `hw`."""
    dims = {'H': hw[0], 'W': hw[1], 'G': max_gts,
            'Hm': hw[0] // MASK_STRIDE, 'Wm': hw[1] // MASK_STRIDE}
    return (b, ) + tuple(dims.get(d, d) for d in BATCH_LAYOUT[key][1])


def _place_masks(dst: np.ndarray, masks, th: int, tw: int) -> None:
    """Each (h, w) mask placed at the top left of a zero (th, tw) frame,
    then taken nearest to dst's (mh, mw): the JAX package's canvas and
    cv2 INTER_NEAREST resize, without the canvas."""
    mh, mw = dst.shape[-2:]
    sy, sx = _nearest_index(mh, th), _nearest_index(mw, tw)
    for g, m in enumerate(masks):
        # the indices grow, so those inside the mask are a prefix
        ys, xs = sy[sy < m.shape[0]], sx[sx < m.shape[1]]
        dst[g, :len(ys), :len(xs)] = m[ys[:, None], xs[None, :]]


def collate_batch(samples: List[Dict], pad_hw, max_gts: int = 100,
                  out: Optional[Dict[str, np.ndarray]] = None,
                  min_hw: Optional[Tuple[int, int]] = None
                  ) -> Dict[str, np.ndarray]:
    """Stack per-image dicts into one static-shape NCHW batch.

    Images are zero-padded to `pad_hw` (one shape, or a list of buckets —
    the smallest fitting one is used). `img_hw` carries the true (resized,
    un-padded) image shape used for anchor valid flags and box clipping;
    gt boxes and labels fill `max_gts` slots, with `gt_valid` marking the
    real ones; `gt_masks` where any sample carries masks. `out`, where
    given, holds one flat buffer per key of BATCH_LAYOUT (gt_masks only
    where masks come), large enough for the largest bucket: the batch is
    written into the leading elements of each (e.g. pinned memory owned by
    a DevicePrefetcher), and the returned arrays are views of them.
    `min_hw`: a shape the bucket must fit besides the images (a data-
    parallel rank pads to its global batch's bucket).
    """
    b = len(samples)
    lo_h, lo_w = min_hw or (0, 0)
    th, tw = select_pad_bucket(
        pad_hw, (max(lo_h, *(s['img'].shape[0] for s in samples)),
                 max(lo_w, *(s['img'].shape[1] for s in samples))))
    with_masks = any('gt_masks' in s for s in samples)
    if with_masks and out is not None and 'gt_masks' not in out:
        raise ValueError('the samples carry gt_masks, and the buffers hold '
                         'none: the loader was built for a pipeline that '
                         'does not collect them')
    batch = {}
    for key, (dtype, _) in BATCH_LAYOUT.items():
        if key == 'gt_masks' and not with_masks:
            continue
        shape = batch_shape(key, b, (th, tw), max_gts)
        if out is None:
            batch[key] = np.zeros(shape, dtype)
        else:
            batch[key] = out[key][:int(np.prod(shape))].reshape(shape)
            if key != 'image':
                batch[key][...] = 0
    images = batch['image']
    for i, s in enumerate(samples):
        img = s['img']
        h, w = img.shape[:2]
        if h > th or w > tw:
            raise ValueError(f'image {img.shape} does not fit {(th, tw)}')
        images[i, :, :h, :w] = img.transpose(2, 0, 1)
        if out is not None:     # a reused buffer: clear the padding
            images[i, :, h:, :] = 0
            images[i, :, :h, w:] = 0
        batch['img_hw'][i] = s['img_shape'][:2]
        batch['scale_factor'][i] = s.get('scale_factor',
                                         np.ones(4, np.float32))
        img_id = s.get('img_id', -1)
        batch['img_ids'][i] = img_id if isinstance(img_id, (int, np.integer)) \
            else -1
        batch['img_idx'][i] = s.get('img_idx', -1)
        if 'gt_bboxes' in s:
            n = min(len(s['gt_bboxes']), max_gts)
            batch['gt_bboxes'][i, :n] = s['gt_bboxes'][:n]
            batch['gt_labels'][i, :n] = s['gt_labels'][:n]
            batch['gt_valid'][i, :n] = True
        if with_masks:
            _place_masks(batch['gt_masks'][i], s.get('gt_masks', [])[:max_gts],
                         th, tw)
    return batch
