"""COCO-format detection datasets (port of `ld_tpu/data/coco.py:21-284`):
json parsing (boxes, labels, areas, each gt's polygons as `masks` (None
for an RLE) and the crowds' segmentations as `masks_ignore`), the
category -> label map, the empty / small-image filter, the aspect-ratio
group flags, `results2json` and `evaluate` of 'bbox' and 'segm' through the
port's own COCO and mask evaluators; and a seeded synthetic dataset with
the same interface.
"""
from __future__ import annotations

import json
import warnings
from collections import defaultdict

import numpy as np

from ld_tpu_torch.utils.registry import DATASETS
from .transforms import Compose, collects_masks

COCO_CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
    'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
    'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush')


def _evaluate(dataset, det_results, metric, classwise=False,
              supported=('bbox', 'segm')):
    """The metrics of `metric` (a name or a list), 'bbox' first."""
    metrics = [metric] if isinstance(metric, str) else list(metric)
    unsupported = [m for m in metrics if m not in supported]
    if unsupported:
        raise NotImplementedError(
            f'metrics {unsupported} are not ported to ld_tpu_torch yet: '
            f'only {list(supported)}')
    out = {}
    if 'bbox' in metrics:
        from ld_tpu_torch.evaluation.coco_eval import CocoEvaluator
        out.update(CocoEvaluator(dataset).evaluate(det_results,
                                                   classwise=classwise))
    if 'segm' in metrics:
        from ld_tpu_torch.evaluation.segm_eval import SegmEvaluator
        out.update(SegmEvaluator(dataset).evaluate(det_results))
    return out


@DATASETS.register_module()
class CocoDataset:
    CLASSES = COCO_CLASSES

    def __init__(self, ann_file, pipeline, img_prefix='', classes=None,
                 test_mode=False, filter_empty_gt=True, min_size=32):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        if classes is not None:
            self.CLASSES = tuple(classes)
        self._load_annotations(ann_file)
        if not test_mode and filter_empty_gt:
            self._filter_imgs(min_size)
        self._set_group_flag()
        self.pipeline = Compose(pipeline)

    # ---- annotation parsing --------------------------------------------------
    def _load_annotations(self, ann_file):
        with open(ann_file) as f:
            coco = json.load(f)
        cats = sorted(coco['categories'], key=lambda c: c['id'])
        wanted = {c['id']: c['name'] for c in cats
                  if c['name'] in self.CLASSES}
        if not wanted:
            warnings.warn(
                f'{ann_file}: none of the {len(cats)} annotation categories '
                "match this dataset's CLASSES: every annotation will be "
                'dropped (and with filter_empty_gt, every image). Pass '
                "classes=('name', ...) to the dataset config.", stacklevel=2)
        # contiguous label ids in CLASSES order
        name_to_label = {n: i for i, n in enumerate(self.CLASSES)}
        self.cat_id_to_label = {cid: name_to_label[n]
                                for cid, n in wanted.items()}
        self.label_to_cat_id = {v: k for k, v in self.cat_id_to_label.items()}

        anns_by_img = defaultdict(list)
        for a in coco.get('annotations', []):
            anns_by_img[a['image_id']].append(a)

        self.img_infos = []
        self.annotations = []
        for img in coco['images']:
            info = dict(id=img['id'], filename=img['file_name'],
                        width=img['width'], height=img['height'])
            bboxes, labels, areas, polys = [], [], [], []
            ignore, ig_labels, ig_areas, ig_segs = [], [], [], []
            for a in anns_by_img.get(img['id'], []):
                if a.get('ignore', False):
                    continue
                x, y, w, h = a['bbox']
                inter_w = max(0, min(x + w, img['width']) - max(x, 0))
                inter_h = max(0, min(y + h, img['height']) - max(y, 0))
                if inter_w * inter_h == 0 or w < 1 or h < 1:
                    continue
                if a['category_id'] not in self.cat_id_to_label:
                    continue
                box = [x, y, x + w, y + h]
                label = self.cat_id_to_label[a['category_id']]
                # the json 'area' (segmentation area on real COCO) decides
                # the small / medium / large gt ranges of the evaluation
                area = float(a.get('area', w * h))
                seg = a.get('segmentation')
                if a.get('iscrowd', False):
                    ignore.append(box)
                    ig_labels.append(label)
                    ig_areas.append(area)
                    # a crowd's segmentation (an RLE on real COCO): the
                    # segm evaluator matches crowds by IoF
                    ig_segs.append(seg)
                else:
                    bboxes.append(box)
                    labels.append(label)
                    areas.append(area)
                    polys.append(seg if isinstance(seg, list) else None)
            self.img_infos.append(info)
            self.annotations.append(dict(
                bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int64),
                bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
                labels_ignore=np.asarray(ig_labels, np.int64),
                areas=np.asarray(areas, np.float64),
                areas_ignore=np.asarray(ig_areas, np.float64),
                masks=polys, masks_ignore=ig_segs))

    def _filter_imgs(self, min_size):
        keep = [i for i, (info, ann) in enumerate(zip(self.img_infos,
                                                      self.annotations))
                if len(ann['bboxes']) and
                min(info['width'], info['height']) >= min_size]
        self.img_infos = [self.img_infos[i] for i in keep]
        self.annotations = [self.annotations[i] for i in keep]

    def _set_group_flag(self):
        """Aspect-ratio groups: 1 where w / h > 1, else 0."""
        self.flag = np.array([
            1 if info['width'] / info['height'] > 1 else 0
            for info in self.img_infos
        ], np.uint8)

    # ---- item access ---------------------------------------------------------
    def __len__(self):
        return len(self.img_infos)

    def get_ann_info(self, idx):
        return self.annotations[idx]

    def __getitem__(self, idx):
        results = dict(img_info=self.img_infos[idx],
                       ann_info=self.annotations[idx],
                       img_prefix=self.img_prefix)
        return self.pipeline(results)

    # ---- results & evaluation ------------------------------------------------
    def results2json(self, det_results, out_file=None):
        """Detections -> COCO json records.

        det_results: per image, a dict with 'boxes' (n, 5) xyxy + score and
        'labels' (n,) contiguous ids, or a per-class list of (n, 5) arrays.
        """
        records = []
        for idx, res in enumerate(det_results):
            img_id = self.img_infos[idx]['id']
            if isinstance(res, dict):
                boxes, labels = res['boxes'], res['labels']
            else:
                boxes = np.concatenate(res) if len(res) else np.zeros((0, 5))
                labels = np.concatenate([
                    np.full(len(r), c, np.int64) for c, r in enumerate(res)
                ]) if len(res) else np.zeros((0, ), np.int64)
            for box, label in zip(boxes, labels):
                x1, y1, x2, y2, score = box
                records.append(dict(
                    image_id=int(img_id),
                    bbox=[float(x1), float(y1), float(x2 - x1),
                          float(y2 - y1)],
                    score=float(score),
                    category_id=int(self.label_to_cat_id[int(label)])))
        if out_file:
            with open(out_file, 'w') as f:
                json.dump(records, f)
        return records

    def evaluate(self, det_results, metric='bbox', classwise=False,
                 **kwargs):
        """'bbox' and / or 'segm'; 'segm' reads each result's `masks`
        (n, 28, 28) roi-space sigmoid masks, as `eval_detector` gives them
        for a model with a mask head."""
        return _evaluate(self, det_results, metric, classwise)


@DATASETS.register_module()
class SyntheticDetectionDataset:
    """Seeded random uint8 images and boxes behind the COCO dataset's
    interface, for runs without the COCO files. The same seed gives the
    same images, boxes, labels and masks as the JAX package's dataset of
    this name: each gt's mask is its (int-truncated) box region, yielded as
    `gt_masks` where the pipeline collects them (the JAX dataset builds
    them for every image and sample; a pipeline that does not collect
    them gets the same batches without them)."""

    CLASSES = COCO_CLASSES

    def __init__(self, num_images=64, hw=(160, 224), num_classes=80,
                 max_boxes=6, pipeline=None, seed=0, draw_boxes=False,
                 **kwargs):
        # draw_boxes=True paints each gt region in a class-determined colour,
        # so that the objects can be detected and not only memorised
        self.num_images = num_images
        self.hw = hw
        self.CLASSES = tuple(COCO_CLASSES[:num_classes]) if \
            num_classes <= len(COCO_CLASSES) else tuple(
                f'class_{i}' for i in range(num_classes))
        rng = np.random.RandomState(seed)
        self.img_infos = [dict(id=i, filename=f'synth_{i}.jpg',
                               width=hw[1], height=hw[0])
                          for i in range(num_images)]
        self.annotations = []
        self._images = []
        for _ in range(num_images):
            n = rng.randint(1, max_boxes + 1)
            xy = rng.uniform(0, [hw[1] * 0.6, hw[0] * 0.6], (n, 2))
            wh = rng.uniform([8, 8], [hw[1] * 0.4, hw[0] * 0.4], (n, 2))
            bboxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
            labels = rng.randint(0, num_classes, n)
            self.annotations.append(dict(
                bboxes=bboxes, labels=labels,
                bboxes_ignore=np.zeros((0, 4), np.float32)))
            img = rng.randint(0, 255, (hw[0], hw[1], 3)).astype(np.uint8)
            if draw_boxes:
                img //= 4  # a dim background, so that the objects stand out
                for bb, lab in zip(bboxes, labels):
                    x1, y1, x2, y2 = bb.astype(int)
                    color = np.random.RandomState(int(lab) + 1).randint(
                        100, 256, 3)
                    img[y1:y2, x1:x2] = (
                        color[None, None, :] * 0.8 +
                        img[y1:y2, x1:x2] * 0.2).astype(np.uint8)
            self._images.append(img)
        self.flag = np.zeros(num_images, np.uint8)
        self.pipeline = Compose(pipeline or [])
        self.cat_id_to_label = {i + 1: i for i in range(num_classes)}
        self.label_to_cat_id = {i: i + 1 for i in range(num_classes)}

    def __len__(self):
        return self.num_images

    def get_ann_info(self, idx):
        return self.annotations[idx]

    def _box_masks(self, idx):
        """The image's gt masks: each box's region, full size, uint8."""
        out = []
        for bb in self.annotations[idx]['bboxes']:
            m = np.zeros(self.hw, np.uint8)
            x1, y1, x2, y2 = bb.astype(int)
            m[y1:y2, x1:x2] = 1
            out.append(m)
        return out

    def __getitem__(self, idx):
        img = self._images[idx]
        ann = self.annotations[idx]
        results = dict(img_info=self.img_infos[idx], ann_info=ann,
                       img_prefix='', img=img, img_shape=img.shape,
                       ori_shape=img.shape, gt_bboxes=ann['bboxes'].copy(),
                       gt_labels=ann['labels'].copy())
        if collects_masks(self.pipeline):
            results['gt_masks'] = self._box_masks(idx)
        return self.pipeline(results)

    def evaluate(self, det_results, metric='bbox', **kwargs):
        return _evaluate(self, det_results, metric, supported=('bbox', ))
