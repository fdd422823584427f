"""LVIS v1 dataset (port of `ld_tpu/data/lvis.py`): a COCO-format json
with LVIS's conventions, registered also as `LVISDataset` (the v0.5
configs' name).

  * the categories are the json's own (1203 in v1, 1230 in v0.5), sorted
    by id, and the labels are their positions;
  * an image without `file_name` takes the last two parts of its
    `coco_url` ('train2017/000000391895.jpg');
  * each image's `neg_category_ids` and `not_exhaustive_category_ids` are
    carried in its `img_infos` entry;
  * gts narrower or lower than 1 are dropped; none is a crowd, so the
    ignore lists stay empty.

Evaluation is `CocoDataset.evaluate`'s COCO-style AP over every class, not
LVIS's federated AP: nothing reads the two federated fields, in this
package or in the JAX one (ROADMAP.md caveat 42).
"""
from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from ld_tpu_torch.utils.registry import DATASETS
from .coco import CocoDataset


@DATASETS.register_module(name=['LVISV1Dataset', 'LVISDataset'])
class LVISV1Dataset(CocoDataset):

    def __init__(self, ann_file, pipeline, img_prefix='', **kwargs):
        super().__init__(ann_file, pipeline, img_prefix=img_prefix, **kwargs)

    def _load_annotations(self, ann_file):
        with open(ann_file) as f:
            data = json.load(f)
        cats = sorted(data['categories'], key=lambda c: c['id'])
        self.CLASSES = tuple(c['name'] for c in cats)
        self.cat_id_to_label = {c['id']: i for i, c in enumerate(cats)}
        self.label_to_cat_id = {v: k for k, v in self.cat_id_to_label.items()}

        anns_by_img = defaultdict(list)
        for a in data.get('annotations', []):
            anns_by_img[a['image_id']].append(a)

        self.img_infos = []
        self.annotations = []
        for img in data['images']:
            filename = img['file_name'] if 'file_name' in img else \
                '/'.join(img['coco_url'].split('/')[-2:])
            self.img_infos.append(dict(
                id=img['id'], filename=filename, width=img['width'],
                height=img['height'],
                neg_category_ids=img.get('neg_category_ids', []),
                not_exhaustive_category_ids=img.get(
                    'not_exhaustive_category_ids', [])))
            bboxes, labels, polys = [], [], []
            for a in anns_by_img.get(img['id'], []):
                x, y, w, h = a['bbox']
                if w < 1 or h < 1:
                    continue
                bboxes.append([x, y, x + w, y + h])
                labels.append(self.cat_id_to_label[a['category_id']])
                seg = a.get('segmentation')
                polys.append(seg if isinstance(seg, list) else None)
            self.annotations.append(dict(
                bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int64),
                bboxes_ignore=np.zeros((0, 4), np.float32),
                masks=polys))


LVISDataset = LVISV1Dataset
