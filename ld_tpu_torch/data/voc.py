"""PASCAL VOC dataset (XML annotations) and its evaluation (port of
`ld_tpu/data/voc.py`).

  * `ann_file` / `img_prefix` may be parallel lists (the 07+12 trainval
    configs: one split file per VOC year); the splits are concatenated into
    one dataset, each image keeping its own prefix.
  * Box corners are 1-based in the XML: xmin / ymin are shifted by -1.
  * `difficult` objects, and with `min_size` objects narrower or lower
    than it, become ignored gts (`bboxes_ignore` / `labels_ignore`).
  * `flag`: the aspect-ratio group, 1 where width / height > 1.
  * `evaluate`: 'mAP' at one IoU threshold, any other metric the COCO-style
    AP50:95 of the LD paper (VOC mAP at IoU 0.50, 0.55, ..., 0.95, and
    their mean).
Image ids are the split files' strings ('000001', '2008_000001').
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ld_tpu_torch.utils.registry import DATASETS
from .transforms import Compose

VOC_CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor')


@DATASETS.register_module(name=['VOCDataset', 'XMLDataset'])
class VOCDataset:
    """Also registered as XMLDataset: the generic Pascal-style XML
    annotation reader with a `classes` override."""
    CLASSES = VOC_CLASSES

    def __init__(self, ann_file, pipeline, img_prefix='', test_mode=False,
                 min_size=None, classes=None, **kwargs):
        if classes is not None:
            self.CLASSES = tuple(classes)
        ann_files = ann_file if isinstance(ann_file, (list, tuple)) \
            else [ann_file]
        prefixes = img_prefix if isinstance(img_prefix, (list, tuple)) \
            else [img_prefix] * len(ann_files)
        if len(prefixes) != len(ann_files):
            raise ValueError(f'{len(ann_files)} ann files but '
                             f'{len(prefixes)} image prefixes')
        self.img_prefix = prefixes[0]
        self.test_mode = test_mode
        self.min_size = min_size
        self.ids, id_prefixes = [], []
        for af, pref in zip(ann_files, prefixes):
            with open(af) as f:
                new = [line.strip() for line in f if line.strip()]
            self.ids += new
            id_prefixes += [pref] * len(new)
        self.id_prefixes = id_prefixes
        self.img_infos = []
        self.annotations = []
        name_to_label = {n: i for i, n in enumerate(self.CLASSES)}
        for img_id, prefix in zip(self.ids, id_prefixes):
            root = ET.parse(os.path.join(prefix, 'Annotations',
                                         f'{img_id}.xml')).getroot()
            size = root.find('size')
            w = int(size.find('width').text)
            h = int(size.find('height').text)
            bboxes, labels, ignore, ignore_labels = [], [], [], []
            for obj in root.findall('object'):
                name = obj.find('name').text
                if name not in name_to_label:
                    continue
                difficult = int(obj.find('difficult').text or 0)
                bnd = obj.find('bndbox')
                box = [float(bnd.find(k).text) - (1 if k in ('xmin', 'ymin')
                                                  else 0)
                       for k in ('xmin', 'ymin', 'xmax', 'ymax')]
                small = self.min_size and (
                    box[2] - box[0] < self.min_size or
                    box[3] - box[1] < self.min_size)
                if difficult or small:
                    ignore.append(box)
                    ignore_labels.append(name_to_label[name])
                else:
                    bboxes.append(box)
                    labels.append(name_to_label[name])
            self.img_infos.append(dict(
                id=img_id, filename=self._filename(img_id, root),
                width=w, height=h))
            self.annotations.append(dict(
                bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int64),
                bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
                labels_ignore=np.asarray(ignore_labels, np.int64)))
        self.flag = np.array([
            1 if i['width'] / i['height'] > 1 else 0 for i in self.img_infos
        ], np.uint8)
        self.pipeline = Compose(pipeline)

    def _filename(self, img_id, xml_root):
        """The image path of `img_id` under its prefix (WIDER-Face reads
        its folder from the XML)."""
        return os.path.join('JPEGImages', f'{img_id}.jpg')

    def __len__(self):
        return len(self.img_infos)

    def get_ann_info(self, idx):
        return self.annotations[idx]

    def __getitem__(self, idx):
        results = dict(img_info=self.img_infos[idx],
                       ann_info=self.annotations[idx],
                       img_prefix=self.id_prefixes[idx])
        return self.pipeline(results)

    def evaluate(self, det_results, metric='mAP', iou_thr=0.5, **kwargs):
        """det_results: per image, a dict of 'boxes' (n, 5) and 'labels', or
        a per-class list of (n, 5) arrays. 'mAP' at `iou_thr`; any other
        metric gives AP50 ... AP95 and their mean as 'mAP'."""
        from ld_tpu_torch.evaluation.mean_ap import eval_map
        num_classes = len(self.CLASSES)
        per_class_results = []
        for res in det_results:
            if isinstance(res, dict):
                boxes = np.asarray(res['boxes']).reshape(-1, 5)
                labels = np.asarray(res['labels'])
                res = [boxes[labels == c] for c in range(num_classes)]
            per_class_results.append(res)
        out = {}
        if metric == 'mAP':
            out['mAP'], _ = eval_map(per_class_results, self.annotations,
                                     iou_thr=iou_thr, num_classes=num_classes)
            return out
        aps = []
        for thr in np.arange(0.5, 1.0, 0.05):
            ap, _ = eval_map(per_class_results, self.annotations,
                             iou_thr=float(thr), num_classes=num_classes)
            aps.append(ap)
            out[f'AP{int(thr * 100)}'] = ap
        out['mAP'] = float(np.mean(aps))
        return out
