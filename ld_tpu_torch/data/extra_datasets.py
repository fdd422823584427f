"""Cityscapes, DeepFashion and WIDER-Face (port of
`ld_tpu/data/extra_datasets.py`): re-parameterisations of the COCO and
XML readers. Cityscapes is a CocoDataset with its 8 instance classes,
DeepFashion one with its 15 clothing classes, and WIDER-Face a
single-class XML dataset whose images sit under the folder its XML's
`<folder>` names (an event directory), not under `JPEGImages/`.
"""
from __future__ import annotations

import os

from ld_tpu_torch.utils.registry import DATASETS
from .coco import CocoDataset
from .voc import VOCDataset


@DATASETS.register_module()
class CityscapesDataset(CocoDataset):
    CLASSES = ('person', 'rider', 'car', 'truck', 'bus', 'train',
               'motorcycle', 'bicycle')


@DATASETS.register_module()
class DeepFashionDataset(CocoDataset):
    CLASSES = ('top', 'skirt', 'leggings', 'dress', 'outer', 'pants', 'bag',
               'neckwear', 'headwear', 'eyeglass', 'belt', 'footwear',
               'hair', 'skin', 'face')


@DATASETS.register_module()
class WIDERFaceDataset(VOCDataset):
    """Faces in the VOC XML layout; the image of `img_id` is
    `<folder>/<img_id>.jpg`."""
    CLASSES = ('face', )

    def _filename(self, img_id, xml_root):
        return os.path.join(xml_root.find('folder').text, f'{img_id}.jpg')
