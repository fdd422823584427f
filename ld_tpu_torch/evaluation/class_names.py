"""Dataset class-name tables (port of `ld_tpu/evaluation/class_names.py`)."""
from ld_tpu_torch.data.coco import COCO_CLASSES
from ld_tpu_torch.data.voc import VOC_CLASSES


def coco_classes():
    return list(COCO_CLASSES)


def voc_classes():
    return list(VOC_CLASSES)


_TABLES = {'coco': coco_classes, 'voc': voc_classes}


def get_classes(dataset: str):
    """The class names of 'coco' or 'voc'."""
    if dataset in _TABLES:
        return _TABLES[dataset]()
    raise KeyError(f'unknown dataset {dataset}')
