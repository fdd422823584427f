from ld_tpu_torch.utils.registry import DATASETS

from .coco import COCO_CLASSES, CocoDataset, SyntheticDetectionDataset
from .dataset_wrappers import (ClassBalancedDataset, ConcatDataset,
                               RepeatDataset)
from .loader import (DataLoader, DevicePrefetcher, GroupBatchSampler,
                     build_dataloader)
from .transforms import (Collect, Compose, DefaultFormatBundle,
                         FilterAnnotations, FusedPreprocess, ImageToTensor,
                         LoadAnnotations, LoadImageFromFile,
                         MultiScaleFlipAug, Normalize, Pad, RandomFlip,
                         Resize, collate_batch, select_pad_bucket)
from .voc import VOC_CLASSES, VOCDataset


def build_dataset(cfg):
    """A dataset from its config dict, through the DATASETS registry."""
    return DATASETS.build(dict(cfg))


__all__ = [
    'COCO_CLASSES', 'ClassBalancedDataset', 'CocoDataset', 'Collect',
    'Compose', 'ConcatDataset', 'DataLoader', 'DefaultFormatBundle',
    'DevicePrefetcher', 'FilterAnnotations', 'FusedPreprocess',
    'GroupBatchSampler', 'ImageToTensor', 'LoadAnnotations',
    'LoadImageFromFile', 'MultiScaleFlipAug', 'Normalize', 'Pad',
    'RandomFlip', 'RepeatDataset', 'Resize', 'SyntheticDetectionDataset',
    'VOCDataset', 'VOC_CLASSES', 'build_dataloader', 'build_dataset',
    'collate_batch', 'select_pad_bucket'
]
