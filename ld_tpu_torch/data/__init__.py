from ld_tpu_torch.utils.registry import DATASETS

from .coco import COCO_CLASSES, CocoDataset, SyntheticDetectionDataset
from .loader import (DataLoader, DevicePrefetcher, GroupBatchSampler,
                     build_dataloader)
from .transforms import (Collect, Compose, FusedPreprocess, LoadAnnotations,
                         LoadImageFromFile, Normalize, Pad, RandomFlip, Resize,
                         collate_batch, select_pad_bucket)


def build_dataset(cfg):
    """A dataset from its config dict, through the DATASETS registry."""
    return DATASETS.build(dict(cfg))


__all__ = [
    'COCO_CLASSES', 'CocoDataset', 'Collect', 'Compose', 'DataLoader',
    'DevicePrefetcher', 'FusedPreprocess', 'GroupBatchSampler',
    'LoadAnnotations', 'LoadImageFromFile', 'Normalize', 'Pad', 'RandomFlip',
    'Resize', 'SyntheticDetectionDataset', 'build_dataloader',
    'build_dataset', 'collate_batch', 'select_pad_bucket'
]
