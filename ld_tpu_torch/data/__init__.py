from ld_tpu_torch.utils.registry import DATASETS

from .auto_augment import (AutoAugment, ColorTransform, Rotate, Shear,
                           Translate)
from .coco import COCO_CLASSES, CocoDataset, SyntheticDetectionDataset
from .corruptions import CORRUPTIONS, Corrupt
from .dataset_wrappers import (ClassBalancedDataset, ConcatDataset,
                               RepeatDataset)
from .extra_datasets import (CityscapesDataset, DeepFashionDataset,
                             WIDERFaceDataset)
from .loader import (DataLoader, DevicePrefetcher, GroupBatchSampler,
                     build_dataloader)
from .lvis import LVISDataset, LVISV1Dataset
from .transforms import (Albu, Collect, Compose, CutOut, DefaultFormatBundle,
                         Expand, FilterAnnotations, FusedPreprocess,
                         ImageToTensor, InstaBoost, LoadAnnotations,
                         LoadImageFromFile, LoadProposals, MinIoURandomCrop,
                         MultiScaleFlipAug, Normalize, Pad,
                         PhotoMetricDistortion, RandomCenterCropPad,
                         RandomCrop, RandomFlip, Resize, SegRescale,
                         collate_batch, select_pad_bucket)
from .voc import VOC_CLASSES, VOCDataset


def build_dataset(cfg):
    """A dataset from its config dict, through the DATASETS registry."""
    return DATASETS.build(dict(cfg))


__all__ = [
    'Albu', 'AutoAugment', 'COCO_CLASSES', 'CORRUPTIONS',
    'CityscapesDataset', 'ClassBalancedDataset', 'CocoDataset', 'Collect',
    'ColorTransform', 'Compose', 'ConcatDataset', 'Corrupt', 'CutOut',
    'DataLoader', 'DeepFashionDataset', 'DefaultFormatBundle',
    'DevicePrefetcher', 'Expand', 'FilterAnnotations', 'FusedPreprocess',
    'GroupBatchSampler', 'ImageToTensor', 'InstaBoost', 'LVISDataset',
    'LVISV1Dataset', 'LoadAnnotations', 'LoadImageFromFile', 'LoadProposals',
    'MinIoURandomCrop', 'MultiScaleFlipAug', 'Normalize', 'Pad',
    'PhotoMetricDistortion', 'RandomCenterCropPad', 'RandomCrop',
    'RandomFlip', 'RepeatDataset', 'Resize', 'Rotate', 'SegRescale', 'Shear',
    'SyntheticDetectionDataset', 'Translate', 'VOCDataset', 'VOC_CLASSES',
    'WIDERFaceDataset', 'build_dataloader', 'build_dataset', 'collate_batch',
    'select_pad_bucket'
]
