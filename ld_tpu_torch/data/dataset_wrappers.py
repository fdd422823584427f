"""Dataset wrappers: Concat, Repeat and ClassBalanced (port of
`ld_tpu/data/dataset_wrappers.py`), with the same `flag` and `indices`.
A wrapper's config builds the datasets it wraps through the registry.

A config that puts a wrapper where its base config has a plain dataset
keeps the base's dataset keys beside the wrapper's own, since configs merge
dict into dict: `configs/ld/*_voc_1x.py` inherit the COCO train set's
`ann_file`, `img_prefix` and `pipeline` under their RepeatDataset. A wrapper
ignores those keys with a warning (the JAX package's wrappers refuse them
with a TypeError, so its VOC LD configs do not build their train set); any
other unknown key is still a TypeError.
"""
from __future__ import annotations

import bisect
import math
import warnings
from collections import defaultdict

import numpy as np

from ld_tpu_torch.utils.registry import DATASETS


def _build(cfg):
    return DATASETS.build(dict(cfg)) if isinstance(cfg, dict) else cfg


def _flag(dataset) -> np.ndarray:
    return getattr(dataset, 'flag', np.zeros(len(dataset), np.uint8))


# a plain dataset's keys, which a base config may leave beside a wrapper
_DATASET_KEYS = ('ann_file', 'img_prefix', 'pipeline', 'seg_prefix',
                 'proposal_file', 'data_root', 'test_mode', 'filter_empty_gt',
                 'classes')


def _drop_inherited(wrapper: str, keys: dict):
    unknown = sorted(set(keys) - set(_DATASET_KEYS))
    if unknown:
        raise TypeError(f'{wrapper} got unexpected arguments {unknown}')
    if keys:
        warnings.warn(f'{wrapper} ignores {sorted(keys)}: dataset keys a '
                      'base config left beside it', stacklevel=3)


@DATASETS.register_module()
class ConcatDataset:
    """The datasets one after another; CLASSES are the first one's."""

    def __init__(self, datasets, **inherited):
        _drop_inherited('ConcatDataset', inherited)
        self.datasets = [_build(d) for d in datasets]
        self.CLASSES = self.datasets[0].CLASSES
        self.cumulative = np.cumsum([len(d) for d in self.datasets])
        self.flag = np.concatenate([_flag(d) for d in self.datasets])

    def __len__(self):
        return int(self.cumulative[-1])

    def _locate(self, idx):
        di = bisect.bisect_right(self.cumulative, idx)
        base = 0 if di == 0 else int(self.cumulative[di - 1])
        return di, idx - base

    def __getitem__(self, idx):
        di, li = self._locate(idx)
        return self.datasets[di][li]

    def get_ann_info(self, idx):
        di, li = self._locate(idx)
        return self.datasets[di].get_ann_info(li)


@DATASETS.register_module()
class RepeatDataset:
    """`times` passes over one dataset: index i is the dataset's i % len."""

    def __init__(self, dataset, times, **inherited):
        _drop_inherited('RepeatDataset', inherited)
        self.dataset = _build(dataset)
        self.times = times
        self.CLASSES = self.dataset.CLASSES
        self.flag = np.tile(_flag(self.dataset), times)

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(idx % len(self.dataset))


@DATASETS.register_module()
class ClassBalancedDataset:
    """Oversample images holding rare categories, with LVIS's repeat
    factors: r(I) = max over I's classes c of max(1, sqrt(t / f_c)), f_c the
    share of images that hold c; image I appears ceil(r(I)) times, in
    `indices`."""

    def __init__(self, dataset, oversample_thr=1e-3, **inherited):
        _drop_inherited('ClassBalancedDataset', inherited)
        self.dataset = _build(dataset)
        self.CLASSES = self.dataset.CLASSES
        n = len(self.dataset)
        cat_freq = defaultdict(float)
        img_cats = []
        for i in range(n):
            cats = set(self.dataset.get_ann_info(i)['labels'].tolist())
            img_cats.append(cats)
            for c in cats:
                cat_freq[c] += 1.0 / n
        cat_repeat = {
            c: max(1.0, math.sqrt(oversample_thr / f))
            for c, f in cat_freq.items()
        }
        indices = []
        for i, cats in enumerate(img_cats):
            r = max((cat_repeat[c] for c in cats), default=1.0)
            indices.extend([i] * int(math.ceil(r)))
        self.indices = np.asarray(indices)
        self.flag = _flag(self.dataset)[self.indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(int(self.indices[idx]))
