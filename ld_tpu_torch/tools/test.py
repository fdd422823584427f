#!/usr/bin/env python
"""Evaluate a detector with ld_tpu_torch (the counterpart of tools/test.py).

    python ld_tpu_torch/tools/test.py CONFIG [CHECKPOINT] [--eval METRIC]
        [--out METRICS.json] [--max-images N] [--fuse-conv-bn]
        [--aug-test [--aug-scales LONG SHORT ...]]
        [--device cuda|cpu] [--launcher none|pytorch]
        [--cfg-options key=value ...]

Builds the model from CONFIG with the weights of CHECKPOINT (an mmdet or
ld_tpu_torch `.pth`, or a JAX `.npz`; without one, random weights from seed
0), runs it over `data.test` and prints `dataset.evaluate(results, metric)`
as JSON; `--out` writes the same JSON to a file. `--aug-test` runs each
image's scales (default (1333, 800)), each with its horizontal flip, and
merges them by one NMS. Runs on the card unless `--device cpu` is given;
without a card it stops with an error. Over N processes, each runs its
share of every batch and rank 0 prints the metrics of all images
(`--aug-test` runs in one process, as the JAX package's):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        ld_tpu_torch/tools/test.py CONFIG CKPT --eval bbox --launcher pytorch
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ld_tpu_torch import Config  # noqa: E402
from ld_tpu_torch.apis import eval_detector, init_detector  # noqa: E402
from ld_tpu_torch.data import build_dataset  # noqa: E402
from ld_tpu_torch.parallel import get_dist_info, init_dist  # noqa: E402
from ld_tpu_torch.utils.config import parse_cfg_options  # noqa: E402

DEFAULT_NORM = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Evaluate a detector')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--eval', default='bbox',
                   help="the dataset's metric: 'bbox' (COCO), 'mAP' or "
                        "'AP50:95' (VOC)")
    p.add_argument('--out', default=None, help='json output for metrics')
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--aug-test', action='store_true',
                   help='multi-scale + flip TTA merged by one NMS')
    p.add_argument('--aug-scales', type=int, nargs='+', default=None,
                   help='flat (long short) x N list, e.g. 1333 640 1333 800')
    p.add_argument('--fuse-conv-bn', action='store_true',
                   help='fold each conv + BN pair (value-identical)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument('--launcher', choices=['none', 'pytorch'], default='none',
                   help="'pytorch': one rank of a torchrun launch")
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='key=value deep config overrides')
    return p.parse_args(argv)


def _aug_test_all(cfg, model, dataset, flat_scales, max_images):
    """Serial per-image TTA over the first `max_images` images; the rest
    get empty results, so that `dataset.evaluate` sees one per image."""
    from ld_tpu_torch.apis.aug_test import aug_test, build_aug_views
    from ld_tpu_torch.apis.inference import _load_img
    if flat_scales:
        scales = [tuple(flat_scales[i:i + 2])
                  for i in range(0, len(flat_scales), 2)]
    else:
        scales = [(1333, 800)]
    norm = DEFAULT_NORM
    for t in cfg.data['test'].get('pipeline', []):
        if 'mean' in t:
            norm = dict(mean=list(t['mean']), std=list(t['std']),
                        to_rgb=t.get('to_rgb', True))
    prefixes = getattr(dataset, 'id_prefixes', None)
    results = []
    n = min(len(dataset), max_images or len(dataset))
    for i in range(n):
        prefix = prefixes[i] if prefixes else getattr(dataset, 'img_prefix',
                                                      '')
        img = _load_img(os.path.join(prefix or '',
                                     dataset.img_infos[i]['filename']))
        views = build_aug_views(img, scales, flip=True, **norm)
        results.append(aug_test(model, views, img.shape[:2]))
    for _ in range(len(dataset) - n):
        results.append(dict(boxes=np.zeros((0, 5), np.float32),
                            labels=np.zeros((0, ), np.int64)))
    return results


def main(argv=None):
    """Returns dict(metrics, results): the printed metrics, and the
    per-image detections they were computed from."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    if args.launcher == 'none':
        return _evaluate(args, cfg, args.device)
    owned = not dist.is_initialized()
    device = init_dist('pytorch', (cfg.get('dist_params') or {}).get(
        'backend'), device=args.device)
    try:
        if args.aug_test and get_dist_info()[1] > 1:
            raise NotImplementedError(
                '--aug-test runs in one process (as the JAX aug_test, on '
                'one device): drop --launcher pytorch')
        return _evaluate(args, cfg, device)
    finally:
        if owned:
            dist.destroy_process_group()


def _evaluate(args, cfg, device):
    rank = get_dist_info()[0]
    model = init_detector(cfg, args.checkpoint, device=device)
    if args.fuse_conv_bn:
        from ld_tpu_torch.utils.fuse_conv_bn import (fuse_conv_bn,
                                                     fuse_conv_bn_cfg_ok)
        if fuse_conv_bn_cfg_ok(cfg.model):
            fuse_conv_bn(model)
        else:
            print('WARNING: --fuse-conv-bn skipped: a ConvWS conv_cfg '
                  'renormalizes its kernel, so the fold would be wrong')
    dataset = build_dataset(cfg.data['test'])
    if args.aug_test:
        results = _aug_test_all(cfg, model, dataset, args.aug_scales,
                                args.max_images)
    else:
        results = eval_detector(model, dataset,
                                pad_hw=cfg.get('pad_to', (800, 1344)),
                                max_images=args.max_images)
    if rank:
        return dict(metrics=None, results=results)
    metrics = dataset.evaluate(results, metric=args.eval)
    print(json.dumps(metrics, indent=2, default=float))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(metrics, f, default=float)
    return dict(metrics=metrics, results=results)


if __name__ == '__main__':
    main()
