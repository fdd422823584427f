#!/usr/bin/env python
"""Train a detector with ld_tpu_torch (the counterpart of tools/train.py).

    python ld_tpu_torch/tools/train.py CONFIG [--work-dir DIR]
        [--resume-from DIR_OR_PTH] [--seed N] [--max-steps N]
        [--device cuda|cpu] [--launcher none|pytorch]
        [--cfg-options key=value ...]

Runs on the card unless `--device cpu` is given; without a card it stops
with an error. The merged config is written to `<work-dir>/config_dump.py`.
Data parallel over N processes, one a card (the config's samples_per_gpu
images each; NCCL):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        ld_tpu_torch/tools/train.py CONFIG --launcher pytorch

Ranks that share a card (or the CPU) need gloo:
`--cfg-options dist_params.backend=gloo`.
"""
import argparse
import os
import sys

import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from ld_tpu_torch import Config  # noqa: E402
from ld_tpu_torch.apis import train_detector  # noqa: E402
from ld_tpu_torch.utils.config import parse_cfg_options  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a detector')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume-from', default=None)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--max-steps', type=int, default=None,
                   help='stop after N optimizer steps (smoke runs)')
    p.add_argument('--device', default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument('--launcher', choices=['none', 'pytorch'], default='none',
                   help="'pytorch': one rank of a torchrun launch")
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='key=value deep config overrides')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    if args.seed is not None:
        cfg['seed'] = args.seed
    if args.resume_from:
        cfg['resume_from'] = args.resume_from
    work_dir = args.work_dir or os.path.join(
        'work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    if args.launcher == 'none' or int(os.environ.get('RANK', 0)) == 0:
        cfg.dump(os.path.join(work_dir, 'config_dump.py'))
    owned = args.launcher == 'pytorch' and not dist.is_initialized()
    try:
        return train_detector(cfg, work_dir, max_steps=args.max_steps,
                              device=args.device, launcher=args.launcher)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
