#!/usr/bin/env python
"""Corruption robustness: evaluate a detector on its test set under each
corruption and severity, and report the mean performance under corruption
(the counterpart of tools/analysis_tools/test_robustness.py).

    python ld_tpu_torch/tools/analysis_tools/test_robustness.py CONFIG \
        [CHECKPOINT] [--corruptions NAME ...] [--severities 1 3 5] \
        [--max-images N] [--out robustness.json] [--device cuda|cpu] \
        [--cfg-options key=value ...]

Each run inserts `Corrupt(corruption, severity)` right after the test
pipeline's first transform (the image load) and goes through
`eval_detector` and the dataset's `evaluate`; the clean run comes last.
The json is {corruption: {severity: {metric: value}}}, severity 0 the clean
run, written after each corruption so that a cut run keeps what it did;
`robustness_eval.py` summarises it. The headline metric is the dataset's
`bbox_mAP` (COCO) or `mAP` / `AP50` (VOC). Runs on the card unless
`--device cpu` is given.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

import numpy as np  # noqa: E402

from ld_tpu_torch import Config  # noqa: E402
from ld_tpu_torch.apis import eval_detector, init_detector  # noqa: E402
from ld_tpu_torch.data import build_dataset  # noqa: E402
from ld_tpu_torch.data.corruptions import CORRUPTIONS  # noqa: E402
from ld_tpu_torch.utils.config import parse_cfg_options  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Corruption robustness')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--corruptions', nargs='+', default=list(CORRUPTIONS),
                   choices=list(CORRUPTIONS))
    p.add_argument('--severities', nargs='+', type=int, default=[1, 3, 5])
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--out', default='robustness.json')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='key=value deep config overrides')
    return p.parse_args(argv)


def headline(metrics):
    """The dataset's headline metric: COCO bbox_mAP, VOC mAP, or AP50."""
    for key in ('bbox_mAP', 'mAP', 'AP50'):
        if key in metrics:
            return metrics[key]
    return next(iter(metrics.values()))


def main(argv=None):
    """Returns dict(results, summary): the json written to `--out`, and
    P (clean), mPC (the mean over corruptions and severities) and rPC."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    model = init_detector(cfg, args.checkpoint, device=args.device)

    def run(extra_transform=None):
        test_cfg = dict(cfg.data['test'])
        if extra_transform is not None:
            pipeline = list(test_cfg['pipeline'])
            pipeline.insert(1, extra_transform)
            test_cfg['pipeline'] = pipeline
        dataset = build_dataset(test_cfg)
        dets = eval_detector(model, dataset,
                             pad_hw=cfg.get('pad_to', (800, 1344)),
                             max_images=args.max_images)
        return {k: float(v) for k, v in dataset.evaluate(dets).items()
                if isinstance(v, (int, float))}

    results = {}
    for corruption in args.corruptions:
        results[corruption] = {0: None}
        for sev in args.severities:
            m = run(dict(type='Corrupt', corruption=corruption,
                         severity=sev))
            results[corruption][sev] = m
            print(f'{corruption} s{sev}: mAP {headline(m):.4f}')
        with open(args.out, 'w') as f:
            json.dump(results, f)
    clean = run()
    for corruption in args.corruptions:
        results[corruption][0] = clean
    corrupted = [headline(results[c][s]) for c in args.corruptions
                 for s in args.severities]
    summary = dict(P=headline(clean), mPC=float(np.mean(corrupted)))
    summary['rPC'] = summary['mPC'] / max(summary['P'], 1e-6)
    print(json.dumps(summary, indent=2))
    with open(args.out, 'w') as f:
        json.dump(results, f)
    return dict(results=results, summary=summary)


if __name__ == '__main__':
    main()
