#!/usr/bin/env python
"""Summarise a corruption-robustness run: P, mPC and rPC a metric (the
counterpart of tools/analysis_tools/robustness_eval.py).

    python ld_tpu_torch/tools/analysis_tools/robustness_eval.py \
        robustness.json [--metric NAME ...] [--prints P mPC rPC] \
        [--aggregate benchmark|all]

Reads the json of `test_robustness.py`, {corruption: {severity: {metric:
value}}} with severity 0 the clean run:
  * P, the clean performance (severity 0 of the first corruption);
  * mPC, the mean over the corruptions and the severities >= 1;
  * rPC = mPC / P.
`--aggregate benchmark` keeps the 15 corruptions of the standard benchmark
that the file has (all of them when it has none of those).
"""
import argparse
import json

import numpy as np

BENCHMARK_CORRUPTIONS = [
    'gaussian_noise', 'shot_noise', 'impulse_noise', 'defocus_blur',
    'glass_blur', 'motion_blur', 'zoom_blur', 'snow', 'frost', 'fog',
    'brightness', 'contrast', 'elastic_transform', 'pixelate',
    'jpeg_compression',
]


def summarize(eval_output, metrics=None, aggregate='benchmark'):
    """(metrics, P, mPC, rPC) of a `test_robustness.py` json, the three as
    float32 arrays over `metrics` (default: the clean run's, sorted)."""
    corruptions = list(eval_output)
    if aggregate == 'benchmark':
        corruptions = [c for c in corruptions
                       if c in BENCHMARK_CORRUPTIONS] or corruptions
    first = next(iter(eval_output.values()))
    clean = first.get('0') or first.get(0)
    if metrics is None:
        metrics = sorted(clean)
    p = np.array([clean[m] for m in metrics], np.float32)
    rows = [[sev_metrics[m] for m in metrics]
            for c in corruptions
            for sev, sev_metrics in eval_output[c].items()
            if int(sev) >= 1]
    mpc = np.asarray(rows, np.float32).mean(axis=0)
    rpc = mpc / np.maximum(p, 1e-6)
    return metrics, p, mpc, rpc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('filename', help='json of test_robustness.py')
    ap.add_argument('--metric', nargs='+', default=None)
    ap.add_argument('--prints', nargs='+', default=['P', 'mPC', 'rPC'],
                    choices=['P', 'mPC', 'rPC'])
    ap.add_argument('--aggregate', default='benchmark',
                    choices=['benchmark', 'all'])
    args = ap.parse_args(argv)
    with open(args.filename) as f:
        eval_output = json.load(f)
    metrics, p, mpc, rpc = summarize(eval_output, args.metric,
                                     args.aggregate)
    print(f'model: {args.filename}')
    if 'P' in args.prints:
        print('Performance on Clean Data [P]')
        for m, v in zip(metrics, p):
            print(f'  {m:20} = {v:0.3f}')
    if 'mPC' in args.prints:
        print('Mean Performance under Corruption [mPC]')
        for m, v in zip(metrics, mpc):
            print(f'  {m:20} = {v:0.3f}')
    if 'rPC' in args.prints:
        print('Relative Performance under Corruption [rPC]')
        for m, v in zip(metrics, rpc):
            print(f'  {m:20} = {v * 100:0.1f} %')
    return dict(metrics=metrics, P=p, mPC=mpc, rPC=rpc)


if __name__ == '__main__':
    main()
