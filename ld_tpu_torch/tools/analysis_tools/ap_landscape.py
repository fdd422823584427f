#!/usr/bin/env python
"""Paired teacher / student analysis, the AP-landscape study (the
counterpart of tools/analysis_tools/ap_landscape.py; the reference's
AP_landscape/test.py:204-239 and AP_landscape/apis/test.py:68-140).

Runs two detectors in lock-step over the second config's test set and
records, per batch: each FPN level's feature L1 error, each level's
sigmoid-class and bbox output L1 errors, and the Pearson correlation of
the two detectors' level-0 class logits. Runs on the card unless
`--device cpu` is given.

    python ld_tpu_torch/tools/analysis_tools/ap_landscape.py TEACHER_CFG \
        STUDENT_CFG [--checkpoint1 T.pth] [--checkpoint2 S.pth] \
        [--max-images 64] [--out ap_landscape.json]

The tensors are flattened in NCHW where the JAX tool flattens NHWC: the
Pearson correlation is invariant to a permutation applied to both, so the
two tools give the same statistics.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ld_tpu_torch import Config  # noqa: E402
from ld_tpu_torch.apis import init_detector  # noqa: E402
from ld_tpu_torch.data import build_dataloader, build_dataset  # noqa: E402


def pearson(a, b, eps=1e-9):
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() /
                 (torch.sqrt((a**2).sum() * (b**2).sum()) + eps))


def paired(det1, det2, image):
    """Both detectors on one batch: per-level feature, sigmoid-cls and
    bbox L1 errors, and the two level-0 class logit maps."""
    with torch.inference_mode():
        o1, f1 = det1(image, output_features=True)
        o2, f2 = det2(image, output_features=True)
        feat_l1 = [float((a - b).abs().mean()) for a, b in zip(f1, f2)]
        cls_l1 = [float((a.sigmoid() - b.sigmoid()).abs().mean())
                  for a, b in zip(o1[0], o2[0])]
        bbox_l1 = [float((a - b).abs().mean()) for a, b in zip(o1[1], o2[1])]
    return feat_l1, cls_l1, bbox_l1, o1[0][0], o2[0][0]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config1', help='teacher config')
    p.add_argument('config2', help='student config')
    p.add_argument('--checkpoint1', default=None)
    p.add_argument('--checkpoint2', default=None)
    p.add_argument('--max-images', type=int, default=64)
    p.add_argument('--out', default='ap_landscape.json')
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = p.parse_args(argv)

    det1 = init_detector(args.config1, args.checkpoint1, device=args.device)
    det2 = init_detector(args.config2, args.checkpoint2, device=args.device)
    device = next(det1.parameters()).device
    cfg = Config.fromfile(args.config2)
    dataset = build_dataset(cfg.data['test'])
    pad_hw = tuple(cfg.get('pad_to', (800, 1344)))
    loader = build_dataloader(dataset, 1, 1, pad_hw, max_gts=1,
                              shuffle=False)

    stats = {'feat_l1': [], 'cls_l1': [], 'bbox_l1': [], 'pearson': []}
    seen = 0
    for batch in loader:
        image = torch.from_numpy(batch['image']).to(device)
        feat_l1, cls_l1, bbox_l1, t_cls, s_cls = paired(det1, det2, image)
        stats['feat_l1'].append(feat_l1)
        stats['cls_l1'].append(cls_l1)
        stats['bbox_l1'].append(bbox_l1)
        stats['pearson'].append(pearson(t_cls.reshape(-1),
                                        s_cls.reshape(-1)))
        seen += image.shape[0]
        if seen >= args.max_images:
            break

    summary = {
        k: np.asarray(v).mean(axis=0).tolist() for k, v in stats.items()
    }
    print(json.dumps(summary, indent=2))
    with open(args.out, 'w') as f:
        json.dump(dict(per_batch=stats, summary=summary), f)
    print(f'saved {args.out}')
    return dict(per_batch=stats, summary=summary)


if __name__ == '__main__':
    main()
