#!/usr/bin/env python
"""End-to-end LD experiment on drawable synthetic data (the counterpart of
tools/analysis_tools/ld_gain_experiment.py).

Runs the whole distillation pipeline at miniature scale: a GFL-R18 teacher
trained on 96 synthetic images, written as a `.pth`, then a thin student
(1 stacked conv, 64 channels) trained with and without LD against it, both
evaluated with the COCO-protocol evaluator on a held-out 32-image split.
The objects are class-coloured rectangles
(`SyntheticDetectionDataset(draw_boxes=True)`), so the task generalises and
a teacher has knowledge to transfer. Runs on the card unless `--device cpu`
is given.

    python ld_tpu_torch/tools/analysis_tools/ld_gain_experiment.py \
        [--out ld_gain.json] [--teacher-epochs 60] [--student-epochs 16] \
        [--work-dir /tmp/ld_gain] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ld_tpu_torch import Config  # noqa: E402
from ld_tpu_torch.apis import eval_detector, train_detector  # noqa: E402
from ld_tpu_torch.data import SyntheticDetectionDataset  # noqa: E402

HW = (160, 224)
NUM_CLASSES = 4
PIPE = [
    dict(type='Normalize', mean=[123.675, 116.28, 103.53],
         std=[58.395, 57.12, 57.375], to_rgb=True),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels']),
]
SYNTHETIC_CONFIG = os.path.join(ROOT, 'configs/synthetic/gfl_r18_synthetic.py')


def dataset(num_images, seed, hw=HW):
    return SyntheticDetectionDataset(num_images=num_images, hw=hw,
                                     num_classes=NUM_CLASSES, max_boxes=4,
                                     pipeline=PIPE, seed=seed,
                                     draw_boxes=True)


def datasets(hw=HW):
    """The 96 training images (seed 0) and the 32 held-out ones (seed 1)."""
    return dataset(96, 0, hw), dataset(32, 1, hw)


def base_cfg(epochs, lr=0.01):
    cfg = Config.fromfile(SYNTHETIC_CONFIG)
    cfg['model']['bbox_head']['num_classes'] = NUM_CLASSES
    cfg['model']['pretrained'] = None
    cfg['runner'] = dict(max_epochs=epochs)
    cfg['optimizer'] = dict(type='SGD', lr=lr, momentum=0.9,
                            weight_decay=1e-4)
    cfg['lr_config'] = dict(warmup_iters=50,
                            step=[int(epochs * 0.75), int(epochs * 0.92)])
    cfg['evaluation'] = dict(interval=0)
    cfg['checkpoint_config'] = dict(interval=10**9)
    cfg['log_config'] = dict(interval=50)
    return cfg


def student_cfg(epochs):
    """The thin student: one stacked conv of 64 channels."""
    cfg = base_cfg(epochs)
    cfg['model']['bbox_head'].update(stacked_convs=1, feat_channels=64)
    return cfg


def ld_student_cfg(epochs, teacher_model, teacher_ckpt, ld=0.25, vlr=0.25,
                   kd=1.0):
    """The same student with main-region LD, VLR LD and class KD against the
    teacher `teacher_model` (a model dict) with the weights of
    `teacher_ckpt`."""
    cfg = student_cfg(epochs)
    model = cfg['model']
    model['type'] = 'KnowledgeDistillationSingleStageDetector'
    model['teacher_config'] = dict(model=dict(teacher_model))
    model['teacher_ckpt'] = teacher_ckpt
    model['bbox_head'].update(
        type='LDHead',
        loss_ld=dict(type='KnowledgeDistillationKLDivLoss',
                     loss_weight=ld, T=10),
        loss_ld_vlr=dict(type='KnowledgeDistillationKLDivLoss',
                         loss_weight=vlr, T=10),
        # class-KD weight 1, not the reference's COCO weight 10: at 4
        # classes the softmax KD is ~20x stronger a class than at 80, and
        # weight 10 collapses the sigmoid scores (docs/EXPERIMENTS.md)
        loss_kd=dict(type='KnowledgeDistillationKLDivLoss',
                     loss_weight=kd, T=2))
    return cfg


def save_teacher(out, path):
    """A trained detector's weights as a `.pth` that the strict
    `teacher_ckpt` path reads."""
    torch.save(dict(state_dict=out['model'].state_dict()), path)


def evaluate(out, val, hw=HW):
    """COCO-protocol metrics of a `train_detector` result on `val`."""
    res = eval_detector(out['model'], val, pad_hw=hw)
    return {k: float(v) for k, v in val.evaluate(res).items()
            if isinstance(v, (int, float))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default='ld_gain.json')
    ap.add_argument('--teacher-epochs', type=int, default=60)
    ap.add_argument('--student-epochs', type=int, default=16)
    ap.add_argument('--work-dir', default='/tmp/ld_gain')
    ap.add_argument('--device', default=None,
                    help='cuda (the default) or cpu')
    args = ap.parse_args(argv)
    train, val = datasets()
    work = args.work_dir

    # 1. teacher: the full GFL-R18 head, a long schedule
    tcfg = base_cfg(args.teacher_epochs)
    t_out = train_detector(tcfg, f'{work}/teacher', dataset=train,
                           device=args.device)
    t_ap = evaluate(t_out, val)
    print('TEACHER:', t_ap)
    save_teacher(t_out, f'{work}/teacher.pth')

    # 2. baseline student: the thin head, a short schedule
    b_out = train_detector(student_cfg(args.student_epochs),
                           f'{work}/student_base', dataset=train,
                           device=args.device)
    b_ap = evaluate(b_out, val)
    print('BASELINE STUDENT:', b_ap)

    # 3. LD student: the same student with main-region LD, VLR LD, cls KD
    lcfg = ld_student_cfg(args.student_epochs, tcfg['model'],
                          f'{work}/teacher.pth')
    l_out = train_detector(lcfg, f'{work}/student_ld', dataset=train,
                           device=args.device)
    l_ap = evaluate(l_out, val)
    print('LD STUDENT:', l_ap)

    summary = dict(teacher=t_ap, baseline_student=b_ap, ld_student=l_ap,
                   ld_gain_mAP=round(l_ap['bbox_mAP'] - b_ap['bbox_mAP'], 4))
    print(json.dumps(summary, indent=2))
    with open(args.out, 'w') as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == '__main__':
    main()
