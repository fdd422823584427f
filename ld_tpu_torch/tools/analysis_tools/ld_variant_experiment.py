#!/usr/bin/env python
"""End-to-end LD experiment for the variant head families (the counterpart
of tools/analysis_tools/ld_variant_experiment.py).

The harness of ld_gain_experiment.py (a teacher trained on drawable
synthetic data and written as a `.pth`, baseline and LD students, the
COCO-protocol evaluator on a held-out split) over the LD head family:
LD-GFL, LD-ATSS, LD-FCOS, LD-Retina and LDv2 (the reference's
mmdet/models/dense_heads/{ld_head,ld_atss,ld_fcos_head,ld_retina,
ld_gflv2}.py). Runs on the card unless `--device cpu` is given.

    python ld_tpu_torch/tools/analysis_tools/ld_variant_experiment.py \
        --family atss --teacher-epochs 120 --teacher-images 192

Miniature scale changes the constants (docs/EXPERIMENTS.md: the
reference's 80-class cls-KD weight 10 collapses 4-class training), so the
recipe has knobs: --kd-weight / --ld-weight / --vlr-weight / --im-weight
and --imitation; --teacher-epochs / --teacher-images set the teacher's
strength (a teacher weaker than the student measurably hurts).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

from ld_tpu_torch import Config  # noqa: E402
from ld_tpu_torch.apis import train_detector  # noqa: E402
from ld_tpu_torch.tools.analysis_tools.ld_gain_experiment import (  # noqa
    NUM_CLASSES, SYNTHETIC_CONFIG, dataset, evaluate, save_teacher)

FL = dict(type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
          loss_weight=1.0)
QFL = dict(type='QualityFocalLoss', use_sigmoid=True, beta=2.0,
           loss_weight=1.0)
QFL_V2 = dict(type='QualityFocalLoss', use_sigmoid=False, beta=2.0,
              loss_weight=1.0)
GIOU = dict(type='GIoULoss', loss_weight=2.0)
DFL = dict(type='DistributionFocalLoss', loss_weight=0.25)
CE_CTR = dict(type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0)
AG_1 = dict(type='AnchorGenerator', ratios=[1.0], octave_base_scale=8,
            scales_per_octave=1, strides=[8, 16, 32, 64, 128])
AG_RETINA = dict(type='AnchorGenerator', octave_base_scale=4,
                 scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                 strides=[8, 16, 32, 64, 128])
ATSS_TRAIN = dict(assigner=dict(type='ATSSAssigner', topk=9),
                  allowed_border=-1, pos_weight=-1)
MAXIOU_TRAIN = dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.5,
                                  neg_iou_thr=0.4, min_pos_iou=0),
                    allowed_border=-1, pos_weight=-1)
HEAD_COMMON = dict(num_classes=NUM_CLASSES, in_channels=256,
                   stacked_convs=4, feat_channels=256)


def kl(weight, T):
    return dict(type='KnowledgeDistillationKLDivLoss', loss_weight=weight,
                T=T)


def family_spec(name, args):
    """(teacher head, LD-student head type, train_cfg, detector extras)."""
    if name == 'gfl':
        teacher = dict(type='GFLHead', anchor_generator=dict(AG_1),
                       loss_cls=dict(QFL), loss_dfl=dict(DFL),
                       loss_bbox=dict(GIOU), reg_max=16)
        student_type = 'LDHead'
        train_cfg, extras = ATSS_TRAIN, {}
    elif name == 'atss':
        teacher = dict(type='ATSSGFLHead', anchor_generator=dict(AG_1),
                       loss_cls=dict(FL), loss_bbox=dict(GIOU),
                       loss_centerness=dict(CE_CTR), reg_max=16)
        student_type = 'LDATSSHead'
        train_cfg, extras = ATSS_TRAIN, {}
    elif name == 'fcos':
        teacher = dict(type='FCOSGFLHead', strides=[8, 16, 32, 64, 128],
                       loss_cls=dict(FL), loss_bbox=dict(GIOU),
                       center_sampling=True, centerness_on_reg=True)
        student_type = 'LDFCOSHead'
        train_cfg, extras = MAXIOU_TRAIN, {}
    elif name == 'retina':
        teacher = dict(type='RetinaGFLHead',
                       anchor_generator=dict(AG_RETINA),
                       loss_cls=dict(FL), loss_bbox=dict(GIOU))
        student_type = 'LDRetinaHead'
        train_cfg, extras = MAXIOU_TRAIN, {}
    elif name == 'ldv2':
        teacher = dict(type='GFocalHead', anchor_generator=dict(AG_1),
                       loss_cls=dict(QFL_V2), loss_dfl=dict(DFL),
                       loss_bbox=dict(GIOU), reg_topk=4, reg_channels=64,
                       add_mean=True, reg_max=16)
        student_type = 'LDv2Head'
        train_cfg = ATSS_TRAIN
        extras = dict(output_feature=args.im_weight > 0)
    else:
        raise ValueError(name)
    return teacher, student_type, train_cfg, extras


def base_cfg(epochs, lr):
    cfg = Config.fromfile(SYNTHETIC_CONFIG)
    cfg['model']['bbox_head']['num_classes'] = NUM_CLASSES
    cfg['model']['pretrained'] = None
    cfg['runner'] = dict(max_epochs=epochs)
    cfg['optimizer'] = dict(type='SGD', lr=lr, momentum=0.9,
                            weight_decay=1e-4)
    cfg['optimizer_config'] = dict(grad_clip=dict(max_norm=35))
    cfg['lr_config'] = dict(warmup_iters=200,
                            step=[int(epochs * 0.75), int(epochs * 0.92)])
    cfg['evaluation'] = dict(interval=0)
    cfg['checkpoint_config'] = dict(interval=10**9)
    cfg['log_config'] = dict(interval=100)
    return cfg


def teacher_cfg(args):
    """The teacher: the family's full-width head, a long schedule."""
    teacher_head, _, train_cfg, _ = family_spec(args.family, args)
    cfg = base_cfg(args.teacher_epochs, args.lr)
    cfg['model']['bbox_head'] = dict(teacher_head, **HEAD_COMMON)
    cfg['model']['train_cfg'] = dict(train_cfg)
    return cfg


def student_cfg(args):
    """The thin student of the family: one stacked conv of 64 channels."""
    teacher_head, _, train_cfg, _ = family_spec(args.family, args)
    slr = args.student_lr if args.student_lr is not None else args.lr
    cfg = base_cfg(args.student_epochs, slr)
    cfg['model']['bbox_head'] = dict(
        teacher_head, **dict(HEAD_COMMON, stacked_convs=1, feat_channels=64))
    cfg['model']['train_cfg'] = dict(train_cfg)
    return cfg


def ld_student_cfg(args, teacher_model, teacher_ckpt):
    """The student with the family's LD head against the teacher
    `teacher_model` (a model dict) with the weights of `teacher_ckpt`."""
    _, student_type, _, extras = family_spec(args.family, args)
    cfg = student_cfg(args)
    model = cfg['model']
    model['type'] = 'KnowledgeDistillationSingleStageDetector'
    model['teacher_config'] = dict(model=dict(teacher_model))
    model['teacher_ckpt'] = teacher_ckpt
    model.update(extras)
    head = model['bbox_head']
    head['type'] = student_type
    head['loss_ld'] = kl(args.ld_weight, 10)
    if args.family in ('gfl', 'ldv2'):
        head['loss_ld_vlr'] = kl(args.vlr_weight, 10)
    # always set: the heads default loss_kd to the reference's 80-class
    # COCO weight 10, which collapses 4-class training
    head['loss_kd'] = kl(args.kd_weight, 2)
    if args.im_weight > 0:
        head['loss_im'] = dict(type='IMLoss', loss_weight=args.im_weight)
        head['imitation_method'] = args.imitation
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--family', default='atss',
                    choices=['gfl', 'atss', 'fcos', 'retina', 'ldv2'])
    ap.add_argument('--out', default=None)
    ap.add_argument('--teacher-epochs', type=int, default=120)
    ap.add_argument('--teacher-images', type=int, default=192,
                    help='teacher-only extra training images (students '
                         'always train on the same 96)')
    ap.add_argument('--student-epochs', type=int, default=16)
    ap.add_argument('--lr', type=float, default=0.01)
    ap.add_argument('--student-lr', type=float, default=None)
    ap.add_argument('--ld-weight', type=float, default=0.25)
    ap.add_argument('--vlr-weight', type=float, default=0.25)
    ap.add_argument('--kd-weight', type=float, default=1.0,
                    help='cls-KD weight; reference uses 10 on 80-class '
                         'COCO, ~20x too strong at 4 classes')
    ap.add_argument('--im-weight', type=float, default=0.0)
    ap.add_argument('--imitation', default='gibox',
                    choices=['fitnet', 'finegrained', 'decouple', 'gibox'])
    ap.add_argument('--skip-baseline', action='store_true')
    ap.add_argument('--reuse-teacher', action='store_true',
                    help='reuse <work>/teacher.pth from a previous run '
                         '(for recipe sweeps without re-training)')
    ap.add_argument('--work-dir', default=None,
                    help='default /tmp/ld_variant_<family>')
    ap.add_argument('--device', default=None,
                    help='cuda (the default) or cpu')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out_path = args.out or f'ld_variant_{args.family}.json'
    work = args.work_dir or f'/tmp/ld_variant_{args.family}'
    student_train = dataset(96, 0)
    teacher_train = dataset(max(96, args.teacher_images), 0)
    val = dataset(32, 1)

    # 1. teacher: full-width head, long schedule, optionally more data
    tcfg = teacher_cfg(args)
    teacher_ckpt = f'{work}/teacher.pth'
    if args.reuse_teacher and os.path.exists(teacher_ckpt):
        t_ap = dict(reused=True)
        print('TEACHER: reusing', teacher_ckpt)
    else:
        t_out = train_detector(tcfg, f'{work}/teacher', dataset=teacher_train,
                               device=args.device)
        t_ap = evaluate(t_out, val)
        print('TEACHER:', t_ap)
        save_teacher(t_out, teacher_ckpt)

    # 2. baseline student
    b_ap = None
    if not args.skip_baseline:
        b_out = train_detector(student_cfg(args), f'{work}/student_base',
                               dataset=student_train, device=args.device)
        b_ap = evaluate(b_out, val)
        print('BASELINE STUDENT:', b_ap)

    # 3. LD student
    l_out = train_detector(ld_student_cfg(args, tcfg['model'], teacher_ckpt),
                           f'{work}/student_ld', dataset=student_train,
                           device=args.device)
    l_ap = evaluate(l_out, val)
    print('LD STUDENT:', l_ap)

    summary = dict(family=args.family, teacher=t_ap, baseline_student=b_ap,
                   ld_student=l_ap,
                   knobs=dict(ld=args.ld_weight, vlr=args.vlr_weight,
                              kd=args.kd_weight, im=args.im_weight,
                              imitation=args.imitation,
                              teacher_epochs=args.teacher_epochs,
                              teacher_images=args.teacher_images))
    if b_ap is not None:
        summary['ld_gain_mAP'] = round(
            l_ap['bbox_mAP'] - b_ap['bbox_mAP'], 4)
    print(json.dumps(summary, indent=2))
    with open(out_path, 'w') as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == '__main__':
    main()
