#!/usr/bin/env python
"""The AP-parity runbook on ld_tpu_torch: one command per published row of
the LD paper's tables (the counterpart of tools/ap_parity_runbook.py, with
the same rows).

    python ld_tpu_torch/tools/ap_parity_runbook.py --list-rows

Real runs (mounted data and published .pth checkpoints; on the card unless
--device cpu):

    # zero-train rows: load a published checkpoint and evaluate it
    python ld_tpu_torch/tools/ap_parity_runbook.py --row gfl_r50_1x \\
        --coco-root /data/coco --ckpt ckpts/gfl_r50_fpn_1x.pth
    # LD rows: train against the published teacher, then evaluate
    python ld_tpu_torch/tools/ap_parity_runbook.py --row ld_r18_voc \\
        --voc-root /data/VOCdevkit --teacher-pth ckpts/gfl_r101_voc.pth

Dry runs (no data, no checkpoints):

    python ld_tpu_torch/tools/ap_parity_runbook.py --dry-run \\
        [--row NAME ...] [--convert-only] [--device cpu]

synthesize, for each row, a random state dict with the keys and shapes of
the published mmdet checkpoint (the student's for a zero-train row, the
teacher's for an LD row) and load it strictly into the model the row's
config builds; then, unless --convert-only, run the row's path: a VOC row
through its own config's data over a seeded synthetic VOC devkit (an
evaluation at AP50:95, or one LD step), a COCO row over two (eval) or eight
(one LD step) synthetic images. A row whose model is not ported yet raises
NotImplementedError naming its ROADMAP.md item (a dry run over several
rows reports it and goes on).
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

RESNET_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3)}
BASIC = {18, 34}


def synth_mmdet_gfl_state_dict(depth=50, num_classes=80, feat=256,
                               stacked=4, reg_max=16,
                               stage_with_dcn=(False, False, False, False),
                               gflv2=False, reg_topk=4, reg_channels=64,
                               groups=1, base_width=64, seed=0):
    """A random state dict with exactly the keys and shapes of a published
    mmdet GFL / GFocalV2 checkpoint: BasicBlock for R18/R34, Bottleneck
    otherwise, the grouped ResNeXt Bottleneck when groups > 1 (width =
    planes * base_width / 64 * groups); optional DCN `conv_offset` keys;
    optional GFLv2 DGQP `reg_conf` branch."""
    rs = np.random.RandomState(seed)

    def t(*shape):
        return (rs.randn(*shape) * 0.05).astype(np.float32)

    sd = {}

    def bn(prefix, c):
        sd[f'{prefix}.weight'] = np.abs(t(c)) + 0.5
        sd[f'{prefix}.bias'] = t(c)
        sd[f'{prefix}.running_mean'] = t(c)
        sd[f'{prefix}.running_var'] = np.abs(t(c)) + 0.5
        sd[f'{prefix}.num_batches_tracked'] = np.int64(1000)

    sd['backbone.conv1.weight'] = t(64, 3, 7, 7)
    bn('backbone.bn1', 64)
    in_ch = 64
    basic = depth in BASIC
    for s, nblocks in enumerate(RESNET_BLOCKS[depth], start=1):
        planes = 64 * 2 ** (s - 1)
        out_ch = planes if basic else planes * 4
        width = planes if groups == 1 else \
            int(planes * (base_width / 64.0)) * groups
        for b in range(nblocks):
            p = f'backbone.layer{s}.{b}'
            if basic:
                sd[f'{p}.conv1.weight'] = t(planes, in_ch, 3, 3)
                bn(f'{p}.bn1', planes)
                sd[f'{p}.conv2.weight'] = t(planes, planes, 3, 3)
                if stage_with_dcn[s - 1]:
                    sd[f'{p}.conv2.conv_offset.weight'] = t(27, planes, 3, 3)
                    sd[f'{p}.conv2.conv_offset.bias'] = t(27)
                bn(f'{p}.bn2', planes)
            else:
                sd[f'{p}.conv1.weight'] = t(width, in_ch, 1, 1)
                bn(f'{p}.bn1', width)
                sd[f'{p}.conv2.weight'] = t(width, width // groups, 3, 3)
                if stage_with_dcn[s - 1]:
                    sd[f'{p}.conv2.conv_offset.weight'] = t(27, width, 3, 3)
                    sd[f'{p}.conv2.conv_offset.bias'] = t(27)
                bn(f'{p}.bn2', width)
                sd[f'{p}.conv3.weight'] = t(planes * 4, width, 1, 1)
                bn(f'{p}.bn3', planes * 4)
            if b == 0 and (s > 1 or not basic):
                sd[f'{p}.downsample.0.weight'] = t(out_ch, in_ch, 1, 1)
                bn(f'{p}.downsample.1', out_ch)
            in_ch = out_ch
    fpn_in = [in_ch // 4, in_ch // 2, in_ch]
    for i, c in enumerate(fpn_in):                   # start_level=1
        sd[f'neck.lateral_convs.{i}.conv.weight'] = t(feat, c, 1, 1)
        sd[f'neck.lateral_convs.{i}.conv.bias'] = t(feat)
    for i in range(5):                               # 3 + 2 on_output
        sd[f'neck.fpn_convs.{i}.conv.weight'] = t(feat, feat, 3, 3)
        sd[f'neck.fpn_convs.{i}.conv.bias'] = t(feat)
    for kind in ('cls', 'reg'):
        for i in range(stacked):
            sd[f'bbox_head.{kind}_convs.{i}.conv.weight'] = t(
                feat, feat, 3, 3)
            sd[f'bbox_head.{kind}_convs.{i}.gn.weight'] = np.ones(
                feat, np.float32)
            sd[f'bbox_head.{kind}_convs.{i}.gn.bias'] = t(feat)
    sd['bbox_head.gfl_cls.weight'] = t(num_classes, feat, 3, 3)
    sd['bbox_head.gfl_cls.bias'] = np.full(num_classes, -4.595,
                                           np.float32)
    sd['bbox_head.gfl_reg.weight'] = t(4 * (reg_max + 1), feat, 3, 3)
    sd['bbox_head.gfl_reg.bias'] = t(4 * (reg_max + 1))
    if gflv2:
        total_dim = reg_topk + 1                     # add_mean=True
        sd['bbox_head.reg_conf.0.weight'] = t(reg_channels, 4 * total_dim,
                                              1, 1)
        sd['bbox_head.reg_conf.0.bias'] = t(reg_channels)
        sd['bbox_head.reg_conf.2.weight'] = t(1, reg_channels, 1, 1)
        sd['bbox_head.reg_conf.2.bias'] = t(1)
    for i in range(5):
        sd[f'bbox_head.scales.{i}.scale'] = np.float32(1.0)
    return sd


class Row:
    """One published row: what to run and what AP to expect."""

    def __init__(self, config, expect_ap, kind='zero', dataset='coco',
                 student=None, teacher=None, source=''):
        self.config = config
        self.expect_ap = expect_ap
        self.kind = kind            # 'zero' (load + eval) | 'train' (LD)
        self.dataset = dataset      # 'coco' | 'voc'
        self.student = student or {}   # synth spec for zero rows
        self.teacher = teacher          # synth spec for train rows
        self.source = source            # the paper's README line


ROWS = {
    # ---- COCO zero-train baselines (README.md:130-136) ----
    'gfl_r18_1x': Row('configs/gfl/gfl_r18_fpn_1x_coco.py', 35.8,
                      student=dict(depth=18), source='README.md:130'),
    'gfl_r34_1x': Row('configs/gfl/gfl_r34_fpn_1x_coco.py', 38.9,
                      student=dict(depth=34), source='README.md:132'),
    'gfl_r50_1x': Row('configs/gfl/gfl_r50_fpn_1x_coco.py', 40.1,
                      student=dict(depth=50), source='README.md:134'),
    'gfl_r101_2x': Row('configs/gfl/gfl_r101_fpn_mstrain_2x_coco.py', 44.6,
                       student=dict(depth=101), source='README.md:136'),
    # ---- COCO LD training rows (README.md:131-163, 249-259) ----
    'ld_r18_1x': Row('configs/ld/ld_r18_gflv1_r101_fpn_coco_1x.py', 36.5,
                     kind='train', teacher=dict(depth=101),
                     source='README.md:131 (37.5 with VLR+KD, :249)'),
    'ld_r34_1x': Row('configs/ld/ld_r34_gflv1_r101_fpn_coco_1x.py', 39.8,
                     kind='train', teacher=dict(depth=101),
                     source='README.md:133 (41.0 with VLR+KD, :251)'),
    'ld_r50_1x': Row('configs/ld/ld_r50_gflv1_r101_fpn_coco_1x.py', 42.1,
                     kind='train', teacher=dict(depth=101),
                     source='README.md:163 (the headline row)'),
    'ld_r50_gi_1x': Row('configs/ld/ld_r50_gflv1_r101_fpn_coco_1x_gi.py',
                        42.4, kind='train', teacher=dict(depth=101),
                        source='README.md:255 (+GI)'),
    'ld_r50_self_1x': Row('configs/ld/ld_r50_self_fpn_coco_1x.py', 40.6,
                          kind='train', teacher=dict(depth=50),
                          source='README.md:147 (self-LD R50)'),
    'ldv2_r50_1x': Row('configs/ldv2/ld_r50_gflv2_r101_fpn_1x.py', 42.7,
                       kind='train', teacher=dict(depth=101, gflv2=True),
                       source='README.md:259 (GFLV2 student)'),
    'ld_r101_dcn_2x': Row('configs/ld/ld_r101_gflv1_r101dcn_fpn_coco_2x.py',
                          45.4, kind='train',
                          teacher=dict(depth=101, stage_with_dcn=(
                              False, True, True, True)),
                          source='README.md:137 (R101-DCN->R101 2x)'),
    # ---- VOC 4-epoch recipe (README.md:177-184; AP = COCO-style 50:95,
    #      VOC mAP averaged over the IoU thresholds 0.50:0.95) ----
    'gfl_r18_voc': Row('configs/gfl/gfl_r18_fpn1x_voc.py', 51.8,
                       dataset='voc', student=dict(depth=18,
                                                   num_classes=20),
                       source='README.md:177'),
    'ld_r18_voc': Row('configs/ld/ld_r18_gflv1_r101_fpn_voc_1x.py', 53.0,
                      kind='train', dataset='voc',
                      teacher=dict(depth=101, num_classes=20),
                      source='README.md:178 (54.0 with VLR KD, :238)'),
    # ---- self-LD rows (README.md:144, :148) ----
    'ld_r18_self_1x': Row('configs/ld/ld_r18_self_fpn_coco_1x.py', 36.1,
                          kind='train', teacher=dict(depth=18),
                          source='README.md:144 (self-LD R18)'),
    'ld_x101_dcn_self_2x': Row(
        'configs/ld/ld_x101_32x4d_dcn_self_2x_coco.py', 47.5, kind='train',
        teacher=dict(depth=101, groups=32, base_width=4,
                     stage_with_dcn=(False, False, True, True)),
        source='README.md:148 (self-LD X-101-32x4d-DCN)'),
    # ---- imitation-ablation arms (README.md:157-161; R-101 -> R-50) ----
    'im_fitnets_r50': Row('configs/im/im_r101_r50_fitnets_1x.py', 40.7,
                          kind='train', teacher=dict(depth=101),
                          source='README.md:158 (FitNets)'),
    'im_inside_gt_r50': Row('configs/im/im_r101_r50_inside_gt_1x.py', 40.7,
                            kind='train', teacher=dict(depth=101),
                            source='README.md:159 (Inside GT Box)'),
    'im_finegrained_r50': Row('configs/im/im_r101_r50_finegrained_1x.py',
                              41.1, kind='train', teacher=dict(depth=101),
                              source='README.md:160 (Fine-Grained)'),
    'im_defeat_r50': Row('configs/im/im_r101_r50_defeat_1x.py', 40.8,
                         kind='train', teacher=dict(depth=101),
                         source='README.md:161 (DeFeat)'),
    # ---- remaining VOC rows (README.md:179-184) ----
    'gfl_r50_voc': Row('configs/gfl/gfl_r50_fpn1x_voc.py', 55.8,
                       dataset='voc', student=dict(depth=50,
                                                   num_classes=20),
                       source='README.md:179'),
    'ld_r50_voc': Row('configs/ld/ld_r50_gflv1_r101_fpn_voc_1x.py', 56.1,
                      kind='train', dataset='voc',
                      teacher=dict(depth=101, num_classes=20),
                      source='README.md:180 (R101->R50 VOC)'),
    'ld_r34_dcn_voc': Row('configs/ld/ld_r34_gflv1_r101dcn_fpn_voc_1x.py',
                          56.7, kind='train', dataset='voc',
                          teacher=dict(depth=101, num_classes=20,
                                       stage_with_dcn=(False, True, True,
                                                       True)),
                          source='README.md:182 (R101-DCN->R34 VOC)'),
    'ld_r101_dcn_voc': Row('configs/ld/ld_r101_gflv1_r101dcn_fpn_voc_1x.py',
                           58.4, kind='train', dataset='voc',
                           teacher=dict(depth=101, num_classes=20,
                                        stage_with_dcn=(False, True, True,
                                                        True)),
                           source='README.md:184 (R101-DCN->R101 VOC)'),
}
# Not covered: the test-dev rows (leaderboard submissions, not reproducible
# locally).


def _apply_data_root(cfg, dataset, root):
    """Point the config's data at a COCO root (annotations/, train2017/,
    val2017/) or a VOCdevkit root (in place of its data/VOCdevkit)."""
    if dataset == 'coco':
        for split in ('train', 'val', 'test'):
            d = cfg.data[split]
            name = 'train2017' if split == 'train' else 'val2017'
            d['ann_file'] = os.path.join(
                root, f'annotations/instances_{name}.json')
            d['img_prefix'] = os.path.join(root, name) + '/'
        return

    def rewrite(d):
        for key in ('ann_file', 'img_prefix'):
            v = d.get(key)
            if isinstance(v, (list, tuple)):
                d[key] = [x.replace('data/VOCdevkit', root) for x in v]
            elif isinstance(v, str):
                d[key] = v.replace('data/VOCdevkit', root)
        if 'dataset' in d:                           # RepeatDataset
            rewrite(d['dataset'])
    for split in ('train', 'val', 'test'):
        rewrite(cfg.data[split])


def run_zero_train_eval(config, ckpt, dataset='coco', data_root=None,
                        max_images=None, device=None):
    """Load `ckpt` into the row's model and evaluate it: AP50:95 on VOC,
    'bbox' on COCO."""
    from ld_tpu_torch import Config
    from ld_tpu_torch.apis import eval_detector, init_detector
    from ld_tpu_torch.data import build_dataset
    cfg = Config.fromfile(config)
    if data_root:
        _apply_data_root(cfg, dataset, data_root)
    model = init_detector(cfg, ckpt, device=device)
    ds = build_dataset(cfg.data['test'])
    results = eval_detector(model, ds, pad_hw=cfg.get('pad_to', (800, 1344)),
                            max_images=max_images)
    return ds.evaluate(results,
                       metric='AP50:95' if dataset == 'voc' else 'bbox')


def run_ld_train(config, teacher_pth, work_dir, dataset='coco',
                 data_root=None, max_steps=None, device=None):
    """Train an LD row against `teacher_pth`; returns the path of the
    student's final weights."""
    import torch

    from ld_tpu_torch import Config
    from ld_tpu_torch.apis import train_detector
    cfg = Config.fromfile(config)
    if data_root:
        _apply_data_root(cfg, dataset, data_root)
    cfg['teacher_ckpt'] = teacher_pth
    cfg.model['teacher_ckpt'] = teacher_pth
    ret = train_detector(cfg, work_dir, max_steps=max_steps, device=device)
    final = os.path.join(work_dir, 'ld_final.pth')
    torch.save(dict(state_dict=ret['model'].state_dict()), final)
    return final


def _validate_synth(config, sd, what, teacher=False):
    """Load the synthesized `sd` strictly into the model (or teacher) that
    the row's config builds."""
    import torch

    from ld_tpu_torch import Config
    from ld_tpu_torch.models import build_detector
    model = build_detector(Config.fromfile(config).model)
    target = model.teacher if teacher else model
    target.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in sd.items()}, strict=True)
    n = sum(np.asarray(v).size for v in sd.values())
    print(f'[dry-run] {what}: strict load OK ({n / 1e6:.1f}M values)')


def _save_pth(sd, path):
    import torch
    torch.save({'state_dict': {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)


def _synth_pipeline():
    return [dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                 std=[58.395, 57.12, 57.375], to_rgb=True),
            dict(type='Pad', size_divisor=32),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]


def _voc_devkit(work_dir):
    """A small seeded VOC devkit (07+12 trainval, 07 test) for dry runs."""
    from ld_tpu_torch.testing import write_voc_devkit
    root = os.path.join(work_dir, 'VOCdevkit')
    write_voc_devkit(root, {'VOC2007': {'trainval': 1, 'test': 1},
                            'VOC2012': {'trainval': 1}})
    return root


def dry_run_row(name, row, work_dir, convert_only=False, device=None):
    """Synthesize this row's checkpoint, load it strictly, then run the
    row's own path (an evaluation, or one LD step) on synthetic data."""
    from ld_tpu_torch import Config
    os.makedirs(work_dir, exist_ok=True)
    print(f'=== [dry-run] row {name} ({row.source}) ===')
    if row.kind == 'zero':
        sd = synth_mmdet_gfl_state_dict(seed=0, **row.student)
        _validate_synth(row.config, sd, f'{name}: synth student ckpt')
        if convert_only:
            return
        pth = os.path.join(work_dir, f'synth_{name}.pth')
        _save_pth(sd, pth)
        if row.dataset == 'voc':
            metrics = run_zero_train_eval(row.config, pth, 'voc',
                                          _voc_devkit(work_dir),
                                          device=device)
        else:
            from ld_tpu_torch.apis import eval_detector, init_detector
            from ld_tpu_torch.data import build_dataset
            model = init_detector(row.config, pth, device=device)
            ds = build_dataset(dict(
                type='SyntheticDetectionDataset', num_images=2,
                hw=(160, 224), num_classes=row.student.get('num_classes', 80),
                pipeline=_synth_pipeline()[:2] + [
                    dict(type='Collect', keys=['img'])]))
            metrics = ds.evaluate(eval_detector(model, ds,
                                                pad_hw=(160, 224)))
        shown = {k: round(float(v), 3) for k, v in list(metrics.items())[:2]}
        print(f'[dry-run] {name}: zero-train eval on synthetic data OK '
              f'({shown})')
        return
    sd_t = synth_mmdet_gfl_state_dict(seed=1, **row.teacher)
    _validate_synth(row.config, sd_t, f'{name}: synth teacher ckpt',
                    teacher=True)
    if convert_only:
        return
    pth = os.path.join(work_dir, f'synth_{name}_teacher.pth')
    _save_pth(sd_t, pth)
    if row.dataset == 'voc':
        run_ld_train(row.config, pth, os.path.join(work_dir, f'dry_{name}'),
                     'voc', _voc_devkit(work_dir), max_steps=1,
                     device=device)
    else:
        from ld_tpu_torch.apis import train_detector
        cfg = Config.fromfile(row.config)
        cfg.model['teacher_ckpt'] = pth
        cfg['pad_to'] = (160, 224)
        cfg['max_gts_per_image'] = 8
        cfg.data['train'] = dict(
            type='SyntheticDetectionDataset', num_images=8, hw=(160, 224),
            num_classes=row.teacher.get('num_classes', 80),
            pipeline=_synth_pipeline())
        cfg.data['samples_per_gpu'] = 1
        cfg.pop('batch_scales', None)
        train_detector(cfg, os.path.join(work_dir, f'dry_{name}'),
                       max_steps=1, device=device)
    print(f'[dry-run] {name}: one LD step with the synthesized teacher OK')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--dry-run', action='store_true')
    p.add_argument('--list-rows', action='store_true')
    p.add_argument('--row', action='append', default=None,
                   help='row name(s) from ROWS; default: all (dry run) / '
                        'required (real run)')
    p.add_argument('--convert-only', action='store_true',
                   help='dry run: stop after the strict load')
    p.add_argument('--coco-root', default=None)
    p.add_argument('--voc-root', default=None)
    p.add_argument('--ckpt', default=None,
                   help='published .pth for a zero-train row')
    p.add_argument('--teacher-pth', default=None,
                   help='published teacher .pth for a train row')
    p.add_argument('--work-dir', default='work_dirs/ap_parity')
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--device', default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the summary of a real run, or {row: error} of the rows a dry
    run found not ported."""
    args = parse_args(argv)
    if args.list_rows:
        for name, row in ROWS.items():
            print(f'{name:20s} {row.kind:5s} {row.dataset:4s} '
                  f'AP {row.expect_ap:4.1f}  {row.config}  [{row.source}]')
        return {}
    names = args.row or list(ROWS)
    unknown = [n for n in names if n not in ROWS]
    if unknown:
        raise SystemExit(f'unknown rows {unknown}; see --list-rows')

    if args.dry_run:
        not_ported = {}
        for n in names:
            try:
                dry_run_row(n, ROWS[n], args.work_dir,
                            convert_only=args.convert_only,
                            device=args.device)
            except NotImplementedError as e:
                print(f'[dry-run] {n}: NOT PORTED: {e}')
                not_ported[n] = str(e)
        print(f'[dry-run] {len(names) - len(not_ported)} of {len(names)} '
              'rows turn-key up to the data mount'
              + (f'; not ported yet: {sorted(not_ported)}'
                 if not_ported else ''))
        return not_ported

    if not args.row:
        raise SystemExit('real runs need explicit --row NAME')
    os.makedirs(args.work_dir, exist_ok=True)
    summary = {}
    for n in names:
        row = ROWS[n]
        root = args.coco_root if row.dataset == 'coco' else args.voc_root
        if not root:
            raise SystemExit(f'row {n} needs --{row.dataset}-root')
        if row.kind == 'zero':
            if not args.ckpt:
                raise SystemExit(f'zero-train row {n} needs --ckpt')
            ckpt = args.ckpt
        else:
            if not args.teacher_pth:
                raise SystemExit(f'train row {n} needs --teacher-pth')
            ckpt = run_ld_train(row.config, args.teacher_pth,
                                os.path.join(args.work_dir, n), row.dataset,
                                root, max_steps=args.max_steps,
                                device=args.device)
        m = run_zero_train_eval(row.config, ckpt, row.dataset, root,
                                args.max_images, device=args.device)
        key = 'mAP' if 'mAP' in m else 'bbox_mAP'
        print(f'ROW {n}: AP = {m[key] * 100:.1f} '
              f'(reference {row.expect_ap}, {row.source})')
        summary[n] = dict(metrics=m, expected=row.expect_ap)
    out = os.path.join(args.work_dir, 'ap_parity_summary.json')
    with open(out, 'w') as f:
        json.dump(summary, f, indent=2, default=float)
    print(f'summary -> {out}')
    return summary


if __name__ == '__main__':
    main()
