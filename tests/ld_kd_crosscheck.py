#!/usr/bin/env python
"""The LD student of the synthetic gain harness, stepped in both packages
from the same weights and the same batches (ROADMAP Queue C 1).

The harness (`ld_tpu_torch/tools/analysis_tools/ld_gain_experiment.py`):
a GFL-R18 teacher, a thin GFL-R18 student (1 stacked conv, width 64), 4
classes, 96 training images at 160x224 in batches of 2, LD 0.25 / VLR 0.25
/ class KD 1. Two modes:

  teacher (the port alone; the card unless --device cpu):
      python tests/ld_kd_crosscheck.py teacher --epochs 60 --out DIR
    trains the harness's teacher with `train_detector` (checkpoints in
    --work-dir, default work_dirs/kd_crosscheck), evaluates it on the
    32 held-out images and writes DIR/teacher_fp16.pth (its state dict in
    float16, to keep the file small; both packages read the same values
    back) and DIR/teacher.json (mAP, seconds).

  compare (both packages, on the CPU):
      JAX_PLATFORMS=cpu python tests/ld_kd_crosscheck.py compare \
          --teacher DIR/teacher_fp16.pth --steps 50 --out FILE.json
    one teacher's weights in both (the port loads the .pth, the JAX package
    takes it through `convert_torch_state_dict`), the same student
    initialisation (JAX init -> `load_from_jax`), the same batches (the
    port's loader, seed 0, in one order), the harness's SGD and warmup, all
    in float32 with no BN fold; then every loss term of every step side by
    side, and the first step and term that differ by more than --rtol, and
    each term's mean over the last two thirds of the steps. With
    --control EPS the other side is the JAX student itself from initial
    weights perturbed by a relative EPS: how fast float32 rounding alone
    parts two runs of one package.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ld_tpu_torch.tools.analysis_tools.ld_gain_experiment import (  # noqa
    HW, base_cfg, dataset, datasets, evaluate, ld_student_cfg)

LD_KEYS = ('loss_cls', 'loss_bbox', 'loss_dfl', 'loss_ld', 'loss_ld_vlr',
           'loss_kd', 'loss_kd_neg', 'loss_im', 'loss')


def train_teacher(args):
    from ld_tpu_torch.apis import train_detector
    os.makedirs(args.out, exist_ok=True)
    train, val = datasets()
    t0 = time.perf_counter()
    out = train_detector(base_cfg(args.epochs), args.work_dir,
                         dataset=train, device=args.device)
    seconds = time.perf_counter() - t0
    metrics = evaluate(out, val)
    sd = {k: (v.half() if v.is_floating_point() else v).cpu()
          for k, v in out['model'].state_dict().items()}
    torch.save(dict(state_dict=sd), os.path.join(args.out,
                                                 'teacher_fp16.pth'))
    info = dict(epochs=args.epochs, seconds=seconds,
                bbox_mAP=metrics.get('bbox_mAP'), device=str(args.device))
    if torch.cuda.is_available() and args.device != 'cpu':
        info['card'] = torch.cuda.get_device_name(0)
    with open(os.path.join(args.out, 'teacher.json'), 'w') as f:
        json.dump(info, f, indent=1)
    print(json.dumps(info))


def _plain(x):
    """A Config tree as plain dicts and lists."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _batches(steps):
    """`steps` batches of the harness's training set from the port's loader
    (seed 0), as numpy arrays, epoch after epoch."""
    from ld_tpu_torch.data.loader import build_dataloader
    loader = build_dataloader(dataset(96, 0), 2, 1, HW, 8, seed=0,
                              num_workers=0)
    out, epoch = [], 0
    while len(out) < steps:
        loader.set_epoch(epoch) if hasattr(loader, 'set_epoch') else None
        for b in loader:
            out.append({k: np.array(v) for k, v in b.items()
                        if k in ('image', 'gt_bboxes', 'gt_labels',
                                 'gt_valid', 'img_hw')})
            if len(out) == steps:
                break
        epoch += 1
    return out, len(loader)


def compare(args):
    import jax
    import jax.numpy as jnp
    import ld_tpu  # noqa: F401 — populates the JAX registries
    from ld_tpu.models import build_detector as j_build_detector
    from ld_tpu.parallel import build_lr_schedule as j_build_lr_schedule
    from ld_tpu.parallel import build_optimizer as j_build_optimizer
    from ld_tpu.parallel import make_train_step as j_make_train_step
    from ld_tpu.parallel.train_step import TrainState
    from ld_tpu.utils.checkpoint import (convert_torch_state_dict,
                                         validate_variables)
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                       make_train_step)
    from ld_tpu_torch.utils.checkpoint import load_from_jax

    torch.set_num_threads(args.threads)
    epochs = 16
    cfg = ld_student_cfg(epochs, base_cfg(1)['model'], None, kd=args.kd)
    model_cfg = _plain(dict(cfg['model']))
    det = j_build_detector(model_cfg)
    shape = (1, ) + HW + (3, )
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        det.init_variables, static_argnums=1)(jax.random.PRNGKey(0), shape))
    t_sd = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in torch.load(args.teacher, map_location='cpu')[
                'state_dict'].items()}
    teacher = convert_torch_state_dict(t_sd)
    assert teacher.pop('_unmapped') == []
    validate_variables(teacher, jax.eval_shape(
        lambda: det.init_teacher_variables(jax.random.PRNGKey(1), shape)))

    model = load_from_jax(build_detector(model_cfg), variables)
    model.teacher.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in t_sd.items()}, strict=True)

    batches, steps_per_epoch = _batches(args.steps)
    lr = cfg['optimizer']['lr']
    opt_cfg = dict(cfg['optimizer'])
    lr_config = dict(cfg['lr_config'])
    j_opt = j_build_optimizer(opt_cfg, j_build_lr_schedule(
        lr, lr_config, steps_per_epoch, epochs), variables['params'],
        frozen_prefixes=det.frozen_param_paths())
    state = TrainState(params=variables['params'],
                       batch_stats=variables['batch_stats'],
                       opt_state=j_opt.init(variables['params']),
                       step=jnp.zeros((), jnp.int32))
    j_step = jax.jit(j_make_train_step(det, j_opt, has_teacher=True))
    optimizer, scheduler = build_optimizer(opt_cfg, build_lr_schedule(
        lr, lr_config, steps_per_epoch, epochs), model)
    step = make_train_step(model, optimizer, scheduler)
    if args.control:
        # the control: the JAX student against itself, its initial weights
        # perturbed by a relative `control` (float32 rounding's size)
        rs = np.random.RandomState(0)
        other = TrainState(
            params=jax.tree_util.tree_map(
                lambda x: jnp.asarray(x * (1 + args.control * rs.randn(
                    *np.shape(x))).astype(np.float32)), state.params),
            batch_stats=state.batch_stats,
            opt_state=j_opt.init(state.params), step=state.step)

        def step(t_batch, j_batch):
            nonlocal other
            other, metrics = j_step(other, j_batch, teacher)
            return metrics

    other_name = 'jax_perturbed' if args.control else 'port'
    rows, first_apart = [], None
    j_sec = t_sec = 0.0
    for i, b in enumerate(batches):
        j_batch = {k: jnp.asarray(v) for k, v in b.items()}
        j_batch['image'] = jnp.asarray(b['image'].transpose(0, 2, 3, 1))
        j_batch['gt_labels'] = j_batch['gt_labels'].astype(jnp.int32)
        t_batch = {k: torch.from_numpy(v) for k, v in b.items()}
        t_batch['gt_labels'] = t_batch['gt_labels'].long()
        t0 = time.perf_counter()
        state, want = j_step(state, j_batch, teacher)
        want = {k: float(v) for k, v in want.items()}
        t1 = time.perf_counter()
        got = {k: float(v) for k, v in (
            step(t_batch, j_batch) if args.control else step(t_batch)
        ).items()}
        t2 = time.perf_counter()
        if i:   # the first JAX step compiles
            j_sec += t1 - t0
        t_sec += t2 - t1
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-7)
               for k in LD_KEYS if k in want}
        worst = max(rel, key=rel.get)
        rows.append(dict(step=i, jax=want, other=got, worst=worst,
                         worst_rel=rel[worst]))
        if first_apart is None and rel[worst] > args.rtol:
            first_apart = dict(step=i, term=worst, rel=rel[worst])
        print(f'step {i:3d} loss jax {want["loss"]:.6f} {other_name} '
              f'{got["loss"]:.6f} kd {want["loss_kd"]:.6f} / '
              f'{got["loss_kd"]:.6f} worst {worst} {rel[worst]:.2e}',
              flush=True)
    tail = rows[len(rows) // 3:]
    result = dict(steps=len(rows), kd=args.kd, rtol=args.rtol,
                  other=other_name, control=args.control,
                  steps_per_epoch=steps_per_epoch, first_apart=first_apart,
                  max_rel=max(r['worst_rel'] for r in rows),
                  # the last two thirds' mean of each loss term
                  mean_tail={side: {k: float(np.mean([r[side][k]
                                                      for r in tail]))
                                    for k in LD_KEYS}
                             for side in ('jax', 'other')},
                  jax_step_seconds=j_sec / max(len(rows) - 1, 1),
                  other_step_seconds=t_sec / len(rows),
                  threads=args.threads, rows=rows)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != 'rows'}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest='mode', required=True)
    t = sub.add_parser('teacher')
    t.add_argument('--epochs', type=int, default=60)
    t.add_argument('--out', default='chiprun_out/kd_crosscheck')
    t.add_argument('--device', default='cuda')
    t.add_argument('--work-dir', default='work_dirs/kd_crosscheck')
    c = sub.add_parser('compare')
    c.add_argument('--teacher', required=True)
    c.add_argument('--steps', type=int, default=50)
    c.add_argument('--kd', type=float, default=1.0)
    c.add_argument('--rtol', type=float, default=1e-3)
    c.add_argument('--threads', type=int, default=4)
    c.add_argument('--control', type=float, default=0.0,
                   help='compare the JAX student with itself from initial '
                        'weights perturbed by this relative size, in '
                        'place of the port')
    c.add_argument('--out', default='kd_crosscheck.json')
    args = ap.parse_args(argv)
    (train_teacher if args.mode == 'teacher' else compare)(args)


if __name__ == '__main__':
    main()
