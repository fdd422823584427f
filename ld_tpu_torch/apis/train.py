"""Training API: from a config to a trained detector on one device or over
the ranks of a process group (port of `ld_tpu/apis/train.py:34-384`).

`train_detector` builds the dataset, the loader (with a DevicePrefetcher
to the card), the detector, its teacher, the SGD optimizer and schedule,
then runs whole epochs of `make_train_step` with the runtime's hooks:
log lines to `log.json` and `train.log`, a non-finite-loss guard, a
checkpoint at each `checkpoint_config.interval` epochs and a final one,
evaluation with `save_best`, SIGTERM preemption and exact mid-epoch resume.

Data parallel (`launcher='pytorch'` under torchrun, or a process group
already up): each of R ranks takes its b images of every global batch
(the JAX package's 'data' mesh axis), and the step is the one-process
step over the R x b images (`parallel/train_step.py`). Rank 0 alone writes
logs, TensorBoard and checkpoints, from the unwrapped model, and a barrier
follows each write. Every rank augments from numpy seeded seed + rank;
the batch order is the sampler's, seed + epoch on every rank. A SIGTERM
to any rank checkpoints every rank at the same step, and the non-finite
guard reads the ranks' mean metrics, so no rank decides alone. The eval
hook runs on every rank; rank 0 scores, and its metrics reach the others.
The JAX package's mesh flavours (sp, tp, fsdp) and remat are not ported.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from ld_tpu_torch.apis.inference import resolve_device
from ld_tpu_torch.data import (DevicePrefetcher, build_dataloader,
                               build_dataset)
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.parallel import (all_reduce_host, barrier,
                                   broadcast_object, build_lr_schedule,
                                   build_optimizer, get_dist_info, init_dist,
                                   make_train_step)
from ld_tpu_torch.utils.checkpoint import (load_checkpoint, load_train_state,
                                           merge_state_dict, read_state_dict,
                                           save_checkpoint)
from ld_tpu_torch.utils.logging import close_file_handler, get_root_logger


def set_random_seed(seed: int) -> torch.Generator:
    """Seed numpy's global generator (the host-side augmentation draws) and
    torch's; returns a generator seeded with `seed` for the weights."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def _check_ported(cfg):
    for key in ('sp', 'tp'):
        if int(cfg.get(key) or 1) > 1:
            raise NotImplementedError(f'{key}={cfg.get(key)}: spatial and '
                                      'tensor parallelism are not ported to '
                                      'ld_tpu_torch yet (see ROADMAP.md)')
    for key in ('fsdp', 'remat'):
        if cfg.get(key):
            raise NotImplementedError(f'{key}=True is not ported to '
                                      'ld_tpu_torch yet (see ROADMAP.md)')


def _check_frozen_bn(model, world: int):
    """Under pjit, a BN in train mode takes the global batch's statistics
    (SyncBN); the port's ranks would each take their own. No LD / GFL
    config trains a BN: such a model raises at R > 1."""
    if world == 1:
        return
    model.train()
    live = [n for n, m in model.named_modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            and m.training]
    if live:
        raise NotImplementedError(
            f'{len(live)} BatchNorm layer(s) train their statistics (e.g. '
            f'{live[0]}: norm_eval=False or SyncBN): global-batch BN over '
            f'{world} ranks is not ported (see ROADMAP.md, A7)')


def _load_teacher(model, logger):
    """The teacher from `teacher_ckpt` (strict), else a warning and random
    weights from generator seed 1."""
    ckpt = getattr(model, 'teacher_ckpt', None)
    if ckpt and os.path.exists(str(ckpt)):
        logger.info(f'loading teacher checkpoint {ckpt}')
        load_checkpoint(model.teacher, str(ckpt))
        return
    logger.warning(f'teacher checkpoint missing ({ckpt}): random-init '
                   'teacher; distillation targets are untrained!')
    model.init_teacher_weights(torch.Generator().manual_seed(1))


def _load_from(model, src, logger):
    """mmcv's load_checkpoint(strict=False): weights only, leaves that are
    missing or of another shape keep their init; optimizer and step start
    fresh (fine-tuning)."""
    logger.info(f'loading weights from {src}')
    loaded, skipped = merge_state_dict(model, read_state_dict(
        src, model.state_dict().keys()))
    if skipped:
        logger.warning(f'load_from: {len(skipped)} checkpoint entries '
                       'skipped (missing or shape-mismatched in the model; '
                       f'first few: {skipped[:5]})')
    logger.info(f'load_from: {len(loaded)} entries loaded')


def _save_weights(path, model, **meta):
    torch.save(dict(state_dict=model.state_dict(), meta=meta), path)


def train_detector(cfg, work_dir: str, dataset=None,
                   max_steps: Optional[int] = None,
                   eval_interval_epochs: Optional[int] = None,
                   log_interval: Optional[int] = None,
                   device=None, launcher: Optional[str] = None) -> Dict:
    """Run the training `cfg` describes on `device` (default: the card;
    without one this raises, unless device='cpu'). launcher='pytorch'
    joins torchrun's process group first (`cfg.dist_params.backend`;
    `parallel.dist.init_dist`) and trains on this rank's card; a process
    group already up is used as it is. Returns dict(model, optimizer,
    scheduler, schedule, step, steps_per_epoch, metrics (the last logged),
    preempted, diverged); the model is the unwrapped student."""
    if launcher not in (None, 'none', 'pytorch'):
        raise ValueError(f"launcher {launcher!r}: 'none' or 'pytorch'")
    if launcher == 'pytorch':
        device = init_dist('pytorch', (cfg.get('dist_params') or {}).get(
            'backend'), device=device)
    else:
        device = resolve_device(device)
    rank, world = get_dist_info()
    _check_ported(cfg)
    os.makedirs(work_dir, exist_ok=True)
    log_file = os.path.join(work_dir, 'train.log') if rank == 0 else None
    logger = get_root_logger(log_file, logging.INFO if rank == 0
                             else logging.ERROR)
    seed = int(cfg.get('seed') or 0)
    generator = set_random_seed(seed)
    # the ranks' augmentations differ; weights and batch order do not
    np.random.seed(seed + rank)

    dataset = dataset or build_dataset(cfg.data['train'])
    samples_per_gpu = cfg.data.get('samples_per_gpu', 2)
    # pad_to: one static shape or a list of pad buckets; each batch pads to
    # the smallest bucket that fits it
    pad_hw = cfg.get('pad_to', (800, 1344))
    buckets = list(map(tuple, pad_hw)) \
        if isinstance(pad_hw[0], (tuple, list)) else [tuple(pad_hw)]
    pad_hw = buckets if len(buckets) > 1 else buckets[0]
    loader = build_dataloader(dataset, samples_per_gpu, world, pad_hw,
                              cfg.get('max_gts_per_image', 100), seed=seed,
                              batch_scales=cfg.get('batch_scales'),
                              scale_sampling=cfg.get('scale_sampling',
                                                     'image_range'),
                              group_pad_buckets=cfg.get('group_pad_buckets',
                                                        True), rank=rank)
    steps_per_epoch = len(loader)
    runner_cfg = cfg.get('runner', {})
    if runner_cfg.get('type') == 'IterBasedRunner':
        # an iteration budget: whole epochs until it is spent; lr_config's
        # steps are already in iterations
        max_iters = runner_cfg.get('max_iters', 90000)
        max_epochs = -(-max_iters // max(steps_per_epoch, 1))
        max_steps = max_steps or max_iters
        lr_steps_per_epoch = 1
    else:
        max_epochs = runner_cfg.get('max_epochs', 12)
        lr_steps_per_epoch = steps_per_epoch

    # the config's top-level dtype lowers the towers' compute; parameters,
    # gradients, optimizer state and checkpoints stay float32
    model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    has_teacher = hasattr(model, 'teacher')
    # mmdet's NumClassCheckHook: the dataset's classes against the head's
    ds_classes = getattr(dataset, 'CLASSES', None)
    head = getattr(model, 'bbox_head', None)
    if ds_classes and head is not None and \
            getattr(head, 'num_classes', None) not in (None,
                                                       len(ds_classes)):
        logger.warning(
            f'dataset has {len(ds_classes)} classes but '
            f'bbox_head.num_classes={head.num_classes}: check the config')
    model.init_weights(generator)
    if has_teacher:
        _load_teacher(model, logger)
        # the teacher runs in eval only, so folding its BNs into its convs
        # is value-identical; refused for a ConvWS teacher
        if cfg.get('fold_teacher_bn', True) and model.fold_teacher_bn():
            logger.info('teacher conv+BN folded into kernels '
                        '(disable with fold_teacher_bn=False)')
    if cfg.get('load_from'):
        _load_from(model, str(cfg['load_from']), logger)
    _check_frozen_bn(model, world)
    model.to(device)

    schedule = build_lr_schedule(cfg.optimizer['lr'], cfg.get('lr_config', {}),
                                 lr_steps_per_epoch, max_epochs)
    optimizer, scheduler = build_optimizer(cfg.optimizer, schedule, model)
    global_step = 0
    if cfg.get('resume_from'):
        global_step = load_train_state(str(cfg['resume_from']), model,
                                       optimizer, scheduler)
        logger.info(f'resumed from step {global_step}')
    step_fn = make_train_step(
        model, optimizer, scheduler,
        (cfg.get('optimizer_config') or {}).get('grad_clip'))
    batches = DevicePrefetcher(loader, device)

    log_interval = log_interval or cfg.get('log_config', {}).get(
        'interval', 50)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f'start training: {n_params / 1e6:.1f}M params on {device}'
                f' x {world} rank(s), {steps_per_epoch} steps/epoch, '
                f'{max_epochs} epochs')

    # TensorboardLoggerHook: on when the config lists it
    tb_writer = None
    if rank == 0 and any(h.get('type') == 'TensorboardLoggerHook'
           for h in cfg.get('log_config', {}).get('hooks', [])):
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb_writer = SummaryWriter(os.path.join(work_dir, 'tf_logs'))
        except ImportError:
            logger.warning('TensorboardLoggerHook requested but no '
                           'tensorboard available')

    # preemption: SIGTERM checkpoints at the next step boundary, so that
    # `resume_from` continues exactly where it hit
    preempted = {'flag': False}

    def _on_sigterm(signum, frame):
        preempted['flag'] = True
        logger.warning('SIGTERM received: checkpointing at the next step')

    def _save(step):
        if rank == 0:
            save_checkpoint(work_dir, model, optimizer, scheduler, step,
                            keep)
        barrier()

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread
        prev_handler = None

    ckpt_cfg = cfg.get('checkpoint_config', {}) or {}
    keep = ckpt_cfg.get('max_keep_ckpts', 3)
    eval_cfg = cfg.get('evaluation', {}) or {}
    eval_every = eval_interval_epochs or eval_cfg.get('interval', 0)
    val_ds = None
    best_score = float('-inf')
    metrics = {}
    last_saved_step = -1
    stop = diverged = False
    start_epoch = global_step // max(steps_per_epoch, 1)
    json_log = open(os.path.join(work_dir, 'log.json'), 'a') \
        if rank == 0 else None
    try:
        with torch.autograd.set_detect_anomaly(bool(cfg.get('debug'))):
            t_last = time.perf_counter()
            for epoch in range(start_epoch, max_epochs):
                batches.set_epoch(epoch)
                skip = 0
                if epoch == start_epoch and \
                        global_step > epoch * steps_per_epoch:
                    # mid-epoch resume: the epoch's batch order is a
                    # function of (seed, epoch), so skipping the trained
                    # prefix continues with the batches the interrupted run
                    # never saw
                    skip = global_step - epoch * steps_per_epoch
                    logger.info(f'mid-epoch resume: skipping the first '
                                f'{skip} batches of epoch {epoch + 1}')
                for batch in batches.iterate(skip):
                    metrics = step_fn(batch)
                    global_step += 1
                    if global_step % log_interval == 0:
                        metrics = {k: float(v) for k, v in metrics.items()}
                        if not all(np.isfinite(v) for v in metrics.values()):
                            logger.error(
                                f'non-finite loss at step {global_step}: '
                                f'{metrics}: stopping. Lower the lr, or '
                                'enable optimizer_config.grad_clip or a '
                                'longer warmup.')
                            if rank == 0:
                                json_log.write(json.dumps(
                                    dict(mode='train', iter=global_step,
                                         error='non-finite loss')) + '\n')
                                # a dump beside the checkpoints, never one
                                # of them: resume must not pick non-finite
                                # weights
                                _save_weights(os.path.join(
                                    work_dir, 'diverged_state.pth'),
                                    model, iter=global_step)
                            barrier()
                            diverged = stop = True
                            break
                        dt = (time.perf_counter() - t_last) / log_interval
                        t_last = time.perf_counter()
                        lr = float(schedule(global_step))
                        line = dict(mode='train', epoch=epoch + 1,
                                    iter=global_step, lr=round(lr, 6),
                                    time=round(dt, 4),
                                    **{k: round(v, 5)
                                       for k, v in metrics.items()})
                        logger.info(' '.join(f'{k}={v}'
                                             for k, v in line.items()))
                        if rank == 0:
                            json_log.write(json.dumps(line) + '\n')
                            json_log.flush()
                        if tb_writer is not None:
                            for k, v in metrics.items():
                                tb_writer.add_scalar(f'train/{k}', v,
                                                     global_step)
                            tb_writer.add_scalar('train/lr', lr, global_step)
                    if world > 1:
                        # a SIGTERM to any rank stops every rank here
                        preempted['flag'] = bool(all_reduce_host(
                            [float(preempted['flag'])], 'max')[0])
                    if preempted['flag']:
                        _save(global_step)
                        last_saved_step = global_step
                        logger.warning(
                            f'preemption checkpoint at step {global_step}: '
                            f"resume with resume_from='{work_dir}'")
                        stop = True
                        break
                    if max_steps and global_step >= max_steps:
                        stop = True
                        break
                # checkpoint hook: every `interval` epochs
                ckpt_every = ckpt_cfg.get('interval', 1)
                if not stop and ckpt_every and (epoch + 1) % ckpt_every == 0:
                    _save(global_step)
                    last_saved_step = global_step
                # eval hook, with save_best
                if not stop and eval_every and \
                        (epoch + 1) % eval_every == 0 and \
                        'val' in cfg.get('data', {}):
                    from ld_tpu_torch.apis.test import eval_detector
                    try:
                        val_ds = val_ds or build_dataset(cfg.data['val'])
                    except FileNotFoundError as e:
                        logger.warning(f'eval skipped: {e}')
                    else:
                        # every rank runs its share; each holds all results
                        results = eval_detector(model, val_ds, pad_hw=pad_hw)
                        val_metrics = broadcast_object(val_ds.evaluate(
                            results, metric=eval_cfg.get('metric', 'bbox'))
                            if rank == 0 else None)
                        line = dict(mode='val', epoch=epoch + 1,
                                    iter=global_step,
                                    **{k: round(float(v), 5)
                                       for k, v in val_metrics.items()
                                       if isinstance(v, (int, float))})
                        logger.info(' '.join(f'{k}={v}'
                                             for k, v in line.items()))
                        if rank == 0:
                            json_log.write(json.dumps(line) + '\n')
                            json_log.flush()
                        best_key = eval_cfg.get('save_best')
                        if best_key and best_key in val_metrics and \
                                float(val_metrics[best_key]) > best_score:
                            best_score = float(val_metrics[best_key])
                            if rank == 0:
                                _save_weights(os.path.join(
                                    work_dir, f'best_{best_key}.pth'),
                                    model, epoch=epoch + 1, iter=global_step,
                                    **{best_key: best_score})
                            barrier()
                            logger.info(f'new best {best_key}='
                                        f'{best_score:.5f} (epoch '
                                        f'{epoch + 1}) -> best_{best_key}.pth')
                if stop:
                    break
        if last_saved_step != global_step and not diverged:
            # the final weights are always on disk (a max_steps exit, an
            # interval that does not divide the epochs), but never
            # non-finite ones
            _save(global_step)
    finally:
        if json_log is not None:
            json_log.close()
        if tb_writer is not None:
            tb_writer.close()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        if log_file:
            close_file_handler(logger, log_file)
    return dict(model=model, optimizer=optimizer, scheduler=scheduler,
                schedule=schedule, step=global_step,
                steps_per_epoch=steps_per_epoch,
                metrics={k: float(v) for k, v in metrics.items()},
                preempted=preempted['flag'], diverged=diverged)
