"""The port's training runtime (`train_detector` and its hooks) on the CPU.

configs/ld/ld_r18_self_2x_3x_voc.py with its data replaced by the synthetic
dataset at 64x96 (6 train images, batch 3: 2 steps an epoch) and the FPN
and head widths of student and teacher at 64, through
`train_detector(device='cpu')`:
  * composition: the weights after the run are bit-identical to a hand
    loop of `make_train_step` over the port's own loader batches (the step
    and the loader are held against the JAX package in their own tests);
  * resume: SIGTERM raised from the main thread after step 3, then a run
    with `resume_from`, ends bit-identical to an uninterrupted run (no
    random augmentation: the CPU ops are deterministic);
  * log.json: the keys of the JAX package's lines, and LR values equal to
    the JAX `build_lr_schedule` at `len(loader)` steps an epoch;
  * checkpoints: `max_keep_ckpts` pruning, the `save_best` file, a lenient
    `load_from` that skips a head of another shape, and a non-finite loss
    that stops the run without a checkpoint;
  * teachers: a JAX `save_variables` `.npz` (through
    `state_dict_from_jax`) and a `.pth` load strictly;
  * device: without CUDA, `device=None` raises; `tools/train.py` runs with
    `--device cpu` from a dumped config.
"""
import copy
import json
import os
import signal

import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.evaluation.coco_eval import CocoEvaluator as JCocoEvaluator
from ld_tpu.parallel import build_lr_schedule as j_build_lr_schedule
from ld_tpu.utils.checkpoint import convert_torch_state_dict, save_variables
from ld_tpu_torch import Config
from ld_tpu_torch.apis import set_random_seed, train_detector
from ld_tpu_torch.apis import train as train_api
from ld_tpu_torch.data import build_dataloader, build_dataset
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                   make_train_step)
from ld_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LD_CFG = os.path.join(ROOT, 'configs/ld/ld_r18_self_2x_3x_voc.py')
TEACHER_CFG = os.path.join(ROOT, 'configs/gfl/gfl_r18_fpn1x_voc.py')
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
LD_KEYS = {'loss_cls', 'loss_bbox', 'loss_dfl', 'loss_ld', 'loss_ld_vlr',
           'loss_kd', 'loss_kd_neg', 'loss_im', 'loss'}


def _narrow(model_cfg):
    model_cfg.neck.out_channels = 64
    model_cfg.bbox_head.in_channels = 64
    model_cfg.bbox_head.feat_channels = 64
    return model_cfg


def _cfg(config_cls=Config, max_epochs=3, evaluate=False):
    """The LD config at width 64 on 6 synthetic 64x96 images."""
    cfg = config_cls.fromfile(LD_CFG)
    teacher = _narrow(config_cls.fromfile(TEACHER_CFG).model)
    _narrow(cfg.model)
    cfg.model.teacher_config = dict(model=teacher)
    cfg.model.teacher_ckpt = None
    pipe = [dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    synth = dict(type='SyntheticDetectionDataset', hw=(64, 96),
                 num_classes=20, max_boxes=4, draw_boxes=True)
    cfg.data = dict(
        samples_per_gpu=3,
        train=dict(synth, num_images=6, pipeline=pipe),
        val=dict(synth, num_images=3, seed=1,
                 pipeline=[pipe[0], dict(type='Collect', keys=['img'])]))
    cfg.pad_to = (64, 96)
    cfg.runner = dict(max_epochs=max_epochs)
    cfg.optimizer = dict(cfg.optimizer, lr=0.01)
    cfg.lr_config = dict(step=[2], warmup_iters=3, warmup_ratio=0.1)
    cfg.log_config = dict(interval=1)
    cfg.checkpoint_config = dict(interval=1, max_keep_ckpts=2)
    cfg.evaluation = dict(interval=1 if evaluate else 0, metric='bbox',
                          save_best='bbox_mAP')
    return cfg


def _log(work_dir):
    with open(os.path.join(work_dir, 'log.json')) as f:
        return [json.loads(line) for line in f]


def _assert_same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _preempt_after(monkeypatch, n):
    """make_train_step whose step raises SIGTERM in the main thread after
    its n-th call, and records each step's img_ids."""
    seen = []

    def wrapped(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def preempting(batch):
            out = step(batch)
            seen.append(batch['img_ids'].tolist())
            if len(seen) == n:
                signal.raise_signal(signal.SIGTERM)
            return out
        return preempting
    monkeypatch.setattr(train_api, 'make_train_step', wrapped)
    return seen


@pytest.fixture(scope='module')
def full_run(tmp_path_factory):
    """3 epochs (6 steps) with an eval and save_best each epoch."""
    work_dir = str(tmp_path_factory.mktemp('full'))
    ret = train_detector(_cfg(evaluate=True), work_dir, device='cpu')
    return work_dir, ret


def test_run_equals_a_hand_loop_of_make_train_step(full_run):
    work_dir, ret = full_run
    cfg = _cfg()
    set_random_seed(0)
    loader = build_dataloader(build_dataset(cfg.data['train']), 3, 1,
                              (64, 96), 100, seed=0)
    assert len(loader) == ret['steps_per_epoch'] == 2
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    assert model.fold_teacher_bn()
    before = copy.deepcopy(model.state_dict())
    schedule = build_lr_schedule(cfg.optimizer['lr'], cfg.lr_config,
                                 len(loader), 3)
    optimizer, scheduler = build_optimizer(cfg.optimizer, schedule, model)
    step = make_train_step(model, optimizer, scheduler)
    for epoch in range(3):
        loader.set_epoch(epoch)
        for batch in loader:
            step({k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_same_weights(ret['model'], model)
    assert not torch.equal(before['bbox_head.gfl_cls.weight'],
                           model.state_dict()['bbox_head.gfl_cls.weight'])
    assert ret['step'] == 6 and not ret['preempted']
    # eval_detector left the model in train mode
    assert ret['model'].training and not ret['model'].teacher.training


def test_sigterm_then_resume_equals_an_uninterrupted_run(full_run, tmp_path,
                                                         monkeypatch):
    _, full = full_run
    work_dir = str(tmp_path)
    seen = _preempt_after(monkeypatch, 3)
    first = train_detector(_cfg(), work_dir, device='cpu')
    assert first['preempted'] and first['step'] == 3
    assert sorted(os.listdir(os.path.join(work_dir, 'checkpoints'))) == \
        ['2.pth', '3.pth']
    monkeypatch.undo()
    cfg = _cfg()
    cfg.resume_from = work_dir
    seen_after = _preempt_after(monkeypatch, -1)
    resumed = train_detector(cfg, work_dir, device='cpu')
    assert resumed['step'] == 6 and not resumed['preempted']
    _assert_same_weights(resumed['model'], full['model'])
    # the mid-epoch skip: the resumed run trained on the batches the
    # interrupted one never saw
    assert len(seen) == 3 and len(seen_after) == 3
    lines = [x for x in _log(work_dir) if x['mode'] == 'train']
    assert [x['iter'] for x in lines] == [1, 2, 3, 4, 5, 6]
    full_lines = [x for x in _log(full_run[0]) if x['mode'] == 'train']
    assert [x['lr'] for x in lines] == [x['lr'] for x in full_lines]


def test_log_json_keys_and_lr_match_jax(full_run):
    work_dir, ret = full_run
    lines = _log(work_dir)
    train = [x for x in lines if x['mode'] == 'train']
    val = [x for x in lines if x['mode'] == 'val']
    assert len(train) == 6 and len(val) == 3
    # the keys of the JAX package's lines (ld_tpu/apis/train.py:300-302,
    # 344-347): its step returns the loss dict plus 'loss'
    for x in train:
        assert set(x) == {'mode', 'epoch', 'iter', 'lr', 'time'} | LD_KEYS
        assert all(np.isfinite(x[k]) for k in LD_KEYS)
    jds = build_dataset(_cfg().data['val'])
    jax_metrics = JCocoEvaluator(jds).evaluate(
        [dict(boxes=np.zeros((0, 5)), labels=np.zeros(0))] * len(jds))
    for x in val:
        assert set(x) == {'mode', 'epoch', 'iter'} | set(jax_metrics)
    assert [x['epoch'] for x in train] == [1, 1, 2, 2, 3, 3]
    cfg = _cfg(JConfig)
    j_sched = j_build_lr_schedule(cfg.optimizer['lr'], cfg.lr_config,
                                  ret['steps_per_epoch'], 3)
    for x in train:
        assert x['lr'] == pytest.approx(float(j_sched(x['iter'])), abs=1e-6)
    assert len({x['lr'] for x in train}) >= 4


def test_checkpoints_pruned_and_best_kept(full_run, tmp_path):
    work_dir, ret = full_run
    assert sorted(os.listdir(os.path.join(work_dir, 'checkpoints'))) == \
        ['4.pth', '6.pth']
    ckpt = torch.load(os.path.join(work_dir, 'checkpoints', '6.pth'),
                      weights_only=False)
    assert ckpt['step'] == 6 and ckpt['scheduler']['last_epoch'] == 6
    best = os.path.join(work_dir, 'best_bbox_mAP.pth')
    model = build_detector(_cfg().model)
    load_checkpoint(model, best)            # strict
    assert 'bbox_mAP' in torch.load(best, weights_only=False)['meta']


def test_load_from_skips_mismatched_shapes(tmp_path, monkeypatch):
    """load_from a checkpoint whose head has 5 classes, with a step that
    leaves the weights alone: the mismatched classifier keeps its init,
    everything else is loaded."""
    monkeypatch.setattr(train_api, 'make_train_step',
                        lambda *a, **k: lambda batch: {'loss': torch.ones(())})
    cfg = _cfg()
    other = copy.deepcopy(cfg.model)
    other.bbox_head.num_classes = 5
    src = build_detector(other)
    src.init_weights(torch.Generator().manual_seed(7))
    path = str(tmp_path / 'src.pth')
    torch.save(dict(state_dict=src.state_dict()), path)
    cfg.load_from = path
    ret = train_detector(cfg, str(tmp_path / 'run'), max_steps=1,
                         device='cpu')
    init = build_detector(cfg.model)
    init.init_weights(torch.Generator().manual_seed(0))
    got, want, fresh = (ret['model'].state_dict(), src.state_dict(),
                        init.state_dict())
    for k in got:
        if k.startswith('bbox_head.gfl_cls'):
            assert torch.equal(got[k], fresh[k]), k
        else:
            assert torch.equal(got[k], want[k]), k
    assert sorted(os.listdir(tmp_path / 'run' / 'checkpoints')) == ['1.pth']


def test_non_finite_loss_stops_without_a_checkpoint(tmp_path, monkeypatch):
    def wrapped(*args, **kwargs):
        step = make_train_step(*args, **kwargs)
        calls = []

        def poisoned(batch):
            out = step(batch)
            calls.append(1)
            if len(calls) == 2:
                out['loss'] = torch.tensor(float('nan'))
            return out
        return poisoned
    monkeypatch.setattr(train_api, 'make_train_step', wrapped)
    ret = train_detector(_cfg(), str(tmp_path), device='cpu')
    assert ret['diverged'] and ret['step'] == 2
    assert _log(str(tmp_path))[-1] == dict(mode='train', iter=2,
                                           error='non-finite loss')
    assert os.path.exists(tmp_path / 'diverged_state.pth')
    assert not os.path.exists(tmp_path / 'checkpoints')


def test_teachers_load_strictly_from_npz_and_pth(tmp_path):
    """A teacher tree of the JAX package (here: seeded weights carried over
    by its converter) saved by its `save_variables`, then a `.pth`."""
    source = build_detector(_cfg().model)
    source.init_teacher_weights(torch.Generator().manual_seed(3))
    want = source.teacher.state_dict()
    variables = convert_torch_state_dict(
        {k: v.numpy() for k, v in want.items()})
    assert variables.pop('_unmapped') == []
    npz = str(tmp_path / 'teacher.npz')
    save_variables(npz, variables)
    model = build_detector(_cfg().model)
    load_checkpoint(model.teacher, npz)
    got = model.teacher.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k

    # a .pth through train_detector's teacher_ckpt, unfolded
    pth = str(tmp_path / 'teacher.pth')
    torch.save(dict(state_dict=got), pth)
    cfg = _cfg()
    cfg.model.teacher_ckpt = pth
    cfg.fold_teacher_bn = False
    ret = train_detector(cfg, str(tmp_path / 'run'), max_steps=1,
                         device='cpu')
    for k, v in ret['model'].teacher.state_dict().items():
        assert torch.equal(v, got[k]), k
    partial = dict(got)
    partial.pop('bbox_head.gfl_cls.bias')
    torch.save(partial, pth)
    with pytest.raises(RuntimeError, match='Missing key'):
        load_checkpoint(build_detector(_cfg().model).teacher, pth)


def test_entry_points_run_on_the_card_unless_told(tmp_path, monkeypatch):
    from ld_tpu_torch.tools import train as train_tool
    cfg = _cfg(max_epochs=1)
    cfg.tp = 2
    with pytest.raises(NotImplementedError):
        train_detector(cfg, str(tmp_path / 'tp'), device='cpu')
    cfg.tp = 1
    path = str(tmp_path / 'cfg.py')
    cfg.dump(path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        train_detector(Config.fromfile(path), str(tmp_path / 'none'))
    with pytest.raises(RuntimeError, match='CUDA'):
        train_tool.main([path, '--work-dir', str(tmp_path / 'cli')])
    ret = train_tool.main([path, '--work-dir', str(tmp_path / 'cli'),
                           '--device', 'cpu', '--max-steps', '1'])
    assert ret['step'] == 1
    assert os.path.exists(tmp_path / 'cli' / 'config_dump.py')
    assert os.listdir(tmp_path / 'cli' / 'checkpoints') == ['1.pth']


def test_iter_based_runner_counts_iterations(tmp_path):
    """runner IterBasedRunner: whole epochs until max_iters, with the LR
    steps of lr_config in iterations."""
    cfg = _cfg()
    cfg.runner = dict(type='IterBasedRunner', max_iters=3)
    cfg.lr_config = dict(step=[2], warmup_iters=1, warmup_ratio=0.1)
    ret = train_detector(cfg, str(tmp_path), device='cpu')
    assert ret['step'] == 3
    lines = [x for x in _log(str(tmp_path)) if x['mode'] == 'train']
    assert [x['lr'] for x in lines] == [0.01, 0.001, 0.001]
    assert sorted(os.listdir(tmp_path / 'checkpoints')) == ['2.pth', '3.pth']
