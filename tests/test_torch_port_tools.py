"""The port's analysis tools and the FCOS-GFL weight names, against the
JAX package:
  * `state_dict_from_jax` with the target's keys carries a JAX FCOS-GFL
    head (whose final convs are named `atss_*`) onto the port's `conv_*`
    names, strictly; an LD-FCOS teacher saved as a JAX `.npz` loads through
    `load_checkpoint`; the ATSS-GFL head's round trip is unchanged;
  * the train-to-AP harnesses (`ld_gain_experiment`,
    `ld_variant_experiment`): `base_cfg` and `family_spec` equal the JAX
    tools', and their datasets equal the JAX `SyntheticDetectionDataset
    (draw_boxes=True)`;
  * a miniature harness run (64x96, width 64, float32, 3 steps): an LD
    student whose LD, VLR and KD weights are 0 equals the no-teacher
    baseline bit for bit, every step's losses and the final parameters
    (the JAX package's takeaway 2, docs/EXPERIMENTS.md); a weighted LD
    student trains with finite losses and `evaluate` gives `bbox_mAP`;
  * `ap_landscape` on two small detectors saved as JAX `.npz` (R34 / R18,
    width 32, the pair of tests/test_ap_landscape.py, whose 1x1 top level
    has GroupNorm groups of one value): every per-batch statistic within
    rtol 1e-4 of the JAX tool's.
"""
import importlib
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.data import SyntheticDetectionDataset as JSynthetic
from ld_tpu.utils.checkpoint import convert_torch_state_dict, save_variables
from ld_tpu_torch import Config
from ld_tpu_torch.apis import train
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.tools.analysis_tools import ap_landscape
from ld_tpu_torch.tools.analysis_tools import ld_gain_experiment as gain
from ld_tpu_torch.tools.analysis_tools import ld_variant_experiment as variant
from ld_tpu_torch.utils.checkpoint import load_checkpoint, state_dict_from_jax
from test_torch_port_bridge import randomize_norms
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R18_NECK = [64, 128, 256, 512]


def jax_tool(name):
    """A JAX tool of tools/analysis_tools as a module. The harnesses point
    jax's persistent compilation cache at the repo when imported; the
    setting is put back, so that the rest of this process is unchanged."""
    cache = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    sys.path.insert(0, os.path.join(ROOT, 'tools', 'analysis_tools'))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)
        jax.config.update('jax_compilation_cache_dir', cache)
        jax.config.update('jax_persistent_cache_min_compile_time_secs',
                          min_secs)


# ---- Queue C: the FCOS-GFL head's weight names ------------------------------
def _r18(model_cfg):
    model_cfg.backbone.depth = 18
    model_cfg.neck.in_channels = R18_NECK
    return model_cfg


def _round_trip(model):
    """port -> convert_torch_state_dict -> state_dict_from_jax with the
    target's keys -> load_state_dict(strict=True); returns the JAX tree."""
    model.init_weights(torch.Generator().manual_seed(6))
    randomize_norms(model, 6)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    conv = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    assert conv.pop('_unmapped') == []
    back = state_dict_from_jax(conv, model.state_dict().keys())
    model.load_state_dict(back, strict=True)
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k
    return conv


@pytest.mark.parametrize('config', ['configs/gfl/fcos_gfl_r50_center.py',
                                    'configs/gfl/atss_gfl_r50_1x.py'])
def test_head_round_trips_strict_with_keys(config):
    """The FCOS-GFL head's `conv_*` convs come back from the JAX tree's
    `atss_*` names; the ATSS-GFL head keeps `atss_*`. Without keys the
    mapping is the ATSS one, as before."""
    cfg = Config.fromfile(os.path.join(ROOT, config))
    model = build_detector(_r18(cfg.model))
    conv = _round_trip(model)
    fcos = 'fcos' in config
    assert hasattr(model.bbox_head, 'conv_cls') == fcos
    assert ('atss_cls' in conv['params']['head_net'])
    plain = state_dict_from_jax(conv)
    assert ('bbox_head.atss_cls.weight' in plain and
            'bbox_head.conv_cls.weight' not in plain)


def test_ld_fcos_teacher_npz_loads_through_load_checkpoint(tmp_path):
    """An LD-FCOS teacher (caffe-style FCOS-GFL, here at R18) saved by the
    JAX package's `save_variables` loads strictly into `model.teacher`."""
    cfg = Config.fromfile(os.path.join(ROOT,
                                       'configs/ld/ld_r50_fcos_r101_1x.py'))
    teacher = Config.fromfile(os.path.join(
        ROOT, cfg.model.teacher_config)).model
    cfg.model.teacher_config = dict(model=_r18(teacher))
    model = build_detector(_r18(cfg.model))
    source = build_detector(_r18(Config.fromfile(os.path.join(
        ROOT, 'configs/gfl/fcos_gfl_r101_2x.py')).model))
    source.init_weights(torch.Generator().manual_seed(3))
    randomize_norms(source, 3)
    conv = convert_torch_state_dict(
        {k: v.numpy() for k, v in source.state_dict().items()})
    assert conv.pop('_unmapped') == []
    path = str(tmp_path / 'teacher.npz')
    save_variables(path, conv)
    load_checkpoint(model.teacher, path)
    got = model.teacher.state_dict()
    for k, v in source.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(got[k], v), k


# ---- harness configs and data -----------------------------------------------
@pytest.mark.parametrize('epochs', [4, 60])
def test_harness_base_cfgs_equal_jax(epochs):
    assert (gain.base_cfg(epochs).to_dict() ==
            jax_tool('ld_gain_experiment').base_cfg(epochs).to_dict())
    j_variant = jax_tool('ld_variant_experiment')
    for lr in (0.01, 0.0025):
        assert (variant.base_cfg(epochs, lr).to_dict() ==
                j_variant.base_cfg(epochs, lr).to_dict())


@pytest.mark.parametrize('family', ['gfl', 'atss', 'fcos', 'retina', 'ldv2'])
def test_family_spec_equals_jax(family):
    j_variant = jax_tool('ld_variant_experiment')
    for im_weight in (0.0, 0.02):
        args = variant.parse_args(['--family', family, '--im-weight',
                                   str(im_weight)])
        assert (variant.family_spec(family, args) ==
                j_variant.family_spec(family, args))


@pytest.mark.parametrize('seed,num', [(0, 96), (1, 32)])
def test_harness_datasets_equal_jax(seed, num):
    got = gain.dataset(num, seed)
    want = JSynthetic(num_images=num, hw=gain.HW,
                      num_classes=gain.NUM_CLASSES, max_boxes=4,
                      pipeline=gain.PIPE, seed=seed, draw_boxes=True)
    for i in range(num):
        np.testing.assert_array_equal(got._images[i], want._images[i])
        for key in ('bboxes', 'labels'):
            np.testing.assert_array_equal(got.annotations[i][key],
                                          want.annotations[i][key])
    g, w = got[0], want[0]
    for key in ('img', 'gt_bboxes', 'gt_labels'):
        np.testing.assert_array_equal(g[key], w[key])


# ---- a miniature harness run ------------------------------------------------
HW_MINI = (64, 96)
MAKE_TRAIN_STEP = train.make_train_step


def _mini(cfg):
    """64x96 images, FPN and head at width 64, float32."""
    cfg.pad_to = HW_MINI
    cfg.dtype = 'float32'
    cfg.model.neck.out_channels = 64
    cfg.model.bbox_head.update(in_channels=64, feat_channels=64)
    return cfg


def _recorded(monkeypatch):
    """Record every step's metrics of `train_detector`'s step."""
    steps = []

    def wrapped(*args, **kwargs):
        step = MAKE_TRAIN_STEP(*args, **kwargs)

        def recording(batch):
            out = step(batch)
            steps.append({k: float(v) for k, v in out.items()})
            return out
        return recording
    monkeypatch.setattr(train, 'make_train_step', wrapped)
    return steps


@pytest.fixture(scope='module')
def mini_runs(tmp_path_factory):
    """The baseline, the zero-weight LD and the weighted LD students of the
    harness, 3 steps each at 64x96, against one teacher `.pth`."""
    work = tmp_path_factory.mktemp('ld_gain')
    mp = pytest.MonkeyPatch()
    train_ds = gain.dataset(6, 0, HW_MINI)
    tcfg = _mini(gain.base_cfg(2))
    teacher = build_detector(tcfg.model)
    teacher.init_weights(torch.Generator().manual_seed(1))
    ckpt = str(work / 'teacher.pth')
    gain.save_teacher(dict(model=teacher), ckpt)
    runs = {}
    try:
        for name, cfg in (
                ('baseline', gain.student_cfg(2)),
                ('zero', gain.ld_student_cfg(2, tcfg.model, ckpt, ld=0.0,
                                             vlr=0.0, kd=0.0)),
                ('ld', gain.ld_student_cfg(2, tcfg.model, ckpt))):
            steps = _recorded(mp)
            out = train.train_detector(_mini(cfg), str(work / name),
                                       dataset=train_ds, max_steps=3,
                                       device='cpu')
            runs[name] = dict(out=out, steps=steps)
    finally:
        mp.undo()
    return runs


def test_zero_weight_ld_student_equals_baseline_bit_for_bit(mini_runs):
    base, zero = mini_runs['baseline'], mini_runs['zero']
    assert len(base['steps']) == len(zero['steps']) == 3
    for b, z in zip(base['steps'], zero['steps']):
        for k, v in b.items():
            assert z[k] == v, (k, z[k], v)
        for k in ('loss_ld', 'loss_ld_vlr', 'loss_kd'):
            assert z[k] == 0.0
    b_sd = base['out']['model'].state_dict()
    z_sd = zero['out']['model'].state_dict()
    assert sorted(b_sd) == sorted(z_sd)
    for k, v in b_sd.items():
        assert torch.equal(z_sd[k], v), k


def test_weighted_ld_student_trains_and_evaluates(mini_runs):
    run = mini_runs['ld']
    assert all(np.isfinite(v) for s in run['steps'] for v in s.values())
    assert any(s['loss_ld'] > 0 for s in run['steps'])
    metrics = gain.evaluate(run['out'], gain.dataset(4, 1, HW_MINI),
                            hw=HW_MINI)
    assert 0.0 <= metrics['bbox_mAP'] <= 1.0


# ---- the AP landscape -------------------------------------------------------
LANDSCAPE_MODEL = """
model = dict(
    type='GFL',
    backbone=dict(type='ResNet', depth={depth}, frozen_stages=1,
                  norm_eval=True),
    neck=dict(type='FPN', in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, add_extra_convs='on_output', num_outs=5),
    bbox_head=dict(type='GFLHead', num_classes=4, in_channels=32,
                   stacked_convs=1, feat_channels=32, reg_max=8),
    test_cfg=dict(nms_pre=50, score_thr=0.05,
                  nms=dict(type='nms', iou_threshold=0.6), max_per_img=10))
pad_to = (64, 96)
data = dict(
    samples_per_gpu=1,
    test=dict(type='SyntheticDetectionDataset', num_images=3, hw=(64, 96),
              pipeline=[
                  dict(type='Normalize', mean=[0, 0, 0], std=[1, 1, 1],
                       to_rgb=False),
                  dict(type='Pad', size_divisor=32),
                  dict(type='Collect', keys=['img']),
              ]))
"""


def test_ap_landscape_matches_jax(tmp_path, monkeypatch):
    """The two detectors' weights go port -> `convert_torch_state_dict` ->
    the JAX package's `save_variables` `.npz`, which both tools load (the
    JAX init, op by op, takes ~23 s on one CPU thread)."""
    paths = []
    for name, depth, seed in (('teacher', 34, 0), ('student', 18, 1)):
        cfg = tmp_path / f'{name}.py'
        cfg.write_text(LANDSCAPE_MODEL.format(depth=depth))
        model = build_detector(Config.fromfile(str(cfg)).model)
        model.init_weights(torch.Generator().manual_seed(seed))
        randomize_norms(model, seed)
        conv = convert_torch_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()})
        assert conv.pop('_unmapped') == []
        ckpt = str(tmp_path / f'{name}.npz')
        save_variables(ckpt, conv)
        paths += [str(cfg), ckpt]
    args = [paths[0], paths[2], '--checkpoint1', paths[1], '--checkpoint2',
            paths[3], '--max-images', '3']
    j_out = tmp_path / 'jax.json'
    monkeypatch.setattr(sys, 'argv', ['ap_landscape.py', *args, '--out',
                                      str(j_out)])
    jax_tool('ap_landscape').main()
    want = json.loads(j_out.read_text())
    got = ap_landscape.main([*args, '--out', str(tmp_path / 'port.json'),
                             '--device', 'cpu'])
    assert got == json.loads((tmp_path / 'port.json').read_text())
    for key in ('feat_l1', 'cls_l1', 'bbox_l1', 'pearson'):
        g = np.asarray(got['per_batch'][key])
        w = np.asarray(want['per_batch'][key])
        assert g.shape == w.shape and len(g) == 3, key
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=key)
    assert np.all(np.abs(got['per_batch']['pearson']) <= 1.0)
