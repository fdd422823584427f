"""The configs' compute dtype in the port, against the JAX package.

`configs/_base_/default_runtime.py` sets `dtype = 'bfloat16'`: the backbone,
neck and head towers compute in bfloat16, while parameters, predictions,
losses, gradients and checkpoints stay float32, and a teacher named by its
config path stays float32 (`ld_tpu/models/__init__.py:31-57`). Held here:
  * `apply_model_dtype` injects the dtype where the JAX one does;
  * the bf16 forward of tests/test_bf16.py's R18 GFL model at FPN / head
    width 64 (torch's GroupNorm refuses one value per group, which width
    32 gives on the 1x1 top level), weights carried port -> JAX:
    |port bf16 - jax bf16| <= 2 x |jax bf16 - jax fp32| and <= 0.15 (the
    JAX package's own bf16 bound, tests/test_bf16.py:41); measured 0.03125
    (one bf16 ulp of a cls logit near -4.6) against 2 x 0.0210;
  * dtype None / 'float32' build the float32 model bit for bit;
  * a level scale multiplies the float32 conv output, as JAX promotes it;
  * one bf16 LD step (a dict teacher, lowered with the student) against
    JAX's bf16 networks and loss: every term within rtol 2e-2 (measured
    worst 1.40e-2, loss_kd), float32 parameters and gradients, the same
    GI masks;
  * `init_detector`, `train_detector` and `tools/test.py` apply the
    config's dtype, with float32 checkpoints that load both ways;
  * a reduced `iou_dtype` NMS equals JAX's and keeps its agreement floors.
The JAX bf16 networks run op by op, as tests/test_bf16.py runs them: XLA
fusions under `jit` keep float32 between bf16 ops and round less often.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.models import apply_model_dtype as j_apply_model_dtype
from ld_tpu.models import build_detector as jax_build_detector
from ld_tpu.models.heads.gfl_head import flatten_levels as j_flatten
from ld_tpu.ops import anchor_center as j_anchor_center
from ld_tpu.ops.nms import multiclass_nms as j_multiclass_nms
from ld_tpu_torch import Config
from ld_tpu_torch.apis import eval_detector, init_detector, train_detector
from ld_tpu_torch.data import build_dataset
from ld_tpu_torch.models import apply_model_dtype, build_detector
from ld_tpu_torch.models.layers import BatchNorm2d, Conv2d, GroupNorm
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.testing import detection_batch_np
from ld_tpu_torch.utils.checkpoint import load_checkpoint, read_state_dict
from test_nms_bf16 import _candidates, _sets
from test_torch_port_bridge import randomize_norms, to_jax_variables
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LD_R50_CFG = 'configs/ld/ld_r50_gflv1_r101_fpn_coco_1x.py'
LD_R18_CFG = 'configs/ld/ld_r18_self_2x_3x_voc.py'
HW = (64, 96)
BF16_BOUND = 0.15
LD_KEYS = ('loss_cls', 'loss_bbox', 'loss_dfl', 'loss_ld', 'loss_ld_vlr',
           'loss_kd', 'loss_kd_neg', 'loss_im')
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


def gfl_cfg(dtype=None):
    """tests/test_bf16.py's model at FPN / head width 64."""
    cfg = dict(
        type='GFL',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1,
                      norm_eval=True),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, start_level=1,
                  add_extra_convs='on_output', num_outs=5),
        bbox_head=dict(type='GFLHead', num_classes=4, in_channels=64,
                       stacked_convs=1, feat_channels=64, reg_max=16),
        train_cfg=dict(assigner=dict(type='ATSSAssigner', topk=9)),
        test_cfg=dict(nms_pre=100, score_thr=0.05,
                      nms=dict(type='nms', iou_threshold=0.6),
                      max_per_img=10))
    if dtype is not None:
        for key in ('backbone', 'neck', 'bbox_head'):
            cfg[key]['dtype'] = dtype
    return cfg


def ld_cfg():
    """An LD detector over the same model, its teacher the same model
    given as a dict (so lowered with the student), GI imitation on."""
    cfg = gfl_cfg()
    cfg.update(type='KnowledgeDistillationSingleStageDetector',
               teacher_config=dict(model=gfl_cfg()), output_feature=True)
    cfg['bbox_head'] = dict(cfg['bbox_head'], type='LDHead',
                            loss_im=dict(type='IMLoss', loss_weight=2.0),
                            imitation_method='gibox')
    return cfg


def seeded(model, seed):
    model.init_weights(torch.Generator().manual_seed(seed))
    randomize_norms(model, seed)
    return model


def image(seed=0):
    return np.random.RandomState(seed).randn(1, 3, *HW).astype(np.float32)


def nhwc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))


def port_outputs(outs):
    """Port per-level NCHW outputs as NHWC numpy, flattened over parts."""
    return [t.detach().numpy().transpose(0, 2, 3, 1)
            for part in outs for t in part]


def lowered(module):
    """The compute dtypes of a module's convs and norms."""
    return {m.compute_dtype for m in module.modules()
            if isinstance(m, (Conv2d, GroupNorm, BatchNorm2d))}


# ---- apply_model_dtype ------------------------------------------------------

class NoDtypeNeck:
    """A module class whose constructor takes no dtype."""

    def __init__(self, in_channels):
        self.in_channels = in_channels


def _dtype_cases():
    path_ld = dict(JConfig.fromfile(os.path.join(ROOT, LD_R50_CFG)).model)
    explicit = gfl_cfg()
    explicit['backbone']['dtype'] = 'float32'
    no_dtype = gfl_cfg()
    no_dtype['neck'] = dict(type=NoDtypeNeck, in_channels=64)
    return dict(path_teacher=path_ld, dict_teacher=ld_cfg(),
                explicit_dtype_wins=explicit, class_without_dtype=no_dtype)


def _dtypes(cfg):
    """{slot: dtype name or None} of a model config and its dict teacher."""
    out, nodes = {}, [('', cfg)]
    if isinstance(cfg.get('teacher_config'), dict):
        nodes.append(('teacher.', cfg['teacher_config']['model']))
    for prefix, node in nodes:
        for key in ('backbone', 'neck', 'bbox_head', 'rpn_head'):
            if isinstance(node.get(key), dict):
                d = node[key].get('dtype')
                out[prefix + key] = None if d is None else \
                    str(d).replace('torch.', '')
    return out


@pytest.mark.parametrize('case', ['path_teacher', 'dict_teacher',
                                  'explicit_dtype_wins',
                                  'class_without_dtype'])
def test_apply_model_dtype_matches_jax(case):
    cfg = _dtype_cases()[case]
    before = copy.deepcopy(cfg)
    want = _dtypes(j_apply_model_dtype(cfg, 'bfloat16'))
    got = _dtypes(apply_model_dtype(cfg, 'bfloat16'))
    assert got == want
    expected = {'path_teacher': {'backbone': 'bfloat16', 'neck': 'bfloat16',
                                 'bbox_head': 'bfloat16'},
                'dict_teacher': {k: 'bfloat16' for k in (
                    'backbone', 'neck', 'bbox_head', 'teacher.backbone',
                    'teacher.neck', 'teacher.bbox_head')},
                'explicit_dtype_wins': {'backbone': 'float32',
                                        'neck': 'bfloat16',
                                        'bbox_head': 'bfloat16'},
                'class_without_dtype': {'backbone': 'bfloat16',
                                        'neck': None,
                                        'bbox_head': 'bfloat16'}}[case]
    assert got == expected
    # the input config is left as it was
    assert cfg == before


def test_ld_config_lowers_the_student_and_not_its_path_teacher():
    """configs/ld/ld_r50_gflv1_r101_fpn_coco_1x.py with its own dtype: the
    R50 student's backbone, FPN and head compute in bf16, the R101 teacher
    its file names in float32, as in the JAX package."""
    jcfg = JConfig.fromfile(os.path.join(ROOT, LD_R50_CFG))
    det = jax_build_detector(jcfg.model, dtype=jcfg.dtype)
    assert jcfg.dtype == 'bfloat16'
    assert det.backbone.dtype == det.neck.dtype == jnp.bfloat16
    assert det.bbox_head.net.dtype == jnp.bfloat16
    assert det.teacher.backbone.dtype == jnp.float32
    assert det.teacher.bbox_head.net.dtype == jnp.float32

    cfg = Config.fromfile(os.path.join(ROOT, LD_R50_CFG))
    with torch.device('meta'):
        model = build_detector(cfg.model, dtype=cfg.dtype)
    for part in (model.backbone, model.neck, model.bbox_head):
        assert lowered(part) == {torch.bfloat16}
    assert lowered(model.teacher) == {None}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.dtype for p in model.teacher.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers() if b.is_floating_point()} == \
        {torch.float32}


# ---- the forward ------------------------------------------------------------

@pytest.fixture(scope='module')
def gfl():
    """The bf16 port model from seed 0 and the JAX fp32 / bf16 outputs on
    the same weights and image."""
    model = seeded(build_detector(gfl_cfg(), dtype='bfloat16'), 0).eval()
    j32, j16 = jax_build_detector(gfl_cfg()), \
        jax_build_detector(gfl_cfg(), dtype='bfloat16')
    variables = to_jax_variables(model, j32)
    x = image()
    want32 = jax.jit(j32.apply)(variables, nhwc(x))
    want16 = j16.apply(variables, nhwc(x))             # op by op
    return dict(model=model, x=x, variables=variables,
                want32=[np.asarray(t) for part in want32 for t in part],
                want16=[np.asarray(t) for part in want16 for t in part])


def test_bf16_forward_matches_jax(gfl):
    model, x = gfl['model'], gfl['x']
    seen = {}

    def record(name):
        def hook(module, args, out):
            seen[name] = out
        return hook
    hooks = [m.register_forward_hook(record(name))
             for name, m in (('backbone', model.backbone),
                             ('neck', model.neck))]
    with torch.no_grad():
        outs = model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert {t.dtype for part in outs for t in part} == {torch.float32}
    assert {t.dtype for t in seen['backbone'] + seen['neck']} == \
        {torch.bfloat16}
    got = port_outputs(outs)
    port_vs_jax = max(float(np.abs(g - w).max())
                      for g, w in zip(got, gfl['want16']))
    bf16_vs_fp32 = max(float(np.abs(a - b).max())
                       for a, b in zip(gfl['want16'], gfl['want32']))
    # measured: 0.03125 against bf16_vs_fp32 0.0210
    assert port_vs_jax <= 2 * bf16_vs_fp32, (port_vs_jax, bf16_vs_fp32)
    assert port_vs_jax <= BF16_BOUND


@pytest.mark.parametrize('dtype', [None, 'float32', torch.float32])
def test_float32_dtype_is_the_float32_model_bit_for_bit(gfl, dtype):
    x = torch.from_numpy(gfl['x'])
    plain = build_detector(gfl_cfg()).eval()
    plain.load_state_dict(gfl['model'].state_dict())
    model = build_detector(gfl_cfg(), dtype=dtype).eval()
    model.load_state_dict(gfl['model'].state_dict())
    assert lowered(model) == {None}
    with torch.no_grad():
        want, got = plain(x), model(x)
        lowered_outs = gfl['model'](x)
    for a, b in zip(port_outputs(want), port_outputs(got)):
        assert np.array_equal(a, b)
    # and the bf16 model computes something else
    assert any(not np.array_equal(a, b) for a, b in
               zip(port_outputs(want), port_outputs(lowered_outs)))


def test_scale_multiplies_the_float32_conv_output():
    """JAX's `(gfl_reg(x) * scales[lvl]).astype(f32)` promotes the bf16 conv
    output against the float32 scale before any rounding; in torch a bf16
    tensor times a 0-dim float32 parameter stays bf16."""
    model = seeded(build_detector(gfl_cfg(), dtype='bfloat16'), 2).eval()
    head = model.bbox_head
    with torch.no_grad():
        for s in head.scales:
            s.scale.fill_(1.1)
    convs = []
    hook = head.gfl_reg.register_forward_hook(
        lambda mod, args, out: convs.append(out))
    with torch.no_grad():
        _, bbox_preds = model(torch.from_numpy(image(1)))
    hook.remove()
    scale = head.scales[0].scale
    for conv_out, pred in zip(convs, bbox_preds):
        assert conv_out.dtype == torch.bfloat16
        assert pred.dtype == torch.float32
        assert torch.equal(pred, conv_out.float() * scale)
    rounded = [(c * scale).float() for c in convs]
    assert {r.dtype for r in rounded} == {torch.float32}
    assert any(not torch.equal(p, r) for p, r in zip(bbox_preds, rounded))


# ---- one LD step ------------------------------------------------------------

def _jax_gi_masks(head, outs, soft_label, soft_target):
    """The JAX LD head's GI mask of each level, as its `_imitation_loss`
    computes them."""
    cls_flat, pred_flat = j_flatten(outs[0]), j_flatten(outs[1])
    soft_label, soft_target = j_flatten(soft_label), j_flatten(soft_target)
    anchors, num_lvl, _, _ = head.level_geometry(
        [c.shape[1:3] for c in outs[0]])
    b, masks, lo = cls_flat.shape[0], [], 0
    for lvl, n in enumerate(num_lvl):
        hi = lo + n
        centers = jnp.tile(j_anchor_center(anchors[lo:hi]) /
                           head.anchor_generator.strides[lvl][0], (b, 1))
        masks.append(head._gi_mask(
            cls_flat[:, lo:hi].reshape(-1, head.cls_out_channels),
            soft_label[:, lo:hi].reshape(-1, head.cls_out_channels),
            pred_flat[:, lo:hi].reshape(-1, pred_flat.shape[-1]),
            soft_target[:, lo:hi].reshape(-1, pred_flat.shape[-1]),
            centers, gi_candidates=head.gi_candidates, gi_top=head.gi_top))
        lo = hi
    return masks


@pytest.fixture(scope='module')
def ld():
    """The bf16 LD detector (student seed 0, dict teacher seed 1) in both
    packages on the same weights and batch: the JAX networks in bf16 op by
    op, its loss (on float32 predictions and features) jitted."""
    model = build_detector(ld_cfg(), dtype='bfloat16')
    seeded(model, 0)
    seeded(model.teacher, 1)
    det = jax_build_detector(ld_cfg(), dtype='bfloat16')
    shape = (1, ) + HW + (3, )
    variables = to_jax_variables(model, det, shape)
    t_vars = to_jax_variables(model.teacher, det.teacher, shape)
    np_batch = detection_batch_np(1, *HW, num_classes=4, max_gts=6, seed=5)
    np_batch['image'] = image()
    j_batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    j_batch['image'] = nhwc(np_batch['image'])
    outs, feats = det.apply(variables, j_batch['image'], train=True,
                            output_features=True)
    t_outs, t_feats = det.teacher.apply(t_vars, j_batch['image'],
                                        output_features=True)
    assert feats[0].dtype == t_feats[0].dtype == jnp.bfloat16
    want = jax.jit(lambda o, f, to, tf: det.bbox_head.loss(
        o, j_batch, [c.shape[1:3] for c in o[0]], tuple(to),
        student_feats=f, teacher_feats=tf))(outs, feats, t_outs, t_feats)
    masks = jax.jit(lambda o, to: _jax_gi_masks(
        det.bbox_head, o, to[0], to[1]))(outs, t_outs)
    return dict(model=model, batch={k: torch.from_numpy(v)
                                    for k, v in np_batch.items()},
                want={k: float(v) for k, v in want.items()},
                masks=[np.asarray(m) for m in masks])


def test_bf16_ld_step_matches_jax(ld):
    model = ld['model'].train()
    model.zero_grad(set_to_none=True)
    got = model.forward_train(ld['batch'])
    assert sorted(got) == sorted(LD_KEYS)
    rel = {}
    for k in LD_KEYS:
        g, w = float(got[k].detach()), ld['want'][k]
        assert np.isfinite(g), k
        rel[k] = abs(g - w) / max(abs(w), 1e-12)
        # measured worst: loss_kd, 1.40e-2 (the class KD over the image's
        # few positives); every other term within 1.4e-3
        assert abs(g - w) <= 2e-2 * abs(w) + 1e-7, (k, g, w)
    assert float(got['loss_im'].detach()) > 0
    sum(v for v in got.values()).backward()
    params = list(model.parameters())
    assert {p.dtype for p in params} == {torch.float32}
    grads = [p.grad for p in params if p.grad is not None]
    assert grads and {g.dtype for g in grads} == {torch.float32}
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(p.grad is None for p in model.teacher.parameters())


def test_bf16_gi_masks_match_jax(ld):
    model = ld['model'].eval()
    x = ld['batch']['image']
    with torch.no_grad():
        outs = model(x)
        t_outs = model.teacher(x)
    got = model.bbox_head.gi_masks(outs, t_outs)
    assert len(got) == len(ld['masks']) == 5
    for g, w in zip(got, ld['masks']):
        np.testing.assert_array_equal(g.numpy(), w)
        assert 0 < g.sum() <= model.bbox_head.gi_top


# ---- the entry points -------------------------------------------------------

def _narrow(model_cfg):
    model_cfg.neck.out_channels = 64
    model_cfg.bbox_head.in_channels = 64
    model_cfg.bbox_head.feat_channels = 64
    return model_cfg


def _runtime_cfg():
    """The R18 self-LD VOC config, its own dtype (bfloat16), the student
    at width 64, its teacher from its config path, on 3 synthetic 64x96
    images; the test split is the val one."""
    cfg = Config.fromfile(os.path.join(ROOT, LD_R18_CFG))
    _narrow(cfg.model)
    cfg.model.teacher_ckpt = None
    pipe = [dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    synth = dict(type='SyntheticDetectionDataset', hw=(64, 96),
                 num_classes=20, max_boxes=4, draw_boxes=True)
    val = dict(synth, num_images=2, seed=1,
               pipeline=[pipe[0], dict(type='Collect', keys=['img'])])
    cfg.data = dict(samples_per_gpu=3,
                    train=dict(synth, num_images=3, pipeline=pipe),
                    val=val, test=val)
    cfg.pad_to = (64, 96)
    cfg.runner = dict(max_epochs=1)
    cfg.log_config = dict(interval=1)
    cfg.evaluation = dict(interval=0)
    return cfg


def test_init_detector_applies_the_config_dtype():
    cfg = Config.fromfile(os.path.join(ROOT,
                                       'configs/gfl/gfl_r18_fpn1x_voc.py'))
    _narrow(cfg.model)
    assert cfg.dtype == 'bfloat16'
    model = init_detector(cfg, device='cpu', seed=3)
    assert lowered(model) == {torch.bfloat16}
    cfg.dtype = 'float32'
    plain = init_detector(cfg, device='cpu', seed=3)
    assert lowered(plain) == {None}
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              plain.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    work_dir = str(tmp_path_factory.mktemp('bf16_run'))
    ret = train_detector(_runtime_cfg(), work_dir, device='cpu')
    return work_dir, ret


def test_train_detector_trains_bf16_towers_on_float32_state(trained):
    work_dir, ret = trained
    model, optimizer = ret['model'], ret['optimizer']
    assert ret['step'] == 1 and not ret['diverged']
    for part in (model.backbone, model.neck, model.bbox_head):
        assert lowered(part) == {torch.bfloat16}
    assert lowered(model.teacher) == {None}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in model.parameters()
            if p.grad is not None} == {torch.float32}
    state = [v for s in optimizer.state.values() for v in s.values()
             if torch.is_tensor(v)]
    assert state and {v.dtype for v in state} == {torch.float32}
    ckpt = os.path.join(work_dir, 'checkpoints', '1.pth')
    sd = read_state_dict(ckpt)
    assert {v.dtype for v in sd.values() if v.is_floating_point()} == \
        {torch.float32}
    # the bf16 run's checkpoint loads into a float32 model, and back
    cfg = _runtime_cfg()
    plain = build_detector(cfg.model)
    load_checkpoint(plain, ckpt)
    back = build_detector(cfg.model, dtype=cfg.dtype)
    back.load_state_dict(plain.state_dict(), strict=True)
    for k, v in back.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_tools_test_applies_the_config_dtype(trained, tmp_path, monkeypatch):
    import importlib.util
    work_dir, ret = trained
    path = str(tmp_path / 'cfg.py')
    _runtime_cfg().dump(path)
    ckpt = os.path.join(work_dir, 'checkpoints', '1.pth')
    spec = importlib.util.spec_from_file_location(
        'tool_test_bf16', os.path.join(ROOT, 'ld_tpu_torch', 'tools',
                                       'test.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    built = []

    def capture(*args, **kwargs):
        built.append(init_detector(*args, **kwargs))
        return built[-1]
    monkeypatch.setattr(tool, 'init_detector', capture)
    out = tool.main([path, ckpt, '--eval', 'bbox', '--device', 'cpu'])
    assert lowered(built[0].backbone) == {torch.bfloat16}
    model = init_detector(path, ckpt, device='cpu')
    want = eval_detector(model, build_dataset(Config.fromfile(path)
                                              .data['test']),
                         pad_hw=(64, 96))
    assert len(out['results']) == len(want) == 2
    for a, b in zip(out['results'], want):
        assert np.array_equal(a['boxes'], b['boxes'])
        assert np.array_equal(a['labels'], b['labels'])


# ---- the reduced-dtype NMS IoU ----------------------------------------------

def _port_nms(boxes, scores, **kw):
    out = multiclass_nms(torch.from_numpy(np.array(boxes))[None],
                         torch.from_numpy(np.array(scores))[None], 0.05, 0.6,
                         max_per_img=100, **kw)
    return [t[0].numpy() for t in out]


@pytest.mark.parametrize('dtype', ['float16', 'bfloat16'])
def test_reduced_iou_dtype_nms_equals_jax(dtype):
    """The class-mask fixpoint on raw boxes / 32 in the reduced dtype keeps
    exactly JAX's boxes on tests/test_nms_bf16.py's clustered candidates
    (each bf16 / f16 op rounds as the JAX op does)."""
    for seed in range(3):
        boxes, scores = _candidates(seed)
        want = j_multiclass_nms(boxes, scores, 0.05, 0.6, max_per_img=100,
                                iou_dtype=getattr(jnp, dtype))
        got = _port_nms(boxes, scores, iou_dtype=dtype)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    # test_cfg.nms.iou_dtype reaches it too
    assert all(np.array_equal(a, b) for a, b in zip(
        got, _port_nms(boxes, scores, nms_cfg=dict(iou_dtype=dtype))))


@pytest.mark.parametrize('dtype,floor', [('float16', 0.95),
                                         ('bfloat16', 0.85)])
def test_reduced_iou_dtype_agreement_with_float32(dtype, floor):
    """The JAX floors of tests/test_nms_bf16.py: det-set agreement with the
    float32 NMS (measured in the port as in JAX: 0.980 float16, 0.881
    bfloat16), and every det a real input box."""
    agree, total = 0, 0
    for seed in range(10):
        boxes, scores = _candidates(seed)
        ref = _sets(*_port_nms(boxes, scores))
        dets, labels, valid = _port_nms(boxes, scores, iou_dtype=dtype)
        agree += len(ref & _sets(dets, labels, valid))
        total += len(ref)
        src = np.asarray(boxes)
        for i in np.where(valid)[0]:
            assert (np.abs(src - dets[i, :4]) < 1e-4).all(axis=1).any()
    assert agree / total > floor, agree / total


def test_float32_iou_dtype_takes_the_keep_kernel():
    boxes, scores = _candidates(3)
    calls = []

    def keep_fn(*args):
        calls.append(1)
        from ld_tpu_torch.ops.nms_cuda import nms_keep
        return nms_keep(*args)
    plain = _port_nms(boxes, scores, keep_fn=keep_fn)
    f32 = _port_nms(boxes, scores, iou_dtype='float32', keep_fn=keep_fn)
    assert len(calls) == 2
    assert all(np.array_equal(a, b) for a, b in zip(plain, f32))
    _port_nms(boxes, scores, iou_dtype='bfloat16', keep_fn=keep_fn)
    assert len(calls) == 2
