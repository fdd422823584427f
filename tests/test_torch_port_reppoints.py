"""The port's RepPoints against the JAX package on the same weights and
inputs: `PointAssigner`, `points2bbox_shifts`, `gen_grid_from_reg`,
`RepPointsHead` (the moment and the grid forms, both init assigners) and
the RepPoints detector.

The weights go JAX -> port: `jax.eval_shape` of the JAX init gives the
variable tree, `fill_tree` fills it from a numpy seed (so the init points,
and with them the DCN offsets, are off the regular grid), and
`state_dict_from_jax` carries it onto mmdet's names strictly (the JAX
converter has no RepPoints rule, asserted below). The gt batch is the
Guided Anchoring file's: the bridge's 2x64x96 one with two large gts an
image, on two levels. Float32 on the CPU:
  * `PointAssigner` at pos_num 1 and 3 on that batch, and on gts whose
    centres lie halfway between two points of their level and a point
    equidistant from two gts (ties go to the lower index, as the JAX
    iterated argmin): every field equal;
  * `points2bbox_shifts` ('minmax', 'partial_minmax', 'moment') and
    `gen_grid_from_reg`: values within 1e-6 of the largest, and the
    gradients of the points, the moment transfer and the regression;
  * the head (width 64, 2 stacked convs, 4 classes, on the bridge's random
    FPN features; 'moment' with the PointAssigner init, 'moment' with the
    MaxIoU init of the head's own `train_cfg`, and the grid form with
    'minmax'): its three outputs within 1e-5 of each level's largest value
    (1e-3 on the 1x1 top level, where GN normalises two values a group);
    its losses on identical outputs to rtol 2e-4; the gradient of the
    summed loss (through the port's own forward: the gradient_mul mix, the
    detached init term, the moment_mul split) for every head parameter
    within 1e-4 of its largest, against the JAX head run in float64 (its
    float32 run's tower gradients lie 3e-3 - 1.2e-2 from it, below); the
    moment head's detections
    on identical outputs: labels and valid mask equal, boxes and scores
    within 1e-4;
  * a RepPoints R18 (configs/reppoints/reppoints_moment_r50_fpn_gn-neck+
    head_1x_coco.py at depth 18, width 64) on the 2x3x64x96 batch: the
    head outputs within 5e-3 absolute (the bridge's bound), the
    `forward_train` loss dict to rtol 1e-3 and the `forward_test`
    detections (labels and valid mask equal, boxes within 5e-3 x 8 px: the
    outputs' bound times the finest stride);
  * every config of configs/reppoints/ builds on the meta device.

The `ref` fixture traces every JAX program once and compiles each in a
thread as soon as it is traced, at LLVM -O0 (each runs once).
"""
import contextlib
import copy
import glob
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.models.heads.reppoints_head import \
    gen_grid_from_reg as j_gen_grid_from_reg
from ld_tpu.models.heads.reppoints_head import \
    points2bbox_shifts as j_points2bbox_shifts
from ld_tpu.ops.extra_assigners import PointAssigner as JPointAssigner
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads.reppoints_head import (RepPointsHead,
                                                      gen_grid_from_reg,
                                                      points2bbox_shifts)
from ld_tpu_torch.ops.deform_conv import DeformConv, ModulatedDeformConv2d
from ld_tpu_torch.ops.extra_assigners import PointAssigner
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import (OUT_ABS, TEST_CFG, assert_losses_close,
                                    fill_tree, fpn_feats, nchw)
from test_torch_port_guided_anchoring import (SIZES, assert_dets_close,
                                              assert_levels_close,
                                              ga_batches, numpy_tree)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(
    ROOT, 'configs/reppoints/reppoints_moment_r50_fpn_gn-neck+head_1x_coco.py')
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/reppoints/*.py')))
MAXIOU_INIT = dict(init=dict(assigner=dict(
    type='MaxIoUAssigner', pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0,
    ignore_iof_thr=-1)))
HEAD_CASES = {
    'moment': {},
    'moment_maxiou_init': dict(train_cfg=MAXIOU_INIT),
    'grid': dict(transform_method='minmax', use_grid_points=True),
}
# the head cases by net: the two moment cases share one
FORMS = {'moment': ('moment', 'moment_maxiou_init'), 'grid': ('grid', )}
METHODS = ('minmax', 'partial_minmax', 'moment')
GRAD_RTOL = 1e-4
# the detector's boxes are its outputs (held within OUT_ABS, in stride
# units) times the stride: OUT_ABS x 8 px at the finest level
BOX_TOL = OUT_ABS * 8
STRIDES = (8., 16., 32., 64., 128.)


def head_cfg(name):
    return dict(type='RepPointsHead', num_classes=4, in_channels=64,
                feat_channels=64, point_feat_channels=64, stacked_convs=2,
                test_cfg=TEST_CFG, **HEAD_CASES[name])


def r18_cfg(cfg):
    model = cfg['model']
    model['backbone']['depth'] = 18
    model['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    model['bbox_head'].update(in_channels=64, feat_channels=64,
                              point_feat_channels=64)
    return model


def points3():
    """Every location of the bridge's five levels as (x, y, stride)."""
    pts = []
    for (h, w), s in zip(SIZES, STRIDES):
        xs = np.tile(np.arange(w) * s, h)
        ys = np.repeat(np.arange(h) * s, w)
        pts.append(np.stack([xs, ys, np.full(h * w, s)], -1))
    return np.concatenate(pts).astype(np.float32)


def tied_gts():
    """Gts whose centres lie halfway between points of their level: at
    stride 8, (12, 16) between x = 8 and 16, (16, 20) between y = 16 and
    24, (16, 12) between y = 8 and 16, all three equally far from the
    point (16, 16); at stride 16, (40, 24) amid four points.
    (gt_bboxes, gt_labels, gt_valid), batch 1."""
    gt = np.array([[[4., 8., 20., 24.], [8., 12., 24., 28.],
                    [8., 4., 24., 20.], [16., 0., 64., 48.],
                    [0., 0., 0., 0.]]], np.float32)
    labels = np.array([[0, 1, 2, 3, 0]])
    valid = np.array([[True, True, True, True, False]])
    return gt, labels, valid


def shift_inputs():
    rs = np.random.RandomState(0)
    pts = (rs.randn(2, 6, 18) * 2).astype(np.float32)
    mt = rs.uniform(-0.5, 0.5, 2).astype(np.float32)
    reg = (rs.randn(2, 6, 4) * 0.5).astype(np.float32)
    prev = np.concatenate([rs.uniform(-8, 0, (2, 6, 2)),
                           rs.uniform(1, 8, (2, 6, 2))], -1).astype(
                               np.float32)
    cot = rs.randn(2, 6, 4).astype(np.float32)
    cot_pts = rs.randn(2, 6, 18).astype(np.float32)
    return pts, mt, reg, prev, cot, cot_pts


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against, on numpy-filled
    variables; numpy trees and outputs."""
    j_batch, t_batch = ga_batches()
    out = {}
    jobs = {}
    X64 = set()

    # PointAssigner on the batch and on the tied gts
    pts = points3()
    for pos_num in (1, 3):
        assigner = JPointAssigner(scale=4, pos_num=pos_num)

        def assign(p, gb, gl, gv, assigner=assigner):
            return tuple(jax.vmap(lambda gb, gl, gv: assigner.assign(
                p, None, gb, gl, gv, num_classes=4))(gb, gl, gv))
        for name, (gb, gl, gv) in (
                ('batch', (j_batch['gt_bboxes'], j_batch['gt_labels'],
                           j_batch['gt_valid'])),
                ('tied', tied_gts())):
            jobs[f'point_{name}_{pos_num}'] = (
                assign, (pts, gb, jnp.asarray(gl, jnp.int32), gv))

    # points2bbox_shifts and gen_grid_from_reg: values and vjps
    p, mt, reg, prev, cot, cot_pts = shift_inputs()

    def shifts(p, mt, reg, prev, cot, cot_pts):
        res = {}
        for method in METHODS:
            y, vjp = jax.vjp(lambda p, mt, method=method: j_points2bbox_shifts(
                p, method, mt, 0.01), p, mt)
            res[method] = (y, ) + vjp(cot)
        (g, box), vjp = jax.vjp(lambda r, b: j_gen_grid_from_reg(r, b, 3),
                                reg, prev)
        res['grid'] = (g, box) + vjp((cot_pts, cot))
        return res
    jobs['shifts'] = (shifts, (p, mt, reg, prev, cot, cot_pts))

    # the head: outputs, losses, gradients, decode, one program a point
    # form, in float64: the JAX float32 gradient of the towers lies 3e-3 -
    # 1.2e-2 (relative) from its float64 one, where the port's float32
    # gradient is within 4e-5 of it (flax's GroupNorm takes E[x^2] -
    # E[x]^2, which cancels on the two-value groups of width 64 at 32
    # groups on the small levels: the likely cause)
    feats = [jnp.asarray(f) for f in fpn_feats(seed=4)]
    for form, names in FORMS.items():
        heads = {n: JAX_HEADS.build(dict(head_cfg(n), dtype=jnp.float64))
                 for n in names}
        net = heads[names[0]].net
        with jax.enable_x64():
            v = fill_tree(jax.eval_shape(lambda: net.init(
                jax.random.PRNGKey(0), feats)), seed=7)
        out.update({f'head_{n}': v for n in names})

        def head_run(v, feats, b, heads=heads, net=net):
            outs, vjp = jax.vjp(lambda v: net.apply(v, feats), v)
            res = {}
            for n, head in heads.items():
                (_, losses), g_outs = jax.value_and_grad(
                    lambda o: (sum(head.loss(o, b, SIZES).values()),
                               head.loss(o, b, SIZES)), has_aux=True)(outs)
                res[n] = (outs, losses, vjp(g_outs)[0],
                          head.get_bboxes(outs, b['img_hw']))
            return res
        jobs[f'head_{form}'] = (head_run, (v, feats, j_batch))
        X64.add(f'head_{form}')

    # the detector: RepPoints R18
    det = j_build_detector(r18_cfg(JConfig.fromfile(CONFIG)))
    dv = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=5)
    out['det'] = dv

    def det_run(v, b):
        outs = det.apply(v, b['image'])
        sizes = [c.shape[1:3] for c in outs[0]]
        return (outs, det.bbox_head.loss(outs, b, sizes),
                det.bbox_head.get_bboxes(outs, b['img_hw']))
    jobs['det'] = (det_run, (dv, j_batch))

    def precision(k):
        return jax.enable_x64() if k in X64 else contextlib.nullcontext()

    def as64(tree):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64)
            if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)
    options = dict(xla_backend_optimization_level=0)
    futures = {}
    with ThreadPoolExecutor(len(jobs)) as pool:
        # each compiles while the next is traced
        for k, (fn, args) in jobs.items():
            if k in X64:
                jobs[k] = (fn, as64(args))
            with precision(k):
                futures[k] = pool.submit(
                    jax.jit(fn).lower(*jobs[k][1]).compile,
                    compiler_options=options)
    for k, (_, args) in jobs.items():
        with precision(k):
            out[f'{k}_out'] = numpy_tree(futures[k].result()(*args))
    return dict(numpy_tree(out), t_batch=t_batch)


def head_out(ref, name):
    """The float64 JAX results of a head case, as float32: (outputs,
    losses, gradients, detections)."""
    form = 'grid' if name == 'grid' else 'moment'
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float32) if a.dtype == np.float64 else a,
        ref[f'head_{form}_out'][name])


def port_head(name, variables):
    head = HEADS.build(head_cfg(name))
    keys = [f'bbox_head.{k}' for k in head.state_dict()]
    sd = state_dict_from_jax({coll: {'head_net': tree}
                              for coll, tree in variables.items()}, keys)
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in sd.items()},
                         strict=True)
    return head.eval()


# ---- the point assigner ---------------------------------------------------------
@pytest.mark.parametrize('pos_num', [1, 3])
@pytest.mark.parametrize('gts', ['batch', 'tied'])
def test_point_assigner_matches_jax(ref, gts, pos_num):
    if gts == 'batch':
        b = ref['t_batch']
        gb, gl, gv = b['gt_bboxes'], b['gt_labels'], b['gt_valid']
    else:
        gb, gl, gv = (torch.from_numpy(a) for a in tied_gts())
    res = PointAssigner(scale=4, pos_num=pos_num).assign(
        torch.from_numpy(points3()), None, gb, gl, gv, num_classes=4)
    want = ref[f'point_{gts}_{pos_num}_out']
    for g, w in zip(res, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if gts == 'batch':
        # the positives lie on two levels (strides 8 and 16)
        level = np.repeat(np.arange(5), [h * w for h, w in SIZES])
        assert set(level[res.pos_mask.numpy().any(0)]) == {0, 1}
        return
    assert set(res.assigned_gt_inds[res.pos_mask].tolist()) == {0, 1, 2, 3}
    pos = torch.nonzero(res.pos_mask[0])[:, 0].tolist()
    if pos_num == 1:
        # the first of each tie in the row-major order: (8, 16), (16, 16),
        # (16, 8) and, of the stride-16 four, (32, 16)
        assert pos == [1 * 12 + 2, 2 * 12 + 1, 2 * 12 + 2, 96 + 1 * 6 + 2]
        assert res.assigned_gt_inds[0, pos].tolist() == [2, 0, 1, 3]
    else:
        # (16, 16), claimed by the first three gts at one distance, goes
        # to the lowest gt index
        assert int(res.assigned_gt_inds[0, 2 * 12 + 2]) == 0


# ---- the point geometry -----------------------------------------------------------
@pytest.mark.parametrize('method', METHODS)
def test_points2bbox_shifts_matches_jax(ref, method):
    p, mt, _, _, cot, _ = shift_inputs()
    want, want_gp, want_gmt = ref['shifts_out'][method]
    tp = torch.from_numpy(p).requires_grad_()
    tmt = torch.from_numpy(mt).requires_grad_()
    got = points2bbox_shifts(tp, method, tmt, 0.01)
    got.backward(torch.from_numpy(cot))
    assert np.abs(got.detach().numpy() - want).max() <= \
        1e-6 * np.abs(want).max()
    assert np.abs(tp.grad.numpy() - want_gp).max() <= \
        1e-6 * np.abs(want_gp).max()
    if method == 'moment':
        # the moment_mul share of the transfer's gradient
        assert np.abs(tmt.grad.numpy() - want_gmt).max() <= \
            1e-6 * np.abs(want_gmt).max()
    else:
        assert tmt.grad is None


def test_gen_grid_from_reg_matches_jax(ref):
    _, _, reg, prev, cot, cot_pts = shift_inputs()
    want_pts, want_box, want_greg, want_gprev = ref['shifts_out']['grid']
    treg = torch.from_numpy(reg).requires_grad_()
    tprev = torch.from_numpy(prev).requires_grad_()
    pts, box = gen_grid_from_reg(treg, tprev, 3)
    (pts * torch.from_numpy(cot_pts)).sum().add(
        (box * torch.from_numpy(cot)).sum()).backward()
    for g, w in ((pts, want_pts), (box, want_box), (treg.grad, want_greg),
                 (tprev.grad, want_gprev)):
        assert np.abs(g.detach().numpy() - w).max() <= 1e-6 * np.abs(w).max()
    # y first, y slowest: the first three points share the top row's y
    ys = pts.detach().numpy()[0, 0, 0::2]
    assert ys[0] == ys[1] == ys[2] < ys[3]


# ---- the head -------------------------------------------------------------------
@pytest.mark.parametrize('name', sorted(HEAD_CASES))
def test_head_outputs_match_jax(ref, name):
    head = port_head(name, ref[f'head_{name}'])
    j_outs = head_out(ref, name)[0]
    with torch.no_grad():
        got = head(nchw(fpn_feats(seed=4)))
    assert len(got) == 3
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w)
    assert sum(isinstance(m, DeformConv) for m in head.modules()) == 2


@pytest.mark.parametrize('name', sorted(HEAD_CASES))
def test_head_losses_match_jax(ref, name):
    """The loss on identical head outputs, under both init assigners."""
    head = port_head(name, ref[f'head_{name}']).train()
    j_outs, want = head_out(ref, name)[:2]
    assert isinstance(head.init_assigner, MaxIoUAssigner if 'maxiou' in name
                      else PointAssigner)
    got = head.loss(tuple(nchw(p) for p in j_outs), ref['t_batch'], SIZES)
    assert sorted(got) == ['loss_cls', 'loss_pts_init', 'loss_pts_refine']
    assert all(float(v) > 0 for v in want.values())
    assert_losses_close(got, want)


@pytest.mark.parametrize('name', sorted(HEAD_CASES))
def test_head_gradients_match_jax(ref, name):
    """The summed loss's gradient through the port's own forward, for every
    head parameter (the JAX gradient tree carried onto the port's names by
    the same map as the weights)."""
    head = port_head(name, ref[f'head_{name}']).train()
    j_grads = head_out(ref, name)[2]
    losses = head.loss(head(nchw(fpn_feats(seed=4))), ref['t_batch'], SIZES)
    sum(losses.values()).backward()
    want = state_dict_from_jax({'params': {'head_net': j_grads['params']}},
                               [f'bbox_head.{k}' for k in head.state_dict()])
    params = dict(head.named_parameters())
    assert sorted(f'bbox_head.{k}' for k in params) == sorted(want)
    for key, p in params.items():
        w = want[f'bbox_head.{key}'].numpy()
        assert np.abs(w).max() > 0, key
        assert np.abs(p.grad.numpy() - w).max() <= \
            GRAD_RTOL * np.abs(w).max(), key


def test_head_detections_match_jax(ref):
    """The decode reads only the class logits and the refine boxes, in any
    point form: the moment head's (the grid head's random DCN taps fall off
    the map at many locations, whose equal logits tie in the NMS, ROADMAP.md
    caveat 2)."""
    head = port_head('moment', ref['head_moment'])
    j_outs, _, _, want = head_out(ref, 'moment')
    got = head.get_bboxes(tuple(nchw(p) for p in j_outs),
                          ref['t_batch']['img_hw'])
    assert_dets_close(got, want, 1e-4)


def test_converter_has_no_reppoints_rule():
    head = HEADS.build(head_cfg('moment'))
    conv = convert_torch_state_dict({f'bbox_head.{k}': v.numpy()
                                     for k, v in head.state_dict().items()})
    unmapped = conv['_unmapped']
    for name in ('reppoints_pts_init_conv.weight', 'reppoints_cls_conv.weight',
                 'reppoints_pts_refine_out.bias', 'moment_transfer'):
        assert f'bbox_head.{name}' in unmapped
    assert 'pts_init_conv' not in conv['params'].get('head_net', {})


# ---- the detector ---------------------------------------------------------------
@pytest.fixture(scope='module')
def detector(ref):
    model = build_detector(r18_cfg(Config.fromfile(CONFIG)))
    model.load_state_dict(state_dict_from_jax(
        ref['det'], list(model.state_dict())), strict=True)
    return model


def test_reppoints_detector_matches_jax(ref, detector):
    j_outs, want, want_dets = ref['det_out']
    t_batch = ref['t_batch']
    assert type(detector).__name__ == 'RepPointsDetector'
    detector.eval()
    with torch.no_grad():
        got = detector(t_batch['image'])
        dets = detector.forward_test(t_batch)
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w, atol=OUT_ABS)
    assert_dets_close(dets, want_dets, BOX_TOL)
    detector.train()
    with torch.no_grad():
        losses = detector.forward_train(t_batch)
    assert_losses_close(losses, want, rtol=1e-3)


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_reppoints_configs_build(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    head = model.bbox_head
    assert type(model).__name__ == 'RepPointsDetector'
    assert isinstance(head, RepPointsHead)
    assert sum(isinstance(m, DeformConv) for m in head.modules()) == 2
    assert head.use_grid_points == ('grid' in path)
    # the top-level train_cfg is read by neither package (caveat 49)
    assert isinstance(head.init_assigner, PointAssigner)
    dconv = 'dconv' in path
    assert any(isinstance(m, ModulatedDeformConv2d)
               for m in model.backbone.modules()) == dconv
