"""The port's VarifocalNet against the JAX package on the same weights and
inputs: the star DCN's `DeformConv`, `VarifocalLoss`, `VFNetHead` and a
VFNet detector.

The weights go JAX -> port: `jax.eval_shape` of the JAX init gives the
variable tree, `fill_tree` fills it from a numpy seed, and
`state_dict_from_jax` carries it onto mmdet's names strictly (the JAX
converter has no VFNet rule: ROADMAP.md caveat 45, asserted below). The
initial-regression bias is set to -2 so that the star taps land a few
cells from their base (on the map, between pixels), and the class bias
to 0 so that the decode sees candidates. Float32 on the CPU:
  * `DeformConv` at 2x16x9x11 with offsets of +-2.5 cells: forward within
    1e-5 of the largest output, the input's, offsets' and kernel's
    gradients within 1e-4 of the largest; zero offsets give F.conv2d to
    1e-5;
  * `VarifocalLoss` with and without `iou_weighted`: value to rtol 1e-6,
    gradient to 1e-6 of its largest;
  * the head (width 64, 2 stacked convs, 4 classes, on the bridge's random
    FPN features of a 2x64x96 batch), plain and with `dcn_on_last_conv`:
    its three outputs within 1e-5 of each level's largest value (1e-3 on
    the 1x1 top level, where GN normalises two values a group); its loss
    dict on identical outputs to rtol 2e-4; for the plain head (the DCN
    tower changes neither), the total loss's gradient with respect to the
    initial-regression conv (reached through the GIoU of the initial boxes
    and the `gradient_mul` share of the star offsets) and the class DCN's
    kernel within 1e-4 of their largest, and its detections on identical
    outputs: the same labels and valid mask, boxes and scores to 1e-4;
  * a VFNet R18 from configs/vfnet/vfnet_r50_fpn_1x_coco.py at depth 18
    (FPN and head width 64) on the bridge's 2x3x64x96 batch: the three
    head outputs within 5e-3 absolute (the bridge's bound), the port's
    `forward_train` loss dict to rtol 1e-3 and its `forward_test`
    detections (labels and valid mask equal, boxes and scores to 1e-3)
    against the JAX head's loss and decode of its one forward, which is
    what its `forward_train` / `forward_test` compute with the R18's frozen
    BNs;
  * every config of configs/vfnet/ builds on the meta device in its bf16
    dtype, with the layers its name asks for.

The `ref` fixture traces every JAX program once and compiles each in a
thread as soon as it is traced, at LLVM -O0 (each runs once).
"""
import glob
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.ops.deform_conv import DeformConv as JDeformConv
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu.utils.registry import LOSSES as JAX_LOSSES
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads.vfnet_head import VFNetHead
from ld_tpu_torch.ops.deform_conv import DeformConv, ModulatedDeformConv2d
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from test_torch_port_bridge import (HEAD_KW, OUT_ABS, TEST_CFG,
                                    assert_losses_close, batches, fill_tree,
                                    fpn_feats, nchw)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs/vfnet/vfnet_r50_fpn_1x_coco.py')
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/vfnet/*.py')))
HEADS_CASES = {'plain': {}, 'dcn': dict(dcn_on_last_conv=True)}
VFL_CASES = {'iou_weighted': True, 'plain': False}
# a DeformConv case: (batch, channels, h, w, out channels)
DCONV_SHAPE = (2, 16, 9, 11, 8)
# on the 1x1 top level a GroupNorm normalises two values a group, which
# amplifies fp32 rounding: 1e-3 there, as in the classic heads' file
OUT_RTOL, OUT_TOP_RTOL, GRAD_RTOL = 1e-5, 1e-3, 1e-4
DET_TOL = 1e-3


def head_cfg(name):
    return dict(type='VFNetHead', **HEAD_KW, **HEADS_CASES[name],
                test_cfg=TEST_CFG)


def r18_cfg(cfg):
    """The config's model at depth 18, FPN and head width 64."""
    model = cfg['model']
    model['backbone']['depth'] = 18
    model['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    model['bbox_head'].update(in_channels=64, feat_channels=64)
    return model


def seed_biases(params):
    """The initial-regression bias at -2 (star taps a few cells out) and
    the class bias at 0 (a decode with candidates)."""
    params['vfnet_reg']['bias'] = np.full_like(params['vfnet_reg']['bias'],
                                               -2.0)
    params['vfnet_cls']['bias'] = np.zeros_like(params['vfnet_cls']['bias'])


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def dconv_inputs():
    b, c, h, w, o = DCONV_SHAPE
    rs = np.random.RandomState(0)
    x = rs.randn(b, h, w, c).astype(np.float32)
    offset = rs.uniform(-2.5, 2.5, (b, h, w, 18)).astype(np.float32)
    kernel = (rs.randn(9 * c, o) / np.sqrt(9 * c)).astype(np.float32)
    cot = rs.randn(b, h, w, o).astype(np.float32)
    return x, offset, kernel, cot


def vfl_inputs():
    """(2, 40, 4) logits and IoU targets: a quarter of the rows positive at
    one class, with IoUs in (0.05, 1)."""
    rs = np.random.RandomState(1)
    pred = (rs.randn(2, 40, 4) * 2).astype(np.float32)
    target = np.zeros_like(pred)
    pos = rs.rand(2, 40) < 0.25
    cls = rs.randint(0, 4, (2, 40))
    target[pos, cls[pos]] = rs.uniform(0.05, 1.0, pos.sum())
    return pred, target, rs.randn(*pred.shape).astype(np.float32)


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against, on numpy-filled
    variables; numpy trees and outputs."""
    j_batch, t_batch = batches()
    out = {}
    jobs = {}

    # DeformConv: forward and the vjp of a random cotangent
    x, offset, kernel, cot = dconv_inputs()
    dconv = JDeformConv(DCONV_SHAPE[4])

    def dconv_vjp(x, offset, kernel, cot):
        def f(x, offset, kernel):
            return dconv.apply({'params': {'kernel': kernel}}, x, offset)
        y, vjp = jax.vjp(f, x, offset, kernel)
        return (y, ) + vjp(cot)
    jobs['dconv'] = (dconv_vjp, (x, offset, kernel, cot))

    # VarifocalLoss: value and gradient
    pred, target, _ = vfl_inputs()
    for name, weighted in VFL_CASES.items():
        loss = JAX_LOSSES.build(dict(type='VarifocalLoss',
                                     iou_weighted=weighted))
        jobs[f'vfl_{name}'] = (jax.value_and_grad(
            lambda p, t, loss=loss: loss(p, t, avg_factor=7.0)),
            (pred, target))

    # the head: outputs, loss, its gradient, detections
    feats = [jnp.asarray(f) for f in fpn_feats(seed=4)]
    sizes = [f.shape[1:3] for f in feats]
    for name in HEADS_CASES:
        j_head = JAX_HEADS.build(head_cfg(name))
        v = fill_tree(jax.eval_shape(lambda: j_head.net.init(
            jax.random.PRNGKey(0), feats)), seed=7)
        seed_biases(v['params'])
        out[f'head_{name}'] = v

        def head_run(v, feats, b, j_head=j_head, full=name == 'plain'):
            if not full:    # the DCN tower's loss and decode are the same
                outs = j_head.net.apply(v, feats)
                return outs, j_head.loss(outs, b, sizes)

            def total(v):
                outs = j_head.net.apply(v, feats)
                losses = j_head.loss(outs, b, sizes)
                return sum(losses.values()), (outs, losses)
            (_, (outs, losses)), grads = jax.value_and_grad(
                total, has_aux=True)(v)
            return outs, losses, grads, j_head.get_bboxes(outs, b['img_hw'])
        jobs[f'head_{name}'] = (head_run, (v, feats, j_batch))

    # the detector: VFNet R18
    det = j_build_detector(r18_cfg(JConfig.fromfile(CONFIG)))
    dv = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=5)
    seed_biases(dv['params']['head_net'])
    out['det'] = dv

    def det_run(v, b):
        # forward_train and forward_test are the loss and the decode of
        # these outputs (the R18's BNs are frozen, norm_eval): one trace
        outs = det.apply(v, b['image'])
        sizes = [c.shape[1:3] for c in outs[0]]
        return (outs, det.bbox_head.loss(outs, b, sizes),
                det.bbox_head.get_bboxes(outs, b['img_hw'],
                                         b.get('scale_factor')))
    jobs['det'] = (det_run, (dv, j_batch))

    options = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(len(jobs)) as pool:
        # each compiles while the next is traced
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=options)
                   for k, (fn, args) in jobs.items()}
    for k, (_, args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*args)
    return dict(numpy_tree(out), t_batch=t_batch)


def port_head(name, variables):
    head = HEADS.build(head_cfg(name))
    keys = [f'bbox_head.{k}' for k in head.state_dict()]
    sd = state_dict_from_jax({coll: {'head_net': tree}
                              for coll, tree in variables.items()}, keys)
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in sd.items()},
                         strict=True)
    return head.eval()


def assert_levels_close(got, want, rtol=OUT_RTOL, atol=None):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        g = g.detach().numpy().transpose(0, 2, 3, 1)
        w = np.asarray(w)
        assert g.shape == w.shape
        if w.shape[1:3] == (1, 1) and rtol == OUT_RTOL:
            rtol = OUT_TOP_RTOL
        bound = atol if atol is not None else rtol * np.abs(w).max()
        diff = float(np.abs(g - w).max())
        assert diff <= bound, (diff, bound)


def assert_dets_close(got, want, tol):
    dets, labels, valid = (t.detach().numpy() for t in got)
    w_dets, w_labels, w_valid = (np.asarray(a) for a in want)
    assert valid.sum() > 0
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_array_equal(labels[valid], w_labels[w_valid])
    np.testing.assert_allclose(dets[valid], w_dets[w_valid], rtol=0,
                               atol=tol)


# ---- DeformConv ---------------------------------------------------------------
def test_deform_conv_matches_jax(ref):
    x, offset, kernel, cot = dconv_inputs()
    y, gx, goff, gk = ref['dconv_out']
    b, c, h, w, o = DCONV_SHAPE
    layer = DeformConv(c, o)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            kernel.reshape(3, 3, c, o).transpose(3, 2, 0, 1).copy()))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    toff = torch.from_numpy(offset.transpose(0, 3, 1, 2).copy()) \
        .requires_grad_()
    got = layer(tx, toff)
    got.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    for g, want in ((got.detach(), y), (tx.grad, gx), (toff.grad, goff)):
        g = g.numpy().transpose(0, 2, 3, 1)
        rtol = OUT_RTOL if want is y else GRAD_RTOL
        assert np.abs(g - want).max() <= rtol * np.abs(want).max()
    # the kernel's gradient, in the JAX (9*C, O) layout
    gw = layer.weight.grad.numpy().transpose(2, 3, 1, 0).reshape(9 * c, o)
    assert np.abs(gw - gk).max() <= GRAD_RTOL * np.abs(gk).max()
    assert float(np.abs(goff).max()) > 0


def test_deform_conv_zero_offsets_are_a_plain_conv():
    torch.manual_seed(0)
    layer = DeformConv(16, 8)
    x = torch.randn(2, 16, 9, 11)
    got = layer(x, torch.zeros(2, 18, 9, 11))
    want = F.conv2d(x, layer.weight, padding=1)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# ---- VarifocalLoss --------------------------------------------------------------
@pytest.mark.parametrize('name', sorted(VFL_CASES))
def test_varifocal_loss_matches_jax(ref, name):
    pred, target, _ = vfl_inputs()
    want, want_grad = ref[f'vfl_{name}_out']
    loss = LOSSES.build(dict(type='VarifocalLoss',
                             iou_weighted=VFL_CASES[name]))
    p = torch.from_numpy(pred).requires_grad_()
    got = loss(p, torch.from_numpy(target), avg_factor=7.0)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    assert np.abs(p.grad.numpy() - want_grad).max() <= \
        1e-6 * np.abs(want_grad).max()


# ---- the head -------------------------------------------------------------------
@pytest.mark.parametrize('name', sorted(HEADS_CASES))
def test_head_outputs_match_jax(ref, name):
    head = port_head(name, ref[f'head_{name}'])
    j_outs = ref[f'head_{name}_out'][0]
    with torch.no_grad():
        got = head(nchw(fpn_feats(seed=4)))
    assert len(got) == 3
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w)
    dcns = [m for m in head.modules() if isinstance(m, ModulatedDeformConv2d)]
    assert len(dcns) == (2 if name == 'dcn' else 0)
    assert sum(isinstance(m, DeformConv) for m in head.modules()) == 2


@pytest.mark.parametrize('name', sorted(HEADS_CASES))
def test_head_losses_match_jax(ref, name):
    """The loss on identical head outputs."""
    head = port_head(name, ref[f'head_{name}']).train()
    j_outs, want = ref[f'head_{name}_out'][:2]
    sizes = [tuple(np.shape(c)[1:3]) for c in j_outs[0]]
    got = head.loss(tuple(nchw(p) for p in j_outs), ref['t_batch'], sizes)
    assert sorted(got) == ['loss_bbox', 'loss_bbox_rf', 'loss_cls']
    assert float(want['loss_bbox_rf']) > 0
    assert_losses_close(got, want)


def test_head_gradients_match_jax(ref):
    """The total loss's gradient through the port's own forward."""
    head = port_head('plain', ref['head_plain']).train()
    j_outs, _, j_grads, _ = ref['head_plain_out']
    sizes = [tuple(np.shape(c)[1:3]) for c in j_outs[0]]
    losses = head.loss(head(nchw(fpn_feats(seed=4))), ref['t_batch'], sizes)
    sum(losses.values()).backward()
    for key, module in (('vfnet_reg', head.vfnet_reg),
                        ('vfnet_cls_dconv', head.vfnet_cls_dconv)):
        want_k = j_grads['params'][key]['kernel']
        g = module.weight.grad.numpy()
        g = g.transpose(2, 3, 1, 0).reshape(want_k.shape)
        assert np.abs(want_k).max() > 0, key
        assert np.abs(g - want_k).max() <= \
            GRAD_RTOL * np.abs(want_k).max(), key


def test_head_offsets_carry_a_gradient_mul_share():
    """With gradient_mul 0 the star offsets send no gradient to the initial
    regression: vfnet_reg's gradient is then the initial GIoU's alone."""
    grads = {}
    for mul in (0.0, 0.1):
        torch.manual_seed(0)
        head = VFNetHead(**HEAD_KW, gradient_mul=mul)
        head.init_weights(torch.Generator().manual_seed(0))
        outs = head(nchw(fpn_feats(seed=4)))
        # the refined and class outputs only: no initial-box loss
        (outs[0][0].sum() + outs[2][0].sum()).backward()
        grads[mul] = head.vfnet_reg.weight.grad
    assert grads[0.0] is None or float(grads[0.0].abs().max()) == 0.0
    assert float(grads[0.1].abs().max()) > 0


def test_head_detections_match_jax(ref):
    head = port_head('plain', ref['head_plain'])
    j_outs, _, _, want = ref['head_plain_out']
    got = head.get_bboxes(tuple(nchw(p) for p in j_outs),
                          ref['t_batch']['img_hw'])
    assert_dets_close(got, want, 1e-4)


def test_converter_has_no_vfnet_rule():
    """ROADMAP.md caveat 45: the JAX converter leaves the VFNet names
    unmapped, which is why the weights go JAX -> port here."""
    head = HEADS.build(head_cfg('plain'))
    conv = convert_torch_state_dict({f'bbox_head.{k}': v.numpy()
                                     for k, v in head.state_dict().items()})
    unmapped = conv['_unmapped']
    for name in ('vfnet_reg.weight', 'vfnet_cls_dconv.weight',
                 'vfnet_reg_conv.gn.weight', 'scales_refine.0.scale'):
        assert f'bbox_head.{name}' in unmapped
    assert 'scales_refine' not in conv['params']['head_net']


# ---- the detector ---------------------------------------------------------------
@pytest.fixture(scope='module')
def detector(ref):
    model = build_detector(r18_cfg(Config.fromfile(CONFIG)))
    keys = list(model.state_dict())
    sd = state_dict_from_jax(ref['det'], keys)
    model.load_state_dict(sd, strict=True)
    return model


def test_detector_outputs_and_losses_match_jax(ref, detector):
    j_outs, want, _ = ref['det_out']
    t_batch = ref['t_batch']
    detector.eval()
    with torch.no_grad():
        got = detector(t_batch['image'])
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w, atol=OUT_ABS)
    detector.train()
    with torch.no_grad():
        losses = detector.forward_train(t_batch)
    assert_losses_close(losses, want, rtol=1e-3)


def test_detector_forward_test_matches_jax(ref, detector):
    want = ref['det_out'][2]
    detector.eval()
    with torch.no_grad():
        got = detector.forward_test(ref['t_batch'])
    assert_dets_close(got, want, DET_TOL)


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_vfnet_configs_build(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    head = model.bbox_head
    assert isinstance(head, VFNetHead) and type(model).__name__ == 'VFNet'
    assert head.reg_denoms == (64, 128, 256, 512, 1024)
    assert sum(isinstance(m, DeformConv) for m in head.modules()) == 2
    mdconv = 'mdconv' in path
    assert sum(isinstance(m, ModulatedDeformConv2d)
               for m in head.modules()) == (2 if mdconv else 0)
    assert any(isinstance(m, ModulatedDeformConv2d)
               for m in model.backbone.modules()) == mdconv
