"""The port's Guided Anchoring against the JAX package on the same weights
and inputs: the batched `MaxIoUAssigner` with anchors of its own for each
image and with a given overlap matrix, `ApproxMaxIoUAssigner`,
`BoundedIoULoss`, `calc_region` / `_loc_targets_level`, `GARetinaHead`,
`GARPNHead` and the GA-RetinaNet and GA-Faster R-CNN detectors.

The weights go JAX -> port: `jax.eval_shape` of the JAX init gives the
variable tree, `fill_tree` fills it from a numpy seed (the offset convs
too, so that the adaptions sample off the grid: zero offsets would hide a
swapped axis), and `state_dict_from_jax` carries it onto the port's names
strictly (the JAX converter has no GA rule: ROADMAP.md caveat 47, asserted
below). The gt batch is the bridge's 2x64x96 one with two large gts an
image added, so that the gts fall on two levels. Float32 on the CPU:
  * the assigners: every field of the assignment equal;
  * `BoundedIoULoss` with a (n, 4) weight: value to rtol 1e-6, gradient
    within 1e-6 of its largest;
  * the location targets and weights of every level equal;
  * the head (width 64, 2 stacked convs, 4 classes, on the bridge's random
    FPN features): its four outputs within 1e-5 of each level's largest
    value; its four losses on identical outputs to rtol 2e-4; the gradient
    of the summed loss (through the port's own forward) for every head
    parameter within 1e-4 of its largest; its detections on identical
    outputs: labels and valid mask equal, boxes and scores within 1e-4;
  * `GARPNHead` (1 class, 1 conv a tower): its outputs as the head's, its
    `loss_rpn_*` dict to rtol 2e-4 and its proposals on identical outputs:
    the same valid mask, boxes within 1e-4 (its net and losses are the
    head's: their gradient is held once, above);
  * GA-RetinaNet R18 (configs/guided_anchoring/ga_retinanet_r50_fpn_1x_
    coco.py at depth 18, width 64) and GA-Faster R-CNN R18 (ga_faster_r50_
    fpn_1x_coco.py, the RoI head's sampler picking every candidate) on the
    2x3x64x96 batch: GA-RetinaNet's head outputs within 5e-3 absolute (the
    bridge's bound), `forward_train`'s loss dict to rtol 1e-3 and
    `forward_test`'s detections (equal labels and valid mask, boxes within
    5e-3 px, GA-Faster's as sets) against the JAX detector;
  * every config of configs/guided_anchoring/ builds on the meta device,
    and so does the bounded-IoU Faster R-CNN.

The `ref` fixture traces every JAX program once and compiles each in a
thread as soon as it is traced, at LLVM -O0 (each runs once).
"""
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
from ld_tpu.models.heads.guided_anchor_head import calc_region as j_calc_region
from ld_tpu.ops.max_iou_assigner import MaxIoUAssigner as JMaxIoUAssigner
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu.utils.registry import LOSSES as JAX_LOSSES
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads.guided_anchor_head import (GARetinaHead,
                                                          GARPNHead,
                                                          calc_region)
from ld_tpu_torch.ops.deform_conv import DeformConv
from ld_tpu_torch.ops.extra_assigners import ApproxMaxIoUAssigner
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from test_torch_port_bridge import (HEAD_KW, OUT_ABS, TEST_CFG,
                                    assert_losses_close, batches, fill_tree,
                                    fpn_feats, nchw)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RETINA_CONFIG = os.path.join(
    ROOT, 'configs/guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py')
FASTER_CONFIG = os.path.join(
    ROOT, 'configs/guided_anchoring/ga_faster_r50_fpn_1x_coco.py')
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/guided_anchoring/'
                                        '*.py')))
RPN_TEST_CFG = dict(nms_pre=200, max_per_img=150,
                    nms=dict(iou_threshold=0.7))
# the RoI head's sampler picks every candidate: its losses are then sums
# over the same rois in both packages, whatever the random keys
ALL = dict(num=10**6, pos_fraction=1.0)
OUT_RTOL, OUT_TOP_RTOL, GRAD_RTOL = 1e-5, 1e-3, 1e-4
DET_TOL = 5e-3
# the bridge's feature sizes of a 64x96 image at strides 8-128
SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
# (n, 4) boxes for the loss and the assigners
N_BOXES = 40


def ga_batches():
    """The bridge's batch with two large gts an image in its first slots
    (level 1 of the GA head's scale mapping and of RepPoints'), so that
    the gts fall on two levels: (jax, port)."""
    j, t = batches()
    big = np.array([[[2., 4., 58., 60.], [30., 6., 90., 62.]],
                    [[10., 2., 70., 50.], [40., 8., 94., 63.]]], np.float32)
    gt = np.array(t['gt_bboxes'])
    gt[:, :2] = np.minimum(big, np.concatenate(
        [np.array(t['img_hw'])[:, None, ::-1]] * 2, -1))
    valid = np.array(t['gt_valid'])
    valid[:, :2] = True
    t = dict(t, gt_bboxes=torch.from_numpy(gt),
             gt_valid=torch.from_numpy(valid),
             gt_labels=t['gt_labels'].long())
    j = dict(j, gt_bboxes=jnp.asarray(gt), gt_valid=jnp.asarray(valid),
             gt_labels=jnp.asarray(np.array(t['gt_labels']), jnp.int32))
    return j, t


def head_cfg(kind):
    if kind == 'rpn':
        return dict(type='GARPNHead', in_channels=64, feat_channels=64,
                    test_cfg=RPN_TEST_CFG)
    return dict(type='GARetinaHead', **HEAD_KW, test_cfg=TEST_CFG)


def retina_cfg(cfg):
    model = cfg['model']
    model['backbone']['depth'] = 18
    model['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    model['bbox_head'].update(in_channels=64, feat_channels=64)
    return model


def faster_cfg(cfg):
    model = cfg['model']
    model['backbone']['depth'] = 18
    model['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    model['rpn_head'].update(in_channels=64, feat_channels=64)
    model['roi_head']['bbox_head'].update(in_channels=64, fc_out_channels=64)
    model['roi_head']['bbox_roi_extractor']['out_channels'] = 64
    model['train_cfg'] = dict(rcnn=dict(sampler=ALL))
    return model


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def box_inputs(seed=0):
    """(2, 40, 4) boxes (anchors / predictions) and (2, 40, 4) targets."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 80, (2, 2 * N_BOXES, 2))
    wh = rs.uniform(4, 40, (2, 2 * N_BOXES, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return boxes[:, :N_BOXES], boxes[:, N_BOXES:]


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against, on numpy-filled
    variables; numpy trees and outputs."""
    j_batch, t_batch = ga_batches()
    out = {}
    jobs = {}
    gtb, gtl, gtv = (j_batch[k] for k in ('gt_bboxes', 'gt_labels',
                                          'gt_valid'))

    # MaxIoU with anchors of each image's own, and with given overlaps
    anchors, _ = box_inputs(1)
    overlaps = np.random.RandomState(2).uniform(
        0, 1, (2, N_BOXES, gtb.shape[1])).astype(np.float32)
    assigner = JMaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4,
                               min_pos_iou=0.0)

    def maxiou(a, ov, gb, gl, gv):
        own = jax.vmap(lambda a, gb, gl, gv: assigner.assign(
            a, None, gb, gl, gv, num_classes=4))(a, gb, gl, gv)
        given = jax.vmap(lambda a, ov, gb, gl, gv: assigner.assign(
            a, None, gb, gl, gv, num_classes=4, overlaps=ov))(
                a, ov, gb, gl, gv)
        return tuple(own), tuple(given)
    jobs['maxiou'] = (maxiou, (anchors, overlaps, gtb, gtl, gtv))

    # BoundedIoU: value and the gradient of the prediction
    pred, target = box_inputs(3)
    weight = np.random.RandomState(4).uniform(
        0, 1, (N_BOXES, 4)).astype(np.float32)
    biou = JAX_LOSSES.build(dict(type='BoundedIoULoss', beta=0.2))
    jobs['biou'] = (jax.value_and_grad(lambda p, t, w: biou(
        p, t, weight=w, avg_factor=7.0)), (pred[0], target[0], weight))

    # the head and the GA-RPN head: outputs, loss, gradient, decode
    feats = [jnp.asarray(f) for f in fpn_feats(seed=4)]
    for kind in ('retina', 'rpn'):
        j_head = JAX_HEADS.build(head_cfg(kind))
        v = fill_tree(jax.eval_shape(lambda: j_head.net.init(
            jax.random.PRNGKey(0), feats)), seed=7)
        out[f'head_{kind}'] = v
        if kind == 'retina':
            # the geometry, the approx assignment, the location targets
            sq, ap, nl, _ = j_head._geometry(SIZES)

            def approx(gb, gl, gv, j_head=j_head, sq=sq, ap=ap, nl=nl):
                res = jax.vmap(lambda gb, gl, gv: j_head.ga_assigner.assign(
                    sq, nl, gb, gl, gv, num_classes=4, approxs=ap))(
                        gb, gl, gv)
                locs = [jax.vmap(lambda gb, gv, lvl=lvl, h=h, w=w:
                                 j_head._loc_targets_level(
                                     gb, gv, lvl, len(SIZES), h, w,
                                     j_head.strides[lvl]))(gb, gv)
                        for lvl, (h, w) in enumerate(SIZES)]
                return sq, ap, tuple(res), locs
            jobs['approx'] = (approx, (gtb, gtl, gtv))

        def head_run(v, feats, b, j_head=j_head, kind=kind):
            if kind == 'rpn':    # the same net and losses: no gradient
                outs = j_head.net.apply(v, feats)
                return (outs, j_head.loss(outs, b, SIZES), None,
                        j_head.get_proposals(outs, b['img_hw']))

            def total(v):
                outs = j_head.net.apply(v, feats)
                losses = j_head.loss(outs, b, SIZES)
                return sum(losses.values()), (outs, losses)
            (_, (outs, losses)), grads = jax.value_and_grad(
                total, has_aux=True)(v)
            return outs, losses, grads, j_head.get_bboxes(outs, b['img_hw'])
        jobs[f'head_{kind}'] = (head_run, (v, feats, j_batch))

    # the detectors: GA-RetinaNet R18, GA-Faster R-CNN R18
    det = j_build_detector(retina_cfg(JConfig.fromfile(RETINA_CONFIG)))
    dv = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=5)
    out['retina'] = dv

    def retina_run(v, b):
        # forward_train and forward_test are the loss and the decode of
        # these outputs (the R18's BNs are frozen, norm_eval): one trace
        outs = det.apply(v, b['image'])
        sizes = [c.shape[1:3] for c in outs[0]]
        return (outs, det.bbox_head.loss(outs, b, sizes),
                det.bbox_head.get_bboxes(outs, b['img_hw']))
    jobs['retina'] = (retina_run, (dv, j_batch))

    fdet = j_build_detector(faster_cfg(JConfig.fromfile(FASTER_CONFIG)))
    fv = fill_tree(jax.eval_shape(lambda: fdet.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=6)
    out['faster'] = fv

    def faster_run(v, b):
        return (fdet.forward_train(v, b, jax.random.PRNGKey(0)),
                fdet.forward_test(v, b))
    jobs['faster'] = (faster_run, (fv, j_batch))

    options = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(len(jobs)) as pool:
        # each compiles while the next is traced
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=options)
                   for k, (fn, args) in jobs.items()}
    for k, (_, args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*args)
    return dict(numpy_tree(out), t_batch=t_batch)


def port_head(kind, variables, scope='head_net'):
    head = HEADS.build(head_cfg(kind))
    prefix = 'bbox_head.' if scope == 'head_net' else 'rpn_head.'
    keys = [prefix + k for k in head.state_dict()]
    sd = state_dict_from_jax({coll: {scope: tree}
                              for coll, tree in variables.items()}, keys)
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    return head.eval()


def assert_levels_close(got, want, rtol=OUT_RTOL, atol=None):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        g = g.detach().numpy().transpose(0, 2, 3, 1)
        w = np.asarray(w)
        assert g.shape == w.shape
        tol = OUT_TOP_RTOL if w.shape[1:3] == (1, 1) else rtol
        bound = atol if atol is not None else tol * np.abs(w).max()
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


def assert_dets_match(got, want, atol):
    """The same valid mask, and in each image the same detections within
    `atol`, as multisets of (score, label, box): detections of equal score
    (rois clipped to the image's edge) may leave the final top-k in either
    order (ROADMAP.md caveat 2)."""
    dets, labels, ok = (np.asarray(a) for a in want)
    valid = got[2].numpy()
    assert ok.sum() > 0
    np.testing.assert_array_equal(valid, ok)
    for i in range(ok.shape[0]):
        rows = []
        for d, lab in ((got[0][i].detach().numpy(), got[1][i].numpy()),
                       (dets[i], labels[i])):
            d, lab = d[ok[i]], lab[ok[i]]
            key = np.lexsort((*d[:, 3::-1].round(2).T, lab,
                              -d[:, 4].round(5)))
            rows.append((d[key], lab[key]))
        np.testing.assert_array_equal(rows[0][1], rows[1][1])
        np.testing.assert_allclose(rows[0][0], rows[1][0], rtol=0,
                                   atol=atol)


def assert_assign_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- assigners and the loss ---------------------------------------------------
@pytest.mark.parametrize('given', [False, True], ids=['own', 'overlaps'])
def test_batched_maxiou_assigner_matches_jax(ref, given):
    """Anchors of each image's own (B, N, 4), and a given (B, N, G)
    overlap matrix in place of their IoU."""
    anchors, _ = box_inputs(1)
    overlaps = np.random.RandomState(2).uniform(
        0, 1, (2, N_BOXES, ref['t_batch']['gt_bboxes'].shape[1])).astype(
            np.float32)
    b = ref['t_batch']
    res = MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4,
                         min_pos_iou=0.0).assign(
        torch.from_numpy(anchors), None, b['gt_bboxes'], b['gt_labels'],
        b['gt_valid'], num_classes=4,
        overlaps=torch.from_numpy(overlaps) if given else None)
    want = ref['maxiou_out'][int(given)]
    assert int(res.pos_mask.sum()) > 0
    assert_assign_equal(res, want)


def test_approx_maxiou_assigner_matches_jax(ref):
    sq, ap, want, _ = ref['approx_out']
    head = GARetinaHead(**HEAD_KW)
    squares, approxs, num_lvl, _ = head.geometry(SIZES, 'cpu')
    np.testing.assert_array_equal(squares.numpy(), sq)
    np.testing.assert_array_equal(approxs.numpy(), ap)
    assert approxs.shape[1] == 9
    b = ref['t_batch']
    res = ApproxMaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4,
                               min_pos_iou=0.0).assign(
        squares, num_lvl, b['gt_bboxes'], b['gt_labels'], b['gt_valid'],
        num_classes=4, approxs=approxs)
    assert int(res.pos_mask.sum()) > 0
    assert_assign_equal(res, want)


def test_bounded_iou_loss_matches_jax(ref):
    pred, target = box_inputs(3)
    weight = np.random.RandomState(4).uniform(
        0, 1, (N_BOXES, 4)).astype(np.float32)
    want, want_grad = ref['biou_out']
    loss = LOSSES.build(dict(type='BoundedIoULoss', beta=0.2))
    p = torch.from_numpy(pred[0]).requires_grad_()
    got = loss(p, torch.from_numpy(target[0]),
               weight=torch.from_numpy(weight), avg_factor=7.0)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    assert np.abs(p.grad.numpy() - want_grad).max() <= \
        1e-6 * np.abs(want_grad).max()


def test_calc_region_matches_jax():
    boxes = box_inputs(5)[0][0] / 8
    for ratio in (0.2, 0.5):
        got = calc_region(torch.from_numpy(boxes), ratio, 8, 12)
        want = j_calc_region(jnp.asarray(boxes), ratio, 8, 12)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_loc_targets_match_jax(ref):
    """Every level's location target and weight (1 centre, 0 ignore band,
    0.1 elsewhere), the gts on two levels."""
    want = ref['approx_out'][3]
    head = GARetinaHead(**HEAD_KW)
    b = ref['t_batch']
    levels_with_centres = 0
    for lvl, (h, w) in enumerate(SIZES):
        t, wt = head._loc_targets_level(b['gt_bboxes'], b['gt_valid'], lvl,
                                        len(SIZES), h, w, head.strides[lvl])
        np.testing.assert_array_equal(t.numpy(), want[lvl][0])
        np.testing.assert_array_equal(wt.numpy(), want[lvl][1])
        levels_with_centres += int(t.sum() > 0)
    assert levels_with_centres == 2


# ---- the head ---------------------------------------------------------------------
@pytest.mark.parametrize('kind', ['retina', 'rpn'])
def test_head_outputs_match_jax(ref, kind):
    head = port_head(kind, ref[f'head_{kind}'])
    j_outs = ref[f'head_{kind}_out'][0]
    with torch.no_grad():
        got = head(nchw(fpn_feats(seed=4)))
    assert len(got) == 4
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w)
    assert sum(isinstance(m, DeformConv) for m in head.modules()) == 2
    # the adaptions sample off the grid
    with torch.no_grad():
        offsets = head.feature_adaption_cls.conv_offset(got[2][0])
    assert float(offsets.abs().mean()) > 0.1


@pytest.mark.parametrize('kind', ['retina', 'rpn'])
def test_head_losses_match_jax(ref, kind):
    """The loss on identical head outputs."""
    head = port_head(kind, ref[f'head_{kind}']).train()
    j_outs, want = ref[f'head_{kind}_out'][:2]
    got = head.loss(tuple(nchw(p) for p in j_outs), ref['t_batch'], SIZES)
    names = ['loss_bbox', 'loss_cls', 'loss_loc', 'loss_shape']
    if kind == 'rpn':
        names = [n.replace('loss_', 'loss_rpn_') for n in names]
    assert sorted(got) == sorted(names)
    assert all(float(want[k]) > 0 for k in names)
    assert_losses_close(got, want)


def test_head_gradients_match_jax(ref):
    """The summed loss's gradient through the port's own forward, for every
    head parameter (the JAX gradient tree carried onto the port's names
    by the same map as the weights)."""
    head = port_head('retina', ref['head_retina']).train()
    _, _, j_grads, _ = ref['head_retina_out']
    losses = head.loss(head(nchw(fpn_feats(seed=4))), ref['t_batch'], SIZES)
    sum(losses.values()).backward()
    want = state_dict_from_jax({'params': {'head_net': j_grads['params']}},
                               [f'bbox_head.{k}' for k in head.state_dict()])
    params = dict(head.named_parameters())
    assert sorted(f'bbox_head.{k}' for k in params) == sorted(want)
    for name, p in params.items():
        w = want[f'bbox_head.{name}'].numpy()
        assert np.abs(w).max() > 0, name
        assert np.abs(p.grad.numpy() - w).max() <= \
            GRAD_RTOL * np.abs(w).max(), name


def test_head_detections_match_jax(ref):
    head = port_head('retina', ref['head_retina'])
    j_outs, _, _, want = ref['head_retina_out']
    got = head.get_bboxes(tuple(nchw(p) for p in j_outs),
                          ref['t_batch']['img_hw'])
    assert_dets_close(got, want, 1e-4)


def test_ga_rpn_proposals_match_jax(ref):
    head = port_head('rpn', ref['head_rpn'])
    j_outs, _, _, (want, w_valid) = ref['head_rpn_out']
    props, valid = head.get_proposals(tuple(nchw(p) for p in j_outs),
                                      ref['t_batch']['img_hw'])
    # K = min(max_per_img, the 129 squares of the five levels)
    assert props.shape == (2, 129, 4) and int(valid.sum()) > 50
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    np.testing.assert_allclose(props.numpy(), want, rtol=0, atol=1e-4)


def test_ga_rpn_loads_under_rpn_head(ref):
    """The GA-RPN's JAX net as a two-stage detector holds it (`rpn_net`)
    maps onto `rpn_head.*`."""
    port_head('rpn', ref['head_rpn'], scope='rpn_net')


def test_converter_has_no_ga_rule():
    """ROADMAP.md caveat 47: the JAX converter leaves the GA names
    unmapped, which is why the weights go JAX -> port here."""
    head = HEADS.build(head_cfg('retina'))
    conv = convert_torch_state_dict({f'bbox_head.{k}': v.numpy()
                                     for k, v in head.state_dict().items()})
    unmapped = conv['_unmapped']
    for name in ('conv_loc.weight', 'conv_shape.weight',
                 'feature_adaption_cls.conv_offset.weight',
                 'feature_adaption_reg.conv_adaption.weight'):
        assert f'bbox_head.{name}' in unmapped
    assert 'conv_loc' not in conv['params'].get('head_net', {})


# ---- the detectors ----------------------------------------------------------------
@pytest.fixture(scope='module')
def retina(ref):
    model = build_detector(retina_cfg(Config.fromfile(RETINA_CONFIG)))
    model.load_state_dict(state_dict_from_jax(
        ref['retina'], list(model.state_dict())), strict=True)
    return model


@pytest.fixture(scope='module')
def faster(ref):
    model = build_detector(faster_cfg(Config.fromfile(FASTER_CONFIG)))
    model.load_state_dict(state_dict_from_jax(
        ref['faster'], list(model.state_dict())), strict=True)
    return model


def test_ga_retinanet_matches_jax(ref, retina):
    j_outs, want, want_dets = ref['retina_out']
    t_batch = ref['t_batch']
    retina.eval()
    with torch.no_grad():
        got = retina(t_batch['image'])
        dets = retina.forward_test(t_batch)
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w, atol=OUT_ABS)
    assert_dets_close(dets, want_dets, DET_TOL)
    retina.train()
    with torch.no_grad():
        losses = retina.forward_train(t_batch)
    assert_losses_close(losses, want, rtol=1e-3)


def test_ga_faster_rcnn_matches_jax(ref, faster):
    want, want_dets = ref['faster_out']
    t_batch = ref['t_batch']
    assert isinstance(faster.rpn_head, GARPNHead)
    faster.eval()
    with torch.no_grad():
        dets = faster.forward_test(t_batch)
    assert_dets_match(dets, want_dets, DET_TOL)
    faster.train()
    with torch.no_grad():
        losses = faster.forward_train(t_batch,
                                      torch.Generator().manual_seed(0))
    assert {'loss_rpn_loc', 'loss_rpn_shape', 'loss_cls'} <= set(losses)
    assert_losses_close(losses, want, rtol=1e-3)


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_guided_anchoring_configs_build(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    if 'ga_fast_' in path:
        # Fast R-CNN on GA-RPN proposals from a file: no GA head (its data
        # stops at `proposal_file`, ROADMAP.md caveat 41)
        assert type(model).__name__ == 'FastRCNN'
        return
    head = getattr(model, 'bbox_head', None) or model.rpn_head
    assert isinstance(head, GARetinaHead)
    assert isinstance(head, GARPNHead) == ('ga_retinanet' not in path)
    assert sum(isinstance(m, DeformConv) for m in head.modules()) == 2
    assert head.approxs_per_loc == 9


def test_bounded_iou_faster_rcnn_config_builds():
    """The one other config whose missing key was `BoundedIoULoss`: its RoI
    head regresses decoded boxes under it."""
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/faster_rcnn/faster_rcnn_r50_fpn_bounded_iou_1x_coco.py'))
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    assert type(model.roi_head.loss_bbox).__name__ == \
        'BoundedIoULoss'
    assert model.roi_head.reg_decoded_bbox
