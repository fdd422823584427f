"""The port's Cascade RPN and TOOD against the JAX package on the same
weights and inputs: `RegionAssigner`, `TaskAlignedAssigner`,
`CascadeRPNHead` (its outputs, both stages' losses and their gradient, its
proposals), the RoI head of the Cascade RPN Faster R-CNN on the port's
proposals, `TOODHead` (outputs, losses, gradient, detections) and the TOOD
detector, with each reference quirk the port follows.

The weights go JAX -> port: `jax.eval_shape` of the JAX init, filled from
a numpy seed (`fill_tree`: the adaptive convs and TOOD's offset branch
too, so that every deformable read lands off the grid), carried onto the
port's mmdet names by `state_dict_from_jax` strictly (the JAX converter
has no Cascade RPN or TOOD rule). Float32 on the CPU, a 2x64x96 batch (the
bridge's gts and two large gts an image, so that the region assignment
uses two levels):
  * the assigners: every field equal, TOOD's alignment metric to 1e-6 of
    its largest;
  * the heads (width 64, 5 levels): outputs within 1e-5 of each level's
    largest value; losses to rtol 2e-4; the gradient of the summed loss
    for each parameter within 1e-4 of its largest (TOOD's within 1e-3 of
    the JAX head run in float64: the GN inter convs on two-value groups
    amplify float32 rounding, the JAX float32 gradient lies 1.4e-2 from
    it, the port's 5.6e-4); proposals (valid mask equal, boxes within
    1e-3 px) and detections (labels and valid mask equal, boxes and scores
    within 1e-4); TOOD's head and detector have three inter convs (the
    config's six build on the meta device);
  * the RoI head of `crpn_faster_rcnn_r50_caffe_fpn_1x_coco.py` at width
    64 (its sampler taking every candidate) on the port's proposals: loss
    dict to rtol 2e-4, detections as multisets within 1e-4;
  * the TOOD R18 detector (the config at depth 18, width 64): head outputs
    within 5e-3, loss dict to rtol 1e-3, detections within 5e-3 px.

The `ref` fixture traces every JAX program once and compiles each in a
thread at LLVM -O0 (each runs once).
"""
import contextlib
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
from ld_tpu.models.heads.cascade_rpn_head import (cascade_rpn_loss,
                                                  cascade_rpn_proposals)
from ld_tpu.ops.extra_assigners import RegionAssigner as JRegionAssigner
from ld_tpu.ops.extra_assigners import \
    TaskAlignedAssigner as JTaskAlignedAssigner
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu.utils.registry import LOSSES as JAX_LOSSES
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads.cascade_rpn_head import CascadeRPNHead
from ld_tpu_torch.ops.deform_conv import DeformConv
from ld_tpu_torch.ops.extra_assigners import (RegionAssigner,
                                              TaskAlignedAssigner)
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from test_torch_port_bridge import (O0, assert_losses_close, batches,
                                    fill_tree, fpn_feats, nchw)
from test_torch_port_guided_anchoring import (assert_dets_match,
                                              assert_levels_close)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRPN_FASTER = os.path.join(
    ROOT, 'configs/cascade_rpn/crpn_faster_rcnn_r50_caffe_fpn_1x_coco.py')
CRPN_RPN = os.path.join(ROOT, 'configs/cascade_rpn/crpn_r50_caffe_fpn_1x_coco.py')
TOOD_CONFIG = os.path.join(ROOT, 'configs/tood/tood_r50_fpn_1x_coco.py')
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/cascade_rpn/*.py')) +
                 [TOOD_CONFIG])
# Cascade RPN: the config's stage-1 anchors, 5 levels at strides 4-64
CRPN_STRIDES = [4, 8, 16, 32, 64]
CRPN_AG = dict(ratios=[1.0], scales=[8], strides=CRPN_STRIDES)
CRPN_SIZES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
CRPN_TEST = dict(nms_pre=2000, max_per_img=150, nms=dict(iou_threshold=0.8))
# TOOD: the bridge's feature sizes at strides 8-128
TOOD_SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
TOOD_HEAD = dict(type='TOODHead', num_classes=4, in_channels=64,
                 stacked_convs=3, feat_channels=64,
                 train_cfg=dict(assigner=dict(type='TaskAlignedAssigner',
                                              topk=13)),
                 test_cfg=dict(nms_pre=60, score_thr=0.05,
                               nms=dict(type='nms', iou_threshold=0.5),
                               max_per_img=100))
# the RoI head's sampler picks every candidate
ALL = dict(num=10**6, pos_fraction=1.0)
GRAD_RTOL, TOOD_GRAD_RTOL, DET_TOL = 1e-4, 1e-3, 5e-3


def gt_batches():
    """The bridge's 2x64x96 batch with two large gts an image in its first
    slots (RegionAssigner's level 1): (jax, port)."""
    j, t = batches()
    big = np.array([[[2., 4., 58., 60.], [30., 6., 90., 62.]],
                    [[10., 2., 70., 50.], [40., 8., 94., 63.]]], np.float32)
    gt = np.array(t['gt_bboxes'])
    hw = np.array(t['img_hw'])
    gt[:, :2] = np.minimum(big, np.concatenate([hw[:, None, ::-1]] * 2, -1))
    valid = np.array(t['gt_valid'])
    valid[:, :2] = True
    labels = np.array(t['gt_labels'])
    t = dict(t, gt_bboxes=torch.from_numpy(gt),
             gt_valid=torch.from_numpy(valid),
             gt_labels=torch.from_numpy(labels).long())
    j = dict(j, gt_bboxes=jnp.asarray(gt), gt_valid=jnp.asarray(valid),
             gt_labels=jnp.asarray(labels, jnp.int32))
    return j, t


def crpn_feats(seed=8):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, h, w, 64).astype(np.float32) for h, w in CRPN_SIZES]


def crpn_head_cfg(**kw):
    return dict(type='CascadeRPNHead', in_channels=64, feat_channels=64,
                test_cfg=CRPN_TEST, **kw)


def roi_cfg():
    roi = JConfig.fromfile(CRPN_FASTER)['model']['roi_head']
    roi['bbox_head'].update(in_channels=64, fc_out_channels=64,
                            num_classes=4)
    roi['bbox_roi_extractor']['out_channels'] = 64
    return dict(roi, train_cfg=dict(sampler=ALL),
                test_cfg=dict(score_thr=0.03, nms=dict(iou_threshold=0.5),
                              max_per_img=40))


def tood_cfg(cfg):
    model = cfg['model']
    model['backbone']['depth'] = 18
    model['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    model['bbox_head'].update(num_classes=4, in_channels=64,
                              feat_channels=64, stacked_convs=3)
    model['test_cfg'] = TOOD_HEAD['test_cfg']
    return model


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def align_inputs(seed=9):
    """Probabilities (2, N, 4), decoded boxes (2, N, 4) and anchors (N, 4)
    of TOOD's geometry."""
    rs = np.random.RandomState(seed)
    n = sum(h * w for h, w in TOOD_SIZES)
    xy = rs.uniform(-4, 90, (2, n, 2))
    wh = rs.uniform(4, 50, (2, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    probs = rs.uniform(0, 1, (2, n, 4)).astype(np.float32)
    return probs, boxes


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against; numpy trees and
    outputs."""
    j_batch, t_batch = gt_batches()
    out, jobs = {}, {}

    # ---- Cascade RPN: the head, its loss and gradient, its proposals
    # the JAX net runs one image at a time (caveat 93): each image of
    # the batch is its own call, the port's batch-2 losses their mean
    j_head = JAX_HEADS.build(crpn_head_cfg(anchor_generator=dict(CRPN_AG)))
    feats = [jnp.asarray(f) for f in crpn_feats()]
    v = out['crpn'] = fill_tree(jax.eval_shape(lambda: j_head.net.init(
        jax.random.PRNGKey(0), [f[:1] for f in feats],
        j_head._anchor_maps(CRPN_SIZES), j_head.strides,
        coder=j_head.coder)), seed=7)

    def crpn_run(v, feats, b):
        def one(fi, bi):
            fi = [f[None] for f in fi]
            bi = {k: x[None] for k, x in bi.items()}

            def total(v):
                outs = j_head.forward(v, fi)
                losses = cascade_rpn_loss(j_head, outs, bi, CRPN_SIZES)
                return sum(losses.values()), (outs, losses)
            (_, (outs, losses)), grads = jax.value_and_grad(
                total, has_aux=True)(v)
            return (outs, losses, grads,
                    cascade_rpn_proposals(j_head, outs, bi['img_hw'],
                                          max_per_img=150))
        outs, losses, grads, props = jax.vmap(one)(feats, b)

        def mean(x):
            return x.mean(0)
        region = tuple(jax.vmap(lambda gb, gl, gv: JRegionAssigner().assign(
            anchors, num_lvl, gb, gl, gv, num_classes=1, anchor_scale=8,
            strides=tuple(CRPN_STRIDES)))(b['gt_bboxes'], b['gt_labels'],
                                          b['gt_valid']))
        return (jax.tree_util.tree_map(lambda x: x[:, 0], outs),
                jax.tree_util.tree_map(mean, losses),
                jax.tree_util.tree_map(mean, grads),
                jax.tree_util.tree_map(lambda x: x[:, 0], props), region)
    anchors = jnp.concatenate(j_head.anchor_generator.grid_anchors(
        CRPN_SIZES))
    num_lvl = j_head.anchor_generator.num_level_anchors(CRPN_SIZES)
    jobs['crpn'] = (crpn_run, (v, feats, j_batch))

    # ---- the Cascade RPN Faster R-CNN's RoI head on the port's proposals
    j_roi = JAX_HEADS.build(roi_cfg())
    rv = out['roi'] = fill_tree(jax.eval_shape(
        lambda: j_roi.net.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 7, 7, 64)))), seed=11)
    out['roi_in'] = roi_in = roi_inputs()
    jobs['roi'] = (lambda v, f, p, pv, b: (
        j_roi.forward_train({'params': {'bbox': v['params']}}, list(f), p, pv,
                            b, rng=jax.random.PRNGKey(3)),
        j_roi.simple_test({'params': {'bbox': v['params']}}, list(f), p, pv,
                          b['img_hw'])), (rv, *roi_in, j_batch))

    # ---- TaskAlignedAssigner, the TOOD head and detector
    probs, boxes = align_inputs()
    tal = JTaskAlignedAssigner(topk=13, alpha=1.0, beta=6.0)
    j_tood = JAX_HEADS.build(TOOD_HEAD)
    t_anchors, *_ = j_tood.level_geometry(TOOD_SIZES)
    # the head in float64: the JAX float32 gradient of the inter convs lies
    # 1.4e-2 (relative) from its float64 one, flax's GroupNorm taking
    # E[x^2] - E[x]^2 on the two-value groups of the small levels
    # (RepPoints' file found the same)
    tfeats = [jnp.asarray(f) for f in fpn_feats(seed=4)]
    tv = out['tood'] = fill_tree(jax.eval_shape(lambda: j_tood.net.init(
        jax.random.PRNGKey(0), tfeats)), seed=5)
    j_tood64 = JAX_HEADS.build(dict(TOOD_HEAD, dtype=jnp.float64))

    def tood_run(v, feats, b):
        def total(v):
            outs = j_tood64.net.apply(v, feats)
            losses = j_tood64.loss(outs, b, TOOD_SIZES)
            return sum(losses.values()), (outs, losses)
        (_, (outs, losses)), grads = jax.value_and_grad(
            total, has_aux=True)(v)
        return outs, losses, grads, j_tood64.get_bboxes(outs, b['img_hw'])
    jobs['tood'] = (tood_run, as64((tv, tfeats, j_batch)))

    det = j_build_detector(tood_cfg(JConfig.fromfile(TOOD_CONFIG)))
    dv = out['tood_det'] = fill_tree(jax.eval_shape(
        lambda: det.init_variables(jax.random.PRNGKey(0), (1, 64, 96, 3))),
        seed=6)

    def det_run(v, b, p, bx):
        outs = det.apply(v, b['image'])
        sizes = [c.shape[1:3] for c in outs[0]]
        # TaskAlignedAssigner on the align inputs, in the same program
        assigned = jax.vmap(lambda p, bx, gb, gl, gv: tal.assign(
            p, bx, t_anchors, gb, gl, gv, num_classes=4))(
                p, bx, b['gt_bboxes'], b['gt_labels'], b['gt_valid'])
        return (outs, det.bbox_head.loss(outs, b, sizes),
                det.bbox_head.get_bboxes(outs, b['img_hw']), assigned)
    jobs['tood_det'] = (det_run, (dv, j_batch, probs, boxes))

    def precision(k):
        return jax.enable_x64() if k == 'tood' else contextlib.nullcontext()

    futures = {}
    with ThreadPoolExecutor(len(jobs)) as pool:
        # the slowest compiles first, each while the next traces
        for k in ('tood', 'crpn', 'tood_det', 'roi'):
            fn, args = jobs[k]
            with precision(k):
                futures[k] = pool.submit(jax.jit(fn).lower(*args).compile,
                                         compiler_options=O0)
    for k, (_, args) in jobs.items():
        with precision(k):
            out[f'{k}_out'] = numpy_tree(futures[k].result()(*args))
    # the float64 results as float32
    out['tood_out'] = jax.tree_util.tree_map(
        lambda a: a.astype(np.float32) if a.dtype == np.float64 else a,
        out['tood_out'])
    return dict(numpy_tree(out), t_batch=t_batch)


def as64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


def roi_inputs():
    """FPN features at strides 4-32 (64 channels) and 60 proposals an
    image, a third of them jittered gts: numpy."""
    rs = np.random.RandomState(12)
    feats = [rs.randn(2, 64 // s, 96 // s, 64).astype(np.float32)
             for s in (4, 8, 16, 32)]
    _, t = gt_batches()
    gt = np.array(t['gt_bboxes'])
    xy = rs.uniform(0, 70, (2, 60, 2))
    wh = rs.uniform(6, 40, (2, 60, 2))
    props = np.concatenate([xy, xy + wh], -1)
    props[:, :20] = gt[:, rs.randint(0, 6, 20)] + rs.uniform(-3, 3, (2, 20, 4))
    props = np.clip(props, 0, 95).astype(np.float32)
    valid = np.ones((2, 60), bool)
    valid[1, 50:] = False
    return feats, props, valid


def load_port(module, tree, scope, prefix, keep=None):
    """`module`'s state from a JAX tree under `scope`, strictly."""
    keys = [prefix + k for k in module.state_dict()]
    sd = state_dict_from_jax({coll: {scope: t} for coll, t in tree.items()},
                             keys)
    sd = {k: v for k, v in sd.items() if keep is None or k.startswith(keep)}
    assert sorted(sd) == sorted(keys)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module


def port_crpn(ref):
    cfg = JConfig.fromfile(CRPN_FASTER)['model']['rpn_head']
    cfg = dict(cfg, in_channels=64, feat_channels=64, test_cfg=CRPN_TEST)
    for stage in cfg['stages']:
        stage.update(in_channels=64, feat_channels=64)
    return load_port(HEADS.build(cfg), ref['crpn'], 'rpn_net', 'rpn_head.')


def port_tood(ref):
    return load_port(HEADS.build(TOOD_HEAD), ref['tood'], 'head_net',
                     'bbox_head.')


def assert_grads_close(module, grads, scope, prefix, rtol=GRAD_RTOL):
    """Each port parameter's gradient against the JAX gradient tree
    carried onto the port's names."""
    keys = [prefix + k for k, _ in module.named_parameters()]
    want = state_dict_from_jax({'params': {scope: grads['params']}}, keys)
    checked = 0
    for name, p in module.named_parameters():
        w = want[prefix + name].numpy()
        g = p.grad.numpy()
        bound = rtol * max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)
        checked += 1
    assert checked == len(keys)


def assert_assign_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the assigners ------------------------------------------------------------
def test_region_assigner_matches_jax(ref):
    head = CascadeRPNHead(in_channels=64, feat_channels=64,
                          anchor_generator=dict(CRPN_AG))
    anchors = torch.cat(head.anchor_generator.grid_anchors(CRPN_SIZES))
    b = ref['t_batch']
    res = RegionAssigner().assign(
        anchors, [h * w for h, w in CRPN_SIZES], b['gt_bboxes'],
        b['gt_labels'], b['gt_valid'], num_classes=1, anchor_scale=8,
        strides=CRPN_STRIDES)
    assert_assign_equal(res, ref['crpn_out'][4])
    # positives on two levels, and an ignore band
    level = np.repeat(np.arange(5), [h * w for h, w in CRPN_SIZES])
    assert len(set(level[res.pos_mask.numpy().any(0)])) == 2
    assert int((res.max_overlaps < 0).sum()) > 0


def test_task_aligned_assigner_matches_jax(ref):
    probs, boxes = align_inputs()
    head = HEADS.build(TOOD_HEAD)
    anchors = head.level_geometry(TOOD_SIZES, 'cpu')[0]
    b = ref['t_batch']
    res, align = TaskAlignedAssigner(topk=13).assign(
        torch.from_numpy(probs), torch.from_numpy(boxes), anchors,
        b['gt_bboxes'], b['gt_labels'], b['gt_valid'], num_classes=4)
    want, want_align = ref['tood_det_out'][3]
    assert int(res.pos_mask.sum()) > 10
    for name in ('assigned_gt_inds', 'labels', 'pos_mask'):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(res.max_overlaps.numpy(), want.max_overlaps,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(align.numpy(), want_align, rtol=0,
                               atol=1e-6 * np.abs(want_align).max())
    # the reference's `anchor_type` key is taken and not read
    assert vars(TaskAlignedAssigner(topk=13, anchor_type='anchor_based')) \
        == vars(TaskAlignedAssigner(topk=13))


# ---- Cascade RPN --------------------------------------------------------------
@pytest.fixture(scope='module')
def crpn(ref):
    """The port's head on the JAX tree and its outputs on the features,
    run once (the loss test takes the gradient through them)."""
    head = port_crpn(ref).train()
    return head, head(nchw(crpn_feats()))


def test_crpn_head_takes_the_first_stage_anchors(ref):
    """The repair: without a top-level generator the head takes
    `stages[0]`'s, the JAX head's explicit one here (caveat 93)."""
    head = port_crpn(ref)
    j_anchors = JAX_HEADS.build(crpn_head_cfg(
        anchor_generator=dict(CRPN_AG))).anchor_generator.grid_anchors(
            CRPN_SIZES)
    for g, w in zip(head.anchor_generator.grid_anchors(CRPN_SIZES),
                    j_anchors):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert head.strides == tuple(CRPN_STRIDES) and head.anchor_scale == 8
    assert sum(isinstance(m, DeformConv) for m in head.modules()) == 2


def test_crpn_head_outputs_match_jax(ref, crpn):
    _, outs = crpn
    want = ref['crpn_out'][0]
    for g, w in zip(outs, want):
        assert_levels_close(g, w)


def test_crpn_losses_and_gradient_match_jax(ref, crpn):
    head, outs = crpn
    _, want, grads, *_ = ref['crpn_out']
    losses = head.loss(outs, ref['t_batch'], CRPN_SIZES)
    assert_losses_close(losses, want)
    sum(losses.values()).backward()
    assert_grads_close(head, grads, 'rpn_net', 'rpn_head.')


def test_crpn_proposals_match_jax(ref, crpn):
    head, outs = crpn
    with torch.no_grad():
        props, valid = head.get_proposals(
            tuple([x.detach() for x in part] for part in outs),
            ref['t_batch']['img_hw'], cfg=dict(max_per_img=150, nms_pre=7))
    w_props, w_valid = ref['crpn_out'][3]
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    assert int(valid.sum()) > 100
    np.testing.assert_allclose(props.numpy(), w_props, rtol=0, atol=1e-3)


def test_crpn_quirks(ref):
    """Caveats 79-82: both stages adaptive `DeformConv`s whatever
    `adapt_cfg` says, one coder (the config's stage-2 stds not read), the
    `train_cfg` list not read, the proposals' `nms_pre` not read (checked
    above with 7) and their boxes unclipped."""
    head = port_crpn(ref)
    other = dict(JConfig.fromfile(CRPN_FASTER)['model']['rpn_head'],
                 in_channels=64, feat_channels=64, test_cfg=CRPN_TEST,
                 train_cfg=[dict(assigner=dict(type='RegionAssigner',
                                               center_ratio=0.5))] * 2)
    for stage in other['stages']:
        stage.update(in_channels=64, feat_channels=64,
                     adapt_cfg=dict(type='offset'),
                     bbox_coder=dict(type='DeltaXYWHBBoxCoder',
                                     target_stds=(1., 1., 1., 1.)))
    built = HEADS.build(other)
    assert built.coder.stds == head.coder.stds == (0.1, 0.1, 0.5, 0.5)
    assert built.region_assigner.center_ratio == 0.2
    assert {k: v.shape for k, v in built.state_dict().items()} == \
        {k: v.shape for k, v in head.state_dict().items()}
    w_props = ref['crpn_out'][3][0]
    assert w_props.max() > 96 or w_props.min() < 0


def test_jax_cascade_rpn_cannot_run_its_configs():
    """Caveat 93: the JAX detector calls the net without its anchors, the
    JAX head built from the config fails on the FPN's five levels, and its
    net fails at batch 2 (it flattens the batch's anchor maps into one
    image's)."""
    cfg = JConfig.fromfile(CRPN_FASTER)['model']
    cfg['backbone']['depth'] = 18
    cfg['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    det = j_build_detector(cfg)
    with pytest.raises(TypeError, match='strides'):
        jax.eval_shape(lambda: det.init_variables(jax.random.PRNGKey(0),
                                                  (1, 64, 96, 3)))
    head = JAX_HEADS.build(dict(JConfig.fromfile(CRPN_RPN)['model'][
        'rpn_head']))
    assert head.strides == (8, 16, 32, 64)
    with pytest.raises(AssertionError):
        head._anchor_maps(CRPN_SIZES)
    j_head = JAX_HEADS.build(crpn_head_cfg(anchor_generator=dict(CRPN_AG)))
    feats = [jnp.zeros((2, h, w, 64)) for h, w in CRPN_SIZES]
    a1 = [jnp.broadcast_to(m, (2, *m.shape[1:]))
          for m in j_head._anchor_maps(CRPN_SIZES)]
    with pytest.raises(TypeError, match='incompatible shapes'):
        jax.eval_shape(lambda: j_head.net.init(
            jax.random.PRNGKey(0), feats, a1, j_head.strides,
            coder=j_head.coder))


def test_crpn_faster_roi_head_matches_jax_on_the_proposals(ref):
    head = HEADS.build(roi_cfg())
    keys = ['roi_head.' + k for k in head.state_dict()]
    stub = {'rpn': {'s1_adapt': {'kernel': np.zeros((9 * 64, 64),
                                                    np.float32)}}}
    sd = {k: v for k, v in state_dict_from_jax({'params': {
        'roi_head': {'bbox': ref['roi']['params']}, 'rpn_net': stub}},
        keys).items() if k.startswith('roi_head.')}
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[9:]: v for k, v in sd.items()}, strict=True)
    feats, props, valid = (ref['roi_in'][0], *(
        torch.from_numpy(np.array(a)) for a in ref['roi_in'][1:]))
    want, want_dets = ref['roi_out']
    got = head.train().forward_train(nchw(feats), props, valid,
                                     ref['t_batch'],
                                     torch.Generator().manual_seed(0))
    assert_losses_close(got, want)
    with torch.no_grad():
        dets = head.eval().simple_test(nchw(feats), props, valid,
                                       ref['t_batch']['img_hw'])
    assert_dets_match(dets, want_dets, 1e-4)


@pytest.mark.parametrize('path', [CRPN_RPN, CRPN_FASTER])
def test_crpn_detectors_drive_the_head(path):
    """The port's RPN and Faster R-CNN run the Cascade RPN configs (R18,
    width 64): finite losses of both stages, proposals from
    `get_proposals` with `max_per_img` from `train_cfg.rpn_proposal` /
    `test_cfg.rpn`."""
    cfg = Config.fromfile(path)
    model = cfg.model
    model.backbone.depth = 18
    model.neck.update(in_channels=[64, 128, 256, 512], out_channels=64)
    model.rpn_head.update(in_channels=64, feat_channels=64)
    if 'roi_head' in model:
        model.roi_head.bbox_head.update(in_channels=64, fc_out_channels=64)
        model.roi_head.bbox_roi_extractor.out_channels = 64
        # an 81-way softmax at random weights scores ~0.012
        model.test_cfg.rcnn.score_thr = 0.001
    det = build_detector(model)
    det.init_weights(torch.Generator().manual_seed(0))
    _, b = gt_batches()
    b['gt_labels'] = b['gt_labels'].clamp(max=0) if 'roi_head' not in \
        model else b['gt_labels']
    losses = det.train().forward_train(b, torch.Generator().manual_seed(1))
    for k in ('loss_rpn_reg_s1', 'loss_rpn_reg_s2', 'loss_rpn_cls'):
        assert np.isfinite(float(losses[k].detach()))
    with torch.no_grad():
        dets, _, valid = det.eval().forward_test(b)
    rpn_test = model.test_cfg.rpn if 'rpn' in model.test_cfg else \
        model.test_cfg
    if 'roi_head' in model:
        assert dets.shape[1] == 100
        props, _ = det._proposals(det(b['image'])[1], b['img_hw'],
                                  det.train_cfg.get('rpn_proposal'))
        assert props.shape[1] == model.train_cfg.rpn_proposal.max_per_img
    else:
        assert dets.shape[1] == rpn_test.max_per_img
    assert int(valid.sum()) > 0


# ---- TOOD ---------------------------------------------------------------------
def test_tood_head_outputs_match_jax(ref):
    head = port_tood(ref).train()
    with torch.no_grad():
        got = head(nchw(fpn_feats(seed=4)))
    for g, w in zip(got, ref['tood_out'][0]):
        assert_levels_close(g, w)
    # the offset branch moves the boxes off the grid
    assert float(head.reg_offset_module[2].weight.abs().max()) > 0


def test_tood_losses_and_gradient_match_jax(ref):
    head = port_tood(ref).train()
    outs = head(nchw(fpn_feats(seed=4)))
    _, want, grads, _ = ref['tood_out']
    losses = head.loss(outs, ref['t_batch'], TOOD_SIZES)
    assert_losses_close(losses, want)
    sum(losses.values()).backward()
    assert_grads_close(head, grads, 'head_net', 'bbox_head.', TOOD_GRAD_RTOL)


def test_tood_detections_match_jax(ref):
    head = port_tood(ref).eval()
    with torch.no_grad():
        outs = head(nchw(fpn_feats(seed=4)))
        dets = head.get_bboxes(outs, ref['t_batch']['img_hw'])
    assert_dets_match(dets, ref['tood_out'][3], 1e-4)


def test_tood_quirks():
    """Caveats 83-85: QualityFocalLoss's `activated` is taken and not read
    in both packages; the alignment read is zero outside the map; the
    distances are clipped at exp(8) strides."""
    rs = np.random.RandomState(3)
    pred = rs.randn(30, 4).astype(np.float32)
    target = (rs.randint(0, 5, 30), rs.uniform(0, 1, 30).astype(np.float32))
    got = [float(LOSSES.build(dict(type='QualityFocalLoss', activated=a))(
        torch.from_numpy(pred), tuple(torch.from_numpy(t) for t in target)))
        for a in (False, True)]
    want = [float(JAX_LOSSES.build(dict(type='QualityFocalLoss',
                                        activated=a))(
        jnp.asarray(pred), tuple(jnp.asarray(t) for t in target)))
        for a in (False, True)]
    assert got[0] == got[1] and want[0] == want[1]
    assert abs(got[0] - want[0]) <= 1e-6 * abs(want[0])
    from ld_tpu_torch.models.heads.tood_head import bilinear_shift
    feat = torch.ones(1, 1, 3, 4)
    off = torch.zeros(1, 2, 3, 4)
    off[:, 1] = 10.0
    assert float(bilinear_shift(feat, off).abs().max()) == 0.0
    head = HEADS.build(TOOD_HEAD)
    with torch.no_grad():
        head.tood_reg.bias.fill_(100.0)
        _, boxes = head([torch.zeros(1, 64, h, w) for h, w in TOOD_SIZES])
    assert float(boxes[0][:, 2].max()) <= 12 + float(np.exp(8)) + 1e-3


def test_tood_detector_matches_jax(ref):
    model = tood_cfg(Config.fromfile(TOOD_CONFIG))
    det = build_detector(model)
    keys = list(det.state_dict())
    det.load_state_dict(state_dict_from_jax(ref['tood_det'], keys),
                        strict=True)
    b = ref['t_batch']
    w_outs, w_losses, w_dets, _ = ref['tood_det_out']
    det.train()
    outs = det(b['image'])
    for g, w in zip(outs, w_outs):
        assert_levels_close(g, w, atol=DET_TOL)
    assert_losses_close(det.forward_train(b), w_losses, rtol=1e-3)
    with torch.no_grad():
        dets = det.eval().forward_test(b)
    assert_dets_match(dets, w_dets, DET_TOL)


@pytest.mark.parametrize('path', CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_config_builds(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        det = build_detector(cfg.model, dtype=cfg.get('dtype'))
    head = getattr(det, 'rpn_head', None) or det.bbox_head
    assert type(head).__name__ in ('CascadeRPNHead', 'RPNHead', 'TOODHead')
