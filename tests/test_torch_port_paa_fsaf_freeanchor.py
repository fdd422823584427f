"""The port's PAA, FSAF and FreeAnchor heads against the JAX package on the
same weights and inputs, and their configs.

Weights go JAX -> port: `jax.eval_shape` of the JAX init, `fill_tree` from a
numpy seed and `state_dict_from_jax` onto the port's names. The PAA head has
the ATSS names, which the JAX converter maps: it is held the recipe's way
too (port -> `convert_torch_state_dict` -> JAX, and back). The FSAF and
FreeAnchor nets are Retina nets with no JAX converter rule (asserted). The
three detectors (R18, FPN and head width 64, 2 stacked convs, 4 classes) run
on a 2x3x64x96 batch of G = 4 gts, the last one padding; the JAX side is one
PAA detector program (its FPN features out) and the FSAF and FreeAnchor
heads on those features. Float32 on the CPU:
  * `TBLRBBoxCoder` encode / decode within 1e-5; `CenterRegionAssigner` on
    nested and equal-area gts (an anchor centre on a shrunk box's edge):
    identical;
  * `fit_gmm_1d` on (6, 45) rows, fully, partly and not masked: the
    responsibilities within 1e-5, their > 0.5 side identical;
  * PAA's reassignment, on given losses with runs of equal values, and on
    the head's own outputs: the kept positives identical;
  * FSAF's level of each gt and its kept positives on the head's outputs:
    identical; `select_levels` of equal means takes the lower level;
  * FreeAnchor's bag anchors on the anchor grid, where integer gt corners
    put gt centres midway between anchor centres (runs of equal IoUs) and a
    padded gt ties at -1 everywhere: the same anchors in the same order;
  * each head's outputs within 1e-5 of each output's largest, its losses on
    the JAX outputs to rtol 2e-4, the summed losses' gradient for each
    output within 1e-4 of the largest, and its detections (PAA's with score
    voting) within 1e-4;
  * the three detectors end to end: head outputs within 5e-3, the loss
    dicts to rtol 1e-3, `forward_test` within 5e-3;
  * every config of configs/paa/, fsaf/ and free_anchor/ builds on the meta
    device.

The `ref` fixture traces every JAX program once and compiles each in a
thread as soon as it is traced, at LLVM -O0.
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
from ld_tpu.models.heads.paa_head import fit_gmm_1d as j_fit_gmm_1d
from ld_tpu.models.heads.retina_gfl_head import flatten_levels_anchors
from ld_tpu.ops.boxes import bbox_overlaps as j_bbox_overlaps
from ld_tpu.ops.coder import build_coder as j_build_coder
from ld_tpu.ops.extra_assigners import \
    CenterRegionAssigner as JCenterRegionAssigner
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads import (FreeAnchorRetinaHead, FSAFHead,
                                       PAAHead)
from ld_tpu_torch.models.heads.paa_head import fit_gmm_1d
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.ops.extra_assigners import CenterRegionAssigner
from ld_tpu_torch.testing import detection_batch_np
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import (HEAD_KW, OUT_ABS, TEST_CFG,
                                    assert_losses_close, fill_tree, nchw,
                                    nhwc)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/paa/*.py')) +
                 glob.glob(os.path.join(ROOT, 'configs/fsaf/*.py')) +
                 glob.glob(os.path.join(ROOT, 'configs/free_anchor/*.py')))
SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
KINDS = ('paa', 'fsaf', 'free_anchor')
HEAD_CFGS = dict(
    paa=dict(type='PAAHead', topk=9, score_voting=True,
             anchor_generator=dict(ratios=[1.0], octave_base_scale=8,
                                   scales_per_octave=1,
                                   strides=[8, 16, 32, 64, 128])),
    fsaf=dict(type='FSAFHead'),
    free_anchor=dict(type='FreeAnchorRetinaHead', pre_anchor_topk=50))
TRAIN_CFGS = dict(
    paa=dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.1,
                           neg_iou_thr=0.1, min_pos_iou=0.0)),
    # the configs' 0.2 leaves the 64x96 batch's gts (8-38 px) almost no
    # anchor centre: 0.5 gives most gts positives at two levels or more
    fsaf=dict(assigner=dict(type='CenterRegionAssigner', pos_scale=0.5,
                            neg_scale=0.8)),
    free_anchor=None)
OUT_RTOL, GRAD_RTOL, DET_TOL = 1e-5, 1e-4, 5e-3


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def head_cfg(kind):
    return dict(HEAD_CFGS[kind], **HEAD_KW, train_cfg=TRAIN_CFGS[kind],
                test_cfg=dict(TEST_CFG, nms_pre=60))


def det_cfg(kind):
    """The kind's detector at R18, width 64 (the PAA config's FPN for all
    three, so that they share one backbone)."""
    model = copy.deepcopy(JConfig.fromfile(os.path.join(
        ROOT, 'configs/paa/paa_r50_fpn_1x_coco.py'))['model'])
    model['type'] = {'paa': 'PAA', 'fsaf': 'FSAF',
                     'free_anchor': 'RetinaNet'}[kind]
    model['backbone']['depth'] = 18
    model['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    cfg = head_cfg(kind)
    model['bbox_head'] = {k: v for k, v in cfg.items()
                          if k not in ('train_cfg', 'test_cfg')}
    model['train_cfg'] = cfg['train_cfg']
    model['test_cfg'] = cfg['test_cfg']
    return model


def gt_batches(seed=3):
    """A 2-image 64x96 batch of 4 classes, G = 4 gts an image, the last
    one padding: (jax, port)."""
    np_batch = detection_batch_np(2, 64, 96, num_classes=4, max_gts=4,
                                  seed=seed)
    np_batch['gt_valid'][:, 3] = False
    np_batch['gt_bboxes'][:, 3] = 0.0
    j = {k: jnp.asarray(v) for k, v in np_batch.items()}
    j['image'] = nhwc(np_batch['image'])
    j['gt_labels'] = j['gt_labels'].astype(jnp.int32)
    t = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    return j, t


def j_paa_pieces(head, outs, b):
    """The JAX PAA loss's candidates and kept positives (its `single`,
    `ld_tpu/models/heads/paa_head.py:166-181`)."""
    anchors, num_lvl, _, level_id = head.level_geometry(SIZES)
    cls_flat = flatten_levels_anchors(outs[0], head.cls_out_channels)
    reg_flat = flatten_levels_anchors(outs[1], 4)
    num_gt = b['gt_bboxes'].shape[1]

    def single(gtb, gtl, gtv, hw, cls_p, reg_p):
        vf = jnp.concatenate(head.anchor_generator.valid_flags(SIZES, hw))
        res = head.assigner.assign(anchors, num_lvl, gtb, gtl, gtv, vf,
                                   num_classes=head.num_classes)
        cand = res.pos_mask & vf
        tgt = gtb[jnp.clip(res.assigned_gt_inds, 0)]
        decoded = head.coder.decode(anchors, reg_p)
        pos_loss = head.loss_cls(cls_p, res.labels,
                                 reduction_override='none').sum(-1) + \
            head.loss_bbox(decoded, tgt, reduction_override='none')
        keep = head._reassign_single(pos_loss, cand, res.assigned_gt_inds,
                                     level_id, num_gt, len(num_lvl))
        return cand, keep
    return jax.vmap(single)(b['gt_bboxes'], b['gt_labels'], b['gt_valid'],
                            b['img_hw'], cls_flat, reg_flat)


def j_fsaf_pieces(head, outs, b):
    """The JAX FSAF loss's level of each gt and kept positives
    (`ld_tpu/models/heads/fsaf_head.py:60-107`)."""
    anchors, num_lvl, _, level_id = head.level_geometry(SIZES)

    def assign_single(gtb, gtl, gtv, hw):
        vf = jnp.concatenate(head.anchor_generator.valid_flags(SIZES, hw))
        res = head.assigner.assign(anchors, num_lvl, gtb, gtl, gtv, vf,
                                   num_classes=head.num_classes)
        return res.labels, res.pos_mask, res.assigned_gt_inds
    labels, pos, gt_inds = jax.vmap(assign_single)(
        b['gt_bboxes'], b['gt_labels'], b['gt_valid'], b['img_hw'])
    cls_flat = flatten_levels_anchors(outs[0], head.cls_out_channels)
    reg_flat = jnp.maximum(flatten_levels_anchors(outs[1], 4), 1e-4)
    safe = jnp.clip(gt_inds, 0)
    tgt = jnp.take_along_axis(b['gt_bboxes'], safe[..., None], axis=1)
    decoded = head.coder.decode(anchors[None], reg_flat)
    cls_none = head.loss_cls(cls_flat, labels,
                             reduction_override='none').sum(-1)
    bbox_none = head.loss_bbox(decoded.reshape(-1, 4), tgt.reshape(-1, 4),
                               reduction_override='none').reshape(pos.shape)
    g, levels = b['gt_bboxes'].shape[1], len(num_lvl)
    onehot_gt = (safe[:, :, None] == jnp.arange(g)[None, None, :]) & \
        pos[:, :, None]
    onehot_lvl = level_id[None, :, None] == jnp.arange(levels)[None, None, :]
    sel = onehot_gt[:, :, :, None] & onehot_lvl[:, :, None, :]
    cnt = sel.sum(axis=1).astype(jnp.float32)
    tab = jnp.where(cnt > 0, ((cls_none + bbox_none)[:, :, None, None] *
                              sel).sum(axis=1) / jnp.maximum(cnt, 1), 1e6)
    best_level = tab.argmin(axis=-1)
    keep = pos & (level_id[None, :] ==
                  jnp.take_along_axis(best_level, safe, axis=1))
    return best_level, keep


def j_free_anchor_bags(head, b):
    """The JAX FreeAnchor loss's bag anchors (`free_anchor_head.py:68-70`)."""
    anchors = head.level_geometry(SIZES)[0]
    k = min(head.pre_anchor_topk, anchors.shape[0])

    def single(gtb, gtv):
        quality = jnp.where(gtv[:, None], j_bbox_overlaps(gtb, anchors), -1.0)
        return jax.lax.top_k(quality, k)[1]
    return jax.vmap(single)(b['gt_bboxes'], b['gt_valid'])


def grid_gts():
    """Gts with integer corners: centres midway between anchor centres
    (equal IoUs), and one gt small enough that most of its bag has IoU 0."""
    gt = np.array([[[12., 12., 28., 28.], [40., 8., 72., 56.],
                    [4., 4., 12., 12.], [0., 0., 0., 0.]],
                   [[16., 0., 48., 32.], [20., 20., 76., 60.],
                    [50., 30., 58., 38.], [0., 0., 0., 0.]]], np.float32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], bool)
    return gt, valid


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against; numpy trees and
    outputs."""
    out = {}
    jobs = {}
    j_batch, t_batch = gt_batches()
    det = j_build_detector(det_cfg('paa'))
    dv = out['det_paa'] = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=9)
    out['heads'] = heads = {'paa': det.bbox_head}
    out['vars'] = {'paa': {'params': dv['params']['head_net']}}

    def total(head, o, b):
        return sum(head.loss(o, b, SIZES).values())

    def paa_run(v, b):
        outs, feats = det.apply(v, b['image'], output_features=True)
        head = det.bbox_head
        return (outs, feats, head.loss(outs, b, SIZES),
                jax.grad(lambda o: total(head, o, b))(outs),
                head.get_bboxes(outs, b['img_hw']),
                j_paa_pieces(head, outs, b))
    jobs['paa'] = (paa_run, (dv, j_batch))

    feat_shapes = [jax.ShapeDtypeStruct((2, h, w, 64), jnp.float32)
                   for h, w in SIZES]
    for seed, kind in ((11, 'fsaf'), (12, 'free_anchor')):
        head = heads[kind] = JAX_HEADS.build(head_cfg(kind))
        v = out['vars'][kind] = fill_tree(jax.eval_shape(
            lambda f, head=head: head.net.init(jax.random.PRNGKey(0), f),
            feat_shapes), seed=seed)

        def head_run(v, feats, b, head=head, kind=kind):
            outs = head.net.apply(v, feats)
            pieces = j_fsaf_pieces(head, outs, b) if kind == 'fsaf' else \
                j_free_anchor_bags(head, b)
            return (outs, head.loss(outs, b, SIZES),
                    jax.grad(lambda o: total(head, o, b))(outs),
                    head.get_bboxes(outs, b['img_hw']), pieces)
        jobs[kind] = (head_run, (v, feat_shapes, j_batch))
    gt, valid = grid_gts()
    jobs['bags'] = (lambda b: j_free_anchor_bags(heads['free_anchor'], b),
                    (dict(gt_bboxes=jnp.asarray(gt),
                          gt_valid=jnp.asarray(valid)), ))

    o0 = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(len(jobs)) as pool:
        # each compiles while the next is traced
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=o0)
                   for k, (fn, args) in jobs.items()}
    out['paa_out'] = futures['paa'].result()(*jobs['paa'][1])
    feats = out['paa_out'][1]
    for kind in ('fsaf', 'free_anchor'):
        fn, (v, _, b) = jobs[kind]
        out[f"{kind}_out"] = futures[kind].result()(v, list(feats), b)
    out['bags_out'] = futures['bags'].result()(*jobs['bags'][1])
    heads = out.pop('heads')
    return dict(numpy_tree(out), heads=heads, t_batch=t_batch,
                j_batch=j_batch)


def port_head(kind, variables):
    head = HEADS.build(head_cfg(kind))
    keys = ['bbox_head.' + k for k in head.state_dict()]
    sd = state_dict_from_jax({coll: {'head_net': tree}
                              for coll, tree in variables.items()}, keys)
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in sd.items()},
                         strict=True)
    return head.eval()


def port_detector(kind, ref):
    """The kind's port detector: the PAA detector's backbone and FPN, the
    kind's head, from the JAX trees."""
    model = build_detector(det_cfg(kind))
    params = dict(ref['det_paa']['params'],
                  head_net=ref['vars'][kind]['params'])
    variables = dict(ref['det_paa'], params=params)
    model.load_state_dict(state_dict_from_jax(variables,
                                              list(model.state_dict())),
                          strict=True)
    return model


def kind_parts(kind, ref):
    """(outputs, losses, grads, dets, pieces) of the kind's JAX run."""
    out = ref[f'{kind}_out']
    if kind == 'paa':
        return out[0], out[2], out[3], out[4], out[5]
    return out


def assert_levels_close(got, want, rtol=OUT_RTOL, atol=None):
    """Each level within `atol`, else `rtol` of the output's largest over
    the levels: flax's GroupNorm takes E[x^2] - E[x]^2 over the 1x1 level's
    2-value groups, which puts the JAX float32 values there ~1.6e-5 of
    their own size away."""
    assert len(got) == len(want)
    bound = atol if atol is not None else \
        rtol * max(np.abs(np.asarray(w)).max() for w in want)
    for g, w in zip(got, want):
        g = g.detach().numpy().transpose(0, 2, 3, 1)
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= bound


def assert_dets_close(got, want, tol):
    dets, labels, valid = (t.detach().numpy() for t in got)
    w_dets, w_labels, w_valid = (np.asarray(a) for a in want)
    assert valid.sum() > 0
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_array_equal(labels[valid], w_labels[w_valid])
    np.testing.assert_allclose(dets[valid], w_dets[w_valid], rtol=0,
                               atol=tol)


# ---- coder, assigner, GMM ---------------------------------------------------
def test_tblr_coder_matches_jax():
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 80, (2, 60, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0, 30, (2, 60, 2))],
                           -1).astype(np.float32)
    boxes[0, :3, 2:] = boxes[0, :3, :2]       # zero-size: the 1e-6 floor
    gts = np.concatenate([xy - 3, xy + rs.uniform(2, 30, (2, 60, 2))],
                         -1).astype(np.float32)
    deltas = rs.uniform(0.01, 2.0, (2, 60, 4)).astype(np.float32)
    hw = np.asarray([[64, 96], [60, 90]], np.float32)
    cfg = dict(type='TBLRBBoxCoder', normalizer=4.0)
    jc, tc = j_build_coder(dict(cfg)), build_coder(dict(cfg))
    np.testing.assert_allclose(
        tc.encode(torch.from_numpy(boxes), torch.from_numpy(gts)).numpy(),
        np.asarray(jax.jit(jc.encode)(boxes, gts)), rtol=1e-5, atol=1e-5)
    got = tc.decode(torch.from_numpy(boxes), torch.from_numpy(deltas),
                    max_shape=torch.from_numpy(hw)).numpy()
    want = np.asarray(jax.jit(lambda b, d, s: jc.decode(b, d, max_shape=s))(
        boxes, deltas, hw[:, None, :]))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # the decode clips to w and h, not w - 1
    assert got[..., 2].max() == 96.0


def test_center_region_assigner_matches_jax():
    """Anchors of stride 4 over 64x96; per image a gt nested in another
    (the smaller wins their shared centres), two gts of equal area covering
    the same centres (the lower index wins), a shrunk edge exactly on an
    anchor centre (inclusive), and a padded gt."""
    ys, xs = np.meshgrid(np.arange(16) * 4 + 2.0, np.arange(24) * 4 + 2.0,
                         indexing='ij')
    c = np.stack([xs.ravel(), ys.ravel()], -1)
    anchors = np.concatenate([c - 8, c + 8], -1).astype(np.float32)
    gt = np.array([[[10., 10., 60., 50.], [20., 20., 40., 40.],
                    [60., 20., 80., 40.], [0., 0., 0., 0.]],
                   [[5., 5., 45., 45.], [5., 5., 45., 45.],
                    [50., 10., 90., 50.], [60., 30., 80., 60.]]], np.float32)
    labels = np.array([[0, 1, 2, 0], [3, 1, 2, 0]], np.int64)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    a_valid = np.ones((2, anchors.shape[0]), bool)
    a_valid[1, :10] = False
    cfg = dict(pos_scale=0.2, neg_scale=0.6, min_pos_iof=0.01)
    j_assign = JCenterRegionAssigner(**cfg)
    want = jax.jit(jax.vmap(lambda g, l, v, av: j_assign.assign(
        jnp.asarray(anchors), [anchors.shape[0]], g, l, v, av,
        num_classes=4)))(gt, labels.astype(np.int32), valid, a_valid)
    got = CenterRegionAssigner(**cfg).assign(
        torch.from_numpy(anchors), [anchors.shape[0]], torch.from_numpy(gt),
        torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(a_valid), num_classes=4)
    for name in ('assigned_gt_inds', 'labels', 'pos_mask', 'max_overlaps'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    pos, ovl = got.pos_mask.numpy(), got.max_overlaps.numpy()
    assert pos.sum() > 5 and (ovl == -1).sum() > 5
    # the nested gt 1 and, of the equal pair, gt 0 take positives
    assert (got.assigned_gt_inds.numpy()[0] == 1).any()
    assert not (got.assigned_gt_inds.numpy()[1] == 1).any()


def test_fit_gmm_matches_jax():
    rs = np.random.RandomState(4)
    x = np.concatenate([rs.normal(0.4, 0.1, (6, 20)),
                        rs.normal(1.5, 0.3, (6, 25))], 1).astype(np.float32)
    x = x[:, rs.permutation(45)]
    valid = np.ones((6, 45), bool)
    valid[1] = False                     # no candidate
    valid[2, 3:] = False                 # 3 of them
    valid[3] = rs.rand(45) < 0.5
    valid[4, 1:] = False                 # one
    x = np.where(valid, x, 1e8).astype(np.float32)
    want = jax.jit(jax.vmap(j_fit_gmm_1d))(x, valid)
    got = fit_gmm_1d(torch.from_numpy(x), torch.from_numpy(valid))
    resp0, logd = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got[0].numpy(), resp0, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0].numpy() > 0.5, resp0 > 0.5)
    np.testing.assert_allclose(got[1].numpy(), logd, rtol=1e-5, atol=1e-4)
    assert (resp0[0] > 0.5).sum() >= 15 and (resp0[1] == 0).all()


def test_paa_reassign_matches_jax_on_tied_losses():
    """Given losses rounded to 0.02 (runs of equal values: the smallest-k
    per gt and level and the fg rank both meet ties) over 5 levels of 40
    anchors, 4 gts an image, one with a single candidate."""
    rs = np.random.RandomState(5)
    b, n, g = 2, 200, 4
    level_id = np.repeat(np.arange(5), 40).astype(np.int32)
    gt_inds = rs.randint(-1, g, (b, n)).astype(np.int32)
    gt_inds[:, (gt_inds[0] == 3) | (gt_inds[1] == 3)] = -1
    gt_inds[:, 7] = 3
    loss = np.round(np.where(rs.rand(b, n) < 0.5, rs.normal(0.5, 0.1, (b, n)),
                             rs.normal(1.6, 0.3, (b, n))) / 0.02) * 0.02
    loss = loss.astype(np.float32)
    cand = gt_inds >= 0
    head = JAX_HEADS.build(head_cfg('paa'))
    want = jax.jit(jax.vmap(lambda pl, c, gi: head._reassign_single(
        pl, c, gi, jnp.asarray(level_id), g, 5)))(loss, cand, gt_inds)
    port = PAAHead(**{k: v for k, v in head_cfg('paa').items()
                      if k != 'type'})
    got = port.reassign(torch.from_numpy(loss), torch.from_numpy(cand),
                        torch.from_numpy(gt_inds).long(),
                        torch.from_numpy(level_id).long(), g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 10 < got.sum() < cand.sum()
    assert not got[:, 7].any()           # a gt of one candidate keeps none


# ---- the heads --------------------------------------------------------------
@pytest.mark.parametrize('kind', KINDS)
def test_head_outputs_losses_and_gradients_match_jax(ref, kind):
    """The port head's forward on the JAX FPN features; its losses and
    their gradient for each output on the JAX outputs."""
    head = port_head(kind, ref['vars'][kind])
    j_outs, want, j_grads, _, _ = kind_parts(kind, ref)
    feats = nchw(ref['paa_out'][1])
    with torch.no_grad():
        got = head(feats)
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w)
    outs = tuple([t.requires_grad_() for t in nchw(part)] for part in j_outs)
    losses = head.loss(outs, ref['t_batch'], SIZES)
    assert_losses_close(losses, want)
    assert all(float(v) > 0 for v in losses.values())
    sum(losses.values()).backward()
    for part, j_part in zip(outs, j_grads):
        for t, w in zip(part, j_part):
            w = np.asarray(w)
            bound = max(GRAD_RTOL * max(np.abs(np.asarray(x)).max()
                                        for x in j_part), 1e-9)
            assert np.abs(t.grad.numpy().transpose(0, 2, 3, 1) - w).max() \
                <= bound


@pytest.mark.parametrize('kind', KINDS)
def test_head_detections_match_jax(ref, kind):
    head = port_head(kind, ref['vars'][kind])
    j_outs, _, _, want, _ = kind_parts(kind, ref)
    got = head.get_bboxes(tuple(nchw(p) for p in j_outs),
                          ref['t_batch']['img_hw'])
    assert_dets_close(got, want, 1e-4)


def test_paa_reassigned_positives_match_jax(ref):
    head = port_head('paa', ref['vars']['paa'])
    j_outs, _, _, _, (cand, keep) = kind_parts('paa', ref)
    r = head.reassigned(tuple(nchw(p) for p in j_outs), ref['t_batch'],
                        SIZES)
    np.testing.assert_array_equal(r['cand'].numpy(), cand)
    np.testing.assert_array_equal(r['keep'].numpy(), keep)
    assert 0 < keep.sum() < cand.sum()


def test_paa_score_voting_moves_boxes(ref):
    """Score voting on: the voted boxes differ from the NMS survivors."""
    head = port_head('paa', ref['vars']['paa'])
    outs = tuple(nchw(p) for p in kind_parts('paa', ref)[0])
    voted = head.get_bboxes(outs, ref['t_batch']['img_hw'])
    head.with_score_voting = False
    plain = head.get_bboxes(outs, ref['t_batch']['img_hw'])
    np.testing.assert_array_equal(voted[2].numpy(), plain[2].numpy())
    np.testing.assert_array_equal(voted[0][..., 4].numpy(),
                                  plain[0][..., 4].numpy())
    assert float((voted[0][..., :4] - plain[0][..., :4]).abs().max()) > 1e-3


def test_fsaf_levels_match_jax(ref):
    head = port_head('fsaf', ref['vars']['fsaf'])
    j_outs, _, _, _, (best_level, keep) = kind_parts('fsaf', ref)
    p = head.pieces(tuple(nchw(o) for o in j_outs), ref['t_batch'], SIZES)
    np.testing.assert_array_equal(p['best_level'].numpy(), best_level)
    np.testing.assert_array_equal(p['keep'].numpy(), keep)
    assert 0 < keep.sum() < p['pos'].sum()
    assert len(set(best_level[:, :3].ravel())) > 1


def test_fsaf_select_levels_ties_go_low():
    """Equal mean losses at two levels: the lower level, as `argmin`."""
    head = FSAFHead(num_classes=4, in_channels=64, feat_channels=64,
                    stacked_convs=1)
    level_id = torch.tensor([0, 0, 1, 1, 2, 3, 4])
    per_anchor = torch.tensor([[2., 4., 3., 3., 1., 5., 6.]])
    pos = torch.tensor([[True, True, True, True, False, True, True]])
    gt_inds = torch.tensor([[0, 0, 0, 0, 0, 1, 1]])
    got = head.select_levels(per_anchor, pos, gt_inds, level_id, 2)
    assert got.tolist() == [[0, 3]]


def test_free_anchor_bags_match_jax_on_tied_grid(ref):
    head = FreeAnchorRetinaHead(**{k: v for k, v in
                                   head_cfg('free_anchor').items()
                                   if k != 'type'})
    gt, valid = grid_gts()
    anchors = head.level_geometry(SIZES, 'cpu')[0]
    got = head.positive_bags(anchors, torch.from_numpy(gt),
                             torch.from_numpy(valid), 50)
    want = ref['bags_out']
    np.testing.assert_array_equal(got.numpy(), want)
    # the ties: runs of equal IoUs inside the bags; the padded gt's (all
    # -1) is the first 50 anchors
    from ld_tpu_torch.ops.boxes import bbox_overlaps
    iou = bbox_overlaps(torch.from_numpy(gt), anchors[None]).gather(-1, got)
    assert (iou[:, :3, 1:] == iou[:, :3, :-1]).sum() > 20
    assert got[:, 3].tolist() == [list(range(50))] * 2
    # the same anchors as the JAX loss's own top-k on the head's outputs
    np.testing.assert_array_equal(
        head.positive_bags(anchors, ref['t_batch']['gt_bboxes'],
                           ref['t_batch']['gt_valid'], 50).numpy(),
        kind_parts('free_anchor', ref)[4])


# ---- weights and detectors --------------------------------------------------
def test_paa_head_weights_both_ways(ref):
    """PAA has the ATSS names: port -> the JAX converter gives the JAX tree
    back, and `state_dict_from_jax` of it the port's state dict."""
    head = port_head('paa', ref['vars']['paa'])
    sd = {f'bbox_head.{k}': v.numpy() for k, v in head.state_dict().items()}
    conv = convert_torch_state_dict(sd)
    assert conv.pop('_unmapped') == []
    j_tree = ref['vars']['paa']['params']
    flat_want = dict(jax.tree_util.tree_leaves_with_path(j_tree))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(
        conv['params']['head_net']))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), v)


@pytest.mark.parametrize('kind', ('fsaf', 'free_anchor'))
def test_converter_has_no_retina_rule(ref, kind):
    head = port_head(kind, ref['vars'][kind])
    conv = convert_torch_state_dict({f'bbox_head.{k}': v.numpy()
                                     for k, v in head.state_dict().items()})
    assert 'bbox_head.retina_cls.weight' in conv['_unmapped']


@pytest.mark.parametrize('kind', KINDS)
def test_detector_end_to_end_matches_jax(ref, kind):
    model = port_detector(kind, ref)
    j_outs, want, _, want_dets, _ = kind_parts(kind, ref)
    batch = ref['t_batch']
    model.eval()
    with torch.no_grad():
        got = model(batch['image'])
        dets = model.forward_test(batch)
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w, atol=OUT_ABS)
    assert_dets_close(dets, want_dets, DET_TOL)
    model.train()
    with torch.no_grad():
        losses = model.forward_train(batch)
    assert_losses_close(losses, want, rtol=1e-3)


def test_unread_keys_follow_jax(ref):
    """ROADMAP.md caveats 59-60: the JAX FSAF head stores
    `score_threshold` and its `CenterRegionAssigner` takes `min_pos_iof`,
    the JAX PAA head takes `covariance_type`, and none reads them
    (`ld_tpu/models/heads/fsaf_head.py:31-53`, `ld_tpu/ops/
    extra_assigners.py:131-134`, `paa_head.py:84-86`): in the port other
    values give the same losses."""
    for kind, extra in (('fsaf', dict(score_threshold=0.9)),
                        ('paa', dict(covariance_type='full'))):
        cfg = head_cfg(kind)
        if kind == 'fsaf':
            cfg['train_cfg'] = dict(assigner=dict(
                cfg['train_cfg']['assigner'], min_pos_iof=0.9))
        head = HEADS.build(dict(cfg, **extra))
        base = port_head(kind, ref['vars'][kind])
        head.load_state_dict(base.state_dict())
        outs = tuple(nchw(p) for p in kind_parts(kind, ref)[0])
        got = head.loss(outs, ref['t_batch'], SIZES)
        want = base.loss(outs, ref['t_batch'], SIZES)
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_paa_fsaf_free_anchor_configs_build(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    head = model.bbox_head
    if '/paa/' in path:
        assert type(model).__name__ == 'PAA' and isinstance(head, PAAHead)
        assert head.with_score_voting and head.topk == 9
        assert head.anchor_generator.num_base_anchors == [1] * 5
    elif '/fsaf/' in path:
        assert type(model).__name__ == 'FSAF' and isinstance(head, FSAFHead)
        assert isinstance(head.assigner, CenterRegionAssigner)
        assert type(head.coder).__name__ == 'TBLRBBoxCoder'
        assert head.num_anchors == 1
    else:
        assert type(model).__name__ == 'RetinaNet'
        assert isinstance(head, FreeAnchorRetinaHead)
        assert head.num_anchors == 9 and head.pre_anchor_topk == 50
