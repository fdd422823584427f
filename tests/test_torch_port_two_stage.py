"""The port's two-stage stack (RoIAlign, samplers, RPN, the standard RoI
head, Faster R-CNN, RPN, Fast R-CNN, the KD two-stage detector, soft-NMS)
against the JAX package on the same weights and inputs.

Weights go JAX -> port (`state_dict_from_jax`; the JAX converter has no
two-stage names): the JAX detector's init at 64x96 (R18, FPN and RPN width
64, RoI fc width 64, 4 classes) with the RPN and RoI nets refilled from a
numpy seed, so that every mapped tensor matters. In float32 on the CPU:
  * `roi_align` and `multi_level_roi_align` (rois across the border, rois
    of each level) within 1e-5 relative;
  * the samplers' invariants: exact counts, only candidates picked, a
    given generator giving the same picks again; `select_topk_mask` equal
    to JAX on the same keys;
  * with samplers that pick every candidate (num past the candidate count,
    pos_fraction 1), so that the random order cannot matter: the RPN loss,
    the RoI head's `forward_train` losses and the detectors' loss dicts to
    rtol 2e-4, three SGD steps (the R18 frozen) to rtol 1e-3;
  * proposals and detections: the same kept set, boxes within 1e-4 (the
    whole detector's within 5e-3 px: the backbone's fp32 rounding reaches
    the boxes through exp(dw)), detections of equal score compared as a
    set;
  * the RPN's distillation terms (`loss_rpn_kd`, `loss_rpn_ld`) against
    JAX, the KD two-stage detector's loss dict built of them, and their
    zero under self-distillation; `soft_nms_select`; a GN ConvFC RoI net
    (fc1's permuted rows);
  * every config of configs/faster_rcnn/, rpn/ and fast_rcnn/ builds, or
    raises NotImplementedError naming the ROADMAP item it waits for;
  * `train_detector` for 2 steps and `eval_detector` on synthetic images.
"""
import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.ops.nms import soft_nms_select as j_soft_nms_select
from ld_tpu.ops.roi_align import multi_level_roi_align as j_ml_roi_align
from ld_tpu.ops.roi_align import roi_align as j_roi_align
from ld_tpu.ops.samplers import select_topk_mask as j_select_topk_mask
from ld_tpu.parallel import build_lr_schedule as j_build_lr_schedule
from ld_tpu.parallel import build_optimizer as j_build_optimizer
from ld_tpu.parallel import make_train_step as j_make_train_step
from ld_tpu.parallel.train_step import TrainState
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu_torch import Config
from ld_tpu_torch.apis import eval_detector, train_detector
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.ops.nms import soft_nms_select
from ld_tpu_torch.ops.roi_align import multi_level_roi_align, roi_align
from ld_tpu_torch.ops.samplers import (RandomSampler, randomized_topk_mask,
                                       select_topk_mask)
from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                   make_train_step)
from ld_tpu_torch.utils.checkpoint import load_from_jax, state_dict_from_jax
from test_torch_port_bridge import (assert_losses_close, batches,
                                    fill_tree, nchw)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
STRIDES = (4, 8, 16, 32)
# samplers that pick every candidate: the losses are then sums over the
# same set in both packages, whatever order the random keys give
ALL = dict(num=10**6, pos_fraction=1.0)
TRAIN_ALL = dict(rpn=dict(sampler=ALL), rcnn=dict(sampler=ALL))
TEST_CFG = dict(rpn=dict(nms_pre=200, max_per_img=150,
                         nms=dict(iou_threshold=0.7)),
                rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                          max_per_img=100))


def faster_cfg(train_cfg=TRAIN_ALL, frozen_stages=1, **roi):
    bbox_head = dict(dict(num_classes=4, in_channels=64, fc_out_channels=64),
                     **roi)
    return dict(
        type='FasterRCNN',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=frozen_stages,
                      norm_eval=True, style='pytorch'),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=dict(type='StandardRoIHead', bbox_head=bbox_head,
                      bbox_roi_extractor=dict(featmap_strides=list(STRIDES))),
        train_cfg=copy.deepcopy(train_cfg), test_cfg=copy.deepcopy(TEST_CFG))


def jax_variables(det, seed):
    """The JAX detector's variables: the backbone and FPN of a port R18
    initialised from `seed` (the JAX package's initializers) through the
    JAX converter, the RPN and RoI nets drawn from a numpy seed
    (`fill_tree`) in the shapes of their JAX inits (the strict load into
    the port checks every name and shape)."""
    port = build_detector(faster_cfg())
    port.init_weights(torch.Generator().manual_seed(seed))
    conv = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()
         if k.startswith(('backbone.', 'neck.'))}, num_laterals=4)
    assert conv.pop('_unmapped') == []
    feats = [jnp.zeros((1, h, w, 64)) for h, w in
             ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
    params = dict(conv['params'])
    params['rpn_net'] = jax.eval_shape(lambda: det.rpn_head.net.init(
        jax.random.PRNGKey(0), feats))['params']
    params['roi_head'] = dict(bbox=jax.eval_shape(
        lambda: det.roi_head.net.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 7, 7, 64))))['params'])
    return refill(dict(conv, params=params), ('rpn_net', 'roi_head'), seed)


def refill(variables, nets, seed):
    """`variables` with the params of `nets` drawn anew (`fill_tree`)."""
    params = dict(variables['params'])
    for i, net in enumerate(nets):
        params[net] = fill_tree(params[net], seed + 10 * (i + 1))
    return dict(variables, params=params)


@pytest.fixture(scope='module')
def faster():
    """Faster R-CNN in both packages on the same weights, the JAX RPN
    outputs and FPN features of the test batch, and its proposals."""
    det = j_build_detector(faster_cfg())
    variables = jax_variables(det, 0)
    model = load_from_jax(build_detector(faster_cfg()), variables)
    j_batch, t_batch = batches()
    j_batch['gt_labels'] = j_batch['gt_labels'].astype(jnp.int32)
    t_batch['gt_labels'] = t_batch['gt_labels'].long()
    feats, rpn_outs, roi_vars = jax.jit(
        lambda v, x: det.extract(v, x))(variables, j_batch['image'])
    props, valid = jax.jit(lambda o, hw: det.rpn_head.get_proposals(o, hw))(
        rpn_outs, j_batch['img_hw'])
    # the JAX forward_test is this chain: its detections, compiled once
    dets = jax.jit(lambda v, x, p, pv, hw: det.roi_head.simple_test(
        v, list(x), p, pv, hw))(roi_vars, feats, props, valid,
                                j_batch['img_hw'])
    # the RPN's loss with a teacher (random outputs near the student's):
    # its first two terms are the plain RPN loss
    rs = np.random.RandomState(8)
    t_outs = tuple(tuple(jnp.asarray(np.asarray(a) + rs.randn(
        *np.shape(a)).astype(np.float32)) for a in part) for part in rpn_outs)
    sizes = [tuple(np.shape(c)[1:3]) for c in rpn_outs[0]]
    rpn_losses = jax.jit(lambda o, b, t: det.rpn_head.loss_with_teacher(
        o, b, sizes, t, rng=jax.random.PRNGKey(4)))(rpn_outs, j_batch, t_outs)
    return dict(det=det, variables=variables, model=model, j_batch=j_batch,
                t_batch=t_batch, feats=feats, rpn_outs=rpn_outs,
                roi_vars=roi_vars, props=props, valid=valid, dets=dets,
                t_outs=t_outs, sizes=sizes, rpn_losses=rpn_losses)


def t_levels(levels):
    return nchw(levels)


def assert_dets_match(got, want, atol=1e-4):
    """The same valid mask, and in each image the same detections within
    `atol`: as multisets of (score, label, box), since
    equal scores (identical rois clipped to the image's edge) may leave
    the final top-k in either order (ROADMAP.md caveat 2)."""
    dets, labels, ok = (np.asarray(a) for a in want)
    assert ok.sum() > 0
    np.testing.assert_array_equal(got[2].numpy(), ok)
    for i in range(ok.shape[0]):
        rows = []
        for d, lab in ((got[0][i].numpy(), got[1][i].numpy()),
                       (dets[i], labels[i])):
            d, lab = d[ok[i]], lab[ok[i]]
            key = np.lexsort((d[:, 0].round(2), lab, -d[:, 4].round(5)))
            rows.append((d[key], lab[key]))
        np.testing.assert_array_equal(rows[0][1], rows[1][1])
        np.testing.assert_allclose(rows[0][0], rows[1][0], rtol=0,
                                   atol=atol)


def test_roi_align_matches_jax():
    rs = np.random.RandomState(0)
    feat = rs.randn(2, 16, 24, 8).astype(np.float32)
    xy = rs.uniform(-20, 90, (30, 2))
    rois = np.concatenate([xy, xy + rs.uniform(0.5, 60, (30, 2))],
                          -1).astype(np.float32)
    rois[0] = [-10, -8, 120, 90]       # across every border
    want = np.asarray(jax.jit(jax.vmap(lambda f, r: j_roi_align(
        f, r, 7, 0.25), in_axes=(0, None)))(jnp.asarray(feat),
                                            jnp.asarray(rois)))
    for i in range(2):
        got = roi_align(torch.from_numpy(feat).permute(0, 3, 1, 2),
                        torch.from_numpy(rois),
                        torch.full((30, ), i, dtype=torch.long), 7, 0.25)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   want[i], rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_multi_level_roi_align_matches_jax():
    rs = np.random.RandomState(1)
    feats = [rs.randn(2, h, w, 8).astype(np.float32)
             for h, w in ((16, 24), (8, 12), (4, 6), (2, 3))]
    # sides from 4 to 1200 px: every level, some rois across the border
    side = np.exp(rs.uniform(np.log(4), np.log(1200), (2, 40)))
    cx, cy = rs.uniform(0, 96, (2, 40)), rs.uniform(0, 64, (2, 40))
    rois = np.stack([cx - side / 2, cy - side / 3, cx + side / 2,
                     cy + side / 3], -1).astype(np.float32)
    valid = rs.rand(2, 40) > 0.2
    from ld_tpu_torch.ops.roi_align import roi_levels
    assert set(roi_levels(torch.from_numpy(rois), 4).numpy().ravel()) == \
        {0, 1, 2, 3}
    want = jax.jit(jax.vmap(lambda f, r, v: j_ml_roi_align(
        f, r, v, 7, STRIDES)))(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        jnp.asarray(valid))
    got = multi_level_roi_align(
        [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
        torch.from_numpy(rois), torch.from_numpy(valid), 7, STRIDES)
    want = np.asarray(want).reshape(80, 7, 7, 8)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert not got.reshape(80, -1)[~torch.from_numpy(valid).reshape(-1)] \
        .any()


def test_samplers_invariants():
    rs = np.random.RandomState(2)
    pos = torch.from_numpy(rs.rand(3, 200) < 0.1)
    neg = torch.from_numpy(rs.rand(3, 200) < 0.7) & ~pos
    sampler = RandomSampler(num=32, pos_fraction=0.25)
    a = sampler.sample(torch.Generator().manual_seed(5), pos, neg)
    b = sampler.sample(torch.Generator().manual_seed(5), pos, neg)
    c = sampler.sample(torch.Generator().manual_seed(6), pos, neg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not (torch.equal(a[0], c[0]) and torch.equal(a[1], c[1]))
    n_pos = torch.clamp(pos.sum(-1), max=8)
    assert torch.equal(a[0].sum(-1), n_pos)
    assert torch.equal(a[1].sum(-1),
                       torch.minimum(neg.sum(-1), 32 - n_pos))
    assert not (a[0] & ~pos).any() and not (a[1] & ~neg).any()
    sel = randomized_topk_mask(pos, 5, torch.Generator().manual_seed(1))
    assert torch.equal(sel.sum(-1), torch.clamp(pos.sum(-1), max=5))
    assert not (sel & ~pos).any()
    # the top-k mask itself, on the same keys as JAX
    keys = rs.rand(200).astype(np.float32)
    keys[10:20] = keys[10]            # ties past the k-th key
    for k in (0, 7, 15, 300):
        want, n = j_select_topk_mask(jnp.asarray(keys), jnp.asarray(
            pos[0].numpy()), k)
        got, m = select_topk_mask(torch.from_numpy(keys), pos[0], k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(m) == int(n)


def test_sampled_rois_invariants(faster):
    """The configs' sampler (512 rois, 1/4 positive) on the JAX
    proposals: a fixed count, positives first, then the negatives, then
    padding; the same generator state gives the same rois."""
    roi_head = build_detector(faster_cfg(train_cfg=None)).roi_head
    t = faster['t_batch']
    props = torch.from_numpy(np.array(faster['props']))
    valid = torch.from_numpy(np.array(faster['valid']))
    args = (props, valid, t['gt_bboxes'], t['gt_labels'], t['gt_valid'])
    s = roi_head.sample_rois(*args, torch.Generator().manual_seed(3))
    again = roi_head.sample_rois(*args, torch.Generator().manual_seed(3))
    assert torch.equal(s['rois'], again['rois'])
    n = min(512, props.shape[1] + t['gt_bboxes'].shape[1])
    assert s['rois'].shape == (2, n, 4)
    n_pos = s['roi_pos'].sum(-1)
    assert (n_pos <= 128).all() and (n_pos >= t['gt_valid'].sum(-1)).all()
    for i in range(2):
        flags = s['roi_pos'][i].long() + s['roi_valid'][i].long()
        assert torch.equal(flags, torch.sort(flags, descending=True).values)
    assert (s['labels'][~s['roi_pos']] == 4).all()
    assert (s['labels'][s['roi_pos']] < 4).all()


def test_rpn_loss_and_proposals_match_jax(faster):
    f = faster
    want = {k: f['rpn_losses'][k] for k in ('loss_rpn_cls', 'loss_rpn_bbox')}
    outs = tuple(t_levels(p) for p in f['rpn_outs'])
    rpn = f['model'].rpn_head
    got = rpn.loss(outs, f['t_batch'], f['sizes'])
    assert_losses_close(got, want)
    props, valid = rpn.get_proposals(outs, f['t_batch']['img_hw'])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(f['valid']))
    assert valid.sum() > 100
    np.testing.assert_allclose(props.numpy(), np.asarray(f['props']),
                               rtol=0, atol=1e-4)


def test_roi_head_train_and_test_match_jax(faster):
    det, f = faster['det'], faster
    feats = t_levels(f['feats'])
    props = torch.from_numpy(np.array(f['props']))
    valid = torch.from_numpy(np.array(f['valid']))
    want = jax.jit(lambda v, x, p, pv, b: det.roi_head.forward_train(
        v, list(x), p, pv, b, rng=jax.random.PRNGKey(5)))(
            f['roi_vars'], f['feats'], f['props'], f['valid'], f['j_batch'])
    roi_head = f['model'].roi_head
    got = roi_head.forward_train(feats, props, valid, f['t_batch'],
                                 torch.Generator().manual_seed(0))
    assert float(want['loss_bbox']) > 0
    assert_losses_close(got, want)
    with torch.no_grad():
        got = roi_head.simple_test(feats, props, valid,
                                   f['t_batch']['img_hw'])
    assert_dets_match(got, f['dets'])


def test_faster_rcnn_end_to_end_matches_jax(faster):
    """`forward_test` of the whole detector against the JAX chain of
    `extract`, `get_proposals` and `simple_test` (its loss dict is the
    first of the three SGD steps below)."""
    f = faster
    with torch.no_grad():
        got = f['model'].eval().forward_test(f['t_batch'])
    # through the R18 and the FPN: fp32 rounding of the features reaches
    # the decoded coordinates through exp(dw), up to 1.2e-3 px here
    assert_dets_match(got, f['dets'], atol=5e-3)


def test_three_sgd_steps_track_jax(faster):
    """Three SGD steps of the detector on one image, its R18 frozen (the
    FPN, RPN and RoI nets train): JAX compiles the step without the
    backbone's backward, a third of the file's time otherwise."""
    f = faster
    det = j_build_detector(faster_cfg(frozen_stages=4))
    opt_cfg = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4)
    lr_config = dict(policy='step', warmup='linear', warmup_iters=2,
                     warmup_ratio=0.1, step=[8])
    variables = f['variables']
    j_opt = j_build_optimizer(opt_cfg, j_build_lr_schedule(
        0.01, lr_config, 100, 12), variables['params'],
        frozen_prefixes=det.frozen_param_paths())
    state = TrainState(params=variables['params'],
                       batch_stats=variables['batch_stats'],
                       opt_state=j_opt.init(variables['params']),
                       step=jnp.zeros((), jnp.int32))
    j_step = jax.jit(j_make_train_step(det, j_opt))
    # the test batch's first image alone: a step costs half
    j_batch = {k: v[:1] for k, v in f['j_batch'].items()}
    t_batch = {k: v[:1] for k, v in f['t_batch'].items()}
    model = load_from_jax(build_detector(faster_cfg(frozen_stages=4)),
                          variables)
    optimizer, scheduler = build_optimizer(opt_cfg, build_lr_schedule(
        0.01, lr_config, 100, 12), model)
    step = make_train_step(model, optimizer, scheduler)
    for i in range(3):
        state, want = j_step(state, j_batch)
        got = step(t_batch)
        if i == 0:
            assert sorted(k for k in got if k != 'loss') == [
                'loss_bbox', 'loss_cls', 'loss_rpn_bbox', 'loss_rpn_cls']
            assert_losses_close(got, want)
        assert_losses_close(got, want, rtol=1e-3)


def kd_cfg():
    cfg = faster_cfg()
    cfg['type'] = 'KnowledgeDistillationTwoStageDetector'
    cfg['teacher_config'] = dict(model=faster_cfg())
    return cfg


def test_kd_two_stage_losses_match_jax(faster):
    """The RPN's distillation terms against the JAX head on the same
    student and teacher outputs; the KD detector's loss dict is Faster
    R-CNN's plus those terms of its teacher's RPN, the teacher hidden and
    frozen, and under self-distillation the terms are zero."""
    f = faster
    sizes, want = f['sizes'], f['rpn_losses']
    rpn = f['model'].rpn_head
    got = rpn.loss_with_teacher(tuple(t_levels(p) for p in f['rpn_outs']),
                                f['t_batch'], sizes,
                                tuple(t_levels(p) for p in f['t_outs']))
    assert float(want['loss_rpn_kd']) > 0 and float(want['loss_rpn_ld']) > 0
    assert_losses_close(got, want)

    teacher = refill(f['variables'], ('rpn_net', ), 1)
    model = load_from_jax(build_detector(kd_cfg()), f['variables'],
                          teacher).train()
    assert not any(k.startswith('teacher') for k in model.state_dict())
    assert model.teacher.training is False
    assert not any(p.requires_grad for p in model.teacher.parameters())
    got = model.forward_train(f['t_batch'])
    plain = f['model'].train().forward_train(f['t_batch'])
    with torch.no_grad():
        _, t_rpn = model.teacher(f['t_batch']['image'])
        s_rpn = f['model'](f['t_batch']['image'])[1]
    kd = rpn.loss_with_teacher(s_rpn, f['t_batch'], sizes, t_rpn)
    for k in plain:
        assert float(got[k]) == pytest.approx(float(plain[k]), rel=1e-6), k
    for k in ('loss_rpn_kd', 'loss_rpn_ld'):
        assert float(got[k]) == pytest.approx(float(kd[k]), rel=1e-6), k
    # self-distillation: the teacher is the student
    model = load_from_jax(build_detector(kd_cfg()), f['variables'],
                          f['variables']).train()
    got = model.forward_train(f['t_batch'])
    assert abs(float(got['loss_rpn_kd'].detach())) < 1e-7
    assert float(got['loss_rpn_ld'].detach()) == 0.0


def test_soft_nms_select_matches_jax():
    rs = np.random.RandomState(3)
    xy = rs.uniform(0, 50, (2, 64, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(5, 30, (2, 64, 2))],
                           -1).astype(np.float32)
    scores = rs.rand(2, 64).astype(np.float32)
    valid = rs.rand(2, 64) > 0.1
    for method in ('linear', 'gaussian'):
        got = soft_nms_select(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(valid), 0.3, 20,
                              method=method, min_score=0.05)
        for i in range(2):
            want = j_soft_nms_select(jnp.asarray(boxes[i]),
                                     jnp.asarray(scores[i]),
                                     jnp.asarray(valid[i]), 0.3, 20,
                                     method=method, min_score=0.05)
            np.testing.assert_array_equal(got[2][i].numpy(),
                                          np.asarray(want[2]))
            ok = np.asarray(want[2])
            np.testing.assert_array_equal(got[0][i].numpy()[ok],
                                          np.asarray(want[0])[ok])
            np.testing.assert_allclose(got[1][i].numpy(),
                                       np.asarray(want[1]), rtol=1e-6,
                                       atol=1e-7)


def test_gn_convfc_roi_net_round_trip():
    """A Shared4Conv1FC RoI net with GN: the JAX tree loads strictly, and
    the net's outputs equal JAX's on the same roi features (fc1's rows
    permuted from the HWC flatten)."""
    from ld_tpu.utils.registry import HEADS as JAX_HEADS
    cfg = faster_cfg(type='Shared4Conv1FCBBoxHead', conv_out_channels=16,
                     norm_cfg=dict(type='GN', num_groups=4))
    net = JAX_HEADS.build(dict(cfg['roi_head'])).net
    bbox = fill_tree(jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 7, 7, 64))))['params'], 2)
    roi_head = build_detector(cfg).roi_head
    keys = [f'roi_head.{k}' for k in roi_head.state_dict()]
    sd = state_dict_from_jax({'params': {'roi_head': {'bbox': bbox}}}, keys)
    roi_head.load_state_dict({k[len('roi_head.'):]: v
                              for k, v in sd.items()}, strict=True)
    assert 'bbox_head.shared_convs.3.gn.weight' in roi_head.state_dict()
    x = np.random.RandomState(4).randn(6, 7, 7, 64).astype(np.float32)
    want = jax.jit(net.apply)({'params': bbox}, jnp.asarray(x))
    with torch.no_grad():
        got = roi_head.bbox_head(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


def test_rpn_and_fast_rcnn_detectors():
    """The RPN detector tests to its proposals ranked by score, the Fast
    R-CNN one runs its RoI head on given proposals."""
    _, t = batches()
    t['gt_labels'] = t['gt_labels'].long()
    cfg = faster_cfg()
    rpn_cfg = dict(type='RPN', backbone=cfg['backbone'], neck=cfg['neck'],
                   rpn_head=cfg['rpn_head'], test_cfg=TEST_CFG['rpn'])
    rpn = build_detector(rpn_cfg)
    rpn.init_weights(torch.Generator().manual_seed(0))
    assert not any(k.startswith('roi_head') for k in rpn.state_dict())
    assert sorted(rpn.train().forward_train(t)) == ['loss_rpn_bbox',
                                                    'loss_rpn_cls']
    with torch.no_grad():
        dets, labels, valid = rpn.eval().forward_test(t)
    assert dets.shape == (2, 150, 5) and not labels.any()
    assert (dets[..., 4].diff(dim=-1) < 0).all()
    fast = build_detector(dict(cfg, type='FastRCNN'))
    fast.init_weights(torch.Generator().manual_seed(0))
    t['proposals'] = dets[..., :4]
    t['proposals_valid'] = valid
    assert sorted(fast.train().forward_train(t)) == ['loss_bbox', 'loss_cls']
    with torch.no_grad():
        assert fast.eval().forward_test(t)[0].shape == (2, 100, 5)


TWO_STAGE_CONFIGS = sorted(
    os.path.relpath(p, ROOT) for d in ('faster_rcnn', 'rpn', 'fast_rcnn')
    for p in glob.glob(os.path.join(ROOT, 'configs', d, '*.py')))


@pytest.mark.parametrize('path', TWO_STAGE_CONFIGS)
def test_two_stage_config_builds_or_names_its_item(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    try:
        with torch.device('meta'):
            model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    except NotImplementedError as e:
        assert 'ROADMAP.md' in str(e), str(e)
        return
    assert type(model).__name__ == cfg.model.type


def test_train_and_eval_on_synthetic_images(tmp_path):
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py'))
    model = faster_cfg(train_cfg=None)
    model['roi_head']['bbox_head']['num_classes'] = 20
    cfg.model = Config(dict(model=model)).model
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)
    pipe = [dict(type='FusedPreprocess', img_scale=(96, 64), **norm),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    synth = dict(type='SyntheticDetectionDataset', hw=(64, 96),
                 num_classes=20, max_boxes=4, draw_boxes=True)
    cfg.data = dict(samples_per_gpu=2,
                    train=dict(synth, num_images=4, pipeline=pipe),
                    val=dict(synth, num_images=2, seed=1, pipeline=[
                        pipe[0], dict(type='Collect', keys=['img'])]))
    cfg.pad_to = HW
    cfg.runner = dict(max_epochs=1)
    cfg.log_config = dict(interval=1)
    cfg.evaluation = dict(interval=0)
    cfg.checkpoint_config = dict(interval=1)
    cfg.dtype = 'float32'
    ret = train_detector(cfg, str(tmp_path), max_steps=2, device='cpu')
    assert ret['step'] == 2
    assert all(np.isfinite(float(v)) for v in ret['metrics'].values())
    from ld_tpu_torch.data import build_dataset
    val = build_dataset(cfg.data['val'])
    res = eval_detector(ret['model'], val, pad_hw=HW)
    metrics = val.evaluate(res)
    assert 'bbox_mAP' in metrics
