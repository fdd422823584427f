"""The port's remaining RoI-head variants against the JAX package on the
same weights and inputs: deformable RoI pooling (dpool / mdpool), the C4
configs' shared res5 head with its mask branch, Double-Head, Dynamic R-CNN
and SCNet; and the configs of configs/scnet/, double_heads/,
dynamic_rcnn/, the C4 and the dpool / mdpool ones.

Weights go JAX -> port (`state_dict_from_jax`; the JAX converter has no
rule for the dpool FCs, the shared res5, the Double-Head net or the global
context: asserted). The RoI heads run at width 64 (the C4 head narrowed to
a stage-1 shared stage over 256-channel stride-16 features) on random FPN
features of a 2x3x64x96 batch of G = 4 gts (the last one padding) and
proposals around the gts, float32 on the CPU:
  * `roi_align` with offsets against `roi_align_offsets` (rois across the
    border, offsets past it) within 1e-5, zero offsets the plain RoIAlign
    exactly, and the level-routed second pass within 1e-5;
  * the dpool and mdpool RoI heads, Double-Head and Dynamic R-CNN: the
    loss dict to rtol 2e-4, and where the test path is new (mdpool,
    Double-Head, C4) `simple_test`'s detections as multisets within 1e-4
    (dpool's is mdpool's without the modulation, Dynamic R-CNN's the
    standard head's). dpool, mdpool and Double-Head sample every candidate
    (num past the count, pos_fraction 1); Dynamic R-CNN and the C4 head
    sample at num 16 with the same uniform draws in both packages (the JAX
    `jax.random.uniform` patched to return them in call order while its
    programs trace, the port's `dynamic_draws` / `uniform_keys`), and the
    sampled rois, labels and targets are identical;
  * Dynamic R-CNN's IoU thresholds against a numpy reckoning, its dynamic
    SmoothL1 (beta, loss) against the JAX loss within 1e-6;
  * the narrow C4 Mask R-CNN RoI head: its loss dict (`loss_mask` through
    the shared stage at the bbox extractor's 14x14) to rtol 2e-4, its test
    detections and 14x14 masks within 1e-4;
  * SCNet: `GlobalContextHead` and `loss_glbctx` against the JAX head's
    own code (its HTC part patched out while it traces), and the port's
    SCNet RoI head as its HTC head (held in
    `tests/test_torch_port_cascade.py`) plus `loss_glbctx`, the same test;
  * full width on the meta device: each new RoI head's names and shapes
    are `state_dict_from_jax` of the JAX head's `jax.eval_shape` tree;
  * every config of the slice builds (445 -> 465 of 491 in all).

The `ref` fixture traces each JAX program once and compiles it in a thread
as soon as it is traced, at LLVM -O0.
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
from ld_tpu.models.heads.htc_roi_head import GlobalContextNet
from ld_tpu.models.heads.htc_roi_head import \
    HybridTaskCascadeRoIHead as JHTCRoIHead
from ld_tpu.models.heads.roi_variants import _DynamicSmoothL1
from ld_tpu.ops.roi_align import (multi_level_roi_align_offsets as
                                  j_ml_offsets)
from ld_tpu.ops.roi_align import roi_align_offsets as j_roi_align_offsets
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads import (DoubleHeadRoIHead, DynamicRoIHead,
                                       HybridTaskCascadeRoIHead,
                                       SCNetRoIHead, StandardRoIHead)
from ld_tpu_torch.models.heads import roi_head as roi_head_module
from ld_tpu_torch.models.heads.htc_roi_head import GlobalContextHead
from ld_tpu_torch.models.heads.roi_head import (DeformRoIPoolExtractor,
                                                ResLayer)
from ld_tpu_torch.models.heads.roi_variants import DynamicSmoothL1Loss
from ld_tpu_torch.ops import samplers as samplers_module
from ld_tpu_torch.ops.roi_align import (multi_level_roi_align_offsets,
                                        roi_align)
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import assert_losses_close, fill_tree, nchw
from test_torch_port_ms_rcnn_resnest import fpn_features, gt_masks, proposals
from test_torch_port_paa_fsaf_freeanchor import gt_batches, numpy_tree
from test_torch_port_sabl import assert_dets_match
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    [os.path.relpath(p, ROOT) for d in ('scnet', 'double_heads',
                                        'dynamic_rcnn')
     for p in glob.glob(os.path.join(ROOT, 'configs', d, '*.py'))] +
    ['configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py',
     'configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py',
     'configs/dcn/faster_rcnn_r50_fpn_dpool_1x_coco.py',
     'configs/dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py'])
ALL = dict(num=10**6, pos_fraction=1.0)
NUM16 = dict(num=16, pos_fraction=0.25)
STRIDES = [4, 8, 16, 32]
TEST_RCNN = dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                 max_per_img=40)
ROI_BBOX = dict(num_classes=4, in_channels=64, fc_out_channels=64)
C4_FEAT = (4, 6, 256)
# the RoI head's rows permute by the RPN's input width (the FPN's)
RPN_STUB = {'rpn_conv': {'kernel': np.zeros((3, 3, 64, 64), np.float32)}}


def dpool(modulated):
    return dict(type='SingleRoIExtractor', featmap_strides=STRIDES,
                roi_layer=dict(type='ModulatedDeformRoIPoolPack' if modulated
                               else 'DeformRoIPoolPack', output_size=7,
                               output_channels=64, deform_fc_channels=32))


def roi_cfg(kind):
    """The RoI head of `kind` at width 64, 4 classes."""
    cfg = dict(type='StandardRoIHead', bbox_head=dict(ROI_BBOX),
               bbox_roi_extractor=dict(featmap_strides=STRIDES),
               train_cfg=dict(sampler=ALL), test_cfg=TEST_RCNN)
    if kind in ('dpool', 'mdpool'):
        cfg['bbox_roi_extractor'] = dpool(kind == 'mdpool')
    elif kind == 'double':
        cfg.update(type='DoubleHeadRoIHead', bbox_head=dict(
            num_classes=4, in_channels=64, conv_out_channels=64,
            fc_out_channels=64, num_convs=2))
    elif kind == 'dynamic':
        cfg.update(type='DynamicRoIHead', ktop_iou=5, ktop_beta=3,
                   train_cfg=dict(sampler=NUM16))
    elif kind == 'c4':
        norm = dict(type='BN', requires_grad=False)
        cfg.update(
            shared_head=dict(type='ResLayer', depth=50, stage=1, stride=2,
                             dilation=1, style='caffe', norm_cfg=norm,
                             norm_eval=True),
            bbox_roi_extractor=dict(
                type='SingleRoIExtractor', roi_layer=dict(
                    type='RoIAlign', output_size=14, sampling_ratio=0),
                out_channels=256, featmap_strides=[16]),
            bbox_head=dict(type='BBoxHead', with_avg_pool=True,
                           roi_feat_size=7, in_channels=512, num_classes=4),
            mask_roi_extractor=None,
            mask_head=dict(type='FCNMaskHead', num_convs=0, in_channels=512,
                           conv_out_channels=64, num_classes=4),
            train_cfg=dict(sampler=NUM16))
    return cfg


@contextlib.contextmanager
def draws_in_order(draws):
    """`jax.random.uniform` returning `draws` in call order while a JAX
    program traces (the samplers' `_uniform_keys` call it too)."""
    it = iter(draws)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'uniform', lambda *a, **k: next(it))
        yield


def j_sampled_roi_losses(head, variables, feats, props, valid, b, draws):
    """The JAX `StandardRoIHead.forward_train` (`roi_head.py:575-603`) with
    each image's `sample_rois` on its (3, P) `draws` (P: the gts and the
    proposals): (losses, the sampled rois' tuple)."""
    def one(p, pv, gtb, gtl, gtv, d):
        with draws_in_order(d):
            return head.sample_rois(p, pv, gtb, gtl, gtv,
                                    jax.random.PRNGKey(0))
    s = jax.vmap(one)(props, valid, b['gt_bboxes'], b['gt_labels'],
                      b['gt_valid'], draws.transpose(1, 0, 2))
    rois, roi_valid, roi_pos, labels, deltas, gt_inds, w = s
    feats = list(feats)[:len(head.featmap_strides)]
    rf = jax.vmap(lambda f, r, v: head._extract_rois(variables, f, r, v))(
        feats, rois, roi_valid)
    cls, reg = head.net.apply(head._bbox_vars(variables),
                              rf.reshape(-1, *rf.shape[-3:]))
    losses = head._bbox_losses(cls, reg, rois, labels, roi_valid, roi_pos,
                               deltas, w, gt_inds)
    if head.mask_head is not None and 'gt_masks' in b:
        mf = jax.vmap(lambda f, r, v: head._extract_rois(
            variables, f, r, v, mask=True))(feats, rois, roi_valid & roi_pos)
        losses['loss_mask'] = jax.vmap(
            lambda m, r, rp, rl, gi, gm: head.mask_head.loss(
                head._mask_vars(variables), m, r, rp, rl, gi, gm))(
                    mf, rois, roi_pos, labels, gt_inds, b['gt_masks']).mean()
    return losses, s


def c4_features(seed=12):
    """Random (2, 4, 6, 256) stride-16 C4 features, NHWC."""
    return [np.random.RandomState(seed).randn(2, *C4_FEAT).astype(
        np.float32)]


def glbctx_loss_only(head, variables, feats, b):
    """The JAX SCNet head's `forward_train` with its HTC part returning no
    loss: its `loss_glbctx` alone."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JHTCRoIHead, 'forward_train', lambda *a, **k: {})
        return head.forward_train(variables, list(feats), None, None, b,
                                  jax.random.PRNGKey(0))


@pytest.fixture(scope='module')
def ref():
    """The JAX trees (numpy) and outputs of every module the tests hold the
    port against."""
    out, jobs = {}, {}
    j_batch, t_batch = gt_batches()
    masks = gt_masks(t_batch)
    j_mask_batch = dict(j_batch, gt_masks=jnp.asarray(masks, jnp.float32))
    feats = fpn_features()
    props, valid = proposals(t_batch)
    cand = props.shape[1] + j_batch['gt_bboxes'].shape[1]
    draws = out['draws'] = np.random.RandomState(21).rand(
        3, 2, cand).astype(np.float32)

    # the offset RoIAlign, one image and level-routed
    rs = np.random.RandomState(5)
    img = rs.randn(9, 13, 8).astype(np.float32)
    rois = np.concatenate([rs.uniform(-10, 40, (10, 2)),
                           rs.uniform(5, 30, (10, 2))], 1).astype(np.float32)
    rois[:, 2:] += rois[:, :2]
    offsets = (rs.randn(10, 7, 7, 2) * 3).astype(np.float32)
    ml_offsets = (rs.randn(2, props.shape[1], 7, 7, 2)).astype(np.float32)
    out['align_in'] = (img, rois, offsets, ml_offsets)
    jobs['align'] = (lambda img, r, o, f, p, v, mo: (
        j_roi_align_offsets(img, r, o, 7, 0.25, 2, 0.1),
        jax.vmap(lambda ff, rr, vv, oo: j_ml_offsets(
            ff, rr, vv, oo, 7, STRIDES))(f, p, v, mo)),
        (img, rois, offsets, list(feats), props, valid, ml_offsets))

    def roi_run(head, kind):
        def run(v, feats, props, valid, b):
            # the test paths that differ from the standard head's: dpool's
            # is mdpool's without the modulation, Dynamic R-CNN's is the
            # standard head's own
            test = None if kind in ('dpool', 'dynamic') else \
                head.simple_test({'params': v}, list(feats), props, valid,
                                 b['img_hw'])
            if kind in ('dynamic', 'c4'):
                losses, s = j_sampled_roi_losses(
                    head, {'params': v}, feats, props, valid, b, draws)
                return test, losses, s
            return test, head.forward_train({'params': v}, list(feats),
                                            props, valid, b,
                                            rng=jax.random.PRNGKey(5))
        return run

    for seed, kind in enumerate(('dpool', 'mdpool', 'double', 'dynamic',
                                 'c4'), 11):
        head = JAX_HEADS.build(roi_cfg(kind))
        tree = out[kind] = fill_tree(jax.eval_shape(
            lambda head=head: head.init_all_variables(
                jax.random.PRNGKey(0), 64)), seed=seed)
        jobs[kind] = (roi_run(head, kind), (
            tree, c4_features() if kind == 'c4' else feats, props, valid,
            j_mask_batch if kind == 'c4' else j_batch))

    net = GlobalContextNet(num_classes=4)
    levels = [np.random.RandomState(13).randn(2, h, w, 64).astype(np.float32)
              for h, w in ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
    out['glbctx'] = fill_tree(jax.eval_shape(
        lambda: net.init(jax.random.PRNGKey(0), levels))['params'], seed=17)
    out['levels'] = levels
    scnet = JAX_HEADS.build(scnet_cfg())
    jobs['glbctx'] = (lambda v, f, b: (
        net.apply({'params': v}, f),
        glbctx_loss_only(scnet, {'params': {'glbctx': v}}, f, b)),
        (out['glbctx'], levels, j_batch))

    o0 = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=o0)
                   for k, (fn, args) in jobs.items()}
    for k, (fn, args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*args)

    jl = _DynamicSmoothL1(ktop=10, initial_beta=1.0)
    out['dsl1'] = [jax.jit(lambda p, t, w, jl=jl: jl(
        p, t, weight=w, avg_factor=w.sum() + 1.0))(*dynamic_case(n))
        for n in (4, 40)]
    return dict(numpy_tree(out), t_batch=t_batch,
                t_mask_batch=dict(t_batch, gt_masks=torch.from_numpy(masks)),
                roi_inputs=(feats, props, valid))


def port_roi_head(kind, ref):
    """The port's RoI head of `roi_cfg(kind)` on the JAX tree, in train
    mode."""
    head = HEADS.build(roi_cfg(kind))
    keys = ['roi_head.' + k for k in head.state_dict()]
    sd = {k: v for k, v in state_dict_from_jax({'params': {
        'roi_head': ref[kind], 'rpn_net': RPN_STUB}}, keys).items()
        if k.startswith('roi_head.')}
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[len('roi_head.'):]: v for k, v in sd.items()},
                         strict=True)
    return head.train()


def roi_inputs(ref, kind=None):
    feats, props, valid = ref['roi_inputs']
    return (nchw(c4_features() if kind == 'c4' else feats),
            torch.from_numpy(np.array(props)),
            torch.from_numpy(np.array(valid)))


@contextlib.contextmanager
def port_draws(head, draws, monkeypatch):
    """The port head sampling on `draws` (3, B, P): Dynamic R-CNN's
    `dynamic_draws`, a sampler's `uniform_keys` in call order."""
    d = torch.from_numpy(draws)
    if isinstance(head, DynamicRoIHead):
        monkeypatch.setattr(head, 'dynamic_draws', lambda *a: d)
    else:
        it = iter(d)
        for mod in (samplers_module, roi_head_module):
            monkeypatch.setattr(mod, 'uniform_keys', lambda *a: next(it))
    yield


# ---- deformable RoIAlign ----------------------------------------------------
def test_roi_align_offsets_matches_jax(ref):
    img, rois, offsets, _ = ref['align_in']
    want, _ = ref['align_out']
    x = torch.from_numpy(img.transpose(2, 0, 1)[None].copy())
    r = torch.from_numpy(rois)
    owner = torch.zeros(len(rois), dtype=torch.long)
    got = roi_align(x, r, owner, 7, 0.25, offsets=torch.from_numpy(
        offsets.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5)
    # the offsets move the samples, and zero offsets are the plain op
    plain = roi_align(x, r, owner, 7, 0.25)
    assert float((got - plain).abs().max()) > 0.1
    assert torch.equal(roi_align(x, r, owner, 7, 0.25,
                                 offsets=torch.zeros(len(rois), 2, 7, 7)),
                       plain)


def test_multi_level_roi_align_offsets_matches_jax(ref):
    *_, ml_offsets = ref['align_in']
    _, want = ref['align_out']
    feats, props, valid = roi_inputs(ref)
    off = torch.from_numpy(ml_offsets.reshape(-1, 7, 7, 2).transpose(
        0, 3, 1, 2).copy())
    got = multi_level_roi_align_offsets(feats, props, valid, off)
    want = want.reshape(-1, *want.shape[2:])
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5)
    assert float(got.abs().max()) > 0.5


# ---- the RoI heads ----------------------------------------------------------
@pytest.mark.parametrize('kind', ('dpool', 'mdpool', 'double'))
def test_roi_head_matches_jax(ref, kind):
    head = port_roi_head(kind, ref)
    feats, props, valid = roi_inputs(ref)
    test_out, want = ref[f'{kind}_out']
    got = head.forward_train(feats, props, valid, ref['t_batch'],
                             torch.Generator().manual_seed(0))
    assert_losses_close(got, want)
    if test_out is not None:
        with torch.no_grad():
            dets = head.eval().simple_test(feats, props, valid,
                                           ref['t_batch']['img_hw'])
        assert_dets_match(dets, test_out)
    if kind != 'double':
        ext = head.bbox_roi_extractor
        assert isinstance(ext, DeformRoIPoolExtractor)
        assert (ext.mask_fc is not None) == (kind == 'mdpool')
        # the offsets of the filled tree move the second pass
        assert float(ext.offset_fc[2].weight.detach().abs().max()) > 0
    else:
        assert isinstance(head, DoubleHeadRoIHead)
        assert len(head.bbox_head.conv_branch) == 2


@pytest.mark.parametrize('kind', ('dynamic', 'c4'))
def test_sampled_roi_head_matches_jax(ref, kind, monkeypatch):
    """Dynamic R-CNN and the C4 Mask R-CNN head sample 16 rois an image on
    the same draws as the JAX head: the same rois, labels and targets, and
    the loss dict (the C4's `loss_mask` too) to rtol 2e-4."""
    head = port_roi_head(kind, ref)
    feats, props, valid = roi_inputs(ref, kind)
    test_out, want, j_s = ref[f'{kind}_out']
    b = ref['t_mask_batch'] if kind == 'c4' else ref['t_batch']
    with port_draws(head, ref['draws'], monkeypatch):
        s = head.sample_rois(props, valid, b['gt_bboxes'],
                             b['gt_labels'].long(), b['gt_valid'],
                             torch.Generator())
    j_rois, j_valid, j_pos, j_labels, j_targets = j_s[:5]
    np.testing.assert_array_equal(s['roi_valid'].numpy(), j_valid)
    np.testing.assert_array_equal(s['roi_pos'].numpy(), j_pos)
    np.testing.assert_array_equal(s['labels'].numpy(), j_labels)
    np.testing.assert_array_equal(s['rois'].numpy(), j_rois)
    np.testing.assert_allclose(s['targets'].numpy(), j_targets, rtol=0,
                               atol=1e-5)
    assert 0 < j_pos.sum() < j_valid.sum() <= 32
    with port_draws(head, ref['draws'], monkeypatch):
        got = head.forward_train(feats, props, valid, b,
                                 torch.Generator().manual_seed(0))
    assert ('loss_mask' in want) == (kind == 'c4')
    assert_losses_close(got, want)
    if kind == 'c4':
        with torch.no_grad():
            dets = head.eval().simple_test(feats, props, valid, b['img_hw'])
        assert_dets_match(dets[:3], test_out[:3])
        assert isinstance(head.shared_head, ResLayer)
        assert tuple(dets[3].shape[-2:]) == (14, 14) == test_out[3].shape[-2:]
        ok = test_out[2]
        for i in range(ok.shape[0]):
            order = np.lexsort((-test_out[0][i][:, 4].round(5), ))
            got_order = np.lexsort((-dets[0][i].numpy()[:, 4].round(5), ))
            np.testing.assert_allclose(
                dets[3][i].numpy()[got_order][ok[i][order]],
                test_out[3][i][order][ok[i][order]], rtol=0, atol=1e-4)


def test_c4_shared_head_stays_frozen_and_on_its_statistics(ref):
    head = port_roi_head('c4', ref)
    bns = [m for m in head.shared_head.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and not any(m.training for m in bns)
    assert not any(p.requires_grad for m in bns for p in m.parameters())
    before = bns[0].running_mean.clone()
    feats, props, valid = roi_inputs(ref, 'c4')
    head.forward_train(feats, props, valid, ref['t_mask_batch'],
                       torch.Generator().manual_seed(0))
    assert torch.equal(bns[0].running_mean, before)
    assert head.mask_head.roi_size == 7 and head.mask_roi_size == 14


def dynamic_case(n, seed=19):
    """(n, 4) predictions and targets, the first rows positive."""
    rs = np.random.RandomState(seed + n)
    pred = rs.randn(n, 4).astype(np.float32)
    target = (rs.randn(n, 4) * 0.3).astype(np.float32)
    w = np.repeat((np.arange(n) < n * 0.6)[:, None], 4, 1).astype(
        np.float32)
    return pred, target, w


@pytest.mark.parametrize('case', (0, 1))
def test_dynamic_smooth_l1_matches_jax(ref, case):
    """Beta is the 10th smallest positive |target| mean (with fewer than
    10 positives, `initial_beta`)."""
    n = (4, 40)[case]
    pred, target, w = (torch.from_numpy(a) for a in dynamic_case(n))
    loss = DynamicSmoothL1Loss(ktop=10, initial_beta=1.0)
    got = float(loss(pred, target, weight=w, avg_factor=w.sum() + 1.0))
    assert abs(got - float(ref['dsl1'][case])) <= 1e-6 * abs(got)
    per_box = target.abs().mean(-1)[:int(w[:, 0].sum())]
    want_beta = 1.0 if n == 4 else float(per_box.sort().values[9])
    assert float(loss.beta(target, w)) == pytest.approx(want_beta)


def test_dynamic_iou_threshold_is_the_mean_kth_iou(ref):
    head = port_roi_head('dynamic', ref)
    _, props, valid = roi_inputs(ref)
    b = ref['t_batch']
    thr, iou, _, _ = head.iou_thresholds(props, valid, b['gt_bboxes'],
                                         b['gt_valid'])
    for i in range(2):
        gv = b['gt_valid'][i].numpy()
        kth = np.sort(iou[i].numpy(), 0)[::-1][4][gv]
        assert float(thr[i]) == pytest.approx(
            np.clip(kth.mean(), 0.4, 0.6), abs=1e-6)
    # without a gt, the initial threshold
    none = torch.zeros_like(b['gt_valid'])
    assert torch.equal(head.iou_thresholds(props, valid, b['gt_bboxes'],
                                           none)[0], torch.full((2, ), 0.4))


# ---- SCNet --------------------------------------------------------------
def scnet_cfg():
    return dict(type='SCNetRoIHead', num_stages=3,
                stage_loss_weights=[1, 0.5, 0.25],
                bbox_head=dict(ROI_BBOX),
                mask_head=dict(num_convs=1, in_channels=64,
                               conv_out_channels=64),
                semantic_head=dict(num_classes=5, in_channels=64,
                                   conv_out_channels=64, num_ins=5),
                bbox_roi_extractor=dict(featmap_strides=STRIDES),
                train_cfg=dict(sampler=ALL), test_cfg=TEST_RCNN)


def test_global_context_matches_jax(ref):
    head = GlobalContextHead(num_classes=4, in_channels=64)
    sd = state_dict_from_jax({'params': {'roi_head': {
        'glbctx': ref['glbctx']}}})
    head.load_state_dict({k[len('roi_head.glbctx_head.'):]: v
                          for k, v in sd.items()}, strict=True)
    (j_logits, j_ctx), j_loss = ref['glbctx_out']
    levels = nchw(ref['levels'])
    logits, ctx = head(levels)
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ctx.detach().numpy(), j_ctx, rtol=0,
                               atol=1e-5)
    roi = HEADS.build(scnet_cfg())
    roi.glbctx_head = head
    got = roi.glbctx_loss(levels, ref['t_batch'])
    assert_losses_close({'loss_glbctx': got}, j_loss)


def test_scnet_is_htc_plus_global_context(ref):
    """The same weights in SCNet's and HTC's port heads: SCNet's losses
    are HTC's plus `loss_glbctx`, its test HTC's (the context vector is
    fused into nothing, as in JAX)."""
    scnet = HEADS.build(scnet_cfg())
    scnet.init_weights(torch.Generator().manual_seed(3))
    htc = HEADS.build(dict(scnet_cfg(), type='HybridTaskCascadeRoIHead'))
    assert isinstance(scnet, SCNetRoIHead) and \
        type(htc) is HybridTaskCascadeRoIHead
    own = {k: v for k, v in scnet.state_dict().items()
           if not k.startswith('glbctx_head.')}
    htc.load_state_dict(own, strict=True)
    feats, props, valid = roi_inputs(ref)
    levels = feats + [feats[-1][..., ::2, ::2].contiguous()]
    b = ref['t_mask_batch']
    got = scnet.forward_train(levels, props, valid, b,
                              torch.Generator().manual_seed(0))
    want = htc.forward_train(levels, props, valid, b,
                             torch.Generator().manual_seed(0))
    assert sorted(got) == sorted([*want, 'loss_glbctx'])
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert float(got['loss_glbctx']) > 0
    with torch.no_grad():
        a = scnet.eval().simple_test(levels, props, valid, b['img_hw'])
        c = htc.eval().simple_test(levels, props, valid, b['img_hw'])
    assert len(a) == 3 and all(torch.equal(x, y) for x, y in zip(a, c))


# ---- full width, the converter and the configs ------------------------------
@pytest.mark.parametrize('path', [
    'configs/scnet/scnet_r50_fpn_1x_coco.py',
    'configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py',
    'configs/dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py',
    'configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py'])
def test_full_width_names_and_shapes_match_jax(path):
    """The config's RoI head at full width (the detector's trunk and FPN
    are held by earlier files): the JAX head's `jax.eval_shape` tree ->
    the port's keys and shapes."""
    det = j_build_detector(JConfig.fromfile(os.path.join(ROOT, path)).model)
    in_channels = getattr(det.neck, 'out_channels', 1024)
    roi = jax.eval_shape(lambda: det.roi_head.init_all_variables(
        jax.random.PRNGKey(0), in_channels))
    rpn = {'rpn_conv': {'kernel': np.zeros((3, 3, in_channels, in_channels),
                                           np.float32)}}
    tree = {'params': {'roi_head': jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), roi), 'rpn_net': rpn}}
    with torch.device('meta'):
        model = build_detector(Config.fromfile(os.path.join(ROOT,
                                                            path)).model)
    want = {k: v for k, v in model.state_dict().items()
            if k.startswith('roi_head.')}
    got = {k: v for k, v in state_dict_from_jax(tree, want.keys()).items()
           if k.startswith('roi_head.')}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    # the JAX converter has no rule for the slice's new RoI-head names
    new = [k for k in want if k.startswith((
        'roi_head.shared_head.', 'roi_head.bbox_roi_extractor.',
        'roi_head.glbctx_head.', 'roi_head.bbox_head.res_block.'))]
    assert new
    conv = convert_torch_state_dict({k: np.zeros(tuple(want[k].shape),
                                                 np.float32) for k in new})
    # (it skips every `num_batches_tracked`)
    assert sorted(conv['_unmapped']) == sorted(
        k for k in new if not k.endswith('.num_batches_tracked'))
    assert not any(conv[c] for c in ('params', 'batch_stats') if c in conv)


@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    assert type(model).__name__ == cfg.model.type
    roi = model.roi_head
    kind = {'SCNet': SCNetRoIHead, 'DoubleHeadRCNN': DoubleHeadRoIHead,
            'DynamicRCNN': DynamicRoIHead}.get(cfg.model.type,
                                                StandardRoIHead)
    assert isinstance(roi, kind)
    assert (roi.shared_head is not None) == ('c4' in path)
    assert isinstance(roi.bbox_roi_extractor, DeformRoIPoolExtractor) == \
        ('pool' in path)
    if 'x101' in path:
        assert type(model.backbone).__name__ == 'ResNeXt'
