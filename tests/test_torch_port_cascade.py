"""The port's cascade family (Cascade R-CNN, Cascade Mask R-CNN, HTC: the
cascade RoI heads, HTC's mask information flow and semantic head, their
weights) against the JAX package on the same weights and inputs.

R18 at 64x96, FPN / RPN / RoI width 64, 4 classes, three stages; the
backbone and FPN of a port init through the JAX converter, the RPN and RoI
nets filled from a numpy seed and carried JAX -> port by
`state_dict_from_jax`. The features and proposals of the test batch come
from JAX once and feed every RoI-head comparison. In float32 on the CPU:
  * the semantic head's bilinear resize of each FPN level to the stride-8
    level against `jax.image.resize` within 1e-5 (the downsampled level is
    antialiased there), the nearest resize of the gt masks bit-identical;
  * with samplers that pick every candidate (so that the random order
    cannot matter): the cascade heads' `forward_train` losses a stage
    (`loss_cls_s{i}`, `loss_bbox_s{i}`, `loss_mask_s{i}`; HTC's
    `loss_semantic_seg` with its semantic head) at rtol 2e-4;
  * with the configs' sampler (512 rois, a quarter positive):
    `loss_mask_s{i}` on the positive slice (128 rois an image) against the
    JAX mask branch on all the same rois at rtol 1e-5;
  * `forward_test` of the whole detector: the same kept set, boxes within
    5e-3 px (the backbone's fp32 rounding reaches them through exp(dw)),
    Cascade Mask R-CNN's masks within 1e-4; HTC's three outputs;
  * every config of configs/cascade_rcnn/, configs/htc/ and the cascades
    of configs/dcn/ builds on the meta device, the SABL cascades as a
    `CascadeSABLRoIHead` (held against JAX in test_torch_port_sabl.py);
    the R50 configs'
    `state_dict_from_jax` gives the port's keys and shapes exactly, and a
    JAX `.npz` loads through `load_checkpoint`;
  * one SGD step of Cascade Mask R-CNN and HTC on the port alone (finite
    losses).
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
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.models.heads.cascade_roi_head import CascadeRoIHead
from ld_tpu.models.heads.mask_head import mask_targets as j_mask_targets
from ld_tpu.ops.roi_align import multi_level_roi_align as j_ml_roi_align
from ld_tpu.ops.roi_align import roi_align as j_roi_align
from ld_tpu.utils.checkpoint import convert_torch_state_dict, save_variables
from ld_tpu_torch import Config
from ld_tpu_torch.apis import inference_detector
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads.htc_roi_head import (foreground_map,
                                                    resize_bilinear,
                                                    resize_nearest)
from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                   make_train_step)
from ld_tpu_torch.utils.checkpoint import (load_checkpoint,
                                           state_dict_from_jax)
from test_torch_port_bridge import (assert_losses_close, batches, fill_tree,
                                    nchw)
from test_torch_port_mask_rcnn import gt_masks_np
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse
from test_torch_port_two_stage import TEST_CFG, assert_dets_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX programs compile at LLVM -O0, as the HRNet file's do
O0 = dict(xla_backend_optimization_level=0)
STRIDES = [4, 8, 16, 32]
ALL = dict(num=10**6, pos_fraction=1.0)
# the proposals (of the RPN's 150, the top) the heads take with samplers
# that pick every candidate
ALL_PROPOSALS = 64
KINDS = ('cascade', 'cascade_mask', 'htc', 'htc_without_semantic')
# the kind whose JAX program and weights each kind is held against: the
# plain cascade is Cascade Mask R-CNN without its mask heads, HTC without
# its semantic head is HTC with a zero semantic feature (`zero_semantic`)
SOURCE = dict(cascade='cascade_mask', cascade_mask='cascade_mask', htc='htc',
              htc_without_semantic='htc')


def cascade_cfg(kind, rcnn_sampler=ALL):
    """`kind` ('cascade', 'cascade_mask', 'htc', 'htc_without_semantic')
    at R18, width 64 (Cascade Mask R-CNN's mask towers 16; 2 convs a
    tower), 4 classes; the RPN's sampler picks every candidate,
    the RoI head's `rcnn_sampler` (None: the config's 512 rois). The
    cascades' rcnn train_cfg is mmdet's list of three stage dicts."""
    roi = dict(type='CascadeRoIHead', num_stages=3,
               stage_loss_weights=[1, 0.5, 0.25],
               bbox_head=dict(num_classes=4, in_channels=64,
                              fc_out_channels=64),
               bbox_roi_extractor=dict(featmap_strides=STRIDES))
    # HTC's towers add their input to the information flow: as wide as it
    mask_head = dict(num_convs=2, in_channels=64,
                     conv_out_channels=64 if kind.startswith('htc') else 16)
    sampler = dict(sampler=rcnn_sampler) if rcnn_sampler else {}
    rcnn = [dict(sampler, assigner=dict(pos_iou_thr=t, neg_iou_thr=t,
                                        min_pos_iou=t))
            for t in (0.5, 0.6, 0.7)]
    if kind == 'cascade_mask':
        roi.update(mask_head=mask_head, mask_roi_extractor=dict(
            roi_layer=dict(output_size=14), featmap_strides=STRIDES))
    elif kind.startswith('htc'):
        roi.update(type='HybridTaskCascadeRoIHead', mask_head=mask_head,
                   semantic_head=None if kind.endswith('semantic') else
                   dict(num_classes=7, in_channels=64, conv_out_channels=64))
        rcnn = sampler
    return dict(
        type='HybridTaskCascade' if kind.startswith('htc') else
        'CascadeRCNN',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      norm_eval=True, style='pytorch'),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=roi, train_cfg=dict(rpn=dict(sampler=ALL), rcnn=rcnn),
        test_cfg=copy.deepcopy(TEST_CFG))


def roi_params(det, seed):
    """The JAX RoI head's params drawn from a numpy seed in the shapes of
    its init."""
    return fill_tree(jax.eval_shape(lambda: det.roi_head.init_all_variables(
        jax.random.PRNGKey(0), 64)), seed)


@pytest.fixture(scope='module')
def ref():
    """The shared backbone, FPN and RPN (a port R18 from seed 0 through the
    JAX converter, the RPN filled from a seed); Cascade Mask R-CNN and HTC
    in JAX, their RoI nets filled from a seed (HTC's stages the cascade's),
    and every kind of port detector on those weights; the test batch with
    gt masks; JAX's features and proposals of it."""
    port = build_detector(cascade_cfg('cascade'))
    port.init_weights(torch.Generator().manual_seed(0))
    conv = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()
         if k.startswith(('backbone.', 'neck.'))}, num_laterals=4)
    assert conv.pop('_unmapped') == []
    dets = {kind: j_build_detector(cascade_cfg(kind))
            for kind in ('cascade_mask', 'htc')}
    feats0 = [jnp.zeros((1, h, w, 64)) for h, w in
              ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
    params = dict(conv['params'], rpn_net=fill_tree(jax.eval_shape(
        lambda: dets['htc'].rpn_head.net.init(jax.random.PRNGKey(0),
                                              feats0))['params'], 10))
    cascade = roi_params(dets['cascade_mask'], 20)
    htc = dict(roi_params(dets['htc'], 21),
               **{f'stage{i}': cascade[f'stage{i}'] for i in range(3)})
    variables = {kind: dict(conv, params=dict(params, roi_head=roi))
                 for kind, roi in (('cascade_mask', cascade), ('htc', htc))}
    models = {}
    for kind in KINDS:
        models[kind] = build_detector(cascade_cfg(kind))
        sd = state_dict_from_jax(variables[SOURCE[kind]])
        own = models[kind].state_dict()
        # every JAX leaf has its place in its own kind's port model
        assert set(own) <= set(sd) and (kind != SOURCE[kind] or
                                         set(own) == set(sd))
        models[kind].load_state_dict({k: sd[k] for k in own}, strict=True)
        models[kind].eval()
    j_batch, t_batch = batches()
    masks = gt_masks_np({k: v.numpy() for k, v in t_batch.items()}, 9)
    j_batch['gt_masks'] = jnp.asarray(masks)
    t_batch['gt_masks'] = torch.from_numpy(masks.astype(np.uint8))
    t_batch['gt_labels'] = t_batch['gt_labels'].long()
    j_batch['gt_labels'] = j_batch['gt_labels'].astype(jnp.int32)
    base = dets['htc']

    def extract(v, x, hw):
        feats, rpn_outs, _ = base.extract(v, x)
        return feats, base.rpn_head.get_proposals(rpn_outs, hw)
    args = (variables['htc'], j_batch['image'], j_batch['img_hw'])
    feats, (props, valid) = jax.jit(extract).lower(*args).compile(
        compiler_options=O0)(*args)
    return dict(dets=dets, variables=variables, models=models,
                j_batch=j_batch, t_batch=t_batch, feats=feats, props=props,
                valid=valid, t_feats=nchw(feats),
                t_props=torch.from_numpy(np.array(props)),
                t_valid=torch.from_numpy(np.array(valid)),
                all_props=props[:, :ALL_PROPOSALS],
                all_valid=valid[:, :ALL_PROPOSALS],
                t_all_props=torch.from_numpy(np.array(
                    props[:, :ALL_PROPOSALS])),
                t_all_valid=torch.from_numpy(np.array(
                    valid[:, :ALL_PROPOSALS])))


def zero_semantic(roi):
    """HTC's RoI params with the semantic feature's 1x1 conv at zero: every
    semantic crop is 0, so the stages compute what HTC without a semantic
    head computes."""
    sem = dict(roi['semantic'], feat=jax.tree_util.tree_map(
        np.zeros_like, roi['semantic']['feat']))
    return dict(roi, semantic=sem)


def roi_vars(f, kind):
    roi = f['variables'][SOURCE[kind]]['params']['roi_head']
    return dict(params=zero_semantic(roi) if kind == 'htc_without_semantic'
                else roi)


# ---- HTC's resizes ----------------------------------------------------------
@pytest.mark.parametrize('level', [0, 2, 3, 4])
def test_semantic_resize_matches_jax(level):
    """A (2, 64, H_l, W_l) level to the stride-8 level's 8 x 12, as the JAX
    semantic head resizes it (level 0 downsamples, antialiased)."""
    h, w = ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))[level]
    x = np.random.RandomState(level).randn(2, h, w, 64).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 8, 12, 64), 'bilinear')
    got = resize_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                          (8, 12))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=1e-5)


def test_nearest_resize_and_foreground_map_match_jax():
    """`resize_nearest` bit-identical to `jax.image.resize(..., 'nearest')`
    down and up, odd sizes included; `foreground_map` equal to the JAX
    head's fallback target (`htc_roi_head.py:147-158`)."""
    rs = np.random.RandomState(3)
    gm = (rs.rand(2, 5, 16, 24) > 0.6).astype(np.float32)
    for size in ((8, 12), (7, 13), (33, 50)):
        want = jax.image.resize(jnp.asarray(gm), (2, 5) + size, 'nearest')
        np.testing.assert_array_equal(
            resize_nearest(torch.from_numpy(gm), size).numpy(),
            np.asarray(want))
    valid = np.array([[1, 1, 0, 1, 0], [0, 1, 1, 0, 0]], bool)
    want = jax.vmap(lambda m, v: jnp.clip((m * v[:, None, None]).sum(0),
                                          0, 1))(
        jax.image.resize(jnp.asarray(gm), (2, 5, 8, 12), 'nearest'),
        jnp.asarray(valid, jnp.float32)).astype(jnp.int32)
    got = foreground_map(torch.from_numpy(gm.astype(np.uint8)),
                         torch.from_numpy(valid), (8, 12))
    assert got.dtype == torch.int64 and 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the heads' losses ------------------------------------------------------
def mask_loss_programs(f):
    """The JAX mask branches' loss (unweighted) on given sampled rois of
    each stage, padded to `N_ROIS` an image, the tower on every roi: for
    Cascade Mask R-CNN one stage's (`cascade_roi_head.py:158-176`, the
    stage's mask params an argument), for HTC all three stages' at once
    (`htc_roi_head.py:209-251`: the semantic crop, the previous stages'
    nets re-run and detached)."""
    feats = list(f['feats'])

    def extract(img_feats, r, v):
        return j_ml_roi_align(img_feats, r, v, 14, STRIDES)

    def cascade(mvars, gm, rois, pos, labels, inds):
        rh = f['dets']['cascade_mask'].roi_head
        mf = jax.vmap(extract)(feats[:4], rois, pos)
        return jax.vmap(lambda *a: rh.mask_heads[0].loss(mvars, *a))(
            mf, rois, pos, labels, inds, gm).mean()

    def one(lg, r, rp, rl, rgi, m):
        tgt = j_mask_targets(m, r, rgi, 28, 4)
        sel = jnp.take_along_axis(lg, jnp.clip(rl, 0, 3)[
            :, None, None, None].repeat(28, 1).repeat(28, 2), -1)[..., 0]
        bce = jnp.maximum(sel, 0) - sel * tgt + \
            jnp.log1p(jnp.exp(-jnp.abs(sel)))
        pf = rp.astype(jnp.float32)
        return (bce.mean((1, 2)) * pf).sum() / jnp.maximum(pf.sum(), 1.0)

    def htc(params, gm, rois, pos, labels, inds):
        rh = f['dets']['htc'].roi_head
        _, sem = rh.semantic_net.apply(dict(params=params['semantic']),
                                       feats)
        out = []
        for i in range(3):
            r, p = rois[i], pos[i]
            mrf = jax.vmap(extract)(feats[:4], r, p) + jax.vmap(
                lambda s, r, v: j_roi_align(s, r, 14, 1.0 / 8) *
                v[:, None, None, None])(sem, r, p)
            flat = mrf.reshape(-1, 14, 14, mrf.shape[-1])
            last = None
            for j in range(i):
                _, last = rh.mask_nets[j].apply(
                    dict(params=params[f'mask{j}']), flat, last)
                last = jax.lax.stop_gradient(last)
            logits, _ = rh.mask_nets[i].apply(
                dict(params=params[f'mask{i}']), flat, last)
            logits = logits.reshape(r.shape[0], -1, 28, 28, 4)
            out.append(jax.vmap(one)(logits, r, p, labels[i], inds[i],
                                     gm).mean())
        return jnp.stack(out)
    return jax.jit(cascade), jax.jit(htc)


# a stage's rois an image: the RPN's 150 proposals and the 6 gt slots
# added at each of the three stages (fewer than the sampler's 512)
N_ROIS = 150 + 3 * 6


def padded_samples(samples, stages=None):
    """The port's sampled rois of a stage (or stack of stages) as JAX
    arrays padded to `N_ROIS` an image with rois that are not positive."""
    out = []
    for s in samples:
        n = N_ROIS - s['rois'].shape[1]
        pad = lambda x, v=0: np.pad(  # noqa: E731
            x.numpy(), [(0, 0), (0, n)] + [(0, 0)] * (x.dim() - 2),
            constant_values=v)
        out.append((pad(s['rois']).astype(np.float32),
                    pad(s['roi_pos'], False),
                    pad(s['labels'], 4).astype(np.int32),
                    pad(s['gt_inds']).astype(np.int32)))
    if stages is None:
        return out
    return [np.stack(x) for x in zip(*out)]


@pytest.fixture(scope='module')
def programs(ref):
    """Every JAX program of the file, traced one after another, each
    compiled in a thread as soon as it is traced (the traces hold the
    interpreter lock, XLA's compiles do not), HTC's, the longest to
    compile, first, at LLVM -O0: the RoI heads' `forward_train` (samplers
    picking every candidate), Cascade Mask R-CNN's `simple_test` and the
    mask-loss programs of `mask_loss_programs`."""
    f = ref
    b = f['j_batch']['image'].shape[0]
    roi = [jax.ShapeDtypeStruct(shape, dtype) for shape, dtype in (
        ((b, N_ROIS, 4), jnp.float32), ((b, N_ROIS), jnp.bool_),
        ((b, N_ROIS), jnp.int32), ((b, N_ROIS), jnp.int32))]
    stack = [jax.ShapeDtypeStruct((3, ) + r.shape, r.dtype) for r in roi]
    gm = f['j_batch']['gt_masks']
    cascade, htc = mask_loss_programs(f)
    params = roi_vars(f, 'cascade_mask')['params']
    rh = f['dets']['cascade_mask'].roi_head
    # the programs that take the longest to compile (HTC's) first
    jobs = {}
    for kind in ('htc', 'cascade_mask'):
        jobs[f'train_{kind}'] = (jax.jit(
            lambda v, x, p, pv, b, rh=f['dets'][kind].roi_head:
            rh.forward_train(v, list(x), p, pv, b,
                             rng=jax.random.PRNGKey(5))), (
            roi_vars(f, kind), f['feats'], f['all_props'], f['all_valid'],
            f['j_batch']))
        if kind == 'htc':
            jobs['mask_htc'] = (htc, [roi_vars(f, 'htc')['params'], gm] +
                                stack)
    jobs['simple_test'] = (jax.jit(lambda v, x, p, pv, hw: rh.simple_test(
        v, list(x), p, pv, hw, jnp.ones((2, 4), jnp.float32),
        rescale=True)), (roi_vars(f, 'cascade_mask'), f['feats'],
                         f['props'], f['valid'], f['j_batch']['img_hw']))
    jobs['mask_cascade_mask'] = (cascade, [dict(params=params['mask0']),
                                           gm] + roi)
    with ThreadPoolExecutor(len(jobs)) as pool:
        # each compiles while the next is traced
        done = {k: pool.submit(fn.lower(*args).compile, compiler_options=O0)
                for k, (fn, args) in jobs.items()}
    return {k: d.result() for k, d in done.items()}


@pytest.mark.parametrize('kind', KINDS)
def test_forward_train_losses_match_jax(ref, programs, kind):
    """The RoI head's `forward_train` on JAX's top 64 proposals, samplers
    picking every candidate: every stage's losses at rtol 2e-4."""
    f = ref
    want = programs[f'train_{SOURCE[kind]}'](
        roi_vars(f, kind), f['feats'], f['all_props'], f['all_valid'],
        f['j_batch'])
    if kind in ('cascade', 'htc_without_semantic'):
        want = {k: v for k, v in want.items()
                if k != 'loss_semantic_seg' and not (
                    kind == 'cascade' and 'mask' in k)}
    stages = [f'loss_{k}_s{i}' for i in range(3)
              for k in ('cls', 'bbox', 'mask')]
    if kind == 'cascade':
        stages = [k for k in stages if 'mask' not in k]
    assert sorted(want) == sorted(stages + (
        ['loss_semantic_seg'] if kind == 'htc' else []))
    assert all(float(v) > 0 for v in want.values())
    got = f['models'][kind].roi_head.forward_train(
        f['t_feats'], f['t_all_props'], f['t_all_valid'], f['t_batch'],
        torch.Generator().manual_seed(0))
    assert_losses_close(got, want)


@pytest.mark.parametrize('kind', ['cascade_mask', 'htc'])
def test_loss_mask_on_the_positive_slice_matches_jax(ref, programs, kind):
    """With the config's sampler (512 rois, 128 positive at most) each
    stage's mask tower runs on the first 128 rois of an image:
    `loss_mask_s{i}` equals the JAX mask branch on all the stage's rois
    (here fewer than 512: 150 proposals and the gts) at rtol 1e-5."""
    f = ref
    model = build_detector(cascade_cfg(kind, None))
    model.load_state_dict(f['models'][kind].state_dict())
    roi_head = model.roi_head
    assert roi_head.sampler.max_pos == 128 and roi_head.num_samples == 512
    samples, own = [], []
    name = 'mask_loss' if kind == 'cascade_mask' else 'htc_mask_loss'
    inner = getattr(roi_head, name)

    def spy(*args):
        s = args[1] if kind == 'cascade_mask' else args[3]
        samples.append({k: v.detach() for k, v in s.items()})
        loss = inner(*args)
        own.append(float(loss))
        return loss
    setattr(roi_head, name, spy)
    with torch.no_grad():
        losses = roi_head.forward_train(
            f['t_feats'], f['t_props'], f['t_valid'], f['t_batch'],
            torch.Generator().manual_seed(1))
    assert len(samples) == 3
    for s in samples:
        # fewer candidates than 512 (150 proposals and the gts), more than
        # the slice
        assert s['rois'].shape[1] > 128 and (s['roi_pos'].sum(-1) > 0).all()
        assert not s['roi_pos'][:, 128:].any()
    params = roi_vars(f, kind)['params']
    gm = f['j_batch']['gt_masks']
    if kind == 'cascade_mask':
        want = [float(programs['mask_cascade_mask'](
            dict(params=params[f'mask{i}']), gm, *roi))
            for i, roi in enumerate(padded_samples(samples))]
    else:
        want = [float(w) for w in programs['mask_htc'](
            params, gm, *padded_samples(samples, stages=3))]
    for i, w in enumerate(want):
        assert w > 0
        assert own[i] == pytest.approx(w, rel=1e-5)
        assert float(losses[f'loss_mask_s{i}']) == pytest.approx(
            roi_head.stage_loss_weights[i] * own[i], rel=1e-6)


# ---- forward_test -----------------------------------------------------------
@pytest.fixture(scope='module')
def simple_test(ref, programs):
    """JAX's Cascade Mask R-CNN `simple_test` (rescale, unit scale factors:
    4 outputs) on the test batch's proposals: `forward_test` is `extract`,
    `get_proposals` and this. Its first three outputs are also Cascade
    R-CNN's and HTC's: HTC's stages have its weights, and the JAX HTC head
    tests with the cascade head's `simple_test`, which skips the mask heads
    (it has none) and the semantic branch."""
    f = ref
    htc = f['dets']['htc'].roi_head
    assert type(htc).simple_test is CascadeRoIHead.simple_test
    assert htc.mask_heads is None and htc.mask_head is None
    return programs['simple_test'](roi_vars(f, 'cascade_mask'), f['feats'],
                                   f['props'], f['valid'],
                                   f['j_batch']['img_hw'])


@pytest.mark.parametrize('kind', ['cascade', 'cascade_mask', 'htc'])
def test_forward_test_matches_jax(ref, simple_test, kind):
    """The whole detector's `forward_test`: the same kept set, boxes within
    5e-3 px; Cascade Mask R-CNN's masks within 1e-4; HTC's three outputs,
    no masks."""
    f = ref
    t = f['t_batch']
    with torch.no_grad():
        got = f['models'][kind].forward_test(dict(
            image=t['image'], img_hw=t['img_hw'],
            scale_factor=torch.ones(2, 4)), rescale=True)
    want = [np.asarray(a) for a in simple_test]
    assert len(got) == (4 if kind == 'cascade_mask' else 3)
    assert_dets_match(got, want[:3], atol=5e-3)
    if kind == 'cascade_mask':
        assert got[3].shape == (2, 100, 28, 28)
        ok = want[2]
        for i in range(2):
            # each detection's mask against the JAX one of its nearest
            # detection of its label (equal detections have equal masks)
            g_dets, w_dets = got[0][i].numpy()[ok[i]], want[0][i][ok[i]]
            same = got[1][i].numpy()[ok[i]][:, None] == \
                want[1][i][ok[i]][None, :]
            dist = np.abs(g_dets[:, None] - w_dets[None]).sum(-1)
            nearest = np.where(same, dist, np.inf).argmin(1)
            np.testing.assert_allclose(got[3][i].numpy()[ok[i]],
                                       want[3][i][ok[i]][nearest], rtol=0,
                                       atol=1e-4)


def test_entry_points_take_htc_and_reject_cascade_masks(ref):
    """`inference_detector` runs HTC (three outputs, as JAX's), and raises
    for Cascade Mask R-CNN's four (ROADMAP.md caveat 21)."""
    img = np.random.RandomState(0).randint(0, 255, (48, 72, 3), np.uint8)
    htc = ref['models']['htc']
    assert not htc.roi_head.with_test_masks
    kw = dict(pad_hw=(64, 96), img_scale=(96, 64))
    out = inference_detector(htc, img, **kw)
    assert out['boxes'].shape[1] == 5 and len(out['labels']) > 0
    assert ref['models']['cascade_mask'].roi_head.with_test_masks
    with pytest.raises(NotImplementedError, match='caveat 21'):
        inference_detector(ref['models']['cascade_mask'], img, **kw)


# ---- configs, weights, steps ------------------------------------------------
CONFIGS = sorted(os.path.relpath(p, ROOT) for pattern in (
    'cascade_rcnn/*.py', 'htc/*.py', 'dcn/cascade_*.py', 'sabl/*cascade*.py')
    for p in glob.glob(os.path.join(ROOT, 'configs', pattern)))


@pytest.mark.parametrize('path', CONFIGS)
def test_cascade_config_builds_or_names_its_item(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    roi_head = model.roi_head
    if path.startswith('configs/sabl/'):
        # SABL heads: one bucketing coder and SABLBBoxHead a stage
        assert type(roi_head).__name__ == 'CascadeSABLRoIHead'
        assert len(roi_head.bbox_head) == 3 and roi_head.num_classes == 80
        assert [c.scale_factor for c in roi_head.coders] == [1.7, 1.5, 1.3]
        return
    if path.startswith('configs/dcn/'):
        # the 'DCN' type builds the DCNv2 layer in c3-c5 (caveat 36)
        assert sum(type(m).__name__ == 'ModulatedDeformConv2d'
                   for m in model.backbone.modules()) == \
            (4 + 23 + 3 if '101' in path else 4 + 6 + 3)
    assert len(roi_head.bbox_head) == 3 and roi_head.num_classes == 80
    assert roi_head.bbox_head[2].fc_reg.out_features == 4
    if 'htc' in path:
        assert type(model).__name__ == 'HybridTaskCascade'
        assert not roi_head.with_test_masks and len(roi_head.mask_head) == 3
        assert (roi_head.semantic_head is None) == ('without' in path)
    else:
        assert type(model).__name__ == 'CascadeRCNN'
        assert roi_head.with_test_masks == ('mask' in path)


@pytest.mark.parametrize('path', [
    'configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py',
    'configs/htc/htc_r50_fpn_1x_coco.py'])
def test_state_dict_from_jax_round_trip_of_the_r50_config(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    det = j_build_detector(cfg.model)
    shapes = jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 64, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    with torch.device('meta'):
        model = build_detector(cfg.model)
    want = model.state_dict()
    got = state_dict_from_jax(tree, want.keys())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k


def test_htc_npz_loads_through_load_checkpoint(ref, tmp_path):
    """The fixture's HTC variables as the JAX package's `save_variables`
    `.npz`: `load_checkpoint` loads them strictly, equal to the fixture's
    port model."""
    path = str(tmp_path / 'htc.npz')
    save_variables(path, ref['variables']['htc'])
    model = load_checkpoint(build_detector(cascade_cfg('htc')), path)
    want = ref['models']['htc'].state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize('kind', ['cascade_mask', 'htc'])
def test_one_sgd_step(ref, kind):
    """One SGD step of the port detector (the config's sampler) on the test
    batch's first image with its gt masks: every loss finite, and a stage-2
    weight moves."""
    model = build_detector(cascade_cfg(kind, None))
    model.load_state_dict(ref['models'][kind].state_dict())
    opt_cfg = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4)
    optimizer, scheduler = build_optimizer(opt_cfg, build_lr_schedule(
        0.01, dict(policy='step', step=[8]), 100, 12), model)
    step = make_train_step(model, optimizer, scheduler)
    before = model.roi_head.bbox_head[2].fc_cls.weight.detach().clone()
    metrics = step({k: v[:1] for k, v in ref['t_batch'].items()})
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert 'loss_mask_s2' in metrics
    assert ('loss_semantic_seg' in metrics) == (kind == 'htc')
    assert not torch.equal(before, model.roi_head.bbox_head[2].fc_cls.weight)
