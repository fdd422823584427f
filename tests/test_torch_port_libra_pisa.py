"""The port's Libra R-CNN and PISA pieces against the JAX package on the same
weights and inputs, and the configs of configs/libra_rcnn/ and pisa/.

Weights go JAX -> port: `jax.eval_shape` of the JAX init, `fill_tree` from a
numpy seed, `state_dict_from_jax` onto the port's names. Float32 on the
CPU:
  * `BFP` (no refine, 'conv', 'non_local') at width 32 on the five maps of a
    128x128 image (every ratio an integer; at 800x1344's and a 100x100
    image's levels the JAX BFP raises, and the port's adaptive pools are
    held against numpy), and the stacked necks `[FPN, BFP]` of the Libra Faster
    R-CNN and Libra RetinaNet configs (`neck.0.*`, `neck.1.*`): each level
    within 1e-5 of the largest output;
  * `BalancedL1Loss` at beta 1.0 and 0.11, per element and reduced, within
    1e-6;
  * the instance-balanced, IoU-balanced (with and without a floor quota)
    and combined samplers on the same injected uniform draws (the JAX
    module's `_uniform_keys` patched): identical selections;
  * `isr_p` and `carl_weights` within 1e-5 relative, on IoUs whose distinct
    values lie at least 1e-4 apart (ISR-P ranks by strict `>`);
  * the PISA RoI and SSD heads' loss dicts (`loss_carl` too) to rtol 1e-3,
    on IoUs of the SSD's prime positives at least 1e-5 apart;
  * a Libra Faster R-CNN (FPN + non-local BFP, `CombinedSampler`,
    BalancedL1) and a PISA RetinaNet (its prime positives' IoUs 1e-5
    apart) at R18, width 64, on a 2x3x64x96 batch: `forward_train` to
    rtol 1e-3 and `forward_test` within 5e-3, with samplers that take
    every candidate;
  * every config of the two folders builds on the meta device, and the
    Libra Faster R-CNN R50 and PISA SSD300 at full width have exactly the
    names and shapes of `state_dict_from_jax` of the JAX tree.

The `ref` fixture traces each JAX program once and compiles it in a thread
as soon as it is traced, at LLVM -O0.
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
import ld_tpu.ops.samplers as j_samplers
from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.models.losses.misc_losses import BalancedL1Loss as JBalancedL1
from ld_tpu.models.losses.pisa_loss import carl_weights as j_carl_weights
from ld_tpu.models.losses.pisa_loss import isr_p as j_isr_p
from ld_tpu.models.necks.seq import build_neck_maybe_seq
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu.utils.registry import NECKS as JAX_NECKS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads import (PISARetinaHead, PISARoIHead,
                                       PISASSDHead)
from ld_tpu_torch.models.losses import BalancedL1Loss
from ld_tpu_torch.models.losses.pisa_loss import carl_weights, isr_p
from ld_tpu_torch.models.necks import BFP, SequentialNeck, build_neck
from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.ops.samplers import build_sampler
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS, NECKS
from test_torch_port_bridge import (HEAD_KW, TEST_CFG, assert_losses_close,
                                    fill_tree, nchw)
from test_torch_port_fovea_ssd import (SSD_KW, SSD_SIZES, port_head,
                                       ssd_batches, ssd_feats)
from test_torch_port_ms_rcnn_resnest import fpn_features, proposals
from test_torch_port_paa_fsaf_freeanchor import gt_batches, numpy_tree
from test_torch_port_sabl import assert_dets_match
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for g in ('libra_rcnn', 'pisa')
                 for p in glob.glob(os.path.join(ROOT, 'configs', g, '*.py')))
FULL_WIDTH = {'libra': 'configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py',
              'pisa_ssd': 'configs/pisa/pisa_ssd300_coco.py'}
LOSS_RTOL, DET_TOL = 1e-3, 5e-3
ALL = dict(num=10**6, pos_fraction=1.0)
CHANS = [16, 32, 64, 128]
BFP_KINDS = (None, 'conv', 'non_local')
STACKS = {
    'faster': [dict(type='FPN', in_channels=CHANS, out_channels=32,
                    num_outs=5),
               dict(type='BFP', in_channels=32, num_levels=5, refine_level=2,
                    refine_type='non_local')],
    'retina': [dict(type='FPN', in_channels=CHANS, out_channels=32,
                    start_level=1, add_extra_convs='on_input', num_outs=5),
               dict(type='BFP', in_channels=32, num_levels=5, refine_level=1,
                    refine_type='non_local')]}
COMBINED = dict(type='CombinedSampler', pos_sampler=dict(
    type='InstanceBalancedPosSampler'), neg_sampler=dict(
        type='IoUBalancedNegSampler', floor_thr=-1, floor_fraction=0,
        num_bins=3))
SAMPLER_CFGS = {
    'instance_pos': dict(type='InstanceBalancedPosSampler', num=24,
                         pos_fraction=0.25),
    'iou_neg': dict(type='IoUBalancedNegSampler', num=24, pos_fraction=0.25,
                    floor_thr=-1, floor_fraction=0, num_bins=3),
    'iou_neg_floor': dict(type='IoUBalancedNegSampler', num=24,
                          pos_fraction=0.25, floor_thr=0.1,
                          floor_fraction=0.25, num_bins=3),
    'combined': dict(COMBINED, num=24, pos_fraction=0.25)}
TEST_TWO = dict(rpn=dict(nms_pre=200, max_per_img=60,
                         nms=dict(iou_threshold=0.7)),
                rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                          max_per_img=40))
ROI_BBOX = dict(num_classes=4, in_channels=64, fc_out_channels=64)


def libra_cfg():
    """Libra Faster R-CNN at R18, width 64, 4 classes."""
    return dict(
        type='FasterRCNN',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      norm_eval=True, style='pytorch'),
        neck=[dict(type='FPN', in_channels=[64, 128, 256, 512],
                   out_channels=64, num_outs=5),
              dict(type='BFP', in_channels=64, num_levels=5, refine_level=2,
                   refine_type='non_local')],
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=dict(type='StandardRoIHead', bbox_head=dict(
            ROI_BBOX, loss_bbox=dict(type='BalancedL1Loss', alpha=0.5,
                                     gamma=1.5, beta=1.0, loss_weight=1.0)),
            bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32])),
        train_cfg=dict(rpn=dict(sampler=ALL),
                       rcnn=dict(sampler=dict(COMBINED, **ALL))),
        test_cfg=copy.deepcopy(TEST_TWO))


def pisa_retina_cfg():
    """The PISA RetinaNet config at R18, width 64, 4 classes."""
    model = copy.deepcopy(JConfig.fromfile(os.path.join(
        ROOT, 'configs/pisa/pisa_retinanet_r50_fpn_1x_coco.py'))['model'])
    model['backbone']['depth'] = 18
    model['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    model['bbox_head'].update(HEAD_KW)
    model['test_cfg'] = dict(TEST_CFG, nms_pre=60)
    return model


def pisa_roi_cfg():
    return dict(type='PISARoIHead', bbox_head=dict(ROI_BBOX),
                bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32]),
                train_cfg=dict(sampler=ALL, isr=dict(k=2.0, bias=0.0),
                               carl=dict(k=1.0, bias=0.2)),
                test_cfg=TEST_TWO['rcnn'])


def neck_inputs(seed=0):
    """The four maps of a 128x128 image (strides 4-32), NHWC numpy."""
    rs = np.random.RandomState(seed)
    return [rs.randn(1, 128 // s, 128 // s, c).astype(np.float32)
            for c, s in zip(CHANS, (4, 8, 16, 32))]


def bfp_inputs(seed=1):
    """Five width-32 levels of a 128x128 image (strides 4-64)."""
    rs = np.random.RandomState(seed)
    return [rs.randn(1, 128 // s, 128 // s, 32).astype(np.float32)
            for s in (4, 8, 16, 32, 64)]


def sampler_case(seed=0, b=2, n=60):
    """Two images of n candidates: masks, gt indices, IoUs, boxes, scores,
    losses, and the uniform draws (positives', negatives', the floor
    quota's) of each image."""
    rs = np.random.RandomState(seed)
    pos = rs.rand(b, n) < 0.3
    neg = ~pos & (rs.rand(b, n) < 0.9)
    gt_inds = np.where(pos, rs.randint(0, 4, (b, n)), -1).astype(np.int32)
    iou = np.where(pos, rs.uniform(0.5, 1.0, (b, n)),
                   rs.uniform(0.0, 0.5, (b, n))).astype(np.float32)
    xy = rs.uniform(0, 60, (b, n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(5, 30, (b, n, 2))],
                           -1).astype(np.float32)
    scores = rs.uniform(0, 0.3, (b, n)).astype(np.float32)
    loss = rs.uniform(0, 3, (b, n)).astype(np.float32)
    draws = rs.rand(3, b, n).astype(np.float32)
    return dict(pos=pos, neg=neg, gt_inds=gt_inds, max_overlaps=iou,
                boxes=boxes, scores=scores, loss=loss, draws=draws)


def j_sample(cfg, case, monkeypatch, keys):
    """The JAX sampler of `cfg` vmapped over the images of `case`, its
    `_uniform_keys` returning the image's draws in call order: (pos_sel,
    neg_sel, weights or None) over the images."""
    sampler = j_samplers.build_sampler(dict(cfg))

    def one(pos, neg, draws, kw):
        it = iter(draws)
        monkeypatch.setattr(j_samplers, '_uniform_keys',
                            lambda rng, shape: next(it))
        return sampler.sample(jax.random.PRNGKey(0), pos, neg, **kw)
    out = jax.jit(jax.vmap(one))(case['pos'], case['neg'],
                                 case['draws'].transpose(1, 0, 2),
                                 {k: case[k] for k in keys})
    return [None if o is None else np.asarray(o) for o in out]


def t_sample(cfg, case, keys):
    """The port's sampler of `cfg` on the batched case and its draws."""
    sampler = build_sampler(dict(cfg))
    n_draws = 2 + sampler.extra_neg_draws
    kw = {k: torch.from_numpy(case[k]) for k in keys}
    if 'gt_inds' in kw:
        kw['gt_inds'] = kw['gt_inds'].long()
    return sampler.select(
        tuple(torch.from_numpy(d) for d in case['draws'][:n_draws]),
        torch.from_numpy(case['pos']), torch.from_numpy(case['neg']), **kw)


def isr_case(seed=4, p=40):
    """P positives of 3 labels over 5 gts with IoUs on a 1e-3 grid (every
    distinct pair 1e-3 apart), a few ties, and invalid slots."""
    rs = np.random.RandomState(seed)
    ious = (rs.permutation(400)[:p] * 1e-3 + 0.5).astype(np.float32)
    ious[5] = ious[6]
    labels = rs.randint(0, 3, p).astype(np.int32)
    gts = rs.randint(0, 5, p).astype(np.int32)
    valid = rs.rand(p) < 0.85
    weights = valid.astype(np.float32)
    loss = rs.uniform(0.1, 2.0, p).astype(np.float32)
    prob = rs.uniform(0, 1, p).astype(np.float32)
    return ious, labels, gts, valid, weights, loss, prob


@pytest.fixture(scope='module')
def ref():
    """The JAX trees (numpy) and outputs of every module the tests hold the
    port against."""
    out, jobs = {}, {}
    # the BFPs and the stacked necks: one program
    necks, args = {}, {}
    bins = [jnp.asarray(x) for x in bfp_inputs()]
    for kind in BFP_KINDS:
        necks[f'bfp_{kind}'] = build_neck_maybe_seq(dict(
            type='BFP', in_channels=32, num_levels=5, refine_level=2,
            refine_type=kind))
        args[f'bfp_{kind}'] = bins
    ins = [jnp.asarray(x) for x in neck_inputs()]
    for name, cfg in STACKS.items():
        necks[f'stack_{name}'] = build_neck_maybe_seq(copy.deepcopy(cfg))
        args[f'stack_{name}'] = ins
    for seed, (k, net) in enumerate(necks.items(), 2):
        out[k] = fill_tree(jax.eval_shape(
            lambda net=net, x=args[k]: net.init(jax.random.PRNGKey(0), x)),
            seed=seed)
    jobs['necks'] = (lambda trees: {k: net.apply(trees[k], args[k])
                                    for k, net in necks.items()},
                     ({k: out[k] for k in necks}, ))

    j_batch, t_batch = gt_batches()
    # the PISA RoI head on random FPN features and proposals
    roi = JAX_HEADS.build(pisa_roi_cfg())
    rv = out['roi_head'] = fill_tree(jax.eval_shape(
        lambda: roi.init_all_variables(jax.random.PRNGKey(0), 64)), seed=6)
    props, valid = proposals(t_batch)
    jobs['roi_head'] = (lambda v, f, p, pv, b: roi.forward_train(
        {'params': v}, list(f), p, pv, b, rng=jax.random.PRNGKey(5)),
        (rv, fpn_features(), props, valid, j_batch))
    # the PISA SSD head
    sj_batch, st_batch = ssd_batches()
    ssd = JAX_HEADS.build(dict(type='PISASSDHead', **SSD_KW))
    sfeats = [jnp.asarray(f) for f in ssd_feats()]
    sv = out['ssd_head'] = fill_tree(jax.eval_shape(
        lambda: ssd.net.init(jax.random.PRNGKey(0), sfeats)), seed=7)
    jobs['ssd_head'] = (lambda v, f, b: ssd.loss(ssd.net.apply(v, f), b,
                                                 SSD_SIZES),
                        (sv, sfeats, sj_batch))
    # the two detectors
    det = j_build_detector(libra_cfg())
    dv = out['libra'] = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=9)
    jobs['libra'] = (lambda v, b: (det.forward_test(v, b),
                                   det.forward_train(
                                       v, b, rng=jax.random.PRNGKey(5))),
                     (dv, j_batch))
    rdet = j_build_detector(pisa_retina_cfg())
    pv = out['pisa_retina'] = fill_tree(jax.eval_shape(
        lambda: rdet.init_variables(jax.random.PRNGKey(0), (1, 64, 96, 3))),
        seed=10)
    jobs['pisa_retina'] = (lambda v, b: (rdet.forward_test(v, b),
                                         rdet.forward_train(v, b)),
                           (pv, j_batch))

    o0 = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=o0)
                   for k, (fn, args) in jobs.items()}
    for k, (fn, job_args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*job_args)
    for k, outs in out.pop('necks_out').items():
        out[f'{k}_out'] = outs
    return dict(numpy_tree(out), t_batch=t_batch, ssd_batch=st_batch,
                roi_inputs=(props, valid))


def assert_levels_close(got, want, rtol=1e-5):
    """Each output within `rtol` of the largest magnitude of all."""
    want = [np.asarray(w) for w in want]
    bound = rtol * max(np.abs(w).max() for w in want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy().transpose(0, 2, 3, 1)
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= bound


def port_neck(cfg, tree):
    neck = build_neck(copy.deepcopy(cfg))
    sd = state_dict_from_jax({'params': {'neck': tree.get('params', {})}})
    neck.load_state_dict({k[len('neck.'):]: v for k, v in sd.items()},
                         strict=True)
    return neck


def port_detector(cfg, tree):
    model = build_detector(cfg)
    model.load_state_dict(state_dict_from_jax(tree,
                                              list(model.state_dict())),
                          strict=True)
    return model


# ---- BFP and the stacked necks ----------------------------------------------
@pytest.mark.parametrize('kind', BFP_KINDS)
def test_bfp_matches_jax(ref, kind):
    cfg = dict(type='BFP', in_channels=32, num_levels=5, refine_level=2,
               refine_type=kind)
    neck = port_neck(cfg, ref[f'bfp_{kind}'])
    assert isinstance(neck, BFP)
    names = set(neck.state_dict())
    if kind == 'non_local':
        assert {f'refine.{m}.conv.weight' for m in (
            'g', 'theta', 'phi', 'conv_out')} <= names
    elif kind == 'conv':
        assert names == {'refine.conv.weight', 'refine.conv.bias'}
    else:
        assert not names
    with torch.no_grad():
        got = neck(nchw(bfp_inputs()))
    assert_levels_close(got, ref[f'bfp_{kind}_out'])


@pytest.mark.parametrize('name', sorted(STACKS))
def test_stacked_neck_matches_jax(ref, name):
    neck = port_neck(STACKS[name], ref[f'stack_{name}'])
    assert isinstance(neck, SequentialNeck) and neck.out_channels == 32
    keys = set(neck.state_dict())
    assert '0.lateral_convs.0.conv.weight' in keys
    assert '1.refine.conv_out.conv.bias' in keys
    with torch.no_grad():
        got = neck(nchw(neck_inputs()))
    assert len(got) == 5
    assert_levels_close(got, ref[f'stack_{name}_out'])


def np_adaptive_max(x, h, w):
    """mmdet's adaptive max pool of (C, H, W) `x`: bin i spans
    [floor(i H / h), ceil((i + 1) H / h))."""
    hin, win = x.shape[1:]
    out = np.empty((x.shape[0], h, w), x.dtype)
    for i in range(h):
        for j in range(w):
            out[:, i, j] = x[:, i * hin // h:-(-(i + 1) * hin // h),
                             j * win // w:-(-(j + 1) * win // w)].max((1, 2))
    return out


def np_nearest(x, h, w):
    """`jax.image.resize(method='nearest')`'s pick: floor((i + 0.5) in /
    out)."""
    hin, win = x.shape[1:]
    rows = np.floor((np.arange(h) + 0.5) * hin / h).astype(int)
    cols = np.floor((np.arange(w) + 0.5) * win / w).astype(int)
    return x[:, rows][:, :, cols]


def test_bfp_runs_where_a_ratio_is_not_an_integer():
    """800x1344's levels (200x336 to 13x21) pool 50x84 to 13x21 at a ratio
    of 3.85: the JAX BFP's integer-ratio pool gives 16x21 and its sum
    raises, where the port pools adaptively as mmdet does (ROADMAP.md
    caveat 69); on a 100x100 image's levels, against numpy."""
    rs = np.random.RandomState(3)
    sizes = (25, 13, 7, 4, 2)
    ins = [rs.randn(1, 8, h, h).astype(np.float32) for h in sizes]
    net = JAX_NECKS.get('BFP')(in_channels=8, num_levels=5, refine_level=2)
    nhwc = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in ins]
    with pytest.raises(TypeError):
        net.apply(net.init(jax.random.PRNGKey(0), nhwc), nhwc)
    neck = NECKS.build(dict(type='BFP', in_channels=8, num_levels=5,
                            refine_level=2))
    with torch.no_grad():
        got = neck([torch.from_numpy(x) for x in ins])
    g = sizes[2]
    bsf = sum(np_adaptive_max(x[0], g, g) if i < 2 else np_nearest(x[0], g, g)
              for i, x in enumerate(ins)) / 5
    for i, (x, out) in enumerate(zip(ins, got)):
        h = sizes[i]
        res = np_nearest(bsf, h, h) if i < 2 else np_adaptive_max(bsf, h, h)
        np.testing.assert_allclose(out[0].numpy(), x[0] + res, rtol=1e-6,
                                   atol=1e-6)


def test_bfp_rejects_an_unknown_refine():
    with pytest.raises(ValueError):
        NECKS.build(dict(type='BFP', refine_type='gc'))


# ---- BalancedL1 -------------------------------------------------------------
@pytest.mark.parametrize('beta', (1.0, 0.11))
def test_balanced_l1_matches_jax(beta):
    rs = np.random.RandomState(5)
    pred, target = (rs.randn(2, 50, 4).astype(np.float32) for _ in range(2))
    weight = (rs.rand(2, 50, 4) > 0.3).astype(np.float32)
    kw = dict(alpha=0.5, gamma=1.5, beta=beta, loss_weight=1.3)
    j, t = JBalancedL1(**kw), BalancedL1Loss(**kw)
    tp, tt, tw = (torch.from_numpy(x) for x in (pred, target, weight))
    np.testing.assert_allclose(
        t(tp, tt, tw, reduction_override='none').numpy(),
        np.asarray(j(pred, target, weight, reduction_override='none')),
        rtol=1e-6, atol=1e-6)
    for call in (dict(), dict(avg_factor=17.0)):
        np.testing.assert_allclose(
            float(t(tp, tt, tw, **call)),
            float(j(pred, target, weight, **call)), rtol=1e-6)


# ---- the samplers -----------------------------------------------------------
@pytest.mark.parametrize('name', sorted(SAMPLER_CFGS))
def test_sampler_selections_match_jax(name, monkeypatch):
    cfg = SAMPLER_CFGS[name]
    case = sampler_case()
    keys = ('gt_inds', 'max_overlaps', 'boxes')
    want = j_sample(cfg, case, monkeypatch, keys)
    got = t_sample(cfg, case, keys)
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w)
    pos_sel, neg_sel = (g.numpy() for g in got[:2])
    assert (pos_sel.sum(1) == 6).all()
    assert (neg_sel.sum(1) == 18).all()
    assert not (pos_sel & neg_sel).any()


def test_instance_balanced_positives_take_gts_round_robin():
    """Six positives of a 4-gt image: every gt with a positive gets one
    before any gets a second."""
    case = sampler_case()
    pos_sel = t_sample(SAMPLER_CFGS['instance_pos'], case,
                       ('gt_inds', ))[0].numpy()
    for i in range(2):
        counts = np.bincount(case['gt_inds'][i][pos_sel[i]], minlength=4)
        avail = np.bincount(case['gt_inds'][i][case['pos'][i]], minlength=4)
        assert counts.max() - counts[avail > 0].min() <= 1


def test_sampler_draw_order_is_kept():
    """`sample` draws the positives' keys, then the negatives', from the
    generator: a `RandomSampler` picks what it picked before the key hooks
    (the same draws through `select`)."""
    case = sampler_case()
    pos, neg = (torch.from_numpy(case[k]) for k in ('pos', 'neg'))
    for cfg in (dict(type='RandomSampler', num=24), SAMPLER_CFGS['iou_neg'],
                SAMPLER_CFGS['iou_neg_floor']):
        sampler = build_sampler(dict(cfg))
        kw = dict(max_overlaps=torch.from_numpy(case['max_overlaps']))
        got = sampler.sample(torch.Generator().manual_seed(3), pos, neg, **kw)
        g = torch.Generator().manual_seed(3)
        draws = [torch.rand(pos.shape, generator=g)
                 for _ in range(2 + sampler.extra_neg_draws)]
        want = sampler.select(draws, pos, neg, **kw)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b)


# ---- ISR-P and CARL ---------------------------------------------------------
def test_isr_p_and_carl_match_jax():
    ious, labels, gts, valid, weights, loss, prob = isr_case()
    distinct = np.unique(ious[valid])
    assert np.diff(distinct).min() >= 1e-4 - 1e-7
    for k, bias in ((2.0, 0.0), (1.0, 0.3)):
        want = np.asarray(jax.jit(j_isr_p, static_argnames=('k', 'bias'))(
            ious, labels, gts, valid, weights, loss, k=k, bias=bias))
        got = isr_p(*(torch.from_numpy(np.asarray(x)) for x in (
            ious, labels, gts, valid, weights, loss)), k=k, bias=bias)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
        assert (got.numpy()[~valid] == 0).all()
        np.testing.assert_allclose(float((got * torch.from_numpy(loss)).sum()),
                                   float((loss * weights).sum()), rtol=1e-5)
    for k, bias in ((1.0, 0.2), (2.0, 0.0)):
        want = np.asarray(j_carl_weights(prob, valid, k=k, bias=bias))
        got = carl_weights(torch.from_numpy(prob), torch.from_numpy(valid),
                           k=k, bias=bias)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(got.sum()), valid.sum(), rtol=1e-5)


# ---- the PISA heads ---------------------------------------------------------
def assert_prime_ious_separated(ious, pos, max_pos=128):
    """The IoUs that ISR-P ranks (the prime positives') lie at least 1e-5
    apart where they differ, so no float32 rounding can swap two ranks."""
    top = np.sort(ious[pos])[::-1][:max_pos]
    gaps = np.diff(np.unique(top))
    assert top.size > 4 and (gaps.size == 0 or gaps.min() > 1e-5)


def test_pisa_roi_head_losses_match_jax(ref):
    cfg = pisa_roi_cfg()
    head = HEADS.build(copy.deepcopy(cfg))
    assert isinstance(head, PISARoIHead)
    keys = ['roi_head.' + k for k in head.state_dict()]
    rpn = {'rpn_conv': {'kernel': np.zeros((3, 3, 64, 64), np.float32)}}
    sd = {k: v for k, v in state_dict_from_jax({'params': {
        'roi_head': ref['roi_head'], 'rpn_net': rpn}}, keys).items()
        if k.startswith('roi_head.')}
    head.load_state_dict({k[len('roi_head.'):]: v for k, v in sd.items()},
                         strict=True)
    props, valid = ref['roi_inputs']
    got = head.forward_train(nchw(fpn_features()), torch.from_numpy(props),
                             torch.from_numpy(valid), ref['t_batch'],
                             torch.Generator().manual_seed(0))
    assert sorted(got) == ['loss_bbox', 'loss_carl', 'loss_cls']
    assert_losses_close(got, ref['roi_head_out'], rtol=LOSS_RTOL)


def test_pisa_ssd_head_losses_match_jax(ref):
    head = port_head(dict(type='PISASSDHead', **SSD_KW),
                     ref['ssd_head']).train()
    assert isinstance(head, PISASSDHead)
    outs = head([torch.from_numpy(f).permute(0, 3, 1, 2)
                 for f in ssd_feats()])
    t = head.loss_pieces(outs, ref['ssd_batch'], SSD_SIZES)
    b = t['pos'].shape[0]
    ious = bbox_overlaps(
        head.coder.decode(t['anchors'].repeat(b, 1),
                          t['reg_flat'].reshape(-1, 4)),
        head.coder.decode(t['anchors'].repeat(b, 1),
                          t['deltas'].reshape(-1, 4)), is_aligned=True)
    assert_prime_ious_separated(ious.detach().numpy(),
                                t['pos'].reshape(-1).numpy())
    got = head.loss(outs, ref['ssd_batch'], SSD_SIZES)
    assert_losses_close(got, ref['ssd_head_out'], rtol=LOSS_RTOL)
    # the plain head's two terms are the same pieces' sums
    plain = dict(loss_cls=(t['ce'] * (t['posf'] + t['neg_keep'].float())
                           ).sum() / t['num_pos'],
                 loss_bbox=(t['sl1'] * t['posf']).sum() / t['num_pos'])
    torch.testing.assert_close(got['loss_bbox'], plain['loss_bbox'])


# ---- the detectors ----------------------------------------------------------
def test_libra_faster_rcnn_end_to_end_matches_jax(ref):
    model = port_detector(libra_cfg(), ref['libra'])
    assert isinstance(model.neck, SequentialNeck)
    assert type(model.roi_head.loss_bbox).__name__ == 'BalancedL1Loss'
    assert type(model.roi_head.sampler).__name__ == 'CombinedSampler'
    batch = ref['t_batch']
    with torch.no_grad():
        dets = model.eval().forward_test(batch)
        losses = model.train().forward_train(
            batch, torch.Generator().manual_seed(0))
    want_dets, want_losses = ref['libra_out']
    assert_dets_match(dets, want_dets, atol=DET_TOL)
    assert_losses_close(losses, want_losses, rtol=LOSS_RTOL)


def test_pisa_retinanet_end_to_end_matches_jax(ref):
    model = port_detector(pisa_retina_cfg(), ref['pisa_retina'])
    head = model.bbox_head
    assert isinstance(head, PISARetinaHead) and head.max_pos == 128
    assert (head.isr_k, head.carl_bias) == (2.0, 0.2)
    batch = ref['t_batch']
    with torch.no_grad():
        dets = model.eval().forward_test(batch)
        outs = model.train()(batch['image'])
    sizes = [tuple(c.shape[-2:]) for c in outs[0]]
    t = head.build_targets(sizes, batch['gt_bboxes'], batch['gt_labels'],
                           batch['gt_valid'], batch['img_hw'])
    anchors = t['anchors'].repeat(2, 1)
    deltas = head.coder.encode(t['anchors'][None],
                               t['bbox_targets']).reshape(-1, 4)
    reg = torch.cat([r.permute(0, 2, 3, 1).reshape(2, -1, 4)
                     for r in outs[1]], 1).reshape(-1, 4)
    ious = bbox_overlaps(head.coder.decode(anchors, reg),
                         head.coder.decode(anchors, deltas), is_aligned=True)
    assert_prime_ious_separated(ious.numpy(),
                                t['pos_mask'].reshape(-1).numpy())
    losses = model.forward_train(batch)
    want_dets, want_losses = ref['pisa_retina_out']
    assert 'loss_carl' in want_losses
    assert_dets_match(dets, want_dets, atol=DET_TOL)
    assert_losses_close(losses, want_losses, rtol=LOSS_RTOL)
    sum(losses.values()).backward()
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters() if p.grad is not None)


# ---- the configs ------------------------------------------------------------
@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    assert type(model).__name__ == cfg.model.type
    if 'libra' in path:
        assert isinstance(model.neck, SequentialNeck)
        assert isinstance(model.neck[1], BFP)
        assert model.neck[1].refine.theta.conv.weight.shape == (256, 256, 1,
                                                                1)
        if 'retina' in path:
            assert type(model.bbox_head.loss_bbox).__name__ == \
                'BalancedL1Loss' and model.bbox_head.loss_bbox.beta == 0.11
            return
        # as the JAX package reads them: the Fast R-CNN config's BalancedL1
        # and its top-level sampler, unread (ROADMAP.md caveat 20); the
        # Faster R-CNN configs' CombinedSampler under roi_head.train_cfg,
        # and no BalancedL1 (ROADMAP.md caveat 67)
        fast = 'fast_rcnn' in path
        assert type(model.roi_head.loss_bbox).__name__ == (
            'BalancedL1Loss' if fast else 'L1Loss')
        assert type(model.roi_head.sampler).__name__ == (
            'RandomSampler' if fast else 'CombinedSampler')
    elif 'ssd' in path:
        assert isinstance(model.bbox_head, PISASSDHead)
    elif 'retina' in path:
        assert isinstance(model.bbox_head, PISARetinaHead)
    else:
        assert isinstance(model.roi_head, PISARoIHead)
        assert model.roi_head.with_test_masks == ('mask' in path)


@pytest.mark.parametrize('name', sorted(FULL_WIDTH))
def test_full_width_names_and_shapes_match_jax(name):
    path = os.path.join(ROOT, FULL_WIDTH[name])
    hw = (300, 300) if 'ssd' in name else (128, 128)
    det = j_build_detector(JConfig.fromfile(path).model)
    shapes = jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, ) + hw + (3, )))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path).model)
        own = model.state_dict()
        sd = state_dict_from_jax(tree, own.keys())
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    if name == 'libra':
        assert 'neck.1.refine.g.conv.weight' in own
