"""The port's ResNeSt backbone and Mask Scoring R-CNN against the JAX package
on the same weights and inputs, and the ResNeSt and MS R-CNN configs.

The weights go JAX -> port: `jax.eval_shape` of the JAX init gives the
variable tree, `fill_tree` fills it from a numpy seed (BN statistics and
affine near identity), and `state_dict_from_jax` carries it onto the
port's mmdet names strictly (the JAX converter has no ResNeSt or MaskIoU
rule: ROADMAP.md caveats 55-56, asserted below). Float32 on the CPU:
  * `SplitAttentionConv` at radix 2 with 1 and 2 groups and at radix 1
    (the sigmoid), width 64 on 2x64x8x12: on running statistics within
    1e-5 of the largest output, and on the batch's (its pooled `bn1` over
    the batch's 2 values) within 5e-5 of JAX and 5e-6 of the port's own
    float64 run (flax's E[x^2] - E[x]^2 variance puts the JAX float32
    output up to 3e-5 from the float64 one), with the running means
    after;
  * `ResNeStBottleneck` with and without `avg_down_stride`, stride 2 with
    the V1d shortcut, within 1e-5;
  * ResNeSt-50 (the Faster R-CNN's trunk) on 2x3x64x96: its four outputs
    on running statistics within 1e-4 of each one's largest value; one
    training forward (frozen_stages 1, norm_eval False) in float64 in both
    packages (in float32 each live 2-value `bn1` amplifies rounding: see
    `float64_programs`) within 1e-7, the running statistics after it
    within 1e-7 once the JAX package's biased batch variance is scaled to
    torch's unbiased one (caveat 56), and the gradient of a fixed linear
    function of the outputs within 1e-6 of each parameter's largest; at
    batch 1 the JAX `bn1` gives its bias and the port raises (caveat 56);
  * `MaskIoUHead` within 1e-5 of the largest output;
  * `MaskScoringRoIHead` (width 64, 4 classes) on random FPN features
    with samplers that pick every candidate: its loss dict to rtol 2e-4,
    `loss_mask_iou` included, and the gradient of the summed losses for
    every MaskIoU parameter and of `loss_mask_iou` alone for the features
    within 1e-4 of the largest (the mask head gets none of the latter);
  * MS R-CNN R18 (configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py at depth 18,
    width 64, 4 classes) and the ResNeSt-50 Faster R-CNN (faster_rcnn_
    s50_*, width 64, its trunk in float64 for `forward_train`) on the
    bridge's 2x3x64x96 batch: `forward_train`'s loss dicts to rtol 1e-3,
    the gradient of MS R-CNN's summed losses for
    its MaskIoU head and one FPN conv within 2e-3 of the largest, and
    `forward_test`'s detections (and masks) as sets within 5e-3;
  * every config of configs/ms_rcnn/ and configs/resnest/ builds on the
    meta device.

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
from ld_tpu.models.backbones.resnest import ResNeSt as JResNeSt
from ld_tpu.models.backbones.resnest import \
    ResNeStBottleneck as JBottleneck
from ld_tpu.models.backbones.resnest import \
    SplitAttentionConv as JSplitAttentionConv
from ld_tpu.models.heads.roi_variants import MaskIoUHeadNet
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones import ResNeSt
from ld_tpu_torch.models.backbones.resnest import (ResNeStBottleneck,
                                                   SplitAttentionConv)
from ld_tpu_torch.models.backbones.resnet import make_shortcut
from ld_tpu_torch.models.heads.roi_variants import (MaskIoUHead,
                                                    MaskScoringRoIHead)
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import (assert_losses_close, batches, fill_tree,
                                    nchw, nhwc)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse
from test_torch_port_two_stage import ALL, TEST_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS_CONFIG = os.path.join(ROOT, 'configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py')
S50_CONFIG = os.path.join(
    ROOT, 'configs/resnest/'
    'faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py')
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/ms_rcnn/*.py')) +
                 glob.glob(os.path.join(ROOT, 'configs/resnest/*.py')))
# (radix, groups) of the split-attention cases
SPLATS = {'r2g1': (2, 1), 'r2g2': (2, 2), 'r1g1': (1, 1)}
SPLAT_X = (2, 64, 8, 12)
# (inplanes, planes, stride, avg_down_stride) of the bottleneck cases
BOTTLENECKS = {'avd': (64, 32, 2, True), 'no_avd': (64, 32, 2, False)}
BLOCK_X = (2, 64, 16, 24)
RESNEST_KW = dict(depth=50, stem_channels=64, radix=2, reduction_factor=4,
                  avg_down_stride=True, frozen_stages=1, norm_eval=False)
# the detector's trunk: ResNeSt-50 cut to one block a stage, registered in
# both packages' ARCH tables under a depth of its own (`cut_depth`)
CUT_DEPTH = 14
STRIDES = (4, 8, 16, 32)
FEAT_SIZES = ((16, 24), (8, 12), (4, 6), (2, 3))
TRAIN_ALL = dict(rpn=dict(sampler=ALL), rcnn=dict(sampler=ALL))
OUT_RTOL, TRAIN_RTOL, GRAD_RTOL, DET_TOL = 1e-5, 5e-5, 1e-4, 5e-3


@pytest.fixture(scope='module', autouse=True)
def cut_depth():
    from ld_tpu.models.backbones import resnest as j_resnest
    from ld_tpu_torch.models.backbones import resnest as t_resnest
    for arch in (j_resnest.ARCH, t_resnest.ARCH):
        arch[CUT_DEPTH] = (1, 1, 1, 1)
    yield
    for arch in (j_resnest.ARCH, t_resnest.ARCH):
        del arch[CUT_DEPTH]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def filled(module, seed, *inputs, **kw):
    return fill_tree(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw)), seed)


def randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def roi_head_cfg():
    """MS R-CNN's RoI head at width 64 and 4 classes."""
    cfg = copy.deepcopy(JConfig.fromfile(MS_CONFIG)['model']['roi_head'])
    cfg['bbox_head'].update(num_classes=4, in_channels=64,
                            fc_out_channels=64)
    cfg['mask_head'].update(in_channels=64, conv_out_channels=64)
    cfg['mask_iou_head'].update(conv_out_channels=64, fc_out_channels=64)
    cfg['train_cfg'] = dict(sampler=ALL)
    return cfg


def small_two_stage(path):
    """A two-stage config at width 64 and 4 classes, its samplers picking
    every candidate; R18 where the trunk is a ResNet, ResNeSt-50 cut to one
    block a stage where it is a ResNeSt."""
    model = copy.deepcopy(JConfig.fromfile(path)['model'])
    if model['backbone']['type'] == 'ResNet':
        model['backbone']['depth'] = 18
        model['neck']['in_channels'] = [64, 128, 256, 512]
    else:
        model['backbone']['depth'] = CUT_DEPTH
    model['neck']['out_channels'] = 64
    model['rpn_head'].update(in_channels=64, feat_channels=64)
    roi = model['roi_head']
    if roi['type'] == 'MaskScoringRoIHead':
        roi.update(roi_head_cfg())
    else:
        roi['bbox_head'].update(num_classes=4, in_channels=64,
                                fc_out_channels=64)
    model['train_cfg'] = copy.deepcopy(TRAIN_ALL)
    model['test_cfg'] = copy.deepcopy(TEST_CFG)
    return model


def gt_masks(t_batch, seed=2):
    """(B, G, H/4, W/4) uint8 masks: random pixels of each valid gt box."""
    rs = np.random.RandomState(seed)
    b, g = t_batch['gt_bboxes'].shape[:2]
    h, w = (s // 4 for s in t_batch['image'].shape[-2:])
    masks = np.zeros((b, g, h, w), np.uint8)
    for i in range(b):
        for j in np.flatnonzero(t_batch['gt_valid'][i].numpy()):
            x1, y1, x2, y2 = (t_batch['gt_bboxes'][i, j].numpy() / 4).astype(
                int)
            masks[i, j, y1:y2 + 1, x1:x2 + 1] = rs.rand(
                y2 + 1 - y1, x2 + 1 - x1) > 0.3
    return masks


def mask_batches():
    """The bridge's batch with gt masks: (jax, port)."""
    j, t = batches()
    masks = gt_masks(t)
    j = dict(j, gt_labels=j['gt_labels'].astype(jnp.int32),
             gt_masks=jnp.asarray(masks))
    t = dict(t, gt_labels=t['gt_labels'].long(),
             gt_masks=torch.from_numpy(masks))
    return j, t


def proposals(t_batch, seed=3):
    """Each image's gts jittered, 3 of each, plus 20 random boxes:
    (B, P, 4) proposals and their valid mask."""
    rs = np.random.RandomState(seed)
    gt = t_batch['gt_bboxes'].numpy()
    b, g = gt.shape[:2]
    jit = np.repeat(gt, 3, axis=1) + rs.uniform(-3, 3, (b, 3 * g, 4))
    xy = rs.uniform(0, 70, (b, 20, 2))
    rand = np.concatenate([xy, xy + rs.uniform(4, 30, (b, 20, 2))], -1)
    boxes = np.concatenate([jit, rand], 1).astype(np.float32)
    valid = np.concatenate([np.repeat(t_batch['gt_valid'].numpy(), 3, 1),
                            np.ones((b, 20), bool)], 1)
    return boxes, valid


def fpn_features(seed=6):
    """Random (2, H, W, 64) FPN features at strides 4-32, NHWC."""
    rs = np.random.RandomState(seed)
    return [rs.randn(2, h, w, 64).astype(np.float32) for h, w in FEAT_SIZES]


def linear_weights(shapes, seed=9):
    """A fixed random weight of each output's shape (NHWC)."""
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) / np.prod(s) ** 0.5
            for s in shapes]


def float64_programs(pool, tv, sv, j_batch):
    """ResNeSt-50 with live BNs in float64 (under `jax.enable_x64`): a
    training forward, the running statistics after it and the gradient of
    a fixed linear function of its outputs; and the ResNeSt-50 Faster
    R-CNN's `forward_train` with its trunk in float64, each compiling in
    `pool`: {name: (future, args)}. In float32 each
    live `bn1` over 2 values amplifies rounding: the JAX float32 trunk's
    last stage lies ~1.9 from the float64 one, the port's ~0.08, where
    the two float64 runs agree to 1e-8."""
    with jax.enable_x64():
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), tree)
        trunk = JResNeSt(**RESNEST_KW, dtype=jnp.float64)
        image = np.asarray(j_batch['image'], np.float64)
        lin = [np.asarray(w, np.float64) for w in linear_weights(
            [(2, 16, 24, 256), (2, 8, 12, 512), (2, 4, 6, 1024),
             (2, 2, 3, 2048)])]

        def trunk_run(v, image, lin):
            def f(params):
                outs, mut = trunk.apply(dict(v, params=params), image,
                                        train=True, mutable=['batch_stats'])
                return sum((o * w).sum() for o, w in zip(outs, lin)), (
                    outs, mut['batch_stats'])
            (_, (outs, stats)), grads = jax.value_and_grad(
                f, has_aux=True)(v['params'])
            return outs, stats, grads
        model = small_two_stage(S50_CONFIG)
        model['backbone']['dtype'] = jnp.float64
        det = j_build_detector(model)
        stats = sv['batch_stats']
        dv = dict(sv, params=dict(sv['params'], backbone=f64(
            sv['params']['backbone'])), batch_stats=dict(
                stats, backbone=f64(stats['backbone'])))
        jobs = dict(
            trunk64=(trunk_run, (f64(tv), image, lin)),
            s50_train64=(lambda v, b: det.forward_train(
                v, b, jax.random.PRNGKey(0)), (dv, dict(j_batch,
                                                        image=image))))
        # optimised: at -O0 the float64 convs run 20x slower; each compiles
        # while the next program is traced
        return {k: (pool.submit(jax.jit(fn).lower(*args).compile), args)
                for k, (fn, args) in jobs.items()}


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against, on numpy-filled
    variables; numpy trees and outputs."""
    j_batch, t_batch = mask_batches()
    out = {}
    jobs = {}
    pool = ThreadPoolExecutor(12)

    # ResNeSt-50 and its Faster R-CNN first: their float64 programs,
    # compiled optimised, take the longest to compile
    s50 = j_build_detector(small_two_stage(S50_CONFIG))
    sv = out['s50'] = fill_tree(jax.eval_shape(lambda: s50.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=8)
    trunk = JResNeSt(**RESNEST_KW)
    tv = out['trunk'] = filled(trunk, 11, j_batch['image'])
    pending = float64_programs(pool, tv, sv, j_batch)

    # the split-attention conv: running statistics, then the batch's
    x = nhwc(randn(SPLAT_X, 0))
    for name, (radix, groups) in SPLATS.items():
        mod = JSplitAttentionConv(64, radix=radix, groups=groups,
                                  norm_eval=False)
        v = out[f'splat_{name}'] = filled(mod, 1, x)

        def splat(v, x, mod=mod):
            y, mut = mod.apply(v, x, train=True, mutable=['batch_stats'])
            return mod.apply(v, x), y, mut['batch_stats']
        jobs[f'splat_{name}'] = (splat, (v, x))

    # the bottleneck with and without the 3x3 avg pool after conv2
    x = nhwc(randn(BLOCK_X, 2))
    for name, (inplanes, planes, stride, avd) in BOTTLENECKS.items():
        mod = JBottleneck(planes, stride=stride, downsample=True,
                          avg_down_stride=avd)
        v = out[f'block_{name}'] = filled(mod, 3, x)
        jobs[f'block_{name}'] = (mod.apply, (v, x))

    # the MaskIoU head net
    net = MaskIoUHeadNet(num_classes=4, conv_out=64, fc_out=64)
    mf, mp = nhwc(randn((6, 64, 14, 14), 4)), randn((6, 28, 28), 5) * 3
    out['maskiou'] = filled(net, 6, mf, mp)
    jobs['maskiou'] = (net.apply, (out['maskiou'], mf, mp))

    # the MS RoI head: losses and gradients on the same rois
    head = JAX_HEADS.build(roi_head_cfg())
    rv = out['roi'] = fill_tree(jax.eval_shape(
        lambda: head.init_all_variables(jax.random.PRNGKey(0), 64)), seed=7)
    feats = [jnp.asarray(f) for f in fpn_features()]
    props, pvalid = proposals(t_batch)

    def roi_run(params, feats, props, pvalid, b):
        # differentiated for the MaskIoU parameters and the features only
        losses, vjp = jax.vjp(lambda m, f: head.forward_train(
            {'params': dict(params, maskiou=m)}, f, props, pvalid, b,
            jax.random.PRNGKey(0)), params['maskiou'], feats)
        ones = jax.tree_util.tree_map(jnp.ones_like, losses)
        iou = {k: v * (k == 'loss_mask_iou') for k, v in ones.items()}
        return losses, vjp(ones)[0], vjp(iou)[1]
    jobs['roi'] = (roi_run, (rv, feats, props, pvalid, j_batch))

    # the trunk alone on running statistics, at batch 1 in training, and
    # the detector's detections
    jobs['trunk'] = (trunk.apply, (tv, j_batch['image']))

    # batch 1: the pooled map's bn1 over one value a channel
    mod = JSplitAttentionConv(64, norm_eval=False)
    x = nhwc(randn(SPLAT_X, 0))[:1]
    jobs['batch_one'] = (lambda v, x: mod.apply(
        v, x, train=True, mutable=['batch_stats']), (
            out['splat_r2g1'], x))
    jobs['s50'] = (s50.forward_test, (sv, j_batch))

    # MS R-CNN R18: losses, the gradient, detections with masks
    ms = j_build_detector(small_two_stage(MS_CONFIG))
    mv = out['ms'] = fill_tree(jax.eval_shape(lambda: ms.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=10)

    def ms_run(v, b):
        # differentiated for the two parameter sets held, so that the
        # trunk's backward is neither traced nor compiled
        p = v['params']

        def total(sub):
            params = dict(p, roi_head=dict(p['roi_head'],
                                           maskiou=sub['maskiou']),
                          neck=dict(p['neck'], fpn_conv_0=sub['fpn_conv_0']))
            losses = ms.forward_train(dict(v, params=params), b,
                                      jax.random.PRNGKey(0))
            return sum(losses.values()), losses
        (_, losses), grads = jax.value_and_grad(total, has_aux=True)(
            {'maskiou': p['roi_head']['maskiou'],
             'fpn_conv_0': p['neck']['fpn_conv_0']})
        return losses, grads, ms.forward_test(v, b)
    jobs['ms'] = (ms_run, (mv, j_batch))

    options = dict(xla_backend_optimization_level=0)
    try:
        # the largest first; each compiles while the next is traced
        for k in ('ms', 'roi', 's50', 'trunk', *jobs):
            if k not in pending:
                fn, args = jobs[k]
                pending[k] = (pool.submit(jax.jit(fn).lower(*args).compile,
                                          compiler_options=options), args)
        for k, (compiled, args) in pending.items():
            with jax.enable_x64(k.endswith('64')):
                out[f'{k}_out'] = compiled.result()(*args)
    finally:
        pool.shutdown()
    return dict(numpy_tree(out), t_batch=t_batch,
                proposals=(props, pvalid))


def as_scope(variables, *scopes):
    """A sub-tree put back under `scopes` of a full JAX tree."""
    for scope in reversed(scopes):
        variables = {coll: {scope: tree} for coll, tree in variables.items()}
    return variables


def load(module, variables, prefix):
    """`variables` (a JAX tree) into `module`, whose state-dict names sit
    under `prefix` in the detector's; strict."""
    keys = [prefix + k for k in module.state_dict()]
    sd = {k: v for k, v in state_dict_from_jax(variables, keys).items()
          if k.startswith(prefix)}
    assert sorted(sd) == sorted(keys)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module


def assert_close(got, want, rtol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bound = rtol * np.abs(want).max()
    assert np.abs(want).max() > 0, name
    diff = float(np.abs(got - want).max())
    assert diff <= bound, (name, diff, bound)


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def dets_rows(dets, labels, valid, masks=None):
    """Each image's valid detections (and masks) as rows sorted by (score,
    label, box): equal scores may leave the top-k in either order
    (ROADMAP.md caveat 2)."""
    rows = []
    for i in range(valid.shape[0]):
        ok = valid[i]
        d, lab = dets[i][ok], labels[i][ok]
        key = np.lexsort((*d[:, 3::-1].round(2).T, lab, -d[:, 4].round(5)))
        rows.append((d[key], lab[key],
                     None if masks is None else masks[i][ok][key]))
    return rows


def assert_dets_sets(got, want, atol=DET_TOL):
    got = [t.detach().numpy() for t in got]
    want = [np.asarray(w) for w in want]
    assert want[2].sum() > 0
    np.testing.assert_array_equal(got[2], want[2])
    with_masks = len(want) == 4
    for g, w in zip(dets_rows(*got[:3], got[3] if with_masks else None),
                    dets_rows(*want[:3], want[3] if with_masks else None)):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=atol)
        if with_masks:
            np.testing.assert_allclose(g[2], w[2], rtol=0, atol=atol)


# ---- ResNeSt ---------------------------------------------------------------
@pytest.mark.parametrize('name', list(SPLATS))
def test_split_attention_matches_jax(ref, name):
    """The radix softmax's channel order (a wrong reshape still gives a
    finite, plausible output), on running and on batch statistics."""
    radix, groups = SPLATS[name]
    mod = load(SplitAttentionConv(64, 64, radix=radix, groups=groups),
               as_scope(ref[f'splat_{name}'], 'backbone', 'layer1_0',
                        'conv2'), 'backbone.layer1.0.conv2.')
    want_eval, want_train, want_stats = ref[f'splat_{name}_out']
    x = torch.from_numpy(randn(SPLAT_X, 0))
    with torch.no_grad():
        assert_close(to_nhwc(mod.eval()(x)), want_eval, OUT_RTOL)
        got = mod.train()(x)
        got64 = copy.deepcopy(mod).double().train()(x.double())
    # flax's BN takes E[x^2] - E[x]^2 over bn1's 2 values a channel: the
    # JAX float32 output lies up to 3e-5 of the largest from the float64
    # one, the port's within 2e-6 of it
    assert_close(got, got64.float(), 5e-6)
    assert_close(to_nhwc(got), want_train, TRAIN_RTOL)
    for bn, scope in ((mod.bn0, 'norm0'), (mod.bn1, 'norm1')):
        stats = want_stats[scope]['bn']
        np.testing.assert_allclose(bn.running_mean.numpy(), stats['mean'],
                                   rtol=1e-5, atol=1e-6)
    assert mod.fc2.out_channels == 64 * radix


@pytest.mark.parametrize('name', list(BOTTLENECKS))
def test_bottleneck_matches_jax(ref, name):
    inplanes, planes, stride, avd = BOTTLENECKS[name]
    block = ResNeStBottleneck(inplanes, planes, stride,
                              downsample=make_shortcut(inplanes, planes * 4,
                                                       stride, True),
                              avg_down_stride=avd)
    keys = ['backbone.layer1.0.' + k for k in block.state_dict()]
    assert any('.downsample.2.' in k for k in keys)
    load(block, as_scope(ref[f'block_{name}'], 'backbone', 'layer1_0'),
         'backbone.layer1.0.')
    assert (block.avd_layer is not None) == avd
    assert block.conv2.conv.stride == ((1, 1) if avd else (2, 2))
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(randn(BLOCK_X, 2)))
    assert_close(to_nhwc(got), ref[f'block_{name}_out'], OUT_RTOL)


@pytest.fixture(scope='module')
def trunk(ref):
    model = ResNeSt(**RESNEST_KW)
    return load(model, as_scope(ref['trunk'], 'backbone'), 'backbone.')


def test_resnest_eval_matches_jax(ref, trunk):
    want = ref['trunk_out']
    with torch.no_grad():
        got = trunk.eval()(ref['t_batch']['image'])
    assert len(got) == 4
    for g, w in zip(got, want):
        assert_close(to_nhwc(g), w, 1e-4)


def test_resnest_training_step_matches_jax(ref, trunk):
    """One training forward with live BNs, in float64 in both packages
    (`float64_programs`): the outputs, the running statistics after it
    (the JAX package's biased variance scaled to torch's unbiased one,
    n / (n - 1) with n the channel's values: caveat 56), and the gradient
    of a fixed linear function of the outputs."""
    want, want_stats, want_grads = ref['trunk64_out']
    model = copy.deepcopy(trunk).double().train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sizes = {}

    def record(name):
        def hook(module, args, output):
            sizes[name] = args[0].numel() // args[0].shape[1]
        return hook
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(record(name))
    outs = model(ref['t_batch']['image'].double())
    lin = linear_weights([(o.shape[0], *o.shape[2:], o.shape[1])
                          for o in outs])
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
        for o, w in zip(outs, lin)).backward()
    for g, w in zip(outs, want):
        assert_close(to_nhwc(g), w, 1e-7)
    keys = ['backbone.' + k for k in model.state_dict()]
    stats = state_dict_from_jax(
        {'params': {'backbone': ref['trunk']['params']},
         'batch_stats': {'backbone': want_stats}}, keys)
    after = model.state_dict()
    live = [n for n, m in model.named_modules()
            if isinstance(m, torch.nn.BatchNorm2d) and m.training]
    assert len(live) > 50 and 'layer2.0.conv2.bn1' in live
    assert not any(n.startswith(('stem', 'layer1.')) for n in live)
    assert len(sizes) > len(live) and sizes['layer2.0.conv2.bn1'] == 2
    for name in sizes:
        mean, var = (f'{name}.running_{s}' for s in ('mean', 'var'))
        np.testing.assert_allclose(after[mean].numpy(),
                                   stats[f'backbone.{mean}'].numpy(),
                                   rtol=1e-7, atol=1e-9, err_msg=mean)
        if name not in live:
            assert torch.equal(after[var], before[var])
            continue
        n = sizes[name]
        # torch keeps 0.9 v0 + 0.1 var * n / (n - 1), flax 0.9 v0 + 0.1 var
        want_var = stats[f'backbone.{var}'].numpy()
        v0 = before[var].numpy()
        torch_var = 0.9 * v0 + (want_var - 0.9 * v0) * n / (n - 1)
        np.testing.assert_allclose(after[var].numpy(), torch_var,
                                   rtol=1e-7, atol=1e-9, err_msg=var)
    grads = state_dict_from_jax({'params': {'backbone': want_grads}}, keys)
    # a bias before a training BN gets none: 1e-6 of the largest gradient
    # of all bounds those
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        w = grads[f'backbone.{name}'].numpy()
        diff = float(np.abs(p.grad.numpy() - w).max())
        assert diff <= max(1e-6 * np.abs(w).max(), floor), (name, diff)
        checked += 1
    assert checked > 200


def test_resnest_batch_one(ref, trunk):
    """At batch 1 a training forward's pooled `bn1` holds one value a
    channel: the JAX BN takes a variance of 0 (its running variance
    decays by the momentum alone) and so gives its bias, where torch's BN
    raises, and so do the port's split-attention conv and trunk."""
    out, stats = ref['batch_one_out']
    v0 = ref['splat_r2g1']['batch_stats']['norm1']['bn']['var']
    np.testing.assert_allclose(stats['batch_stats']['norm1']['bn']['var'],
                               0.9 * v0, rtol=1e-6)
    assert np.isfinite(out).all()
    mod = load(SplitAttentionConv(64, 64),
               as_scope(ref['splat_r2g1'], 'backbone', 'layer1_0', 'conv2'),
               'backbone.layer1.0.conv2.').train()
    with pytest.raises(ValueError, match='more than 1 value per channel'):
        mod(torch.from_numpy(randn(SPLAT_X, 0))[:1])
    model = copy.deepcopy(trunk).train()
    with pytest.raises(ValueError, match='more than 1 value per channel'):
        model(ref['t_batch']['image'][:1])


def test_converter_has_no_resnest_rule(trunk):
    """ROADMAP.md caveat 56: the JAX converter leaves the split-attention
    names unmapped, which is why the weights go JAX -> port here."""
    conv = convert_torch_state_dict({f'backbone.{k}': v.numpy() for k, v in
                                     trunk.state_dict().items()})
    unmapped = conv['_unmapped']
    for name in ('layer1.0.conv2.conv.weight', 'layer1.0.conv2.fc1.bias',
                 'layer2.0.conv2.bn1.running_var'):
        assert f'backbone.{name}' in unmapped


# ---- Mask Scoring ---------------------------------------------------------
@pytest.fixture(scope='module')
def roi_head(ref):
    head = HEADS.build(roi_head_cfg())
    # fc1's rows are permuted by the RPN's input width (the FPN's)
    rpn = {'rpn_conv': {'kernel': np.zeros((3, 3, 64, 64), np.float32)}}
    return load(head, {'params': {'roi_head': ref['roi'], 'rpn_net': rpn}},
                'roi_head.')


def test_maskiou_head_matches_jax(ref):
    head = MaskIoUHead(num_classes=4, in_channels=64, conv_out_channels=64,
                       fc_out_channels=64)
    load(head, as_scope(ref['maskiou'], 'roi_head', 'maskiou'),
         'roi_head.mask_iou_head.')
    mf, mp = randn((6, 64, 14, 14), 4), randn((6, 28, 28), 5) * 3
    with torch.no_grad():
        got = head(torch.from_numpy(mf), torch.from_numpy(mp))
    assert_close(got, ref['maskiou_out'], OUT_RTOL)


def roi_train(head, ref, feats):
    props, pvalid = ref['proposals']
    return head.forward_train(feats, torch.from_numpy(props),
                              torch.from_numpy(pvalid), ref['t_batch'],
                              torch.Generator().manual_seed(0))


def test_mask_scoring_losses_match_jax(ref, roi_head):
    want = ref['roi_out'][0]
    assert isinstance(roi_head, MaskScoringRoIHead)
    with torch.no_grad():
        got = roi_train(roi_head, ref, nchw(fpn_features()))
    assert sorted(got) == ['loss_bbox', 'loss_cls', 'loss_mask',
                           'loss_mask_iou']
    assert float(want['loss_mask_iou']) > 0
    assert_losses_close(got, want)


def test_mask_iou_gradients_match_jax(ref, roi_head):
    """The summed losses' gradient for every MaskIoU parameter, and
    `loss_mask_iou`'s alone for the RoI features: it reaches them through
    the MaskIoU head, not through the detached mask logits."""
    _, want_head, want_feats = ref['roi_out']
    head = copy.deepcopy(roi_head)
    feats = [f.requires_grad_() for f in nchw(fpn_features())]
    sum(roi_train(head, ref, feats).values()).backward()
    grads = state_dict_from_jax(
        {'params': {'roi_head': {'maskiou': want_head}}},
        ['roi_head.mask_iou_head.' + k
         for k in head.mask_iou_head.state_dict()])
    for name, p in head.mask_iou_head.named_parameters():
        assert_close(p.grad, grads[f'roi_head.mask_iou_head.{name}'].numpy(),
                     GRAD_RTOL, name)
    head.zero_grad()
    feats = [f.detach().requires_grad_() for f in feats]
    roi_train(head, ref, feats)['loss_mask_iou'].backward()
    assert all(p.grad is None or not p.grad.any()
               for p in head.mask_head.parameters())
    reached = 0
    for g, w in zip(feats, want_feats):
        if g.grad is None:      # a level that holds no roi of this batch
            assert not np.asarray(w).any()
            continue
        assert_close(to_nhwc(g.grad), w, GRAD_RTOL)
        reached += 1
    assert reached >= 1


# ---- the detectors --------------------------------------------------------
@pytest.fixture(scope='module')
def s50(ref):
    model = build_detector(small_two_stage(S50_CONFIG))
    model.load_state_dict(state_dict_from_jax(
        ref['s50'], list(model.state_dict())), strict=True)
    return model


@pytest.fixture(scope='module')
def ms(ref):
    model = build_detector(small_two_stage(MS_CONFIG))
    model.load_state_dict(state_dict_from_jax(
        ref['ms'], list(model.state_dict())), strict=True)
    return model


def test_resnest_faster_rcnn_losses_match_jax(ref, s50):
    """`forward_train` with live BNs, the trunk in float64 in both
    packages (`float64_programs`), the rest in float32."""
    want = ref['s50_train64_out']
    model = copy.deepcopy(s50).train()
    model.backbone.double()
    model.backbone.register_forward_hook(
        lambda m, args, outs: tuple(o.float() for o in outs))
    batch = dict(ref['t_batch'], image=ref['t_batch']['image'].double())
    with torch.no_grad():
        got = model.forward_train(batch, torch.Generator().manual_seed(0))
    assert_losses_close(got, want, rtol=1e-3)


def test_resnest_faster_rcnn_detections_match_jax(ref, s50):
    with torch.no_grad():
        got = s50.eval().forward_test(ref['t_batch'])
    assert_dets_sets(got, ref['s50_out'])


def test_ms_rcnn_losses_and_gradient_match_jax(ref, ms):
    """The loss dict and the summed losses' gradient for the MaskIoU head
    and the first FPN output conv, which `loss_mask_iou` reaches through
    the RoI features."""
    want, want_grads, _ = ref['ms_out']
    model = copy.deepcopy(ms).train()
    got = model.forward_train(ref['t_batch'],
                              torch.Generator().manual_seed(0))
    assert 'loss_mask_iou' in got and float(want['loss_mask_iou']) > 0
    assert_losses_close(got, want, rtol=1e-3)
    sum(got.values()).backward()
    keys = list(model.state_dict())
    grads = state_dict_from_jax({'params': {
        'roi_head': {'maskiou': want_grads['maskiou']},
        'neck': {'fpn_conv_0': want_grads['fpn_conv_0']}}}, keys)
    params = dict(model.named_parameters())
    assert sorted(grads) == sorted(
        k for k in params if k.startswith(('roi_head.mask_iou_head.',
                                           'neck.fpn_convs.0.')))
    for name, w in grads.items():
        assert_close(params[name].grad, w.numpy(), 2e-3, name)


def test_ms_rcnn_detections_match_jax(ref, ms):
    """Testing is Mask R-CNN's: the detections and their masks."""
    with torch.no_grad():
        got = ms.eval().forward_test(ref['t_batch'])
    assert len(got) == 4
    assert_dets_sets(got, ref['ms_out'][2])


def test_converter_has_no_maskiou_rule(ms):
    conv = convert_torch_state_dict(
        {k: v.numpy() for k, v in ms.state_dict().items()
         if k.startswith('roi_head.mask_iou_head.')})
    assert len(conv['_unmapped']) == len(
        ms.roi_head.mask_iou_head.state_dict())


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_ms_rcnn_and_resnest_configs_build(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    if '/ms_rcnn/' in path:
        assert type(model).__name__ == 'MaskScoringRCNN'
        assert isinstance(model.roi_head, MaskScoringRoIHead)
        assert model.roi_head.mask_iou_head.fcs[0].in_features == 256 * 49
    else:
        assert isinstance(model.backbone, ResNeSt)
        assert not model.backbone.norm_eval
        assert model.backbone.stem[0].out_channels == \
            cfg.model.backbone.stem_channels // 2
