"""The port's FoveaBox and SSD against the JAX package on the same weights
and inputs, and the FoveaBox and SSD configs.

SSD-VGG goes the reference recipe's way: a port init through
`ld_tpu.utils.checkpoint.convert_torch_state_dict` into the JAX network
(and back through `state_dict_from_jax`). The heads' weights go JAX ->
port: `jax.eval_shape` of the JAX init, `fill_tree` from a numpy seed
(FoveaBox-align's zero-initialised offset conv too, so that its DCN
samples off the grid), and `state_dict_from_jax` onto the port's names
(the JAX converter has no SSD-head or FoveaBox rule: ROADMAP.md caveats
53-54, asserted below). Float32 on the CPU:
  * `L2Norm` within 1e-6 of the largest output; `SSDVGG` at 1x3x300x300:
    its six levels (38 to 1) within 1e-4 of each one's largest value;
  * the anchors of SSD300 and SSD512 (COCO and VOC ratio ranges) and of
    the legacy generator: base and grid anchors equal;
  * the SSD head (4 classes, the SSD300 level sizes at 16 channels): its
    outputs within 1e-5 of each level's largest; on given outputs whose
    first level is flat (equal CE at many negatives: a tie for the
    hard-negative ranking) the assignment, the hard-negative keep mask
    and the labels equal and the losses to rtol 2e-4; the summed losses'
    gradient for every head parameter within 1e-4 of the largest; the
    detections of given untied outputs (labels and valid mask equal,
    boxes and scores within 1e-4);
  * the FoveaBox targets with a gt in two levels' scale ranges and two gts
    covering one point: labels, positive mask and targets equal (targets
    within 1e-6);
  * the FoveaBox head (width 64, 2 stacked convs, 4 classes), plain and
    align (its offsets off the grid): outputs within 1e-5 of each level's
    largest, losses on identical outputs to rtol 2e-4, the summed losses'
    gradient for every head parameter within 1e-4 of the largest of the
    JAX float64 one (the JAX float32 one lies up to 9e-5 from it), and the
    detections of identical outputs (within 1e-4);
  * FoveaBox-align R18 (fovea_align_r50_* at depth 18, width 64) on the
    bridge's 2x3x64x96 batch: head outputs within 5e-3, `forward_train`'s
    loss dict to rtol 1e-3, `forward_test`'s detections within 5e-3;
  * every config of configs/foveabox/ and the six SSD configs build on
    the meta device.

The `ref` fixture traces every JAX program once and compiles each in a
thread as soon as it is traced, at LLVM -O0 (the VGG optimised).
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
from ld_tpu.models.backbones.ssd_vgg import L2Norm as JL2Norm
from ld_tpu.models.backbones.ssd_vgg import SSDVGG as JSSDVGG
from ld_tpu.models.heads.ssd_head import (
    LegacySSDAnchorGenerator as JLegacySSDAnchorGenerator)
from ld_tpu.models.heads.ssd_head import \
    SSDAnchorGenerator as JSSDAnchorGenerator
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones.ssd_vgg import SSDVGG, L2Norm
from ld_tpu_torch.models.heads.fovea_head import FoveaHead
from ld_tpu_torch.models.heads.ssd_head import (LegacySSDAnchorGenerator,
                                                SSDAnchorGenerator, SSDHead)
from ld_tpu_torch.ops.deform_conv import DeformConv
from ld_tpu_torch.testing import detection_batch_np
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import (HEAD_KW, OUT_ABS, TEST_CFG,
                                    assert_losses_close, batches, fill_tree,
                                    fpn_feats, nchw, nhwc)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIGN_CONFIG = os.path.join(
    ROOT, 'configs/foveabox/fovea_align_r50_fpn_gn-head_4x4_2x_coco.py')
SSD_CONFIGS = [os.path.join(ROOT, p) for p in (
    'configs/ssd/ssd300_coco.py', 'configs/ssd/ssd512_coco.py',
    'configs/pascal_voc/ssd300_voc0712.py',
    'configs/pascal_voc/ssd512_voc0712.py',
    'configs/legacy_1.x/ssd300_coco_v1.py',
    'configs/wider_face/ssd300_wider_face.py')]
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/foveabox/*.py'))) + \
    SSD_CONFIGS
# the anchors' configs: SSD300 / SSD512 COCO and VOC, and the legacy form
ANCHOR_CONFIGS = [p for p in SSD_CONFIGS if 'wider' not in p]
SSD_SIZES = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
SSD_CH = 16
SSD_KW = dict(num_classes=4, in_channels=(SSD_CH, ) * 6)
# the bridge's FPN levels of a 64x96 image at strides 8-128
SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
FOVEA_KINDS = ('plain', 'align')
OUT_RTOL, GRAD_RTOL, DET_TOL = 1e-5, 1e-4, 5e-3


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randn(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def ssd_batches():
    """A 2-image 300x300 batch of 4 classes: (jax, port)."""
    np_batch = detection_batch_np(2, 300, 300, num_classes=4, max_gts=6,
                                  seed=3)
    j = {k: jnp.asarray(v) for k, v in np_batch.items()}
    j['gt_labels'] = j['gt_labels'].astype(jnp.int32)
    t = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    return j, t


def ssd_feats(seed=5):
    return [randn((2, h, w, SSD_CH), seed + i)
            for i, (h, w) in enumerate(SSD_SIZES)]


def flat_outputs(j_outs, seed=6, flat=True):
    """Random SSD head outputs of the head's shapes whose first level
    repeats one position's logits over its first 20 rows, the background
    logits there at -10: the largest negative losses are runs of equal
    values, and the hard-negative cut falls inside one."""
    rs = np.random.RandomState(seed)
    cls = [rs.randn(*np.shape(c)).astype(np.float32) for c in j_outs[0]]
    if flat:
        cls[0][:, :20] = cls[0][:, :1, :1]
        cls[0][:, :20, :, SSD_KW['num_classes']::SSD_KW[
            'num_classes'] + 1] = -10.0
    reg = [(rs.randn(*np.shape(r)) * 0.5).astype(np.float32)
           for r in j_outs[1]]
    return cls, reg


def fovea_batches():
    """The bridge's batch with, in image 0, a gt whose sqrt(area) (48) lies
    in levels 0 and 1's scale ranges, and a gt nested in it whose shrunk
    box covers the same centre: (jax, port)."""
    j, t = batches()
    gt = np.array(t['gt_bboxes'])
    valid = np.array(t['gt_valid'])
    labels = np.array(t['gt_labels'])
    gt[0, :2] = [[20., 10., 68., 58.], [34., 24., 54., 44.]]
    valid[0, :2] = True
    labels[0, :2] = [1, 2]
    t = dict(t, gt_bboxes=torch.from_numpy(gt),
             gt_valid=torch.from_numpy(valid),
             gt_labels=torch.from_numpy(labels).long())
    j = dict(j, gt_bboxes=jnp.asarray(gt), gt_valid=jnp.asarray(valid),
             gt_labels=jnp.asarray(labels, jnp.int32))
    return j, t


def fovea_cfg(kind):
    return dict(type='FoveaHead', **HEAD_KW, with_deform=kind == 'align',
                test_cfg=TEST_CFG)


def align_cfg():
    model = copy.deepcopy(JConfig.fromfile(ALIGN_CONFIG)['model'])
    model['backbone']['depth'] = 18
    model['neck'].update(in_channels=[64, 128, 256, 512], out_channels=64)
    model['bbox_head'].update(in_channels=64, feat_channels=64,
                              num_classes=4)
    return model


def fovea_gradients(pool, options, out, j_batch):
    """The FoveaBox heads' summed-loss gradients in float64 (under
    `jax.enable_x64`, the heads built with dtype float64): flax's
    GroupNorm takes E[x^2] - E[x]^2 over 2-value groups on the small
    levels, which puts the JAX float32 tower gradients up to 9e-5 of the
    largest from the float64 ones, where the port's float32 ones lie
    within 2e-5 of them."""
    with jax.enable_x64():
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), tree)
        feats = [np.asarray(f, np.float64) for f in fpn_feats(seed=4)]
        batch = dict(j_batch, gt_bboxes=np.asarray(j_batch['gt_bboxes'],
                                                   np.float64))
        lowered = {}
        for kind in FOVEA_KINDS:
            head = JAX_HEADS.build(dict(fovea_cfg(kind), dtype=jnp.float64))

            def grad(v, feats, b, head=head):
                return jax.grad(lambda v: sum(head.loss(
                    head.net.apply(v, feats), b, SIZES).values()))(v)
            args = (f64(out[f'fovea_{kind}']), feats, batch)
            lowered[kind] = (jax.jit(grad).lower(*args), args)
        futures = {k: pool.submit(low.compile, compiler_options=options)
                   for k, (low, _) in lowered.items()}
        return {f'fovea_{k}_grads': futures[k].result()(*lowered[k][1])
                for k in lowered}


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against, on numpy-filled
    variables (the VGG's from a port init); numpy trees and outputs."""
    out = {}
    jobs = {}
    options = {}

    # L2Norm and the VGG
    x = randn((2, 5, 5, 512), 0)
    l2 = JL2Norm(20.0)
    out['l2norm'] = fill_tree(jax.eval_shape(
        lambda: l2.init(jax.random.PRNGKey(0), x)), seed=1)
    jobs['l2norm'] = (l2.apply, (out['l2norm'], x))
    vgg = SSDVGG(300)
    vgg.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        vgg.l2_norm.weight.uniform_(10, 30,
                                    generator=torch.Generator()
                                    .manual_seed(1))
    out['vgg_port'] = vgg
    conv = convert_torch_state_dict({f'backbone.{k}': v.numpy()
                                     for k, v in vgg.state_dict().items()})
    assert conv.pop('_unmapped') == []
    out['vgg'] = {'params': conv['params']['backbone']}
    image = nhwc(randn((1, 3, 300, 300), 2))
    jobs['vgg'] = (JSSDVGG(300).apply, (out['vgg'], image))
    options['vgg'] = {}

    # the SSD head: outputs and gradient from features, the loss pieces
    # and detections of given outputs with a flat region
    j_batch, ssd_batch = ssd_batches()
    ssd = JAX_HEADS.build(dict(type='SSDHead', **SSD_KW))
    feats = [jnp.asarray(f) for f in ssd_feats()]
    sv = out['ssd'] = fill_tree(jax.eval_shape(
        lambda: ssd.net.init(jax.random.PRNGKey(0), feats)), seed=7)
    shapes = jax.eval_shape(ssd.net.apply, sv, feats)
    given = flat_outputs(shapes)
    # the decode's: untied scores, so that the top-k order is defined
    decoded = flat_outputs(shapes, seed=7, flat=False)
    out['ssd_given'], out['ssd_decoded'] = given, decoded

    def ssd_run(v, feats, given, decoded, b):
        def total(v):
            outs = ssd.net.apply(v, feats)
            return sum(ssd.loss(outs, b, SSD_SIZES).values()), outs
        (_, outs), grads = jax.value_and_grad(total, has_aux=True)(v)
        pieces = ssd._loss_pieces(given, b, SSD_SIZES)
        return (outs, grads, {k: pieces[k] for k in (
            'labels', 'pos', 'neg_keep', 'ce', 'sl1')},
            ssd.loss(given, b, SSD_SIZES),
            ssd.get_bboxes(decoded, b['img_hw']))
    jobs['ssd'] = (ssd_run, (sv, feats, given, decoded, j_batch))

    # the FoveaBox targets, heads and detector
    j_batch, t_batch = fovea_batches()
    fovea = JAX_HEADS.build(fovea_cfg('plain'))
    points, lvl_id = fovea._level_points(SIZES)
    jobs['fovea_targets'] = (
        jax.vmap(lambda b, l, v: fovea._targets_single(points, lvl_id, b, l,
                                                       v)),
        (j_batch['gt_bboxes'], j_batch['gt_labels'], j_batch['gt_valid']))
    feats = [jnp.asarray(f) for f in fpn_feats(seed=4)]
    for kind in FOVEA_KINDS:
        head = JAX_HEADS.build(fovea_cfg(kind))
        v = out[f'fovea_{kind}'] = fill_tree(jax.eval_shape(
            lambda head=head: head.net.init(jax.random.PRNGKey(0), feats)),
            seed=8)

        def head_run(v, feats, b, head=head):
            outs = head.net.apply(v, feats)
            return (outs, head.loss(outs, b, SIZES),
                    head.get_bboxes(outs, b['img_hw']))
        jobs[f'fovea_{kind}'] = (head_run, (v, feats, j_batch))

    det = j_build_detector(align_cfg())
    dv = out['align'] = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=9)

    def align_run(v, b):
        # the R18's BNs are frozen (norm_eval): forward_train and
        # forward_test are the loss and the decode of these outputs
        outs = det.apply(v, b['image'])
        sizes = [c.shape[1:3] for c in outs[0]]
        return (outs, det.bbox_head.loss(outs, b, sizes),
                det.bbox_head.get_bboxes(outs, b['img_hw']))
    jobs['align'] = (align_run, (dv, j_batch))

    o0 = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(len(jobs) + 2) as pool:
        # each compiles while the next is traced
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=options.get(k, o0))
                   for k, (fn, args) in jobs.items()}
        out.update(fovea_gradients(pool, o0, out, j_batch))
    for k, (_, args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*args)
    vgg_port = out.pop('vgg_port')
    return dict(numpy_tree(out), vgg_port=vgg_port, ssd_batch=ssd_batch,
                fovea_batch=t_batch)


def port_head(cfg, variables):
    head = HEADS.build(cfg)
    keys = ['bbox_head.' + k for k in head.state_dict()]
    sd = state_dict_from_jax({coll: {'head_net': tree}
                              for coll, tree in variables.items()}, keys)
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in sd.items()},
                         strict=True)
    return head.eval()


def assert_levels_close(got, want, rtol=OUT_RTOL, atol=None):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy().transpose(0, 2, 3, 1)
        w = np.asarray(w)
        assert g.shape == w.shape
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


def assert_grads_close(head, j_grads):
    """The JAX gradient tree carried onto the port's names by the weights'
    map, against every head parameter's gradient."""
    want = state_dict_from_jax({'params': {'head_net': j_grads['params']}},
                               [f'bbox_head.{k}' for k in head.state_dict()])
    params = dict(head.named_parameters())
    assert sorted(f'bbox_head.{k}' for k in params) == sorted(want)
    # a level whose anchors all go unselected gets no gradient: 1e-6 of
    # the largest gradient of all bounds those
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for name, p in params.items():
        w = want[f'bbox_head.{name}'].numpy().astype(np.float32)
        assert np.abs(p.grad.numpy() - w).max() <= \
            max(GRAD_RTOL * np.abs(w).max(), floor), name


# ---- SSD-VGG ----------------------------------------------------------------
def test_l2norm_matches_jax(ref):
    mod = L2Norm(512)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(ref['l2norm']['params']['gamma']))
        got = mod(torch.from_numpy(randn((2, 5, 5, 512), 0)).permute(
            0, 3, 1, 2))
    want = ref['l2norm_out']
    diff = np.abs(got.numpy().transpose(0, 2, 3, 1) - want).max()
    assert diff <= 1e-6 * np.abs(want).max()


def test_ssd_vgg_matches_jax(ref):
    """SSDVGG at 300 (port -> convert_torch_state_dict -> JAX), its six
    levels, and `state_dict_from_jax` carrying the JAX tree back."""
    vgg = ref['vgg_port'].eval()
    with torch.no_grad():
        got = vgg(torch.from_numpy(randn((1, 3, 300, 300), 2)))
    assert [tuple(g.shape[-2:]) for g in got] == SSD_SIZES
    assert [g.shape[1] for g in got] == [512, 1024, 512, 256, 256, 256]
    for g, w in zip(got, ref['vgg_out']):
        diff = np.abs(g.numpy().transpose(0, 2, 3, 1) - w).max()
        assert diff <= 1e-4 * np.abs(w).max()
    back = state_dict_from_jax({'params': {'backbone': ref['vgg']['params']},
                                'batch_stats': {}})
    own = vgg.state_dict()
    assert sorted(back) == sorted(f'backbone.{k}' for k in own)
    for k, v in own.items():
        assert torch.equal(back[f'backbone.{k}'], v), k


def test_ssd512_vgg_levels():
    with torch.device('meta'):
        vgg = SSDVGG(512)
    x = torch.empty(1, 3, 512, 512, device='meta')
    assert [tuple(o.shape[1:]) for o in vgg(x)] == [
        (512, 64, 64), (1024, 32, 32), (512, 16, 16), (256, 8, 8),
        (256, 4, 4), (256, 2, 2), (256, 1, 1)]


# ---- SSD anchors and head ---------------------------------------------------
@pytest.mark.parametrize('path', ANCHOR_CONFIGS, ids=os.path.basename)
def test_ssd_anchors_match_jax(path):
    ag = dict(Config.fromfile(path).model.bbox_head.anchor_generator)
    kind = ag.pop('type')
    legacy = kind.startswith('Legacy')
    got = (LegacySSDAnchorGenerator if legacy else SSDAnchorGenerator)(**ag)
    want = (JLegacySSDAnchorGenerator if legacy else JSSDAnchorGenerator)(
        **ag)
    assert got.num_base_anchors == want.num_base_anchors
    assert got.min_sizes == want.min_sizes
    assert got.max_sizes == want.max_sizes
    for g, w in zip(got.base_anchors, want.base_anchors):
        np.testing.assert_array_equal(g, w)
    size = ag['input_size']
    sizes = [(int(np.ceil(size / s)), ) * 2 for s in ag['strides']]
    for g, w in zip(got.grid_anchors(sizes), want.grid_anchors(sizes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ssd_head_outputs_and_gradients_match_jax(ref):
    head = port_head(dict(type='SSDHead', **SSD_KW), ref['ssd']).train()
    j_outs, j_grads = ref['ssd_out'][:2]
    outs = head([torch.from_numpy(f).permute(0, 3, 1, 2)
                 for f in ssd_feats()])
    for g, w in zip(outs, j_outs):
        assert_levels_close(g, w)
    sum(head.loss(outs, ref['ssd_batch'], SSD_SIZES).values()).backward()
    assert_grads_close(head, j_grads)


def test_ssd_losses_and_hard_negatives_match_jax(ref):
    """On given outputs with a flat first level: the stable descending
    sort breaks the ties among equal negative losses by anchor index, as
    `jnp.argsort` does, so the kept negatives are the same set."""
    head = port_head(dict(type='SSDHead', **SSD_KW), ref['ssd'])
    pieces, losses = ref['ssd_out'][2:4]
    given = [nchw(p) for p in ref['ssd_given']]
    got = head.loss_pieces(given, ref['ssd_batch'], SSD_SIZES)
    for k in ('labels', 'pos', 'neg_keep'):
        np.testing.assert_array_equal(got[k].numpy(), pieces[k], err_msg=k)
    np.testing.assert_allclose(got['ce'].numpy(), pieces['ce'], rtol=1e-5,
                               atol=1e-6)
    pos, neg = got['pos'].numpy(), got['neg_keep'].numpy()
    assert pos.sum() > 0
    np.testing.assert_array_equal(neg.sum(1), 3 * pos.sum(1))
    # the tie: the cut falls inside a run of equal negative losses
    ce = pieces['ce']
    for i in range(2):
        cut = ce[i][neg[i]].min()
        assert ((ce[i] == cut) & ~neg[i] & ~pos[i]).any()
    assert_losses_close(head.loss(given, ref['ssd_batch'], SSD_SIZES),
                        losses)


def test_ssd_detections_match_jax(ref):
    head = port_head(dict(type='SSDHead', **SSD_KW), ref['ssd'])
    got = head.get_bboxes([nchw(p) for p in ref['ssd_decoded']],
                          ref['ssd_batch']['img_hw'])
    assert got[0].shape == (2, 200, 5)
    assert_dets_close(got, ref['ssd_out'][4], 1e-4)


def test_converter_has_no_ssd_head_rule(ref):
    head = port_head(dict(type='SSDHead', **SSD_KW), ref['ssd'])
    conv = convert_torch_state_dict({f'bbox_head.{k}': v.numpy()
                                     for k, v in head.state_dict().items()})
    assert len(conv['_unmapped']) == len(head.state_dict())


# ---- FoveaBox ---------------------------------------------------------------
def test_fovea_targets_match_jax(ref):
    head = FoveaHead(**HEAD_KW)
    b = ref['fovea_batch']
    labels, targets, pos = head.targets(SIZES, b['gt_bboxes'],
                                        b['gt_labels'], b['gt_valid'])
    w_labels, w_targets, w_pos = ref['fovea_targets_out']
    np.testing.assert_array_equal(labels.numpy(), w_labels)
    np.testing.assert_array_equal(pos.numpy(), w_pos)
    np.testing.assert_allclose(targets.numpy(), w_targets, rtol=0,
                               atol=1e-6)
    # the big gt (label of slot 0) is positive on levels 0 and 1; the
    # nested one (slot 1) wins their shared centre points
    lvl = np.concatenate([np.full(h * w, i) for i, (h, w) in
                          enumerate(SIZES)])
    big, small = 1, 2
    assert set(lvl[w_labels[0] == big]) >= {0, 1}
    assert (w_labels[0] == small).any()


@pytest.mark.parametrize('kind', FOVEA_KINDS)
def test_fovea_head_matches_jax(ref, kind):
    """Outputs, the loss on identical outputs, and the summed losses'
    gradient through the port's own forward (the align's DCN offsets and
    their gradient into `conv_reg` included) against the JAX float64 one
    (`fovea_gradients`)."""
    head = port_head(fovea_cfg(kind), ref[f'fovea_{kind}'])
    j_outs, want, _ = ref[f'fovea_{kind}_out']
    j_grads = ref[f'fovea_{kind}_grads']
    feats = nchw(fpn_feats(seed=4))
    with torch.no_grad():
        got = head(feats)
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w)
    if kind == 'align':
        assert sum(isinstance(m, DeformConv) for m in head.modules()) == 1
        with torch.no_grad():
            off = head.feature_adaption.conv_offset(torch.exp(got[1][0]))
        assert float(off.abs().mean()) > 0.1
    losses = head.loss(tuple(nchw(p) for p in j_outs), ref['fovea_batch'],
                       SIZES)
    assert sorted(losses) == ['loss_bbox', 'loss_cls']
    assert_losses_close(losses, want)
    head.train()
    sum(head.loss(head(feats), ref['fovea_batch'], SIZES).values()
        ).backward()
    assert_grads_close(head, j_grads)


def test_fovea_detections_match_jax(ref):
    head = port_head(fovea_cfg('plain'), ref['fovea_plain'])
    j_outs, _, want = ref['fovea_plain_out']
    got = head.get_bboxes(tuple(nchw(p) for p in j_outs),
                          ref['fovea_batch']['img_hw'])
    assert_dets_close(got, want, 1e-4)


def test_fovea_align_detector_matches_jax(ref):
    model = build_detector(align_cfg())
    model.load_state_dict(state_dict_from_jax(
        ref['align'], list(model.state_dict())), strict=True)
    j_outs, want, want_dets = ref['align_out']
    batch = ref['fovea_batch']
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


def test_converter_has_no_fovea_rule(ref):
    head = port_head(fovea_cfg('align'), ref['fovea_align'])
    conv = convert_torch_state_dict({f'bbox_head.{k}': v.numpy()
                                     for k, v in head.state_dict().items()})
    unmapped = conv['_unmapped']
    for name in ('feature_adaption.conv_offset.weight',
                 'feature_adaption.conv_adaption.weight'):
        assert f'bbox_head.{name}' in unmapped


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_fovea_and_ssd_configs_build(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    head = model.bbox_head
    if '/foveabox/' in path:
        assert type(model).__name__ == 'FoveaBox'
        assert isinstance(head, FoveaHead)
        assert head.with_deform == ('align' in path)
    else:
        assert type(model).__name__ == 'SSD' and model.neck is None
        assert isinstance(head, SSDHead)
        assert sum(head.anchor_generator.num_base_anchors) in (30, 36)
