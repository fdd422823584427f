"""The port's mmdet v1 anchor layout (`LegacyAnchorGenerator`) and the GHM
losses (`GHMC`, `GHMR`) against the JAX package, and the configs of
configs/legacy_1.x/ and ghm/.

  * `LegacyAnchorGenerator`: every level's anchors and valid flags of the
    RetinaNet v1 generators (plain and caffe) equal to JAX's, bit for bit;
    a RetinaNet v1 head builds it, as the JAX GFL-lineage heads do;
  * the RPN of the Faster / Mask / Cascade Mask R-CNN v1 configs drops the
    legacy type and builds the plain generator with `center_offset` 0.5,
    as the JAX RPN does (`ld_tpu/models/heads/rpn_head.py:68-71`): its
    anchors equal the JAX RPN's and differ from the legacy layout;
  * the RetinaNet v1 head (legacy anchors and coder) at width 64 on random
    FPN features: the loss dict to rtol 2e-4, the decode within 1e-4, with
    weights JAX -> port (`state_dict_from_jax`);
  * `GHMC` / `GHMR` on seeded (N, C) / (N, 4) inputs, with and without
    label weights, within 1e-6 relative of JAX; the JAX normaliser is
    `bins`, not the count of bins that hold elements as in mmdet (a case
    whose elements fill two bins of ten); a head's `weight` and
    `avg_factor` are not read; on (B, N, C) logits the port's loss is the
    JAX loss of the flattened (B x N, C) ones, where the JAX loss itself
    fails to broadcast at B > 1;
  * the RetinaNet GHM head's loss dict against JAX at batch 1 (the batch
    the JAX head can take), rtol 2e-4;
  * every config of the two folders builds on the meta device.

Float32 on the CPU; the JAX references are jitted.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.ops.anchors import AnchorGenerator as JAnchorGenerator
from ld_tpu.ops.anchors import LegacyAnchorGenerator as JLegacyAnchorGenerator
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu.utils.registry import LOSSES as JAX_LOSSES
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.ops.anchors import AnchorGenerator, LegacyAnchorGenerator
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from test_torch_port_bridge import (HEAD_KW, TEST_CFG, assert_losses_close,
                                    batches, fill_tree, fpn_feats, nchw)
from test_torch_port_classic_heads import MAX_IOU, jax_to_port_head
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for d in ('legacy_1.x', 'ghm')
                 for p in glob.glob(os.path.join(ROOT, 'configs', d, '*.py')))
SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
GHM_CLS = dict(type='GHMC', bins=30, momentum=0.75, use_sigmoid=True,
               loss_weight=1.0)
GHM_REG = dict(type='GHMR', mu=0.02, bins=10, momentum=0.7, loss_weight=10.0)


def model_cfg(path):
    return Config.fromfile(os.path.join(ROOT, path)).model


def generator_cfg(path, head='bbox_head'):
    return dict(model_cfg(path)[head]['anchor_generator'])


# ---- the v1 anchors ---------------------------------------------------------
@pytest.mark.parametrize('path', [
    'configs/legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py',
    'configs/legacy_1.x/retinanet_r50_caffe_fpn_1x_coco_v1.py'])
def test_legacy_anchor_generator_matches_jax(path):
    ag = generator_cfg(path)
    assert ag.pop('type') == 'LegacyAnchorGenerator'
    got, want = LegacyAnchorGenerator(**ag), JLegacyAnchorGenerator(**ag)
    for g, w in zip(got.grid_anchors(SIZES), want.grid_anchors(SIZES)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got.valid_flags(SIZES, (60.0, 90.0)),
                    want.valid_flags(SIZES, (60.0, 90.0))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # integer corners about 0.5 x (size - 1), not the plain layout's
    base = got.base_anchors[0]
    np.testing.assert_array_equal(base, np.round(base))
    plain = AnchorGenerator(**ag).base_anchors[0]
    assert np.abs(base - plain).max() >= 0.5


@pytest.mark.parametrize('path', [
    'configs/legacy_1.x/faster_rcnn_r50_fpn_1x_coco_v1.py',
    'configs/legacy_1.x/mask_rcnn_r50_fpn_1x_coco_v1.py',
    'configs/legacy_1.x/cascade_mask_rcnn_r50_fpn_1x_coco_v1.py'])
def test_rpn_drops_the_legacy_type_as_jax(path):
    cfg = model_cfg(path)
    assert cfg.rpn_head.anchor_generator.type == 'LegacyAnchorGenerator'
    with torch.device('meta'):
        model = build_detector(cfg)
    ag = model.rpn_head.anchor_generator
    assert type(ag) is AnchorGenerator and ag.center_offset == 0.5
    j_rpn = JAX_HEADS.build(dict(cfg.rpn_head))
    assert type(j_rpn.anchor_generator) is JAnchorGenerator
    for g, w in zip(ag.grid_anchors(SIZES),
                    j_rpn.anchor_generator.grid_anchors(SIZES)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    args = {k: v for k, v in cfg.rpn_head.anchor_generator.items()
            if k != 'type'}
    legacy = LegacyAnchorGenerator(**args).base_anchors[0]
    assert np.abs(ag.base_anchors[0] - legacy).max() >= 0.5


def retina_v1_cfg():
    head = dict(model_cfg('configs/legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py')
                .bbox_head)
    for k in ('in_channels', 'feat_channels', 'stacked_convs',
              'num_classes'):
        head.pop(k, None)
    return dict(head, **HEAD_KW, train_cfg=dict(assigner=MAX_IOU),
                test_cfg=TEST_CFG)


def retina_pair(cfg, seed):
    """The JAX head of `cfg`, the port head on its filled tree (cls bias 0),
    the JAX outputs on random FPN features: (j_head, head, j_outs)."""
    j_head, head = JAX_HEADS.build(dict(cfg)), HEADS.build(dict(cfg))
    feats = fpn_feats(seed=4)
    template = jax.eval_shape(lambda: j_head.net.init(
        jax.random.PRNGKey(0), [jnp.zeros(f.shape) for f in feats]))
    variables = fill_tree(dict(template), seed=seed)
    variables['params']['retina_cls']['bias'] = np.zeros_like(
        variables['params']['retina_cls']['bias'])
    head = jax_to_port_head(variables, head).eval()
    j_outs = jax.jit(j_head.net.apply)(variables,
                                       [jnp.asarray(f) for f in feats])
    return j_head, head, tuple(tuple(p) for p in j_outs)


def test_retina_v1_head_loss_and_decode_match_jax():
    cfg = retina_v1_cfg()
    j_head, head, j_outs = retina_pair(cfg, seed=7)
    assert isinstance(head.anchor_generator, LegacyAnchorGenerator)
    assert isinstance(j_head.anchor_generator, JLegacyAnchorGenerator)
    assert type(head.coder).__name__ == 'LegacyDeltaXYWHBBoxCoder'
    j_batch, t_batch = batches()
    sizes = [tuple(np.shape(c)[1:3]) for c in j_outs[0]]
    want = jax.jit(lambda o, b: j_head.loss(o, b, sizes))(j_outs, j_batch)
    port = tuple(nchw(p) for p in j_outs)
    assert float(want['loss_bbox']) > 0
    assert_losses_close(head.loss(port, t_batch, sizes), want)
    img_hw = t_batch['img_hw'].numpy()
    dets, labels, valid = (np.asarray(a) for a in jax.jit(
        lambda o, hw: j_head.get_bboxes(o, hw))(j_outs, jnp.asarray(img_hw)))
    got = head.get_bboxes(port, torch.from_numpy(img_hw))
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), labels)
    np.testing.assert_allclose(got[0].numpy(), dets, rtol=0, atol=1e-4)


# ---- the GHM losses ---------------------------------------------------------
def ghm_case(seed=0, n=300, c=5):
    """Logits spread over every gradient bin, labels with background (c)
    and ignored (-1) rows, regression pairs with small and large errors."""
    rs = np.random.RandomState(seed)
    logits = (rs.randn(n, c) * 3).astype(np.float32)
    labels = rs.randint(-1, c + 2, n).astype(np.int32)
    label_w = (rs.rand(n) < 0.8).astype(np.float32)
    pred = (rs.randn(n, 4) * 0.05).astype(np.float32)
    target = (pred + rs.randn(n, 4) * np.array([0.001, 0.01, 0.1, 1.0])
              ).astype(np.float32)
    box_w = np.repeat((rs.rand(n, 1) < 0.5).astype(np.float32), 4, 1)
    return logits, labels, label_w, pred, target, box_w


def j_loss(cfg, *args, **kw):
    fn = JAX_LOSSES.build(dict(cfg))
    return float(jax.jit(lambda *a: fn(*a, **kw))(*args))


def t_loss(cfg, *args, **kw):
    return float(LOSSES.build(dict(cfg))(*(torch.from_numpy(np.asarray(a))
                                           for a in args), **kw))


def assert_rel(got, want, rtol=1e-6):
    assert np.isfinite(got) and abs(got - want) <= rtol * abs(want), \
        (got, want)


@pytest.mark.parametrize('weighted', (False, True))
def test_ghmc_matches_jax(weighted):
    logits, labels, label_w, *_ = ghm_case()
    args = (logits, labels) + ((label_w, ) if weighted else ())
    want = j_loss(GHM_CLS, *args)
    assert_rel(t_loss(GHM_CLS, *args), want)
    # a one-hot target is the labels' (the background and -1 rows zero)
    onehot = np.eye(logits.shape[1] + 1, dtype=np.float32)[
        np.where(labels < 0, logits.shape[1], np.minimum(
            labels, logits.shape[1]))][:, :-1]
    assert_rel(t_loss(GHM_CLS, logits, onehot, *args[2:]), want)


@pytest.mark.parametrize('weighted', (False, True))
def test_ghmr_matches_jax(weighted):
    _, _, _, pred, target, box_w = ghm_case()
    args = (pred, target) + ((box_w, ) if weighted else ())
    assert_rel(t_loss(GHM_REG, *args), j_loss(GHM_REG, *args))


def test_ghm_divides_by_bins_not_by_the_bins_that_hold_elements():
    """Every gradient norm of this case falls in bin 0 or bin 9 of 10: the
    loss is (mean loss of bin 0 + of bin 9) / 10, in JAX and in the port;
    mmdet's GHM-C divides by the 2 non-empty bins."""
    logits = np.array([[-9.0, 9.0], [-8.0, 7.0], [9.0, -9.0],
                       [8.5, -8.0]], np.float32)
    target = np.array([[0, 1], [0, 1], [0, 0], [0, 0]], np.float32)
    cfg = dict(type='GHMC', bins=10, loss_weight=1.0)
    g = np.abs(1 / (1 + np.exp(-logits)) - target)
    assert set(np.minimum((g * 10).astype(int), 9).ravel()) == {0, 9}
    bce = np.maximum(logits, 0) - logits * target + np.log1p(
        np.exp(-np.abs(logits)))
    low, high = g < 0.1, g >= 0.9
    bin_means = bce[low].mean() + bce[high].mean()
    want = j_loss(cfg, logits, target)
    assert_rel(want, bin_means / 10, 1e-5)
    assert_rel(t_loss(cfg, logits, target), want)
    assert abs(want - bin_means / 2) > 0.1 * want


def test_ghm_reads_no_weight_or_avg_factor():
    logits, labels, _, pred, target, box_w = ghm_case(seed=1)
    for cfg, args, w in ((GHM_CLS, (logits, labels), labels * 0.0),
                         (GHM_REG, (pred, target), box_w * 0.0)):
        plain = t_loss(cfg, *args)
        assert t_loss(cfg, *args, weight=torch.from_numpy(
            np.asarray(w, np.float32)), avg_factor=7.0) == plain
        assert_rel(plain, j_loss(cfg, *args, weight=w, avg_factor=7.0))


def test_ghmc_on_a_batch_is_the_flattened_loss():
    """(2, N, C) logits: the port's GHM-C is JAX's on the (2N, C) rows; the
    JAX loss broadcasts its default weights, ones((B,)), against (B, N,
    C) and fails (the JAX GHM RetinaNet trains at batch 1 only)."""
    logits, labels, *_ = ghm_case(seed=2, n=400)
    batched = (logits.reshape(2, 200, -1), labels.reshape(2, 200))
    got = t_loss(GHM_CLS, *batched)
    assert_rel(got, t_loss(GHM_CLS, logits, labels))
    assert_rel(got, j_loss(GHM_CLS, logits, labels))
    with pytest.raises(ValueError, match='broadcast'):
        j_loss(GHM_CLS, *batched)


def test_ghm_retina_head_losses_match_jax_at_batch_1():
    cfg = dict(retina_v1_cfg(), loss_cls=dict(GHM_CLS),
               loss_bbox=dict(GHM_REG))
    cfg.pop('anchor_generator')
    cfg.pop('bbox_coder')
    j_head, head, j_outs = retina_pair(cfg, seed=8)
    assert type(head.loss_cls).__name__ == 'GHMC'
    j_batch, t_batch = batches(b=1)
    one = tuple(tuple(x[:1] for x in part) for part in j_outs)
    sizes = [tuple(np.shape(c)[1:3]) for c in one[0]]
    want = jax.jit(lambda o, b: j_head.loss(o, b, sizes))(one, j_batch)
    got = head.loss(tuple(nchw(p) for p in one), t_batch, sizes)
    assert float(want['loss_bbox']) > 0
    assert_losses_close(got, want)
    # at batch 2 the port's losses are finite
    _, t_two = batches(b=2)
    two = head.loss(tuple(nchw(p) for p in j_outs), t_two, sizes)
    assert all(bool(torch.isfinite(v)) for v in two.values())


# ---- the configs ------------------------------------------------------------
@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    assert type(model).__name__ == cfg.model.type
    head = getattr(model, 'bbox_head', None)
    if 'ghm' in path:
        assert (type(head.loss_cls).__name__,
                type(head.loss_bbox).__name__) == ('GHMC', 'GHMR')
    elif 'retinanet' in path:
        assert isinstance(head.anchor_generator, LegacyAnchorGenerator)
    assert JConfig.fromfile(os.path.join(ROOT, path)).model.type == \
        cfg.model.type
