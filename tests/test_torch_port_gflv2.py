"""The port's GFocalV2 heads (GFocalHead, LDv2Head, IMv2Head) against the
JAX package on the same weights, and the LDv2 config's step as a whole.

Weights go port -> `convert_torch_state_dict` -> JAX (tests/
test_torch_port_bridge.py); inputs come from numpy seeds:
  * the head's three outputs on random FPN features (DGQP probability
    scores, box distributions, raw cls logits) within 5e-3 max abs and 2e-4
    median rel;
  * the loss dicts on identical head outputs, the LD heads with a random
    teacher tuple, to rtol 2e-4;
  * `get_bboxes`: the GFocalHead's probability scores decode without a
    second sigmoid, as in JAX, and so does a plain GFLHead whose
    QualityFocalLoss has use_sigmoid=False (same labels and valid mask,
    boxes and scores to 1e-4);
  * the LDv2 / IMv2 GI masks (raw teacher logits minus student
    probabilities, one NMS a level) identical;
  * `KnowledgeDistillationSingleStageDetector.forward_train` of
    configs/ldv2/ld_r50_gflv2_r101_fpn_1x.py with the student's and the
    teacher's depth set to 18, widths kept, term by term to rtol 2e-4.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as jax_build_detector
from ld_tpu.models.heads.gfl_head import flatten_levels as j_flatten
from ld_tpu.ops import anchor_center as j_anchor_center
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.testing import detection_batch_np
from test_torch_port_bridge import (HW, NUM_CLASSES, assert_dets_close,
                                    assert_losses_close, assert_outputs_close,
                                    bare_heads, batches, both_head_forward,
                                    fpn_feats, nchw, port_and_jax_head,
                                    port_outs, random_like, to_jax_variables)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LDV2_CFG = os.path.join(ROOT, 'configs/ldv2/ld_r50_gflv2_r101_fpn_1x.py')
GFOCAL = dict(type='GFocalHead', reg_topk=4, reg_channels=64, add_mean=True)
LD_ARMS = dict(loss_im=dict(type='IMLoss', loss_weight=2),
               imitation_method='gibox')


@pytest.fixture(scope='module')
def gfocal():
    """A GFocalV2 head in both packages and its outputs on random FPN
    features of a 2-image batch (cls prediction bias 0, so that the decode
    sees candidates)."""
    head, j_head, variables = port_and_jax_head(GFOCAL, seed=0)
    j_outs, t_outs = both_head_forward(head, j_head, variables,
                                       fpn_feats(seed=1))
    return dict(head=head, j_head=j_head, j_outs=j_outs, t_outs=t_outs)


def test_gfocal_forward_matches_jax(gfocal):
    assert len(gfocal['t_outs']) == 3
    assert_outputs_close(gfocal['j_outs'], gfocal['t_outs'])
    # the scores are probabilities: sigmoid(logits) x a quality in (0, 1)
    for score, logit in zip(gfocal['t_outs'][0], gfocal['t_outs'][2]):
        assert bool(((score > 0) & (score < torch.sigmoid(logit))).all())


def _teacher(j_outs, seed):
    """A random GFocalV2 teacher tuple: probabilities, box distributions
    and raw logits, NHWC."""
    rs = np.random.RandomState(seed)
    teacher = random_like(j_outs, seed)
    return (tuple(jnp.asarray(rs.uniform(0.01, 0.99, np.shape(a))
                              .astype(np.float32)) for a in j_outs[0]),
            ) + teacher[1:]


@pytest.mark.parametrize('head', ['GFocalHead', 'LDv2Head', 'IMv2Head'])
def test_gflv2_loss_dicts_match_jax(gfocal, head):
    """On identical head outputs; the LD heads against a random teacher
    (their GI arm: the mask test below and the detector test)."""
    j_outs = gfocal['j_outs']
    j_head, t_head = bare_heads(dict(GFOCAL, type=head))
    j_batch, t_batch = batches()
    j_sizes = [a.shape[1:3] for a in j_outs[0]]
    t_sizes = [tuple(s) for s in j_sizes]
    if head == 'GFocalHead':
        want = jax.jit(lambda o: j_head.loss(o, j_batch, j_sizes))(j_outs)
        got = t_head.loss(port_outs(j_outs), t_batch, t_sizes)
    else:
        teacher = _teacher(j_outs, seed=7)
        want = jax.jit(lambda o, t: j_head.loss(o, j_batch, j_sizes, t))(
            j_outs, teacher)
        got = t_head.loss(port_outs(j_outs), t_batch, t_sizes,
                          port_outs(teacher))
        assert float(got['loss_kd']) > 0 and float(got['loss_ld_vlr']) > 0
    if head == 'IMv2Head':
        assert float(got['loss_dfl']) == 0.0
    assert_losses_close(got, want)


def test_gfocal_get_bboxes_matches_jax(gfocal):
    """The DGQP scores are probabilities: the decode applies no sigmoid
    (a second one lifts every score above 0.5 and past score_thr)."""
    j_outs, j_head = gfocal['j_outs'], gfocal['j_head']
    img_hw = np.array([[60, 90], [64, 70]], np.float32)
    sf = np.array([[1.5, 1.25, 1.5, 1.25], [0.5, 0.5, 0.5, 0.5]], np.float32)
    want = jax.jit(lambda o: j_head.get_bboxes(
        o, jnp.asarray(img_hw), jnp.asarray(sf), rescale=True))(j_outs)
    got = gfocal['head'].get_bboxes(port_outs(j_outs),
                                    torch.from_numpy(img_hw),
                                    torch.from_numpy(sf), rescale=True)
    assert_dets_close(got, want)
    assert float(got[0][..., 4].max()) < 0.5


def test_gfl_head_without_sigmoid_decodes_as_jax():
    """A plain GFLHead whose QualityFocalLoss has use_sigmoid=False takes
    its cls maps as probabilities, in JAX and in the port."""
    head_cfg = dict(type='GFLHead', loss_cls=dict(
        type='QualityFocalLoss', use_sigmoid=False, beta=2.0,
        loss_weight=1.0))
    j_head, t_head = bare_heads(head_cfg)
    assert not t_head.use_sigmoid_cls
    rs = np.random.RandomState(11)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    cls = [rs.uniform(0, 0.3, (2, h, w, NUM_CLASSES)).astype(np.float32)
           for h, w in sizes]
    reg = [rs.randn(2, h, w, 68).astype(np.float32) for h, w in sizes]
    img_hw = np.array([[64, 96], [50, 80]], np.float32)
    want = jax.jit(lambda c, r: j_head.get_bboxes((c, r), jnp.asarray(
        img_hw)))([jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg])
    got = t_head.get_bboxes((nchw(cls), nchw(reg)), torch.from_numpy(img_hw))
    assert_dets_close(got, want)
    assert float(got[0][..., 4].max()) <= 0.3


def _jax_gi_masks(head, outs, soft_label, soft_target):
    """The JAX LDv2 head's GI mask of each level, as its `_imitation_loss`
    computes them."""
    cls_flat, pred_flat = j_flatten(outs[0]), j_flatten(outs[1])
    soft_label, soft_target = j_flatten(soft_label), j_flatten(soft_target)
    anchors, num_lvl, _, _ = head.level_geometry(
        [c.shape[1:3] for c in outs[0]])
    b, masks, lo = cls_flat.shape[0], [], 0
    for lvl, n in enumerate(num_lvl):
        hi = lo + n
        centers = jnp.tile(j_anchor_center(anchors[lo:hi]) /
                           head.anchor_generator.strides[lvl][0], (b, 1))
        masks.append((head._gi_mask(
            cls_flat[:, lo:hi].reshape(-1, head.cls_out_channels),
            soft_label[:, lo:hi].reshape(-1, head.cls_out_channels),
            pred_flat[:, lo:hi].reshape(-1, pred_flat.shape[-1]),
            soft_target[:, lo:hi].reshape(-1, pred_flat.shape[-1]),
            centers, gi_candidates=head.gi_candidates, gi_top=head.gi_top)))
        lo = hi
    return masks


@pytest.mark.parametrize('head', ['LDv2Head', 'IMv2Head'])
def test_gflv2_gi_masks_match_jax(gfocal, head):
    """The GI score is the teacher's raw logits minus the student's
    probabilities, with no sigmoid (a reference quirk kept for parity)."""
    j_outs = gfocal['j_outs']
    j_head, t_head = bare_heads(dict(GFOCAL, type=head, **LD_ARMS))
    teacher = _teacher(j_outs, seed=8)
    want = jax.jit(lambda o, t: _jax_gi_masks(j_head, o, t[2], t[1]))(
        j_outs, teacher)
    got = t_head.gi_masks(port_outs(j_outs), port_outs(teacher))
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert 0 < g.sum() <= t_head.gi_top
    # a sigmoid on either side would pick other regions
    z = t_head.gi_scores(torch.zeros(1, 1), torch.full((1, 1), 3.0))
    assert float(z) == 3.0


def _r18(model_cfg):
    """An LDv2 model config at depth 18, widths kept."""
    model_cfg['backbone']['depth'] = 18
    model_cfg['neck']['in_channels'] = [64, 128, 256, 512]
    return model_cfg


def _ldv2_cfg(package_config):
    cfg = package_config.fromfile(LDV2_CFG)
    teacher = package_config.fromfile(os.path.join(
        ROOT, cfg.model.teacher_config))
    _r18(cfg.model)
    cfg.model.teacher_config = dict(model=_r18(copy.deepcopy(
        dict(teacher.model))))
    return cfg


def test_ldv2_detector_forward_train_matches_jax():
    """The slice as a whole: the LDv2 config's KD detector (GFocalV2
    teacher -> LDv2 student, VLR, raw-logit KD, GI imitation) on the same
    weights and batch, the networks and the loss jitted apart."""
    cfg = _ldv2_cfg(Config)
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    det = jax_build_detector(_ldv2_cfg(JConfig).model)
    shape = (1, ) + HW + (3, )
    variables = to_jax_variables(model, det, shape)
    t_vars = to_jax_variables(model.teacher, det.teacher, shape)

    np_batch = detection_batch_np(2, *HW, num_classes=80, max_gts=8, seed=5)
    j_batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    j_batch['image'] = jnp.asarray(np_batch['image'].transpose(0, 2, 3, 1))
    outs, feats = jax.jit(lambda v: det.apply(
        v, j_batch['image'], train=True, output_features=True))(variables)
    t_outs, t_feats = jax.jit(lambda v: det.teacher.apply(
        v, j_batch['image'], output_features=True))(t_vars)
    want = jax.jit(lambda o, f, to, tf: det.bbox_head.loss(
        o, j_batch, [c.shape[1:3] for c in o[0]], tuple(to),
        student_feats=f, teacher_feats=tf))(outs, feats, t_outs, t_feats)

    got = model.train().forward_train(
        {k: torch.from_numpy(v) for k, v in np_batch.items()})
    assert float(got['loss_im'].detach()) > 0
    assert_losses_close(got, want)
