"""The port's classic one-stage heads (plain RetinaNet and its NAS-FPN
shared-conv / BN-a-level variant, FCOS, ATSS), their
box coder and L1 losses, against the JAX package on the same weights and
inputs.

Weights go JAX -> port: the JAX head's parameter tree (`jax.eval_shape` of
its init) is filled from a numpy seed (every kernel, bias, GN affine and
level scale and BN statistic random, DCN offsets non-zero) and carried by
`state_dict_from_jax` (the JAX converter has no plain-head names). A head
runs at width 64 (GN 32), 2 stacked convs, 4 classes, on random 64-channel
FPN features of a 2-image 64x96 batch, in float32:
  * head outputs within 1e-5 of each level's largest value (1e-3 on the
    1x1 top level, where GN normalises two values a group);
  * the loss dict on identical head outputs to rtol 2e-4 (the SepBN and
    the DCN-tower heads' loss and decode are the Retina and FCOS heads',
    held once);
  * `get_bboxes` on identical head outputs: the same kept set, labels and
    valid mask, boxes and scores within 1e-4;
  * `DeltaXYWHBBoxCoder` / `LegacyDeltaXYWHBBoxCoder` encode and decode,
    L1 / SmoothL1 values and gradients;
  * every config of configs/retinanet/, fcos/ and atss/ builds in the port
    (on the meta device), and the LD-FCOS configs that set `norm_on_bbox`
    give the losses of the same head without it.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.ops.coder import build_coder as j_build_coder
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu.utils.registry import LOSSES as JAX_LOSSES
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from test_torch_port_bridge import (HEAD_KW, TEST_CFG, assert_losses_close,
                                    batches, fill_tree, fpn_feats, nchw)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_IOU = dict(type='MaxIoUAssigner', pos_iou_thr=0.5, neg_iou_thr=0.4,
               min_pos_iou=0, ignore_iof_thr=-1)
# head outputs within 1e-5 of a level's largest value; on the 1x1 top
# level a GroupNorm normalises two values a group, which amplifies fp32
# rounding (7e-4 of the level's largest FCOS centerness logit): 1e-3 there
OUT_RTOL, OUT_TOP_RTOL = 1e-5, 1e-3
HEAD_CASES = {
    'retina': (dict(type='RetinaHead'), dict(assigner=MAX_IOU)),
    'fcos': (dict(type='FCOSHead', norm_on_bbox=True,
                  loss_bbox=dict(type='GIoULoss', loss_weight=1.0)), None),
    'fcos_dcn': (dict(type='FCOSHead', dcn_on_last_conv=True,
                      centerness_on_reg=False), None),
    'atss': (dict(type='ATSSHead'), None),
    'retina_sepbn': (dict(type='RetinaSepBNHead', num_ins=5),
                     dict(assigner=MAX_IOU)),
}


def jax_to_port_head(variables, head):
    """The JAX head net's variables -> the port head, strictly."""
    keys = [f'bbox_head.{k}' for k in head.state_dict()]
    sd = state_dict_from_jax({coll: {'head_net': tree}
                              for coll, tree in variables.items()}, keys)
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in sd.items()},
                         strict=True)
    return head


@pytest.fixture(scope='module')
def heads():
    """Per case, lazily: the JAX head, the port head with its weights, the
    JAX outputs on random FPN features and the port's."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        head_cfg, train_cfg = HEAD_CASES[name]
        cfg = dict(head_cfg, **HEAD_KW, train_cfg=train_cfg,
                   test_cfg=TEST_CFG)
        j_head, head = JAX_HEADS.build(dict(cfg)), HEADS.build(dict(cfg))
        feats = fpn_feats(seed=4)
        template = jax.eval_shape(lambda: j_head.net.init(
            jax.random.PRNGKey(0), [jnp.zeros(f.shape) for f in feats]))
        variables = fill_tree(dict(template), seed=7)
        params = variables['params']
        # prediction biases 0, so that the decode sees candidates
        for pred in ('retina_cls', 'conv_cls', 'atss_cls'):
            if pred in params:
                params[pred]['bias'] = np.zeros_like(params[pred]['bias'])
        head = jax_to_port_head(variables, head).eval()
        j_outs = jax.jit(j_head.net.apply)(variables,
                                           [jnp.asarray(f) for f in feats])
        with torch.no_grad():
            t_outs = head(nchw(feats))
        cache[name] = dict(j_head=j_head, head=head,
                           j_outs=tuple(tuple(p) for p in j_outs),
                           t_outs=t_outs)
        return cache[name]
    return get


@pytest.mark.parametrize('name', sorted(HEAD_CASES))
def test_head_outputs_match_jax(heads, name):
    h = heads(name)
    assert len(h['t_outs']) == (2 if 'retina' in name else 3)
    for j_part, t_part in zip(h['j_outs'], h['t_outs']):
        for j, t in zip(j_part, t_part):
            want = np.asarray(j)
            got = t.numpy().transpose(0, 2, 3, 1)
            assert got.shape == want.shape
            bound = OUT_RTOL if want.shape[1:3] != (1, 1) else OUT_TOP_RTOL
            diff = float(np.abs(got - want).max())
            assert diff <= bound * float(np.abs(want).max()), diff


# the SepBN head's loss and decode are the Retina head's own, the DCN
# tower's FCOS head's the plain one's: held once
DECODE_CASES = sorted(set(HEAD_CASES) - {'retina_sepbn', 'fcos_dcn'})


@pytest.mark.parametrize('name', DECODE_CASES)
def test_head_losses_match_jax(heads, name):
    h = heads(name)
    j_batch, t_batch = batches()
    sizes = [tuple(np.shape(c)[1:3]) for c in h['j_outs'][0]]
    want = jax.jit(lambda o, b: h['j_head'].loss(o, b, sizes))(
        h['j_outs'], j_batch)
    port_outs = tuple(nchw(p) for p in h['j_outs'])
    got = h['head'].loss(port_outs, t_batch, sizes)
    assert float(want['loss_bbox']) > 0
    assert_losses_close(got, want)


@pytest.mark.parametrize('name', DECODE_CASES)
def test_head_get_bboxes_match_jax(heads, name):
    h = heads(name)
    _, t_batch = batches()
    img_hw = t_batch['img_hw'].numpy()
    want = jax.jit(lambda o, hw: h['j_head'].get_bboxes(o, hw))(
        h['j_outs'], jnp.asarray(img_hw))
    got = h['head'].get_bboxes(tuple(nchw(p) for p in h['j_outs']),
                               torch.from_numpy(img_hw))
    dets, labels, valid = (np.asarray(a) for a in want)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), labels)
    np.testing.assert_allclose(got[0].numpy(), dets, rtol=0, atol=1e-4)


@pytest.mark.parametrize('coder', [
    dict(type='DeltaXYWHBBoxCoder', target_means=[0.1, -0.1, 0.0, 0.05],
         target_stds=[0.1, 0.1, 0.2, 0.2]),
    dict(type='LegacyDeltaXYWHBBoxCoder', target_stds=[0.1, 0.1, 0.2, 0.2]),
])
def test_coder_matches_jax(coder):
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 80, (2, 50, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(1, 40, (2, 50, 2))],
                           -1).astype(np.float32)
    gts = np.concatenate([xy + rs.uniform(-5, 5, (2, 50, 2)),
                          xy + rs.uniform(2, 60, (2, 50, 2))],
                         -1).astype(np.float32)
    deltas = rs.randn(2, 50, 4).astype(np.float32)
    hw = np.asarray([[64, 96], [60, 90]], np.float32)
    jc, tc = j_build_coder(coder), build_coder(coder)
    np.testing.assert_allclose(
        tc.encode(torch.from_numpy(boxes), torch.from_numpy(gts)).numpy(),
        np.asarray(jax.jit(jc.encode)(boxes, gts)), rtol=1e-6, atol=1e-6)
    got = tc.decode(torch.from_numpy(boxes), torch.from_numpy(deltas),
                    max_shape=torch.from_numpy(hw)).numpy()
    # the JAX decode takes one image's (h, w): vmapped over the images
    want = np.asarray(jax.jit(jax.vmap(lambda b, d, s: jc.decode(
        b, d, max_shape=s)))(boxes, deltas, hw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # the FSAF and SABL coders build (held against JAX in
    # test_torch_port_paa_fsaf_freeanchor.py and test_torch_port_sabl.py)
    assert type(build_coder(dict(type='TBLRBBoxCoder'))).__name__ == \
        'TBLRBBoxCoder'
    assert build_coder(dict(type='BucketingBBoxCoder')).side_num == 7


@pytest.mark.parametrize('loss', [dict(type='L1Loss', loss_weight=2.0),
                                  dict(type='SmoothL1Loss', beta=0.5,
                                       loss_weight=1.5)])
def test_l1_losses_match_jax(loss):
    rs = np.random.RandomState(1)
    pred, target = (rs.randn(64, 4).astype(np.float32) for _ in range(2))
    weight = (rs.rand(64, 4) > 0.3).astype(np.float32)
    j_fn, t_fn = JAX_LOSSES.build(dict(loss)), LOSSES.build(dict(loss))
    j_val, j_grad = jax.value_and_grad(
        lambda p: j_fn(p, jnp.asarray(target), weight=jnp.asarray(weight),
                       avg_factor=7.0))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    val = t_fn(p, torch.from_numpy(target), weight=torch.from_numpy(weight),
               avg_factor=7.0)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-6, atol=1e-8)
    # mean without avg_factor
    np.testing.assert_allclose(
        float(t_fn(torch.from_numpy(pred), torch.from_numpy(target))),
        float(j_fn(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)


CLASSIC_CONFIGS = sorted(
    os.path.relpath(p, ROOT) for d in ('retinanet', 'fcos', 'atss')
    for p in glob.glob(os.path.join(ROOT, 'configs', d, '*.py')))


@pytest.mark.parametrize('path', CLASSIC_CONFIGS)
def test_classic_config_builds(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    head = cfg.model.bbox_head
    assert type(model.bbox_head).__name__ == head.type
    if head.get('dcn_on_last_conv'):
        assert hasattr(model.bbox_head.cls_convs[-1].conv, 'conv_offset')


def test_norm_on_bbox_is_stored_and_not_read(heads):
    """The LD-FCOS configs' `norm_on_bbox` (ROADMAP.md caveat 17): stored,
    and the losses equal those of the same head without it."""
    for path in ('configs/ld/ld_r50_fcos_r101_1x.py',
                 'configs/gfl/fcos_gfl_r50_center.py'):
        cfg = Config.fromfile(os.path.join(ROOT, path))
        assert 'norm_on_bbox' in cfg.model.bbox_head
        with torch.device('meta'):
            assert build_detector(cfg.model).bbox_head.norm_on_bbox is \
                cfg.model.bbox_head.norm_on_bbox
    h = heads('fcos')
    cfg = dict(HEAD_CASES['fcos'][0], **HEAD_KW, test_cfg=TEST_CFG,
               norm_on_bbox=False)
    plain = HEADS.build(cfg)
    plain.load_state_dict(h['head'].state_dict())
    _, t_batch = batches()
    outs = tuple(nchw(p) for p in h['j_outs'])
    sizes = [tuple(c.shape[-2:]) for c in outs[0]]
    a, b = h['head'].loss(outs, t_batch, sizes), plain.loss(outs, t_batch,
                                                             sizes)
    assert {k: float(v) for k, v in a.items()} == \
        {k: float(v) for k, v in b.items()}


def test_sepbn_shared_convs_are_not_folded(heads):
    """The BN fold leaves a conv that one BN a level follows, so a folded
    RetinaSepBNHead computes what it did."""
    from ld_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
    head = heads('retina_sepbn')['head']
    x = nchw(fpn_feats(seed=5))
    with torch.no_grad():
        before = head(x)
        assert fuse_conv_bn(head) == 0
        after = head(x)
    for a, b in zip(before, after):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
