"""The port's SABL family (the bucketing coder, the SABL RetinaNet head, the
SABL Faster R-CNN and Cascade R-CNN RoI heads) against the JAX package on
the same weights and inputs, and the SABL configs.

Weights go JAX -> port (`state_dict_from_jax`): neither package's
converter has a SABL rule (ROADMAP.md caveat 58, asserted). The heads run at
width 64 (the RoI nets' reg branch at 32 with one reg FC of 16 a branch, so
that every mapped tensor counts), 4 classes; the detectors at R18 on a
2x3x64x96 batch of G = 4 gts, the last one padding, with samplers that pick
every candidate (num past the count, pos_fraction 1), so that the random
order cannot matter. The Faster and the Cascade detector share one backbone,
FPN and RPN: the JAX side is one Faster program (features, proposals,
detections, loss dict) and the cascade's RoI head on its features. Float32
on the CPU:
  * `BucketingBBoxCoder`: the encode of boxes whose gt sides lie midway
    between two bucket centres (equal |offsets|: the lower bucket, as the
    stable `jnp.argsort`) and of zero-size rois (finite), labels and weights
    identical, offsets within 1e-5; the decode of bucket logits tied at the
    top, adjacent and apart (the lower index first, as `lax.top_k`): the
    chosen buckets identical, boxes and confidence within 1e-4;
  * the SABL RetinaNet head: outputs within 1e-5 of each output's largest,
    losses on the JAX outputs to rtol 2e-4, the summed losses' gradient for
    each output within 1e-4 of the largest, detections within 1e-4;
  * the SABL RoI heads on the JAX features and proposals: `forward_train`'s
    losses to rtol 2e-4, `simple_test`'s detections within 1e-4 (as sets of
    equal scores);
  * the two detectors end to end: loss dicts to rtol 1e-3, `forward_test`
    within 5e-3;
  * every config of configs/sabl/ builds on the meta device.

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
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.ops.coder import build_coder as j_build_coder
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads import (CascadeSABLRoIHead, SABLRetinaHead,
                                       SABLRoIHead)
from ld_tpu_torch.models.heads.sabl_roi_head import SABLBBoxHead
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import (HEAD_KW, TEST_CFG, assert_losses_close,
                                    fill_tree, fpn_feats, nchw)
from test_torch_port_paa_fsaf_freeanchor import (assert_dets_close,
                                                 assert_levels_close,
                                                 gt_batches, numpy_tree)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/sabl/*.py')))
SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
GRAD_RTOL = 1e-4
RETINA_CFG = dict(type='SABLRetinaHead', **HEAD_KW,
                  test_cfg=dict(TEST_CFG, nms_pre=60))
ALL = dict(num=10**6, pos_fraction=1.0)
SABL_HEAD = dict(type='SABLHead', num_classes=4, in_channels=64,
                 cls_out_channels=64, reg_in_channels=32, num_reg_fcs=1,
                 reg_offset_out_channels=16, reg_cls_out_channels=16)
TEST_TWO = dict(rpn=dict(nms_pre=200, max_per_img=150,
                         nms=dict(iou_threshold=0.7)),
                rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                          max_per_img=100))


def two_stage_cfg(cascade):
    """SABL Faster (or Cascade) R-CNN at R18, FPN and RPN width 64."""
    rcnn = dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.5,
                              neg_iou_thr=0.5, min_pos_iou=0.5),
                sampler=ALL)
    roi = dict(type='StandardRoIHead', bbox_head=dict(SABL_HEAD),
               bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32]))
    if cascade:
        roi.update(type='CascadeRoIHead',
                   bbox_head=[dict(SABL_HEAD) for _ in range(3)])
        rcnn = [dict(rcnn, assigner=dict(rcnn['assigner'], pos_iou_thr=t,
                                         neg_iou_thr=t, min_pos_iou=t))
                for t in (0.5, 0.6, 0.7)]
    return dict(
        type='CascadeRCNN' if cascade else 'FasterRCNN',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      norm_eval=True, style='pytorch'),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=roi,
        train_cfg=dict(rpn=dict(sampler=ALL), rcnn=rcnn),
        test_cfg=copy.deepcopy(TEST_TWO))


def tied_coder_case():
    """Proposals, gts and bucket predictions with ties (14 buckets, scale
    1): a 28-px proposal has buckets 2 px wide with centres 1, 3, 5, ...
    from each side, so a gt side 4 px in lies midway between two centres;
    a zero-size roi; bucket logits tied at the top, adjacent (side 0) and
    two apart (side 2)."""
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 60, (40, 2))
    props = np.concatenate([xy, xy + rs.uniform(4, 40, (40, 2))],
                           -1).astype(np.float32)
    props[0] = [0., 0., 28., 28.]
    props[1] = [10., 10., 10., 10.]
    gts = (props + rs.uniform(-6, 6, (40, 4))).astype(np.float32)
    gts[0] = [4., 6., 24., 22.]
    cls = rs.randn(40, 28).astype(np.float32)
    cls[0, 2] = cls[0, 3] = 9.0
    cls[0, 14 + 1] = cls[0, 14 + 3] = 9.0
    cls[5, 7 + 4] = cls[5, 7 + 5] = 9.0
    offs = (rs.randn(40, 28) * 0.5).astype(np.float32)
    return props, gts, cls, offs


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against; numpy trees and
    outputs."""
    out = {}
    jobs = {}
    j_batch, t_batch = gt_batches()

    # the coder
    props, gts, cls, offs = tied_coder_case()
    coder = j_build_coder(dict(type='BucketingBBoxCoder', num_buckets=14,
                               scale_factor=1.0))
    hw = jnp.asarray([60.0, 90.0])
    jobs['coder'] = (lambda p, g, c, o: (coder.encode(p, g), coder.decode(
        p, (c, o), max_shape=hw)), (props, gts, cls, offs))

    # the SABL RetinaNet head
    head = JAX_HEADS.build(dict(RETINA_CFG))
    feats = [jnp.asarray(f) for f in fpn_feats(seed=4)]
    rv = out['retina'] = fill_tree(jax.eval_shape(
        lambda: head.net.init(jax.random.PRNGKey(0), feats)), seed=8)

    def retina_run(v, feats, b):
        outs = head.net.apply(v, feats)
        return (outs, head.loss(outs, b, SIZES),
                jax.grad(lambda o: sum(head.loss(o, b, SIZES).values()))(
                    outs),
                head.get_bboxes(outs, b['img_hw']))
    jobs['retina'] = (retina_run, (rv, feats, j_batch))

    # the two detectors: one backbone, FPN and RPN
    det = j_build_detector(two_stage_cfg(False))
    cdet = j_build_detector(two_stage_cfg(True))
    dv = out['faster'] = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=9)
    croi = fill_tree(jax.eval_shape(lambda: cdet.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3)))['params']['roi_head'],
        seed=10)
    out['cascade'] = dict(dv, params=dict(dv['params'], roi_head=croi))

    def faster_run(v, b):
        feats, rpn_outs, roi_vars = det.extract(v, b['image'])
        props, valid = det.rpn_head.get_proposals(rpn_outs, b['img_hw'])
        # the RoI head's losses are those of `forward_train`: its
        # proposals are these (no `rpn_proposal` config) and the sampler
        # takes every candidate
        return (feats, props, valid,
                det.roi_head.simple_test(roi_vars, list(feats), props, valid,
                                         b['img_hw']),
                det.forward_train(v, b, rng=jax.random.PRNGKey(5)))
    jobs['faster'] = (faster_run, (dv, j_batch))
    shapes = jax.eval_shape(faster_run, dv, j_batch)[:3]

    def cascade_run(roi_vars, feats, props, valid, b):
        return (cdet.roi_head.simple_test(roi_vars, list(feats), props,
                                          valid, b['img_hw']),
                cdet.roi_head.forward_train(roi_vars, list(feats), props,
                                            valid, b,
                                            rng=jax.random.PRNGKey(5)))
    jobs['cascade'] = (cascade_run, ({'params': croi}, ) + tuple(shapes) +
                       (j_batch, ))

    o0 = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(len(jobs)) as pool:
        # each compiles while the next is traced
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=o0)
                   for k, (fn, args) in jobs.items()}
    for k in ('coder', 'retina', 'faster'):
        out[f'{k}_out'] = futures[k].result()(*jobs[k][1])
    feats, props, valid = out['faster_out'][:3]
    out['cascade_out'] = futures['cascade'].result()(
        {'params': croi}, feats, props, valid, j_batch)
    return dict(numpy_tree(out), t_batch=t_batch)


def assert_dets_match(got, want, atol=1e-4):
    """The same valid mask, and in each image the same detections within
    `atol` as multisets of (score, label, box): at random weights rois
    clipped to the image's edge pool the same clamped samples and score
    alike, so equal scores with different boxes may leave the top-k in
    either order (ROADMAP.md caveat 2)."""
    dets, labels, ok = (np.asarray(a) for a in want)
    assert ok.sum() > 0
    np.testing.assert_array_equal(got[2].numpy(), ok)
    for i in range(ok.shape[0]):
        rows = []
        for d, lab in ((got[0][i].numpy(), got[1][i].numpy()),
                       (dets[i], labels[i])):
            d, lab = d[ok[i]], lab[ok[i]]
            key = np.lexsort((d[:, 3].round(2), d[:, 2].round(2),
                              d[:, 1].round(2), d[:, 0].round(2), lab,
                              -d[:, 4].round(5)))
            rows.append((d[key], lab[key]))
        np.testing.assert_array_equal(rows[0][1], rows[1][1])
        np.testing.assert_allclose(rows[0][0], rows[1][0], rtol=0,
                                   atol=atol)


def port_retina(variables):
    head = HEADS.build(dict(RETINA_CFG))
    keys = ['bbox_head.' + k for k in head.state_dict()]
    sd = state_dict_from_jax({coll: {'head_net': tree}
                              for coll, tree in variables.items()}, keys)
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in sd.items()},
                         strict=True)
    return head.eval()


def port_detector(kind, ref):
    model = build_detector(two_stage_cfg(kind == 'cascade'))
    model.load_state_dict(state_dict_from_jax(ref[kind],
                                              list(model.state_dict())),
                          strict=True)
    return model


# ---- the coder --------------------------------------------------------------
def test_bucketing_coder_matches_jax_on_ties(ref):
    props, gts, cls, offs = tied_coder_case()
    c = build_coder(dict(type='BucketingBBoxCoder', num_buckets=14,
                         scale_factor=1.0))
    (w_offs, w_off_w, w_lab, w_cls_w), (w_boxes, w_conf) = ref['coder_out']
    offsets, off_w, labels, cls_w = c.encode(torch.from_numpy(props),
                                             torch.from_numpy(gts))
    np.testing.assert_allclose(offsets.numpy(), w_offs, rtol=1e-5, atol=1e-5)
    for got, want in ((off_w, w_off_w), (labels, w_lab), (cls_w, w_cls_w)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(offsets.numpy()).all()
    # the tie: gt x1 = 4 is 1.5 and 0.5 buckets from the first three left
    # centres (1, 3, 5): buckets 1 and 2 tie at 0.5, the lower one wins
    assert labels[0, :7].argmax() == 1 and off_w[0, :7].tolist() == \
        [0, 1, 1, 0, 0, 0, 0]
    boxes, conf = c.decode(torch.from_numpy(props),
                           (torch.from_numpy(cls), torch.from_numpy(offs)),
                           max_shape=torch.tensor([60.0, 90.0]))
    np.testing.assert_allclose(boxes.numpy(), w_boxes, rtol=0, atol=1e-4)
    np.testing.assert_allclose(conf.numpy(), w_conf, rtol=0, atol=1e-5)
    assert boxes[..., 2].max() <= 89.0 and boxes[..., 3].max() <= 59.0
    # side 0's top two tie adjacent (both count), side 2's two apart (the
    # top one alone), each with the lower index first
    vals, idx = torch.softmax(torch.from_numpy(cls[0]).reshape(4, 7),
                              -1).sort(dim=-1, descending=True, stable=True)
    assert idx[0, :2].tolist() == [2, 3] and idx[2, :2].tolist() == [1, 3]
    expect = sum(float(vals[i, 0]) + float(vals[i, 1]) * float(
        abs(int(idx[i, 0]) - int(idx[i, 1])) == 1) for i in range(4)) / 4
    assert abs(float(conf[0]) - expect) < 1e-6


# ---- the SABL RetinaNet head ------------------------------------------------
def test_retina_head_outputs_losses_and_gradients_match_jax(ref):
    head = port_retina(ref['retina'])
    j_outs, want, j_grads, _ = ref['retina_out']
    with torch.no_grad():
        got = head(nchw(fpn_feats(seed=4)))
    for g, w in zip(got, j_outs):
        assert_levels_close(g, w)
    outs = tuple([t.requires_grad_() for t in nchw(part)] for part in j_outs)
    losses = head.loss(outs, ref['t_batch'], SIZES)
    assert_losses_close(losses, want)
    assert all(float(v) > 0 for v in losses.values())
    sum(losses.values()).backward()
    for part, j_part in zip(outs, j_grads):
        bound = GRAD_RTOL * max(np.abs(np.asarray(x)).max() for x in j_part)
        for t, w in zip(part, j_part):
            assert np.abs(t.grad.numpy().transpose(0, 2, 3, 1) -
                          np.asarray(w)).max() <= bound


def test_retina_head_detections_match_jax(ref):
    head = port_retina(ref['retina'])
    j_outs, _, _, want = ref['retina_out']
    got = head.get_bboxes(tuple(nchw(p) for p in j_outs),
                          ref['t_batch']['img_hw'])
    assert_dets_close(got, want, 1e-4)


def test_retina_head_names_and_converter_gap(ref):
    head = port_retina(ref['retina'])
    names = set(head.state_dict())
    for name in ('cls_convs.1.conv.weight', 'reg_convs.0.conv.bias',
                 'retina_cls.weight', 'retina_bbox_cls.weight',
                 'retina_bbox_reg.bias'):
        assert name in names
    conv = convert_torch_state_dict({f'bbox_head.{k}': v.numpy()
                                     for k, v in head.state_dict().items()})
    assert 'bbox_head.retina_bbox_cls.weight' in conv['_unmapped']


# ---- the SABL RoI heads -----------------------------------------------------
@pytest.mark.parametrize('kind', ('faster', 'cascade'))
def test_roi_head_train_and_test_match_jax(ref, kind):
    model = port_detector(kind, ref)
    feats, props, valid = ref['faster_out'][:3]
    if kind == 'faster':
        want_dets, want_losses = ref['faster_out'][3], {
            k: v for k, v in ref['faster_out'][4].items()
            if not k.startswith('loss_rpn')}
    else:
        want_dets, want_losses = ref['cascade_out']
    roi_head = model.roi_head
    assert type(roi_head) is (SABLRoIHead if kind == 'faster'
                              else CascadeSABLRoIHead)
    t_feats = nchw(feats)
    t_props, t_valid = (torch.from_numpy(np.array(a)) for a in (props, valid))
    got = roi_head.forward_train(t_feats, t_props, t_valid, ref['t_batch'],
                                 torch.Generator().manual_seed(0))
    assert_losses_close(got, want_losses)
    assert all(float(v) > 0 for v in got.values())
    with torch.no_grad():
        dets = roi_head.simple_test(t_feats, t_props, t_valid,
                                    ref['t_batch']['img_hw'])
    assert_dets_match(dets, want_dets)


@pytest.mark.parametrize('kind', ('faster', 'cascade'))
def test_detector_end_to_end_matches_jax(ref, kind):
    model = port_detector(kind, ref)
    batch = ref['t_batch']
    model.eval()
    with torch.no_grad():
        dets = model.forward_test(batch)
    want = ref['faster_out'][3] if kind == 'faster' else \
        ref['cascade_out'][0]
    assert_dets_match(dets, want, atol=5e-3)
    model.train()
    with torch.no_grad():
        losses = model.forward_train(batch, torch.Generator().manual_seed(0))
    want = dict(ref['faster_out'][4])
    if kind == 'cascade':
        want = dict({k: v for k, v in want.items()
                     if k.startswith('loss_rpn')}, **ref['cascade_out'][1])
    assert_losses_close(losses, want, rtol=1e-3)


def test_sabl_bbox_head_names_and_converter_gap(ref):
    model = port_detector('cascade', ref)
    head = model.roi_head.bbox_head[2]
    assert isinstance(head, SABLBBoxHead)
    names = set(head.state_dict())
    for name in ('cls_fcs.0.weight', 'fc_cls.bias', 'reg_pre_convs.1.conv.'
                 'weight', 'reg_conv_att_x.weight', 'reg_post_conv_ys.0.conv.'
                 'weight', 'upsample_x.weight', 'reg_offset_fcs.0.weight',
                 'reg_cls_fcs.0.bias', 'fc_reg_offset.weight',
                 'fc_reg_cls.weight'):
        assert name in names, name
    assert tuple(head.reg_post_conv_xs[0].conv.weight.shape) == (32, 32, 1, 3)
    assert [c.scale_factor for c in model.roi_head.coders] == [1.7, 1.5, 1.3]
    conv = convert_torch_state_dict({
        f'roi_head.{k}': v.numpy()
        for k, v in model.roi_head.state_dict().items()})
    assert 'roi_head.bbox_head.0.upsample_x.weight' in conv['_unmapped']


def test_sabl_retina_norm_cfg_is_not_read():
    """ROADMAP.md caveat 57: the GN configs' `norm_cfg` is read by
    neither package: the same plain towers (the same names and shapes),
    and the port warns."""
    plain, gn = (Config.fromfile(os.path.join(ROOT, 'configs/sabl', name))
                 for name in ('sabl_retinanet_r50_fpn_1x_coco.py',
                              'sabl_retinanet_r50_fpn_gn_1x_coco.py'))
    assert gn.model.bbox_head.norm_cfg['type'] == 'GN'
    with torch.device('meta'):
        a = HEADS.build(dict(plain.model.bbox_head))
        with pytest.warns(UserWarning, match='caveat 57'):
            b = HEADS.build(dict(gn.model.bbox_head))
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    j_plain = JAX_HEADS.build(dict(plain.model.bbox_head))
    j_gn = JAX_HEADS.build(dict(gn.model.bbox_head))
    feats = [jax.ShapeDtypeStruct((1, 8, 8, 256), jnp.float32)]
    trees = [jax.eval_shape(lambda f, h=h: h.net.init(
        jax.random.PRNGKey(0), f), feats) for h in (j_plain, j_gn)]
    assert jax.tree_util.tree_structure(trees[0]) == \
        jax.tree_util.tree_structure(trees[1])


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_sabl_configs_build(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    if 'retinanet' in path:
        head = model.bbox_head
        assert type(model).__name__ == 'RetinaNet'
        assert isinstance(head, SABLRetinaHead)
        assert head.side_num == 7 and head.coder.scale_factor == 3.0
        assert head.approxs_per_loc == 9
        return
    roi = model.roi_head
    if 'cascade' in path:
        assert type(model).__name__ == 'CascadeRCNN'
        assert isinstance(roi, CascadeSABLRoIHead)
        assert [c.scale_factor for c in roi.coders] == [1.7, 1.5, 1.3]
        assert len(roi.bbox_head) == 3
        assert roi.bbox_head[0].fc_cls.in_features == 1024
    else:
        assert type(model).__name__ == 'FasterRCNN'
        assert isinstance(roi, SABLRoIHead)
        assert roi.coder.scale_factor == 1.7
        assert roi.bbox_head.cls_fcs[0].out_features == 1024
        assert roi.bbox_head.upsample_x.out_channels == 256
