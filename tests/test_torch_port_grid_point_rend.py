"""The port's Grid R-CNN and PointRend RoI heads against the JAX package on
the same weights and inputs, and the configs of configs/grid_rcnn/ and
point_rend/.

Weights go JAX -> port (`state_dict_from_jax`): the JAX converter has no
rule for the grid net or the point MLP (asserted). The RoI heads run at
width 64 (a grid net of width 32, a point MLP of width 32), 4 classes, on
random FPN features at strides 4-32 of a 2x3x64x96 batch of G = 4 gts
(the last one padding) and proposals around the gts, with a sampler that
picks every candidate (num past the count, pos_fraction 1), so that
neither the random order nor the second draw of each head can matter.
Float32 on the CPU:
  * `whiskered` and `bilinear_points` (at corners, edges and outside the
    map) within 1e-6; PointRend's point indices on untied logits
    identical, on tied ones the lower index first, as `lax.top_k`;
  * the Grid RoI head: the loss dict (`loss_grid` too) to rtol 2e-4, the
    refined detections within 1e-4 (as multisets of equal scores); a box
    rebuilt from hand-made heatmaps; the `GridRCNN` detector through
    `forward_test` and `forward_train`;
  * the PointRend RoI head: the loss dict with `loss_mask` and
    `loss_point` to rtol 2e-4, and its test (coarse masks only, as the JAX
    head) with masks within 1e-4;
  * Grid R-CNN R50 at full width on the meta device: names and shapes are
    `state_dict_from_jax` of the JAX `jax.eval_shape` tree;
  * every config of the two folders builds, and so does the GRoIE Grid
    config (its grid extractor a `GenericRoIExtractor`).

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
from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.models.heads.grid_point_roi import _bilinear_points, _whiskered
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads import (GridRoIHead, PointRendRoIHead,
                                       StandardRoIHead)
from ld_tpu_torch.models.heads.grid_point_roi import (bilinear_points,
                                                      whiskered)
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import assert_losses_close, fill_tree, nchw
from test_torch_port_ms_rcnn_resnest import fpn_features, gt_masks, proposals
from test_torch_port_paa_fsaf_freeanchor import gt_batches, numpy_tree
from test_torch_port_sabl import assert_dets_match
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for g in ('grid_rcnn',
                                                     'point_rend')
                 for p in glob.glob(os.path.join(ROOT, 'configs', g, '*.py')))
ALL = dict(num=10**6, pos_fraction=1.0)
TEST_TWO = dict(rpn=dict(nms_pre=200, max_per_img=32,
                         nms=dict(iou_threshold=0.7)),
                rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                          max_per_img=40))


def det_cfg(kind):
    """Grid R-CNN or PointRend at R18, width 64, 4 classes."""
    roi = dict(bbox_head=dict(num_classes=4, in_channels=64,
                              fc_out_channels=64),
               bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32]))
    if kind == 'grid':
        roi.update(type='GridRoIHead',
                   grid_head=dict(grid_points=9, conv_out_channels=32))
    else:
        roi.update(type='PointRendRoIHead',
                   mask_head=dict(num_convs=1, in_channels=64,
                                  conv_out_channels=64),
                   point_head=dict(num_points=196, fc_channels=32))
    return dict(
        type='GridRCNN' if kind == 'grid' else 'PointRend',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      norm_eval=True, style='pytorch'),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=roi,
        train_cfg=dict(rpn=dict(sampler=ALL), rcnn=dict(sampler=ALL)),
        test_cfg=copy.deepcopy(TEST_TWO))


def untied_logits(seed=0):
    """(5, 28, 28) coarse logits, every |value| distinct, and a copy with
    runs of equal |value| (+-x pairs and repeats) across the cut."""
    rs = np.random.RandomState(seed)
    untied = rs.permutation(5 * 784).reshape(5, 28, 28).astype(np.float32)
    untied = (untied - 1960.0) * 1e-3 + 5e-4
    tied = np.round(rs.randn(5, 28, 28) * 4).astype(np.float32) / 8
    return untied, tied


@pytest.fixture(scope='module')
def ref():
    """The JAX RoI heads' trees (numpy) and their `simple_test` and
    `forward_train` on random FPN features and proposals."""
    out = {}
    j_batch, t_batch = gt_batches()
    masks = gt_masks(t_batch)
    j_mask_batch = dict(j_batch, gt_masks=jnp.asarray(masks, jnp.float32))
    feats = fpn_features()
    props, valid = proposals(t_batch)
    out['inputs'] = (feats, props, valid)

    def roi_run(det):
        def run(roi_vars, feats, props, valid, b):
            return (det.roi_head.simple_test(roi_vars, list(feats), props,
                                             valid, b['img_hw']),
                    det.roi_head.forward_train(roi_vars, list(feats), props,
                                               valid, b,
                                               rng=jax.random.PRNGKey(5)))
        return run

    jobs = {}
    for seed, kind in enumerate(('grid', 'point'), 11):
        det = j_build_detector(det_cfg(kind))
        tree = out[kind] = fill_tree(jax.eval_shape(
            lambda det=det: det.roi_head.init_all_variables(
                jax.random.PRNGKey(0), 64)), seed=seed)
        jobs[kind] = (roi_run(det), ({'params': tree}, feats, props, valid,
                                     j_mask_batch if kind == 'point'
                                     else j_batch))
    o0 = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=o0)
                   for k, (fn, args) in jobs.items()}
    for k, (_, args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*args)

    top_k = jax.jit(lambda x: jax.lax.top_k(-jnp.abs(x.reshape(5, -1)),
                                            196)[1])
    out['top_k'] = [top_k(x) for x in untied_logits()]
    return dict(numpy_tree(out), t_batch=t_batch,
                t_mask_batch=dict(t_batch, gt_masks=torch.from_numpy(masks)))


def port_roi_head(kind, ref):
    """The port's RoI head of `det_cfg(kind)` on the JAX tree."""
    cfg = det_cfg(kind)
    head = HEADS.build(dict(cfg['roi_head'], train_cfg=cfg['train_cfg'][
        'rcnn'], test_cfg=cfg['test_cfg']['rcnn']))
    keys = ['roi_head.' + k for k in head.state_dict()]
    # fc1's rows are permuted by the RPN's input width (the FPN's)
    rpn = {'rpn_conv': {'kernel': np.zeros((3, 3, 64, 64), np.float32)}}
    sd = {k: v for k, v in state_dict_from_jax({'params': {
        'roi_head': ref[kind], 'rpn_net': rpn}}, keys).items()
        if k.startswith('roi_head.')}
    assert sorted(sd) == sorted(keys)
    head.load_state_dict({k[len('roi_head.'):]: v for k, v in sd.items()},
                         strict=True)
    return head


def roi_inputs(ref):
    feats, props, valid = ref['inputs']
    return (nchw(feats), torch.from_numpy(np.array(props)),
            torch.from_numpy(np.array(valid)))


# ---- the point and box helpers ----------------------------------------------
def test_whiskered_and_bilinear_points_match_jax():
    rs = np.random.RandomState(1)
    boxes = rs.uniform(0, 50, (12, 4)).astype(np.float32)
    np.testing.assert_allclose(
        whiskered(torch.from_numpy(boxes), 0.25).numpy(),
        np.asarray(jax.jit(_whiskered, static_argnums=1)(boxes, 0.25)),
        rtol=0, atol=1e-5)
    fmap = rs.randn(3, 6, 7, 5).astype(np.float32)          # (R, H, W, C)
    u = rs.uniform(-1.5, 8.5, (3, 11)).astype(np.float32)
    v = rs.uniform(-1.5, 7.5, (3, 11)).astype(np.float32)
    u[:, :4] = [0.0, 6.0, 6.5, -0.5]
    v[:, :4] = [0.0, 5.0, 5.5, 3.0]
    want = np.asarray(jax.jit(jax.vmap(_bilinear_points))(fmap, u, v))
    got = bilinear_points(torch.from_numpy(fmap.transpose(0, 3, 1, 2)),
                          torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want,
                               rtol=0, atol=1e-6)


def test_point_indices_match_jax_top_k(ref):
    head = port_roi_head('point', ref)
    for logits, want in zip(untied_logits(), ref['top_k']):
        got = head.point_indices(torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)
    # the tied case has equal |logit| across the cut at 196: the lower
    # index goes first
    flat = np.abs(untied_logits()[1].reshape(5, -1))
    kth = np.sort(flat, 1)[:, 195]
    assert ((flat == kth[:, None]).sum(1) > 1).all()


# ---- Grid R-CNN -------------------------------------------------------------
def test_grid_roi_head_losses_and_refined_boxes_match_jax(ref):
    roi_head = port_roi_head('grid', ref)
    assert isinstance(roi_head, GridRoIHead)
    feats, props, valid = roi_inputs(ref)
    got = roi_head.forward_train(feats, props, valid, ref['t_batch'],
                                 torch.Generator().manual_seed(0))
    want = ref['grid_out'][1]
    assert 'loss_grid' in want
    assert_losses_close(got, want)
    assert all(float(v) > 0 for v in got.values())
    with torch.no_grad():
        dets = roi_head.simple_test(feats, props, valid,
                                    ref['t_batch']['img_hw'])
    assert_dets_match(dets, ref['grid_out'][0])


def test_grid_rcnn_detector_tests_and_trains():
    """`GridRCNN` wires the grid head through `forward_test` (rescaled) and
    `forward_train` (`loss_grid`)."""
    model = build_detector(det_cfg('grid'))
    model.init_weights(torch.Generator().manual_seed(0))
    _, batch = gt_batches()
    batch = dict(batch, scale_factor=torch.full((2, 4), 0.5))
    with torch.no_grad():
        dets, labels, valid = model.eval().forward_test(batch, rescale=True)
        losses = model.train().forward_train(
            batch, torch.Generator().manual_seed(0))
    assert dets.shape == (2, 40, 5) and bool(torch.isfinite(dets).all())
    assert 'loss_grid' in losses and all(
        bool(torch.isfinite(v)) for v in losses.values())


def test_grid_rebuilds_the_boxes(monkeypatch):
    """With each heatmap peaked at one cell, each edge is the centre of its
    border points' cells in the whisker-expanded box: the box is rebuilt,
    not the detection's own."""
    head = GridRoIHead(bbox_head=dict(num_classes=2, in_channels=8),
                       grid_head=dict(conv_out_channels=8, num_convs=1))
    heat = torch.full((1, 9, 56, 56), -10.0)
    for p in range(9):
        heat[0, p, 14 * (p // 3 + 1), 14 * (p % 3 + 1)] = 10.0
    dets = torch.tensor([[[0.0, 0.0, 56.0, 56.0, 0.9]]])
    monkeypatch.setattr(StandardRoIHead, 'simple_test', lambda *a, **k: (
        dets, torch.zeros(1, 1, dtype=torch.long),
        torch.ones(1, 1, dtype=torch.bool)))
    monkeypatch.setattr(head, '_grid_heat', lambda *a: heat)
    out = head.simple_test([], None, None, None)[0]
    # the whiskered box is (-14, -14, 70, 70): 84 px over 56 cells
    cell = (np.array([14, 28, 42]) + 0.5) / 56 * 84 - 14
    np.testing.assert_allclose(out[0, 0].numpy(),
                               [cell[0], cell[0], cell[2], cell[2], 0.9],
                               rtol=0, atol=1e-4)


# ---- PointRend --------------------------------------------------------------
def test_point_rend_losses_and_coarse_masks_match_jax(ref):
    roi_head = port_roi_head('point', ref)
    assert isinstance(roi_head, PointRendRoIHead)
    feats, props, valid = roi_inputs(ref)
    test_out, want = ref['point_out']
    assert {'loss_mask', 'loss_point'} <= set(want)
    got = roi_head.forward_train(feats, props, valid, ref['t_mask_batch'],
                                 torch.Generator().manual_seed(0))
    assert_losses_close(got, want)
    # without gt masks, neither mask loss (the configs load none)
    plain = roi_head.forward_train(feats, props, valid, ref['t_batch'],
                                   torch.Generator().manual_seed(0))
    assert sorted(plain) == ['loss_bbox', 'loss_cls']
    with torch.no_grad():
        dets = roi_head.simple_test(feats, props, valid,
                                    ref['t_batch']['img_hw'])
    assert len(dets) == len(test_out) == 4
    assert_dets_match(dets[:3], test_out[:3])
    ok = test_out[2]
    order = [np.lexsort((-d[:, 4].round(5), )) for d in test_out[0]]
    got_order = [np.lexsort((-d[:, 4].round(5), ))
                 for d in dets[0].numpy()]
    for i in range(ok.shape[0]):
        np.testing.assert_allclose(
            dets[3][i].numpy()[got_order[i]][ok[i][order[i]]],
            test_out[3][i][order[i]][ok[i][order[i]]], rtol=0, atol=1e-4)


def test_grid_point_names_and_converter_gap(ref):
    for kind, names in (('grid', ('grid_head.convs.7.gn.weight',
                                  'grid_head.deconv2.weight')),
                        ('point', ('point_head.fcs.2.conv.weight',
                                   'point_head.fc_logits.bias'))):
        roi = port_roi_head(kind, ref)
        keys = set(roi.state_dict())
        conv = convert_torch_state_dict({f'roi_head.{k}': v.numpy()
                                         for k, v in roi.state_dict()
                                         .items()})
        for name in names:
            assert name in keys
            assert f'roi_head.{name}' in conv['_unmapped']
    assert tuple(port_roi_head('point', ref).point_head.fcs[0]
                 .conv.weight.shape) == (32, 65, 1)


# ---- the configs ------------------------------------------------------------
@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    assert type(model).__name__ == cfg.model.type
    roi = model.roi_head
    if 'grid' in path:
        assert isinstance(roi, GridRoIHead)
        assert len(roi.grid_head.convs) == 8
        assert roi.grid_head.convs[0].conv.out_channels == 64
        assert not roi.with_test_masks
    else:
        assert isinstance(roi, PointRendRoIHead)
        assert roi.with_test_masks and roi.num_points == 196
        assert len(roi.mask_head.convs) == 4


def test_groie_grid_config_names_queue_a_item_4():
    """The GRoIE Grid R-CNN config (Queue A item 4) builds: its grid
    extractor is an all-level `GenericRoIExtractor`, and an unknown
    extractor type still raises."""
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/groie/grid_rcnn_r50_fpn_gn-head_groie_1x_coco.py'))
    with torch.device('meta'):
        model = build_detector(cfg.model)
    assert isinstance(model.roi_head, GridRoIHead)
    assert type(model.roi_head.grid_roi_extractor).__name__ == \
        'GenericRoIExtractor'
    assert model.roi_head.grid_roi_extractor.out_size == 14
    with pytest.raises(NotImplementedError):
        GridRoIHead(grid_roi_extractor=dict(type='SomeRoIExtractor'))


def test_grid_rcnn_full_width_names_and_shapes_match_jax():
    path = os.path.join(ROOT, 'configs/grid_rcnn/'
                        'grid_rcnn_r50_fpn_gn-head_1x_coco.py')
    det = j_build_detector(JConfig.fromfile(path).model)
    shapes = jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 64, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path).model)
    own = model.state_dict()
    sd = state_dict_from_jax(tree, own.keys())
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
