"""The port's GRoIE extractors and hard-mining samplers against the JAX
package on the same weights and inputs, and the configs of configs/groie/.

Weights go JAX -> port: `jax.eval_shape` of the JAX init, `fill_tree` from a
numpy seed (every `GeneralizedAttention` gate then set to 0.7, so that the
post module is far from the identity), `state_dict_from_jax` onto the
port's names. Float32 on the CPU:
  * `GeneralizedAttention` '0100' with `kv_stride=2` on odd 7x7 and on 14x14
    roi maps (a 3x3 and a 7x7 key grid): within 1e-5 of the largest output;
  * the OHEM and ScoreHLR samplers on the same injected uniform draws (the
    JAX module's `_uniform_keys` patched): identical selections, ScoreHLR's
    label weights within 1e-6;
  * the hard-mining RoI heads (OHEM, ScoreHLR) at width 64 on random FPN
    features and proposals: `forward_train`'s losses to rtol 1e-3, with
    samplers whose `num` is the candidate count (every candidate is picked,
    and ScoreHLR's weights still decay from 1 over the ranks); the
    preliminary pass's inputs (`hard_mining_extras`) against the JAX CE
    and scores;
  * GRoIE on the bbox and grid extractors of a Grid R-CNN RoI head:
    `forward_train` to rtol 1e-3 (`loss_grid` too);
  * a GRoIE Mask R-CNN (GRoIE on the bbox and mask extractors) at R18,
    width 64, on a 2x3x64x96 batch with gt masks end to end:
    `forward_train` to rtol 1e-3 (`loss_mask` too), `forward_test`'s
    detections and masks within 5e-3;
  * every config of configs/groie/ builds on the meta device, and the GRoIE
    Grid R-CNN R50 at full width has exactly the names and shapes of
    `state_dict_from_jax` of the JAX tree.

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
from ld_tpu.models.backbones.plugins import build_plugin as j_build_plugin
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones.plugins import (GeneralizedAttention,
                                                   build_plugin)
from ld_tpu_torch.models.heads import GridRoIHead, StandardRoIHead
from ld_tpu_torch.models.heads.roi_head import GenericRoIExtractor
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import assert_losses_close, fill_tree, nchw
from test_torch_port_libra_pisa import j_sample, sampler_case, t_sample
from test_torch_port_ms_rcnn_resnest import (fpn_features, gt_masks,
                                             proposals)
from test_torch_port_paa_fsaf_freeanchor import gt_batches, numpy_tree
from test_torch_port_sabl import assert_dets_match
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'configs', 'groie', '*.py')))
FULL_WIDTH = {'grid': 'configs/groie/'
              'grid_rcnn_r50_fpn_gn-head_groie_1x_coco.py'}
LOSS_RTOL, DET_TOL = 1e-3, 5e-3
ALL = dict(num=10**6, pos_fraction=1.0)
GATE = 0.7
# 4 gts and 32 proposals an image: num = the candidate count picks them all
CANDIDATES = 4 + 32
MINING = {'ohem': dict(type='OHEMSampler', num=CANDIDATES, pos_fraction=1.0),
          'score_hlr': dict(type='ScoreHLRSampler', num=CANDIDATES,
                            pos_fraction=1.0, score_thr=0.05, iou_thr=0.5,
                            k=0.5, bias=0.0)}
SAMPLER_CFGS = {'ohem': dict(type='OHEMSampler', num=24, pos_fraction=0.25),
                'score_hlr': dict(type='ScoreHLRSampler', num=24,
                                  pos_fraction=0.25, score_thr=0.05,
                                  iou_thr=0.5, k=0.5, bias=0.0),
                'score_hlr_bias': dict(type='ScoreHLRSampler', num=24,
                                       pos_fraction=0.25, score_thr=0.1,
                                       iou_thr=0.3, k=1.0, bias=0.2)}
TEST_TWO = dict(rpn=dict(nms_pre=200, max_per_img=60,
                         nms=dict(iou_threshold=0.7)),
                rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                          max_per_img=40))
ROI_BBOX = dict(num_classes=4, in_channels=64, fc_out_channels=64)
GA = dict(type='GeneralizedAttention', in_channels=64, spatial_range=-1,
          num_heads=6, attention_type='0100', kv_stride=2)


def groie(size):
    """A GRoIE extractor config of the configs' form at width 64."""
    return dict(type='GenericRoIExtractor', aggregation='sum',
                roi_layer=dict(type='RoIAlign', output_size=size,
                               sampling_ratio=2),
                out_channels=64, featmap_strides=[4, 8, 16, 32],
                pre_cfg=dict(type='ConvModule', in_channels=64,
                             out_channels=64, kernel_size=5, padding=2,
                             inplace=False),
                post_cfg=dict(GA))


def roi_cfg(kind, sampler=ALL):
    """The RoI head of `kind` ('bbox', 'mask', 'grid', or 'ohem' /
    'score_hlr' with the level-routed extractor) at width 64."""
    cfg = dict(type='StandardRoIHead', bbox_head=dict(ROI_BBOX),
               bbox_roi_extractor=groie(7),
               train_cfg=dict(sampler=sampler), test_cfg=TEST_TWO['rcnn'])
    if kind in MINING:
        cfg.update(bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32]),
                   train_cfg=dict(sampler=MINING[kind]))
    elif kind == 'mask':
        cfg.update(mask_roi_extractor=groie(14),
                   mask_head=dict(type='FCNMaskHead', num_convs=1,
                                  in_channels=64, conv_out_channels=64,
                                  num_classes=4))
    elif kind == 'grid':
        cfg.update(type='GridRoIHead', grid_roi_extractor=groie(14),
                   grid_head=dict(grid_points=9, conv_out_channels=32))
    return cfg


def groie_mask_cfg():
    """GRoIE Mask R-CNN at R18, width 64, 4 classes (GRoIE on the bbox and
    the mask extractor)."""
    return dict(
        type='MaskRCNN',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      norm_eval=True, style='pytorch'),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=roi_cfg('mask'),
        train_cfg=dict(rpn=dict(sampler=ALL), rcnn=dict(sampler=ALL)),
        test_cfg=copy.deepcopy(TEST_TWO))


def open_gates(tree):
    """`tree` with every GeneralizedAttention `gamma` at GATE."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.full_like(x, GATE)
        if jax.tree_util.keystr(p).endswith("['gamma']") else x, tree)


def ga_input(size, seed=8):
    return np.random.RandomState(seed).randn(6, size, size, 64).astype(
        np.float32)


@pytest.fixture(scope='module')
def ref():
    """The JAX trees (numpy) and outputs of every module the tests hold the
    port against."""
    out, jobs = {}, {}
    ga = j_build_plugin({k: v for k, v in GA.items() if k != 'in_channels'},
                        name='post')
    xs = tuple(jnp.asarray(ga_input(size)) for size in (7, 14))
    tree = out['ga'] = open_gates(fill_tree(jax.eval_shape(
        lambda: ga.init(jax.random.PRNGKey(0), xs[0])), seed=2))
    jobs['ga'] = (lambda v, xs: tuple(ga.apply(v, x) for x in xs),
                  (tree, xs))

    j_batch, t_batch = gt_batches()
    masks = gt_masks(t_batch)
    j_mask_batch = dict(j_batch, gt_masks=jnp.asarray(masks, jnp.float32))
    feats = fpn_features()
    props, valid = proposals(t_batch)
    assert props.shape[1] + 4 == CANDIDATES

    def roi_run(head):
        def run(v, feats, props, valid, b):
            return head.forward_train({'params': v}, list(feats), props,
                                      valid, b, rng=jax.random.PRNGKey(5))
        return run

    def extras(head, v, feats, props, valid, b):
        """The JAX head's preliminary pass (`roi_head.py:552-567`)."""
        def prelim(img_feats, gtb, gtl, gtv, p, pv):
            cand = jnp.concatenate([gtb, p])
            cv = jnp.concatenate([gtv, pv])
            rf = head._extract_rois({'params': v}, img_feats, cand, cv)
            cls, _ = head.net.apply({'params': v['bbox']}, rf)
            res = head.assigner.assign(cand, [cand.shape[0]], gtb, gtl, gtv,
                                       cv, num_classes=head.num_classes)
            lab = jnp.where(res.pos_mask, res.labels, head.num_classes)
            ce = -jnp.take_along_axis(jax.nn.log_softmax(cls, -1),
                                      lab[:, None], 1)[:, 0]
            return ce, jax.nn.softmax(cls, -1)[:, :head.num_classes].max(-1)
        return jax.vmap(prelim)(list(feats), b['gt_bboxes'], b['gt_labels'],
                                b['gt_valid'], props, valid)

    for seed, kind in enumerate(('grid', 'ohem', 'score_hlr'), 11):
        head = JAX_HEADS.build(roi_cfg(kind))
        tree = out[kind] = open_gates(fill_tree(jax.eval_shape(
            lambda head=head: head.init_all_variables(
                jax.random.PRNGKey(0), 64)), seed=seed))
        run = roi_run(head)
        if kind == 'ohem':
            def run(v, *args, head=head, train=run):
                return train(v, *args), extras(head, v, *args)
        jobs[kind] = (run, (tree, feats, props, valid, j_batch))

    det = j_build_detector(groie_mask_cfg())
    dv = out['mask_rcnn'] = open_gates(fill_tree(jax.eval_shape(
        lambda: det.init_variables(jax.random.PRNGKey(0), (1, 64, 96, 3))),
        seed=9))
    jobs['mask_rcnn'] = (lambda v, b: (det.forward_test(v, b),
                                       det.forward_train(
                                           v, b, rng=jax.random.PRNGKey(5))),
                         (dv, j_mask_batch))

    o0 = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=o0)
                   for k, (fn, args) in jobs.items()}
    for k, (fn, args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*args)
    return dict(numpy_tree(out), t_batch=t_batch,
                t_mask_batch=dict(t_batch, gt_masks=torch.from_numpy(masks)),
                roi_inputs=(feats, props, valid))


def assert_masks_match(dets, want, atol=DET_TOL):
    """The masks of the valid detections, each image's rows matched by
    descending score."""
    ok = want[2]
    for i in range(ok.shape[0]):
        order = np.lexsort((-want[0][i][:, 4].round(5), ))
        got_order = np.lexsort((-dets[0][i].numpy()[:, 4].round(5), ))
        np.testing.assert_allclose(
            dets[3][i].numpy()[got_order][ok[i][order]],
            want[3][i][order][ok[i][order]], rtol=0, atol=atol)


def port_roi_head(kind, ref):
    """The port's RoI head of `roi_cfg(kind)` on the JAX tree."""
    head = HEADS.build(roi_cfg(kind))
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
    feats, props, valid = ref['roi_inputs']
    return (nchw(feats), torch.from_numpy(np.array(props)),
            torch.from_numpy(np.array(valid)))


# ---- GeneralizedAttention on roi maps ---------------------------------------
@pytest.mark.parametrize('size', (7, 14))
def test_generalized_attention_on_roi_maps_matches_jax(ref, size):
    ga = build_plugin({k: v for k, v in GA.items() if k != 'in_channels'},
                      64)
    sd = state_dict_from_jax({'params': {'roi_head': {'groie': {
        'post': ref['ga']['params']}}}})
    prefix = 'roi_head.bbox_roi_extractor.post_module.'
    assert all(k.startswith(prefix) for k in sd)
    ga.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                       strict=True)
    assert isinstance(ga, GeneralizedAttention) and ga.qk_dim == 10
    with torch.no_grad():
        got = ga(torch.from_numpy(ga_input(size)).permute(0, 3, 1, 2))
    want = ref['ga_out'][size == 14]
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the block is not the identity
    assert np.abs(want - ga_input(size)).max() > 0.1


# ---- the hard-mining samplers -----------------------------------------------
@pytest.mark.parametrize('name', sorted(SAMPLER_CFGS))
def test_hard_mining_sampler_selections_match_jax(name, monkeypatch):
    cfg = SAMPLER_CFGS[name]
    case = sampler_case(seed=1)
    keys = ('loss', ) if name == 'ohem' else ('boxes', 'scores')
    want = j_sample(cfg, case, monkeypatch, keys)
    got = t_sample(cfg, case, keys)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[0].numpy().sum(1) == 6).all()
    assert (got[1].numpy().sum(1) == 18).all()
    if name == 'ohem':
        assert got[2] is None and want[2] is None
        # the negatives picked are those of the largest losses
        neg = case['neg']
        for i in range(2):
            picked = case['loss'][i][got[1][i].numpy()]
            left = case['loss'][i][neg[i] & ~got[1][i].numpy()]
            assert picked.min() >= left.max() - 1e-4
        return
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-6)
    w = got[2].numpy()
    assert (w[~case['neg']] == 0).all()
    assert w[case['neg']].min() < 0.9 * w[case['neg']].max()


# ---- hard mining in the RoI head --------------------------------------------
@pytest.mark.parametrize('kind', sorted(MINING))
def test_hard_mining_roi_head_losses_match_jax(ref, kind):
    head = port_roi_head(kind, ref)
    assert head.hard_mining
    feats, props, valid = roi_inputs(ref)
    got = head.forward_train(feats, props, valid, ref['t_batch'],
                             torch.Generator().manual_seed(0))
    want = ref[f'{kind}_out']
    assert_losses_close(got, want[0] if kind == 'ohem' else want,
                        rtol=LOSS_RTOL)
    if kind == 'score_hlr':
        extras = head.hard_mining_extras(feats, props, valid,
                                         ref['t_batch'])
        s = head.sample_rois(props, valid, ref['t_batch']['gt_bboxes'],
                             ref['t_batch']['gt_labels'].long(),
                             ref['t_batch']['gt_valid'],
                             torch.Generator().manual_seed(0),
                             extras=extras)
        w = s['weights'][s['roi_valid'] & ~s['roi_pos']]
        assert float(w.min()) < 0.9 * float(w.max())
        assert bool((s['weights'][s['roi_pos']] == 1).all())


def test_hard_mining_extras_match_jax(ref):
    head = port_roi_head('ohem', ref)
    feats, props, valid = roi_inputs(ref)
    got = head.hard_mining_extras(feats, props, valid, ref['t_batch'])
    ce, scores = ref['ohem_out'][1]
    np.testing.assert_allclose(got['loss'].numpy(), ce, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got['scores'].numpy(), scores, rtol=1e-5,
                               atol=1e-6)
    assert not got['loss'].requires_grad


def test_sabl_rejects_hard_mining():
    with pytest.raises(NotImplementedError, match='hard mining'):
        HEADS.build(dict(type='SABLRoIHead', bbox_head=dict(
            type='SABLHead', num_classes=4), train_cfg=dict(
                sampler=MINING['ohem'])))


# ---- GRoIE ------------------------------------------------------------------
def test_groie_grid_roi_head_matches_jax(ref):
    """The bbox extractor and the grid extractor (both GRoIE) in training
    (the test path pools through the same extractors: the Mask R-CNN's
    end to end below)."""
    head = port_roi_head('grid', ref)
    for ext in (head.bbox_roi_extractor, head.grid_roi_extractor):
        assert isinstance(ext, GenericRoIExtractor)
        assert isinstance(ext.post_module, GeneralizedAttention)
    assert 'grid_roi_extractor.pre_module.conv.weight' in head.state_dict()
    feats, props, valid = roi_inputs(ref)
    got = head.forward_train(feats, props, valid, ref['t_batch'],
                             torch.Generator().manual_seed(0))
    assert 'loss_grid' in got
    assert_losses_close(got, ref['grid_out'], rtol=LOSS_RTOL)


def test_groie_zeroes_invalid_rois():
    ext = GenericRoIExtractor(7, (4, 8, 16, 32), 8, pre_cfg=dict(
        type='ConvModule', out_channels=8, kernel_size=5, padding=2),
        post_cfg=dict(GA, in_channels=8, num_heads=2))
    ext.init_weights(torch.Generator().manual_seed(0))
    feats = [torch.randn(1, 8, 16 // 2 ** i, 24 // 2 ** i) for i in range(4)]
    rois = torch.tensor([[[0.0, 0.0, 30.0, 20.0], [10.0, 5.0, 60.0, 50.0]]])
    with torch.no_grad():
        out = ext(feats, rois, torch.tensor([[True, False]]))
    assert out.shape == (2, 8, 7, 7)
    assert bool((out[1] == 0).all()) and float(out[0].abs().max()) > 0


def test_groie_mask_rcnn_end_to_end_matches_jax(ref):
    """GRoIE on the bbox and the mask extractor: the losses (`loss_mask` on
    the positive slice), the detections and their masks."""
    model = build_detector(groie_mask_cfg())
    model.load_state_dict(state_dict_from_jax(
        ref['mask_rcnn'], list(model.state_dict())), strict=True)
    roi = model.roi_head
    assert isinstance(roi.mask_roi_extractor, GenericRoIExtractor)
    assert roi.mask_roi_extractor.out_size == 14
    batch = ref['t_mask_batch']
    with torch.no_grad():
        dets = model.eval().forward_test(batch)
        losses = model.train().forward_train(
            batch, torch.Generator().manual_seed(0))
    want_dets, want_losses = ref['mask_rcnn_out']
    assert len(dets) == len(want_dets) == 4
    assert_dets_match(dets[:3], want_dets[:3], atol=DET_TOL)
    assert_masks_match(dets, want_dets)
    assert 'loss_mask' in losses
    assert_losses_close(losses, want_losses, rtol=LOSS_RTOL)


# ---- the configs ------------------------------------------------------------
@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    assert type(model).__name__ == cfg.model.type
    roi = model.roi_head
    exts = [roi.bbox_roi_extractor]
    if 'grid' in path:
        assert isinstance(roi, GridRoIHead)
        exts.append(roi.grid_roi_extractor)
    elif 'mask' in path:
        assert isinstance(roi, StandardRoIHead) and roi.with_test_masks
        exts.append(roi.mask_roi_extractor)
    else:
        assert roi.mask_roi_extractor is None
    for ext, size in zip(exts, (7, 14)):
        assert isinstance(ext, GenericRoIExtractor) and ext.out_size == size
        assert ext.pre_module.conv.weight.shape == (256, 256, 5, 5)
        assert ext.post_module.kv_stride == 2
        assert ext.post_module.num_heads == 6


@pytest.mark.parametrize('name', sorted(FULL_WIDTH))
def test_full_width_names_and_shapes_match_jax(name):
    path = os.path.join(ROOT, FULL_WIDTH[name])
    det = j_build_detector(JConfig.fromfile(path).model)
    shapes = jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 128, 128, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path).model)
        own = model.state_dict()
        sd = state_dict_from_jax(tree, own.keys())
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    assert f'roi_head.{name}_roi_extractor.post_module.appr_geom_fc_x.weight' \
        in own
