"""The port's ATSS-, FCOS- and Retina-GFL heads and their LD variants, the
losses and assigner they need, and the caffe-style ResNet, against the JAX
package on the same weights and inputs.

Weights go port -> `convert_torch_state_dict` -> JAX (tests/
test_torch_port_bridge.py); inputs come from numpy seeds:
  * each head's outputs on random FPN features within 5e-3 max abs and
    2e-4 median rel, the Retina anchors in the JAX order, and the detector
    names ATSS / FCOS / RetinaNet;
  * the loss dict of every head, the LD heads with a random teacher tuple,
    on identical head outputs, to rtol 2e-4;
  * `get_bboxes` on identical head outputs: the same labels and valid
    mask, boxes and scores to 1e-4;
  * the GFocalV2, ATSS and Retina state dicts through both converters and
    back, unchanged;
  * FocalLoss (int and one-hot targets) and CrossEntropyLoss (softmax,
    sigmoid with int and float targets) to rtol 1e-6;
  * MaxIoUAssigner exactly, on a hand-made set with tied best IoUs and an
    anchor two gts claim as their best, and on 3 random sets;
  * the caffe-style R50 (stride on conv1, frozen BN affine) at 1x3x64x64
    to 1e-4 of the largest output;
  * every LD / LDv2 config, the IMv2 config and the GFL-family configs
    build in the port, the DCN and ResNeXt ones with their DCN stages and
    conv groups.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_tpu import Config as JConfig
from ld_tpu.models.backbones import ResNet as JResNet
from ld_tpu.ops.max_iou_assigner import MaxIoUAssigner as JMaxIoUAssigner
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import LOSSES as JAX_LOSSES
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones import ResNet
from ld_tpu_torch.ops import AnchorGenerator, MaxIoUAssigner
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.testing import detection_batch_np
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import LOSSES
from test_torch_port_bridge import (HW, assert_dets_close,
                                    assert_losses_close, assert_outputs_close,
                                    bare_heads, batches, both_head_forward,
                                    fpn_feats, port_and_jax_head, port_outs,
                                    random_like, randomize_norms)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_IOU = dict(type='MaxIoUAssigner', pos_iou_thr=0.5, neg_iou_thr=0.4,
               min_pos_iou=0, ignore_iof_thr=-1)
# family -> (head, train_cfg)
FAMILIES = {
    'atss': (dict(type='ATSSGFLHead'), None),
    'fcos': (dict(type='FCOSGFLHead'), dict(assigner=MAX_IOU)),
    'retina': (dict(type='RetinaGFLHead'), dict(assigner=MAX_IOU)),
}
# head -> its family
LOSS_HEADS = {'ATSSGFLHead': 'atss', 'LDATSSHead': 'atss',
              'FCOSGFLHead': 'fcos', 'LDFCOSHead': 'fcos',
              'LDFCOSCompareHead': 'fcos', 'RetinaGFLHead': 'retina',
              'LDRetinaHead': 'retina'}


@pytest.fixture(scope='module')
def family_outputs():
    """Per family, lazily: the head in both packages and its outputs on
    random FPN features of a 2-image batch (cls prediction bias 0, so that
    the decode sees candidates)."""
    cache = {}

    def get(name):
        if name not in cache:
            head_cfg, train_cfg = FAMILIES[name]
            head, j_head, variables = port_and_jax_head(head_cfg, seed=2,
                                                        train_cfg=train_cfg)
            j_outs, t_outs = both_head_forward(head, j_head, variables,
                                               fpn_feats(seed=4))
            cache[name] = dict(head=head, j_head=j_head, j_outs=j_outs,
                               t_outs=t_outs)
        return cache[name]
    return get


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_dense_head_forward_matches_jax(family_outputs, family):
    out = family_outputs(family)
    assert len(out['t_outs']) == (2 if family == 'retina' else 3)
    assert_outputs_close(out['j_outs'], out['t_outs'])


def test_retina_anchors_match_jax():
    """9 anchors a location (octave base 4, 3 scales x 3 ratios) in the JAX
    base-anchor order, over the grid and its valid flags."""
    from ld_tpu.ops import AnchorGenerator as JAnchorGenerator
    kw = dict(strides=[8, 16, 32, 64, 128], ratios=[0.5, 1.0, 2.0],
              octave_base_scale=4, scales_per_octave=3)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    gen, j_gen = AnchorGenerator(**kw), JAnchorGenerator(**kw)
    assert gen.num_base_anchors == [9] * 5
    for got, want in zip(gen.grid_anchors(sizes), j_gen.grid_anchors(sizes)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(gen.valid_flags(sizes, (60, 90)),
                         j_gen.valid_flags(sizes, jnp.asarray([60., 90.]))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('det_type', ['ATSS', 'FCOS', 'RetinaNet'])
def test_detector_names_resolve(det_type):
    cfg = Config.fromfile(os.path.join(ROOT,
                                       'configs/gfl/gfl_r50_fpn_1x_coco.py'))
    cfg.model.type = det_type
    with torch.device('meta'):
        assert type(build_detector(cfg.model)).__name__ == det_type


@pytest.mark.parametrize('head', sorted(LOSS_HEADS))
def test_dense_head_loss_dicts_match_jax(family_outputs, head):
    family = LOSS_HEADS[head]
    j_outs = family_outputs(family)['j_outs']
    j_head, t_head = bare_heads(dict(type=head), FAMILIES[family][1])
    j_batch, t_batch = batches()
    j_sizes = [a.shape[1:3] for a in j_outs[0]]
    t_sizes = [tuple(s) for s in j_sizes]
    if head.startswith('LD'):
        teacher = random_like(j_outs, seed=9)
        want = jax.jit(lambda o, t: j_head.loss(o, j_batch, j_sizes, t))(
            j_outs, teacher)
        got = t_head.loss(port_outs(j_outs), t_batch, t_sizes,
                          port_outs(teacher))
        assert all(float(v) > 0 for k, v in got.items()
                   if k != 'loss_cls_kd' or head != 'LDFCOSCompareHead')
    else:
        want = jax.jit(lambda o: j_head.loss(o, j_batch, j_sizes))(j_outs)
        got = t_head.loss(port_outs(j_outs), t_batch, t_sizes)
    if head == 'LDFCOSCompareHead':
        assert float(got['loss_cls_kd']) == 0.0
    assert_losses_close(got, want)


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_dense_head_get_bboxes_matches_jax(family_outputs, family):
    out = family_outputs(family)
    j_outs, j_head = out['j_outs'], out['j_head']
    img_hw = np.array([[60, 90], [64, 70]], np.float32)
    sf = np.array([[1.5, 1.25, 1.5, 1.25], [0.5, 0.5, 0.5, 0.5]], np.float32)
    want = jax.jit(lambda o: j_head.get_bboxes(
        o, jnp.asarray(img_hw), jnp.asarray(sf), rescale=True))(j_outs)
    got = out['head'].get_bboxes(
        port_outs(j_outs), torch.from_numpy(img_hw), torch.from_numpy(sf),
        rescale=True)
    assert_dets_close(got, want)


@pytest.mark.parametrize('head', ['GFocalHead', 'ATSSGFLHead',
                                  'RetinaGFLHead'])
def test_state_dict_round_trips_through_both_converters(head):
    """port -> convert_torch_state_dict -> state_dict_from_jax gives the
    port's state dict back, so a JAX-trained teacher of these heads loads
    into the port."""
    cfg = Config.fromfile(os.path.join(ROOT,
                                       'configs/gfl/gfl_r18_fpn_1x_coco.py'))
    cfg.model.bbox_head = dict(type=head, num_classes=4, in_channels=256,
                               stacked_convs=1, feat_channels=64)
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(6))
    randomize_norms(model, 6)
    sd = model.state_dict()
    conv = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    assert conv.pop('_unmapped') == []
    back = state_dict_from_jax(conv)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(back[k], v), k


# ---- losses ----------------------------------------------------------------
def _loss_inputs(seed, n=40, c=6):
    rs = np.random.RandomState(seed)
    pred = (rs.randn(n, c) * 2).astype(np.float32)
    labels = rs.randint(0, c + 1, n)              # c is the background
    weight = rs.uniform(0, 1, n).astype(np.float32)
    return pred, labels, weight


def _both_losses(cfg, pred, target, weight, avg_factor):
    want = JAX_LOSSES.build(dict(cfg))(
        jnp.asarray(pred), jnp.asarray(target), weight=jnp.asarray(weight),
        avg_factor=avg_factor)
    got = LOSSES.build(dict(cfg))(
        torch.from_numpy(pred), torch.from_numpy(target),
        weight=torch.from_numpy(weight), avg_factor=avg_factor)
    return float(got), float(want)


@pytest.mark.parametrize('target', ['int', 'one_hot'])
def test_focal_loss_matches_jax(target):
    pred, labels, weight = _loss_inputs(0)
    if target == 'one_hot':
        labels = np.eye(pred.shape[1] + 1, dtype=np.float32)[labels][:, :-1]
    got, want = _both_losses(dict(type='FocalLoss', use_sigmoid=True,
                                  gamma=2.0, alpha=0.25, loss_weight=1.5),
                             pred, labels, weight, avg_factor=7.0)
    assert got > 0 and got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize('use_sigmoid,target', [(False, 'int'),
                                                (True, 'int'),
                                                (True, 'float')])
def test_cross_entropy_loss_matches_jax(use_sigmoid, target):
    pred, labels, weight = _loss_inputs(1)
    labels = labels % pred.shape[1]
    if target == 'float':
        # the centerness form: one logit per row against a soft target
        pred = pred[:, 0]
        labels = np.random.RandomState(2).uniform(
            0, 1, pred.shape).astype(np.float32)
    got, want = _both_losses(dict(type='CrossEntropyLoss',
                                  use_sigmoid=use_sigmoid, loss_weight=2.0),
                             pred, labels, weight, avg_factor=5.0)
    assert got > 0 and got == pytest.approx(want, rel=1e-6)


def test_cross_entropy_mask_form_names_its_item():
    with pytest.raises(NotImplementedError, match='caveat 24'):
        LOSSES.build(dict(type='CrossEntropyLoss', use_mask=True))


# ---- MaxIoU assignment -----------------------------------------------------
def _assert_assign_equal(anchors, num_lvl, gt, labels, gt_valid, valid,
                         **kw):
    """The port's batched assignment against the JAX one, image by image,
    exactly."""
    got = MaxIoUAssigner(**kw).assign(
        torch.from_numpy(anchors), num_lvl, torch.from_numpy(gt),
        torch.from_numpy(labels), torch.from_numpy(gt_valid),
        torch.from_numpy(valid), num_classes=5)
    assign = jax.jit(lambda *a: JMaxIoUAssigner(**kw).assign(
        a[0], num_lvl, *a[1:], num_classes=5))
    for i in range(gt.shape[0]):
        want = assign(jnp.asarray(anchors), jnp.asarray(gt[i]),
                      jnp.asarray(labels[i]), jnp.asarray(gt_valid[i]),
                      jnp.asarray(valid[i]))
        for field in ('assigned_gt_inds', 'labels', 'pos_mask',
                      'max_overlaps'):
            np.testing.assert_array_equal(
                getattr(got, field)[i].numpy(),
                np.asarray(getattr(want, field)), err_msg=field)
    return got


@pytest.mark.parametrize('assign_all', [True, False])
def test_max_iou_assigner_ties_and_shared_claims(assign_all):
    """gt0 and gt1 tie at IoU 1/3 on anchor 0, both below pos_iou_thr, so
    both claim it as their best and the higher index wins; anchor 3 ties
    with anchor 0 as gt0's best (claimed too only with gt_max_assign_all);
    anchor 4 fits gt2 exactly; anchor 6 would fit gt0 but lies outside the
    image; the padded gt 3 claims nothing."""
    anchors = np.array([[0, 0, 30, 10], [0, 0, 10, 40], [20, 0, 30, 40],
                        [-20, 0, 10, 10], [50, 50, 60, 60],
                        [100, 100, 110, 110], [0, 0, 10, 10]], np.float32)
    gt = np.array([[[0, 0, 10, 10], [20, 0, 30, 10], [50, 50, 60, 60],
                    [0, 0, 0, 0]]], np.float32)
    labels = np.array([[1, 2, 3, 0]])
    gt_valid = np.array([[True, True, True, False]])
    valid = np.array([[True] * 6 + [False]])
    got = _assert_assign_equal(anchors, [7], gt, labels, gt_valid, valid,
                               pos_iou_thr=0.5, neg_iou_thr=0.4,
                               min_pos_iou=0, gt_max_assign_all=assign_all)
    want_inds = [1, -1, -1, 0 if assign_all else -1, 2, -1, -1]
    assert got.assigned_gt_inds[0].tolist() == want_inds


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_max_iou_assigner_matches_jax_on_random_sets(seed):
    gen = AnchorGenerator(strides=[8, 16, 32, 64, 128],
                          ratios=[0.5, 1.0, 2.0], octave_base_scale=4,
                          scales_per_octave=3)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    mlvl = gen.grid_anchors(sizes)
    anchors = torch.cat(mlvl).numpy()
    batch = detection_batch_np(2, *HW, num_classes=5, max_gts=10,
                               seed=seed)
    valid = np.stack([torch.cat(gen.valid_flags(sizes, hw)).numpy()
                      for hw in batch['img_hw']])
    got = _assert_assign_equal(anchors, [len(a) for a in mlvl],
                               batch['gt_bboxes'], batch['gt_labels'],
                               batch['gt_valid'], valid, **dict(
                                   MAX_IOU, type=None, min_pos_iou=0.0))
    assert got.pos_mask.any()


# ---- caffe-style ResNet ------------------------------------------------------
def test_caffe_resnet50_matches_jax():
    kw = dict(depth=50, style='caffe', frozen_stages=1, norm_eval=True,
              norm_cfg=dict(type='BN', requires_grad=False))
    model = ResNet(**kw)
    model.init_weights(torch.Generator().manual_seed(3))
    model.bbox_head = None
    randomize_norms(model, 3)
    model.eval()
    # the stride sits on the bottleneck's 1x1 conv1
    assert model.layer2[0].conv1.stride == (2, 2)
    assert model.layer2[0].conv2.stride == (1, 1)
    assert not any(p.requires_grad for m in model.modules()
                   if isinstance(m, torch.nn.BatchNorm2d)
                   for p in m.parameters())
    assert model.layer4[0].conv2.weight.requires_grad
    conv = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert conv.pop('_unmapped') == []
    variables = {'params': conv['params']['backbone'],
                 'batch_stats': conv['batch_stats']['backbone']}
    x = np.random.RandomState(5).randn(1, 3, 64, 64).astype(np.float32)
    want = jax.jit(JResNet(**kw).apply)(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(g.shape[-2:]) for g in got] == [(16, 16), (8, 8), (4, 4),
                                                  (2, 2)]
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


# ---- configs -----------------------------------------------------------------
CONFIGS = sorted(
    [os.path.relpath(p, ROOT) for pattern in ('configs/ld/*.py',
                                              'configs/ldv2/*.py',
                                              'configs/gfl/*.py')
     for p in glob.glob(os.path.join(ROOT, pattern))] +
    ['configs/imv2/im_r50_gflv2_r101_1x.py'])
# the blocks of each ResNet / ResNeXt stage
STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3)}


def _assert_backbone_as_configured(backbone, cfg):
    """The DCN conv2s sit in the stages `stage_with_dcn` names (each
    bottleneck of them), and every conv2 has the config's groups."""
    dcn_stages = cfg.get('stage_with_dcn', (False, ) * 4) \
        if cfg.get('dcn') else (False, ) * 4
    want = sum(n for n, on in zip(STAGE_BLOCKS[cfg['depth']], dcn_stages)
               if on)
    dcns = [m for m in backbone.modules()
            if isinstance(m, ModulatedDeformConv2d)]
    assert len(dcns) == want
    groups = cfg.get('groups', 32 if cfg['type'] == 'ResNeXt' else 1)
    assert {blk.conv2.groups for i in range(1, 5)
            for blk in getattr(backbone, f'layer{i}')} == {groups}


@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    """Every config of the LD tables and of the GFL family builds (on the
    meta device: no memory, no init), the DCN and ResNeXt ones too, with
    the backbone its config asks for."""
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(cfg.model)
    want = JConfig.fromfile(os.path.join(ROOT, path)).model
    assert type(model.bbox_head).__name__ == want['bbox_head']['type']
    assert type(model.backbone).__name__ == want['backbone']['type']
    _assert_backbone_as_configured(model.backbone, want['backbone'])


def test_config_list_holds_every_teacher():
    for path in CONFIGS:
        teacher = Config.fromfile(os.path.join(ROOT, path)).model.get(
            'teacher_config')
        assert teacher is None or teacher in CONFIGS, (path, teacher)
