"""The port's DCN / ResNeXt model layer and voting NMS against the JAX
package, with non-zero random `conv_offset` weights and biases everywhere
(zero offsets would hide the offset layout and the bilinear sample).

Weights go port -> `convert_torch_state_dict` -> JAX (tests/
test_torch_port_bridge.py); inputs come from numpy seeds:
  * `ModulatedDeformConv2d` against `ld_tpu.ops.deform_conv.
    ModulatedDeformConv` at (deform_groups, groups, stride) in {(1, 1, 1),
    (2, 1, 2), (1, 4, 1)} on 1x8x12x16: the forward within 1e-5 of the
    largest output; the gradients wrt the input, `weight` and `conv_offset`
    against `jax.grad` within 1e-4 of the largest of each; in bf16 within
    the JAX package's bf16 bound of 0.15, the JAX kernel taken from the
    port's float32 weights (ROADMAP.md Queue C, caveat 13);
  * an R50 at base_channels 16 with DCN on stages 2-4 (2 deform groups) and
    a ResNeXt-50 (groups 4, base_width 4) with DCN c4-c5, at 1x3x64x64, to
    1e-4 of the largest output; `build_detector(dtype=...)` lowers the DCN
    layers with the trunk;
  * the BN fold: the folded DCN backbone computes what the unfolded one
    does, and folds as many pairs as the JAX fold;
  * `state_dict_from_jax` gives back every tensor of both backbones;
  * the slice as a whole: the loss dict of configs/ld/
    ld_r101_gflv1_r101dcn_fpn_coco_2x.py with an R18-width student and a
    DCN R50 teacher at base_channels 16, term by term to rtol 2e-4;
  * `multiclass_nms_voting` per image, and through `GFLHead.get_bboxes`:
    labels and valid flags identical, dets within 1e-5 relative.
"""
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as jax_build_detector
from ld_tpu.models.backbones import ResNet as JResNet
from ld_tpu.models.backbones import ResNeXt as JResNeXt
from ld_tpu.ops import nms as jax_nms
from ld_tpu.ops.deform_conv import ModulatedDeformConv as JDeformConv
from ld_tpu.utils.checkpoint import (_dcn_offset_perm,
                                     convert_torch_state_dict)
from ld_tpu.utils.fuse_conv_bn import fuse_conv_bn as jax_fuse_conv_bn
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones import ResNet, ResNeXt
from ld_tpu_torch.ops import nms as port_nms
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.testing import detection_batch_np, randomize_dcn_offsets
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import (HEAD_KW, HW, TEST_CFG, assert_dets_close,
                                    assert_losses_close, compile_in, nchw,
                                    networks_and_loss, randomize_norms,
                                    to_jax_variables)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LD_DCN_CFG = os.path.join(ROOT,
                          'configs/ld/ld_r101_gflv1_r101dcn_fpn_coco_2x.py')
DCN = dict(type='DCNv2', deform_groups=1, fallback_on_stride=False)
# the two backbones: (port class, JAX class, keyword arguments)
BACKBONES = {
    'r50_dcn': (ResNet, JResNet, dict(
        depth=50, base_channels=16, dcn=dict(DCN, deform_groups=2),
        stage_with_dcn=(False, True, True, True))),
    'x50_dcn': (ResNeXt, JResNeXt, dict(
        depth=50, groups=4, base_width=4, base_channels=16, dcn=DCN,
        stage_with_dcn=(False, False, True, True))),
}


def _hwio_to_oihw(kernel):
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def _layer_case(deform_groups, groups, stride, seed=0):
    """A port DCN layer (8 -> 8 channels, k 3) with seeded weight and
    conv_offset, its JAX variables through the converter, an input and an
    output cotangent."""
    rs = np.random.RandomState(seed)
    layer = ModulatedDeformConv2d(8, 8, 3, stride, groups=groups,
                                  deform_groups=deform_groups)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            (rs.randn(*layer.weight.shape) * 0.3).astype(np.float32)))
    randomize_dcn_offsets(layer, seed=seed + 1, shift=1.5)
    sd = {f'layer1.0.conv2.{k}': v.numpy()
          for k, v in layer.state_dict().items()}
    conv = convert_torch_state_dict(sd)
    assert conv.pop('_unmapped') == []
    variables = {'params': conv['params']['backbone']['layer1_0']['conv2']}
    x = rs.randn(1, 8, 12, 16).astype(np.float32)
    oh = (12 - 1) // stride + 1
    ow = (16 - 1) // stride + 1
    cot = rs.randn(1, 8, oh, ow).astype(np.float32)
    return layer, variables, x, cot


@pytest.mark.parametrize('deform_groups,groups,stride',
                         [(1, 1, 1), (2, 1, 2), (1, 4, 1)])
def test_dcn_layer_matches_jax(deform_groups, groups, stride):
    layer, variables, x, cot = _layer_case(deform_groups, groups, stride)
    j_layer = JDeformConv(features=8, stride=stride, groups=groups,
                          deform_groups=deform_groups)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    cot_nhwc = jnp.asarray(cot.transpose(0, 2, 3, 1))

    def j_loss(v, xi):
        return jnp.sum(j_layer.apply(v, xi) * cot_nhwc)
    with ThreadPoolExecutor(2) as pool:
        fwd = compile_in(pool, j_layer.apply, variables, x_nhwc)[1]
        grad = compile_in(pool, jax.grad(j_loss, argnums=(0, 1)), variables,
                          x_nhwc)[1]
        want = np.asarray(fwd.result()(variables, x_nhwc))
        j_gv, j_gx = grad.result()(variables, x_nhwc)

    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    got = out.detach().numpy()
    want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    # the JAX gradients in the port's layouts: NCHW input, OIHW weight, the
    # conv_offset channels back in mmcv's order
    inv = np.argsort(_dcn_offset_perm(27 * deform_groups, 3))
    p = j_gv['params']
    want_grads = {
        'input': np.asarray(j_gx).transpose(0, 3, 1, 2),
        'weight': _hwio_to_oihw(np.asarray(p['kernel']).reshape(
            3, 3, 8 // groups, 8)),
        'conv_offset.weight': _hwio_to_oihw(p['conv_offset']['kernel'])[inv],
        'conv_offset.bias': np.asarray(p['conv_offset']['bias'])[inv]}
    got_grads = {'input': xt.grad.numpy(),
                 'weight': layer.weight.grad.numpy(),
                 'conv_offset.weight':
                     layer.conv_offset.weight.grad.numpy(),
                 'conv_offset.bias': layer.conv_offset.bias.grad.numpy()}
    for name, w in want_grads.items():
        g = got_grads[name]
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name

    # bf16: conv_offset in bf16, the sample and product in float32 on the
    # float32 kernel; JAX op by op (under jit XLA keeps float32 between
    # fused bf16 ops)
    layer.compute_dtype = layer.conv_offset.compute_dtype = torch.bfloat16
    j_bf16 = JDeformConv(features=8, stride=stride, groups=groups,
                         deform_groups=deform_groups, dtype=jnp.bfloat16)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got16 = layer(x16)
    want16 = j_bf16.apply(variables, jnp.asarray(
        x16.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16))
    assert got16.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    diff = np.abs(got16.float().numpy() -
                  np.asarray(want16, np.float32).transpose(0, 3, 1, 2))
    assert diff.max() <= 0.15


def test_dcn_layer_argument_checks():
    with pytest.raises(NotImplementedError, match='caveat 12'):
        ModulatedDeformConv2d(8, 8, 3, dilation=2)
    with pytest.raises(ValueError):
        ModulatedDeformConv2d(8, 6, 3, groups=4)
    # zero conv_offset: the plain conv of `weight`, with masks of 0.5
    layer = ModulatedDeformConv2d(4, 4, 3)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 5, 6)
                         .astype(np.float32))
    with torch.no_grad():
        want = torch.nn.functional.conv2d(x, layer.weight, padding=1) * 0.5
        assert torch.allclose(layer(x), want, atol=1e-6)


def _backbone(name, seed=3):
    """The named port backbone from `seed` with random BN statistics and
    affine and random DCN offsets, in eval, and its JAX variables."""
    cls, _, kw = BACKBONES[name]
    model = cls(**kw)
    model.init_weights(torch.Generator().manual_seed(seed))
    randomize_norms(model, seed)
    assert randomize_dcn_offsets(model, seed) > 0
    conv = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert conv.pop('_unmapped') == []
    variables = {'params': conv['params']['backbone'],
                 'batch_stats': conv['batch_stats']['backbone']}
    return model.eval(), variables


@pytest.fixture(scope='module')
def backbone_outputs():
    """Each backbone in both packages on the same 1x3x64x64 input: {name:
    (port model, JAX variables, port outputs, JAX outputs NCHW)}."""
    x = np.random.RandomState(5).randn(1, 3, 64, 64).astype(np.float32)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    out, jobs = {}, {}
    with ThreadPoolExecutor(len(BACKBONES)) as pool:
        for name, (_, j_cls, kw) in BACKBONES.items():
            model, variables = _backbone(name)
            jobs[name] = (model, variables, compile_in(
                pool, j_cls(**kw).apply, variables, x_nhwc)[1])
        for name, (model, variables, compiled) in jobs.items():
            want = compiled.result()(variables, x_nhwc)
            with torch.no_grad():
                got = model(torch.from_numpy(x))
            out[name] = (model, variables, x, got,
                         [np.asarray(w).transpose(0, 3, 1, 2) for w in want])
    return out


@pytest.mark.parametrize('name', sorted(BACKBONES))
def test_dcn_backbone_matches_jax(backbone_outputs, name):
    model, _, _, got, want = backbone_outputs[name]
    assert [tuple(g.shape[-3:]) for g in got] == [
        (64, 16, 16), (128, 8, 8), (256, 4, 4), (512, 2, 2)]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    if name == 'x50_dcn':
        # ResNeXt: width int(planes * 4 / 64) * 4 at stage 3, grouped DCN
        conv2 = model.layer3[0].conv2
        assert isinstance(conv2, ModulatedDeformConv2d)
        assert (conv2.in_channels, conv2.groups) == (16, 4)
        assert model.layer2[0].conv2.groups == 4


@pytest.mark.parametrize('name', sorted(BACKBONES))
def test_dcn_backbone_fold(backbone_outputs, name):
    """The folded backbone computes the unfolded one's outputs, and folds
    the pairs the JAX fold folds (DCN conv2s included)."""
    model, variables, x, got, _ = backbone_outputs[name]
    folded = copy.deepcopy(model)
    pairs = fuse_conv_bn(folded)
    with torch.no_grad():
        after = folded(torch.from_numpy(x))
    for a, b in zip(after, got):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    j_folded = jax_fuse_conv_bn(variables)
    j_pairs = sum(
        1 for path, leaf in jax.tree_util.tree_leaves_with_path(
            j_folded['batch_stats'])
        if path[-1].key == 'var' and np.allclose(leaf, 1.0 - 1e-5))
    assert pairs == j_pairs == 53
    # a DCN conv2's weight was scaled, its conv_offset left alone
    block = folded.layer4[0]
    assert not torch.equal(block.conv2.weight, model.layer4[0].conv2.weight)
    assert torch.equal(block.conv2.conv_offset.weight,
                       model.layer4[0].conv2.conv_offset.weight)


@pytest.mark.parametrize('name', sorted(BACKBONES))
def test_dcn_backbone_state_dict_round_trip(backbone_outputs, name):
    model, variables = backbone_outputs[name][:2]
    back = state_dict_from_jax({
        'params': {'backbone': variables['params']},
        'batch_stats': {'backbone': variables['batch_stats']}})
    own = model.state_dict()
    assert sorted(back) == sorted(f'backbone.{k}' for k in own)
    for k, v in own.items():
        assert torch.equal(back[f'backbone.{k}'], v), k


def test_dcn_configs_lower_with_the_trunk():
    """build_detector(dtype=...) lowers each DCN conv2 with the trunk; the
    X101-32x4d-DCN config's conv2s are grouped DCNs of width 512 at
    stage 3."""
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/gfl/gfl_x101_32x4d_fpn_dconv_c4-c5_mstrain_2x_coco.py'))
    with torch.device('meta'):
        model = build_detector(cfg.model, dtype='bfloat16')
    dcns = [m for m in model.backbone.modules()
            if isinstance(m, ModulatedDeformConv2d)]
    assert len(dcns) == 23 + 3
    assert {(m.compute_dtype, m.conv_offset.compute_dtype)
            for m in dcns} == {(torch.bfloat16, torch.bfloat16)}
    assert (dcns[0].in_channels, dcns[0].groups) == (512, 32)
    with pytest.raises(ValueError, match='BasicBlock'):
        ResNet(depth=18, dcn=DCN, stage_with_dcn=(False, True, True, True))
    # mmcv's DCNv1 type builds the DCNv2 layer, as in JAX (caveat 36)
    with torch.device('meta'):
        v1 = ResNet(depth=50, dcn=dict(type='DCN'),
                    stage_with_dcn=(False, True, True, True))
    assert isinstance(v1.layer2[0].conv2, ModulatedDeformConv2d)
    with pytest.raises(ValueError, match='DCN'):
        ResNet(depth=50, dcn=dict(type='DCNv3'),
               stage_with_dcn=(False, True, True, True))


# ---- the slice as a whole ----------------------------------------------------
def _ld_dcn_cfg(package_config):
    """The R101-DCN -> R101 LD config with an R18 student (widths kept) and
    a DCN R50 teacher at base_channels 16 (stage widths 64 to 512)."""
    cfg = package_config.fromfile(LD_DCN_CFG)
    teacher = copy.deepcopy(dict(package_config.fromfile(os.path.join(
        ROOT, cfg.model.teacher_config)).model))
    cfg.model.backbone.depth = 18
    cfg.model.neck.in_channels = [64, 128, 256, 512]
    teacher['backbone'] = dict(teacher['backbone'], depth=50,
                               base_channels=16)
    teacher['neck'] = dict(teacher['neck'], in_channels=[64, 128, 256, 512])
    cfg.model.teacher_config = dict(model=teacher)
    return cfg


def test_ld_dcn_detector_forward_train_matches_jax():
    """The R101-DCN teacher config's LD detector (DCN teacher, VLR, class
    KD) on the same weights and batch, the networks and the loss jitted
    apart."""
    cfg = _ld_dcn_cfg(Config)
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    randomize_norms(model.teacher, 2)
    assert randomize_dcn_offsets(model.teacher, seed=3) == 4 + 6 + 3
    det = jax_build_detector(_ld_dcn_cfg(JConfig).model)
    shape = (1, ) + HW + (3, )
    variables = to_jax_variables(model, det, shape)
    t_vars = to_jax_variables(model.teacher, det.teacher, shape)

    np_batch = detection_batch_np(2, *HW, num_classes=80, max_gts=8, seed=5)
    j_batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    j_batch['image'] = jnp.asarray(np_batch['image'].transpose(0, 2, 3, 1))
    want = networks_and_loss(det, variables, t_vars, j_batch)

    got = model.train().forward_train(
        {k: torch.from_numpy(v) for k, v in np_batch.items()})
    assert float(got['loss_ld'].detach()) > 0
    assert_losses_close(got, want)


# ---- voting NMS --------------------------------------------------------------
def _voting_inputs(rng, b, n, c):
    """Clustered boxes under 4096 and continuous random scores (no ties
    among the top pairs)."""
    centers = rng.uniform(0, 900, (b, 40, 2))
    ctr = np.take_along_axis(centers, rng.randint(0, 40, (b, n, 1)), 1)
    ctr = ctr + rng.normal(0, 10, (b, n, 2))
    wh = rng.uniform(20, 150, (b, n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = rng.uniform(0, 1, (b, n, c)) ** 3
    return boxes.astype(np.float32), scores.astype(np.float32)


def _assert_voted_close(got, want):
    dets, labels, valid = (np.asarray(a) for a in got)
    w_dets, w_labels, w_valid = (np.asarray(a) for a in want)
    assert valid.sum() > 0
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_array_equal(labels, w_labels)
    np.testing.assert_allclose(dets, w_dets, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('n,c,thr,max_per_img', [(2500, 6, 0.6, 100),
                                                 (300, 3, 0.5, 50)])
def test_multiclass_nms_voting_matches_jax(n, c, thr, max_per_img):
    boxes, scores = _voting_inputs(np.random.RandomState(n), 2, n, c)
    got = port_nms.multiclass_nms_voting(torch.from_numpy(boxes),
                                         torch.from_numpy(scores), 0.05, thr,
                                         max_per_img)
    assert port_nms.multiclass_nms_voting.iterations >= 2
    fn = jax.jit(lambda bx, sc: jax_nms.multiclass_nms_voting(
        bx, sc, 0.05, thr, max_per_img=max_per_img))
    for i in range(2):
        want = fn(jnp.asarray(boxes[i]), jnp.asarray(scores[i]))
        _assert_voted_close([a[i] for a in got], want)


def test_voting_get_bboxes_route_matches_jax():
    """`test_cfg.nms.type='voting_cluster_diounms'` routes GFLHead's decode
    to the voting NMS in both packages."""
    test_cfg = dict(TEST_CFG, nms=dict(type='voting_cluster_diounms',
                                       iou_threshold=0.6))
    head_cfg = dict(type='GFLHead', **HEAD_KW, test_cfg=test_cfg)
    j_head, t_head = JAX_HEADS.build(dict(head_cfg)), HEADS.build(
        dict(head_cfg))
    rs = np.random.RandomState(11)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    cls = [rs.randn(2, h, w, HEAD_KW['num_classes']).astype(np.float32) - 1
           for h, w in sizes]
    reg = [rs.randn(2, h, w, 68).astype(np.float32) for h, w in sizes]
    img_hw = np.array([[64, 96], [50, 80]], np.float32)
    want = jax.jit(lambda c, r: j_head.get_bboxes((c, r), jnp.asarray(
        img_hw)))([jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg])
    got = t_head.get_bboxes((nchw(cls), nchw(reg)), torch.from_numpy(img_hw))
    assert_dets_close(got, want)
    plain = t_head.get_bboxes((nchw(cls), nchw(reg)),
                              torch.from_numpy(img_hw), cfg=TEST_CFG)
    assert not torch.equal(got[0], plain[0])
