"""The port's HRNet, HRFPN and RegNet against the JAX package on the same
weights, and the HRNet / RegNet configs.

The weights go JAX -> port: `jax.eval_shape` of the JAX init gives the
variable tree, `fill_tree` fills it from a numpy seed (kernels N(0,
1/fan_in), BN statistics and affine near identity, DCN `conv_offset`
leaves uniform in +-0.5, so that the taps move), and `state_dict_from_jax`
carries it onto the port's mmdet names strictly. (The JAX converter has no
HRNet, HRFPN or RegNet names: ROADMAP.md caveat 33.) Inputs come from
numpy seeds. In float32 on the CPU, unless a case says otherwise:
  * the RegNet layout helpers against JAX's for every arch, exactly, and
    the port's stage widths and conv groups built from them;
  * a small RegNet (4 stages of 16 to 128 channels, 8 blocks), with and
    without grouped DCN on c3-c5, on 1x3x64x64 within 1e-5 of the largest
    output;
  * a small HRNet (the 8/16/32/64 layout of tests/test_new_backbones.py),
    with two modules in stage 3, and with Bottleneck branches and a stage
    that adds two branches at once, on 1x3x64x64 within 1e-5;
  * HRFPN at stride 1 and 2, AVG and MAX pooling, on the JAX HRNet's
    outputs, within 1e-5;
  * HRNet + HRFPN in bf16 against the JAX bf16 modules compiled with
    excess precision off (so every op rounds to bf16, as op by op), within
    the bf16 bound of tests/test_torch_port_bf16.py (0.15);
  * the slice as a whole at head width 64 on a 2x3x64x96 batch: a Faster
    R-CNN on the small HRNet + HRFPN, its `forward_test` detections against
    JAX's `forward_test` (the NMS through its plain version); an FCOS on it
    (HRFPN stride 2), its head outputs and loss dict;
  * every config of configs/hrnet/ and configs/regnet/ builds on the meta
    device in its bf16 dtype; the necks still unported raise
    NotImplementedError naming their ROADMAP item;
  * `state_dict_from_jax` carries a full-width HRNetV2p-W18 Faster R-CNN
    and the RegNetX-3.2GF mdconv Mask R-CNN from their `jax.eval_shape`
    trees onto the port's keys and shapes, strictly.

The `ref` fixture traces every JAX program once and compiles each in a
thread as soon as it is traced, at LLVM -O0 (the programs run once).
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
from ld_tpu.models.backbones import regnet as j_regnet
from ld_tpu.models.backbones.hrnet import HRNet as JHRNet
from ld_tpu.models.necks.extra_necks import HRFPN as JHRFPN
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones import HRNet, RegNet
from ld_tpu_torch.models.backbones import regnet
from ld_tpu_torch.models.layers import BatchNorm2d, Conv2d
from ld_tpu_torch.models.necks import HRFPN
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import BACKBONES, NECKS
from test_torch_port_bridge import (assert_losses_close, batches, fill_tree,
                                    nchw, nhwc)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse
from test_torch_port_two_stage import TEST_CFG, TRAIN_ALL, assert_dets_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DCN = dict(type='DCNv2', deform_groups=1, fallback_on_stride=False)
# 4 stages of widths 16, 32, 64, 128 and blocks 1, 1, 3, 3; group width 8
SMALL_ARCH = dict(w0=16, wa=16, wm=2.0, group_w=8, depth=8, bot_mul=1.0)
REGNETS = {'plain': dict(arch=SMALL_ARCH, frozen_stages=1),
           'mdconv': dict(arch=SMALL_ARCH, frozen_stages=1, dcn=DCN,
                          stage_with_dcn=(False, True, True, True))}


def hr_extra(stage2_block='BASIC', stage3_modules=1, stage3_branches=3):
    """The 8/16/32/64 HRNet of tests/test_new_backbones.py, one block a
    branch; `stage2_block` 'BOTTLENECK' makes stage 3's transition adapt
    the existing branches' widths, 4 `stage3_branches` add two branches at
    once (a chain of two stride-2 convs)."""
    chans = (8, 16, 32, 64)
    n3 = stage3_branches
    return dict(
        stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                    num_blocks=(1, ), num_channels=(16, )),
        stage2=dict(num_modules=1, num_branches=2, block=stage2_block,
                    num_blocks=(1, 1), num_channels=chans[:2]),
        stage3=dict(num_modules=stage3_modules, num_branches=n3,
                    block='BASIC', num_blocks=(1, ) * n3,
                    num_channels=chans[:n3]),
        stage4=dict(num_modules=1, num_branches=4, block='BASIC',
                    num_blocks=(1, 1, 1, 1), num_channels=chans))


HRNETS = {'small': hr_extra(),
          'two_modules': hr_extra(stage3_modules=2),
          'bottleneck': hr_extra('BOTTLENECK', stage3_branches=4)}
HRFPNS = [(stride, pool) for stride in (1, 2) for pool in ('AVG', 'MAX')]
HR_CHANNELS = [8, 16, 32, 64]
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/hrnet/*.py')) +
                 glob.glob(os.path.join(ROOT, 'configs/regnet/*.py')))


def faster_cfg():
    return dict(
        type='FasterRCNN', backbone=dict(type='HRNet', extra=HRNETS['small']),
        neck=dict(type='HRFPN', in_channels=HR_CHANNELS, out_channels=64,
                  num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=dict(type='StandardRoIHead', bbox_head=dict(
            num_classes=4, in_channels=64, fc_out_channels=64),
            bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32])),
        train_cfg=copy.deepcopy(TRAIN_ALL), test_cfg=copy.deepcopy(TEST_CFG))


def fcos_cfg():
    return dict(
        type='FCOS', backbone=dict(type='HRNet', extra=HRNETS['small']),
        neck=dict(type='HRFPN', in_channels=HR_CHANNELS, out_channels=64,
                  stride=2, num_outs=5),
        bbox_head=dict(type='FCOSHead', num_classes=4, in_channels=64,
                       stacked_convs=2, feat_channels=64,
                       strides=[8, 16, 32, 64, 128]),
        test_cfg=dict(nms_pre=50, score_thr=0.05,
                      nms=dict(type='nms', iou_threshold=0.6),
                      max_per_img=100))


def image(seed, hw=(64, 64)):
    return np.random.RandomState(seed).randn(1, 3, *hw).astype(np.float32)


def filled(module, inputs, seed):
    return fill_tree(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                    inputs), seed)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against, on numpy-filled
    variables: the HRNets and RegNets on `image(0)`, the HRFPNs on the
    small HRNet's outputs, the bf16 HRNet + HRFPN, the Faster R-CNN's
    `forward_test` and the FCOS's head outputs and losses on the bridge's
    test batch. Returns numpy trees and outputs."""
    x = nhwc(image(0))
    j_batch, t_batch = batches()
    j_batch['gt_labels'] = j_batch['gt_labels'].astype(jnp.int32)
    t_batch['gt_labels'] = t_batch['gt_labels'].long()
    out = dict(j_batch=j_batch)
    faster = j_build_detector(faster_cfg())
    fv = fill_tree(jax.eval_shape(lambda: faster.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=4)
    out['faster'] = fv
    jobs = dict(faster=(lambda v, b: faster.forward_test(v, b),
                        (fv, j_batch)))
    # the small HRNet and the HRFPN hold the Faster R-CNN's weights
    part = {scope: {coll: tree[scope] for coll, tree in fv.items()
                    if scope in tree} for scope in ('backbone', 'neck')}
    out['hrnet_small'], out['hrfpn'] = part['backbone'], part['neck']
    for name, extra in HRNETS.items():
        net = JHRNet(extra=extra)
        if name != 'small':
            out[f'hrnet_{name}'] = filled(net, x, seed=1)
        jobs[f'hrnet_{name}'] = (net.apply, (out[f'hrnet_{name}'], x))
    for name, kw in REGNETS.items():
        net = j_regnet.RegNet(**kw)
        out[f'regnet_{name}'] = filled(net, x, seed=2)
        jobs[f'regnet_{name}'] = (net.apply, (out[f'regnet_{name}'], x))

    def hrfpns(v, feats):
        return {f'hrfpn_{s}_{p}': JHRFPN(
            in_channels=HR_CHANNELS, out_channels=64, stride=s,
            pooling_type=p).apply(v, feats) for s, p in HRFPNS}
    # the small HRNet's outputs, as its program's lowering gives them
    jobs['hrfpn'] = (hrfpns, (out['hrfpn'], 'hrnet_small'))

    def bf16(v, nv, x):
        net = JHRNet(extra=HRNETS['small'], dtype=jnp.bfloat16)
        neck = JHRFPN(in_channels=HR_CHANNELS, out_channels=64,
                      dtype=jnp.bfloat16)
        return neck.apply(nv, net.apply(v, x))
    jobs['bf16'] = (bf16, (out['hrnet_small'], out['hrfpn'],
                           jnp.asarray(x, jnp.bfloat16)))

    fcos = j_build_detector(fcos_cfg())
    cv = fill_tree(jax.eval_shape(lambda: fcos.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=5)
    cv['params']['head_net']['conv_cls']['bias'] = np.zeros_like(
        cv['params']['head_net']['conv_cls']['bias'])
    out['fcos'] = cv

    def fcos_train(v, b):
        outs = fcos.apply(v, b['image'])
        sizes = [c.shape[1:3] for c in outs[0]]
        return outs, fcos.bbox_head.loss(outs, b, sizes)
    jobs['fcos'] = (fcos_train, (cv, j_batch))

    # LLVM at -O0 compiles in two thirds of the CPU time; the programs run
    # once
    options = {k: dict(xla_backend_optimization_level=0) for k in jobs}
    options['bf16']['xla_allow_excess_precision'] = False
    lowered, futures = {}, {}
    with ThreadPoolExecutor(len(jobs)) as pool:
        # each compiles while the next is traced, the detectors first
        for k in ('faster', 'fcos', *jobs):
            fn, args = jobs[k]
            if k in futures:
                continue
            if k == 'hrfpn':
                args = (args[0], lowered[args[1]].out_info)
            lowered[k] = jax.jit(fn).lower(*args)
            futures[k] = pool.submit(lowered[k].compile,
                                     compiler_options=options[k])
    compiled = {k: f.result() for k, f in futures.items()}
    for k, (_, args) in jobs.items():
        if k != 'hrfpn':
            out[f'{k}_out'] = compiled[k](*args)
    out.update(compiled['hrfpn'](out['hrfpn'], out['hrnet_small_out']))
    return dict(numpy_tree(out), t_batch=t_batch)


def as_backbone(variables, scope='backbone'):
    return {coll: {scope: tree} for coll, tree in variables.items()}


def port_module(cls, kw, variables, scope='backbone', dtype=None):
    """`cls(**kw)` holding the JAX `variables` (a backbone's or a neck's),
    loaded strictly, in eval."""
    model = cls(**kw, dtype=dtype)
    keys = [f'{scope}.{k}' for k in model.state_dict()]
    sd = state_dict_from_jax(as_backbone(variables, scope), keys)
    assert sorted(sd) == sorted(keys)
    model.load_state_dict({k[len(scope) + 1:]: v for k, v in sd.items()},
                          strict=True)
    return model.eval()


def assert_close(got, want, rtol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().float().numpy(), np.asarray(w, np.float32)
        w = w.transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rtol * np.abs(w).max(), \
            float(np.abs(g - w).max() / np.abs(w).max())


# ---- RegNet -----------------------------------------------------------------
@pytest.mark.parametrize('arch', sorted(regnet.ARCH_SETTINGS))
def test_regnet_layout_matches_jax(arch):
    """The port's copies of the layout helpers against JAX's, exactly, and
    the trunk built from them: each stage's width and conv2 groups."""
    assert regnet.ARCH_SETTINGS[arch] == j_regnet.ARCH_SETTINGS[arch]
    a = regnet.ARCH_SETTINGS[arch]
    widths = regnet.generate_regnet(a['w0'], a['wa'], a['wm'], a['depth'])
    assert widths == j_regnet.generate_regnet(a['w0'], a['wa'], a['wm'],
                                              a['depth'])
    stages = regnet.get_stages_from_blocks(widths[0])
    assert stages == j_regnet.get_stages_from_blocks(widths[0])
    bot = [a['bot_mul']] * widths[1]
    groups = [a['group_w']] * widths[1]
    assert regnet.adjust_width_group(stages[0], bot, groups) == \
        j_regnet.adjust_width_group(stages[0], bot, groups)
    assert regnet.quantize_float(a['w0'] * 1.37, 8) == \
        j_regnet.quantize_float(a['w0'] * 1.37, 8)
    layout = regnet.regnet_layout(arch)
    assert layout == j_regnet.RegNet(arch=arch)._layout()
    with torch.device('meta'):
        model = RegNet(arch=arch)
    for i, (width, blocks, group_w, _) in enumerate(zip(*layout)):
        layer = getattr(model, f'layer{i + 1}')
        assert len(layer) == blocks
        assert layer[0].conv2.out_channels == layer[-1].conv3.out_channels \
            == width
        assert layer[0].conv2.groups == width // group_w
        assert layer[0].conv2.stride == (2, 2)


@pytest.mark.parametrize('name', sorted(REGNETS))
def test_regnet_matches_jax(ref, name):
    model = port_module(RegNet, REGNETS[name], ref[f'regnet_{name}'])
    with torch.no_grad():
        got = model(torch.from_numpy(image(0)))
    assert [tuple(g.shape[1:]) for g in got] == [
        (16, 16, 16), (32, 8, 8), (64, 4, 4), (128, 2, 2)]
    assert_close(got, ref[f'regnet_{name}_out'])
    dcns = [m for m in model.modules()
            if isinstance(m, ModulatedDeformConv2d)]
    assert len(dcns) == (7 if name == 'mdconv' else 0)
    assert {m.groups for m in dcns} <= {4, 8, 16}
    # frozen_stages=1: the stem and layer1 get no gradient
    assert not any(p.requires_grad for m in (model.conv1, model.bn1,
                                             model.layer1)
                   for p in m.parameters())
    assert all(p.requires_grad for p in model.layer2.parameters())


# ---- HRNet and HRFPN --------------------------------------------------------
@pytest.mark.parametrize('name', sorted(HRNETS))
def test_hrnet_matches_jax(ref, name):
    model = port_module(HRNet, dict(extra=HRNETS[name]),
                        ref[f'hrnet_{name}'])
    with torch.no_grad():
        got = model(torch.from_numpy(image(0)))
    assert [tuple(g.shape[1:]) for g in got] == [
        (8, 16, 16), (16, 8, 8), (32, 4, 4), (64, 2, 2)]
    assert_close(got, ref[f'hrnet_{name}_out'])
    if name == 'bottleneck':
        # stage 3 adapts the Bottleneck branches (32, 64 -> 8, 16) and
        # adds branches 2 and 3, branch 3 by two stride-2 convs
        assert model.transition2[0][0].in_channels == 32
        assert len(model.transition2[3]) == 2


@pytest.mark.parametrize('stride,pool', HRFPNS)
def test_hrfpn_matches_jax(ref, stride, pool):
    key = f'hrfpn_{stride}_{pool}'
    neck = port_module(HRFPN, dict(in_channels=HR_CHANNELS, out_channels=64,
                                   stride=stride, pooling_type=pool),
                       ref['hrfpn'], scope='neck')
    with torch.no_grad():
        got = neck(nchw(ref['hrnet_small_out']))
    assert [tuple(g.shape[-2:]) for g in got] == [
        (16 // stride, 16 // stride), (8 // stride, 8 // stride),
        (4 // stride, 4 // stride), (2 // stride, 2 // stride), (1, 1)]
    assert_close(got, ref[key])


def test_hrnet_hrfpn_bf16_matches_jax(ref):
    """The port's bf16 HRNet + HRFPN against the JAX bf16 modules, both on
    the float32 variables: every output in bf16 and within 0.15."""
    net = port_module(HRNet, dict(extra=HRNETS['small']), ref['hrnet_small'],
                      dtype='bfloat16')
    neck = port_module(HRFPN, dict(in_channels=HR_CHANNELS, out_channels=64),
                       ref['hrfpn'], scope='neck', dtype='bfloat16')
    with torch.no_grad():
        got = neck(net(torch.from_numpy(image(0)).to(torch.bfloat16)))
    want = ref['bf16_out']
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        diff = np.abs(g.float().numpy() - np.asarray(w, np.float32)
                      .transpose(0, 3, 1, 2))
        assert diff.max() <= 0.15, float(diff.max())


# ---- the slice as a whole ---------------------------------------------------
def test_faster_rcnn_on_hrnet_matches_jax(ref):
    """Faster R-CNN on the small HRNet + HRFPN: the port's `forward_test`
    against JAX's on the same weights, the same kept set, boxes within
    5e-3 px."""
    model = build_detector(faster_cfg())
    model.load_state_dict(state_dict_from_jax(
        ref['faster'], model.state_dict().keys()), strict=True)
    t = ref['t_batch']
    with torch.no_grad():
        got = model.eval().forward_test(dict(image=t['image'],
                                             img_hw=t['img_hw']))
    assert int(got[2].sum()) > 10
    assert_dets_match(got, ref['faster_out'], atol=5e-3)


def test_fcos_on_hrnet_matches_jax(ref):
    """FCOS on the small HRNet + HRFPN at stride 2: the head outputs within
    1e-5 of a level's largest (1e-3 on the 1x1 top level, where GN
    normalises two values a group), and the loss dict at rtol 2e-4."""
    model = build_detector(fcos_cfg())
    model.load_state_dict(state_dict_from_jax(
        ref['fcos'], model.state_dict().keys()), strict=True)
    t = ref['t_batch']
    j_outs, want = ref['fcos_out']
    got = model.train()(t['image'])
    for j_part, t_part in zip(j_outs, got):
        assert [tuple(o.shape[-2:]) for o in t_part] == [
            (8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
        for j, o in zip(j_part, t_part):
            w = np.asarray(j).transpose(0, 3, 1, 2)
            bound = 1e-3 if w.shape[-2:] == (1, 1) else 1e-5
            assert np.abs(o.detach().numpy() - w).max() <= \
                bound * np.abs(w).max()
    sizes = [tuple(c.shape[-2:]) for c in got[0]]
    assert float(want['loss_bbox']) > 0
    assert_losses_close(model.bbox_head.loss(got, t, sizes), want)


@pytest.mark.parametrize('path', CONFIGS,
                         ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_config_builds(path):
    """Every config of configs/hrnet/ and configs/regnet/ builds on the meta
    device in its own dtype (bf16): the HRNet / RegNet trunk and HRFPN
    lowered by `apply_model_dtype`; the mdconv config's grouped DCN conv2
    in stages 2-4."""
    cfg = Config.fromfile(path)
    assert cfg.dtype == 'bfloat16'
    with torch.device('meta'):
        model = build_detector(cfg.model, dtype=cfg.dtype)
    backbone = cfg.model.backbone['type']
    assert type(model.backbone).__name__ == backbone
    for part in (model.backbone, model.neck):
        convs = [m for m in part.modules()
                 if isinstance(m, (Conv2d, BatchNorm2d))]
        assert convs and {m.compute_dtype for m in convs} == {torch.bfloat16}
    if backbone == 'HRNet':
        assert type(model.neck).__name__ == 'HRFPN'
        assert model.neck.fpn_convs[0].conv.stride == (
            (2, 2) if 'fcos' in path else (1, 1))
    dcns = [m for m in model.backbone.modules()
            if isinstance(m, ModulatedDeformConv2d)]
    if 'mdconv' in path:
        assert len(dcns) == 6 + 15 + 2
        assert {m.groups for m in dcns} == {4, 9, 21}
    else:
        assert not dcns


def test_unported_necks_name_their_item():
    assert not {'HRNet', 'RegNet'} & set(BACKBONES.not_ported)
    for name in ('NASFPN', 'FPN_CARAFE', 'NASFCOS_FPN', 'FPG', 'RFP',
                 'PAFPN', 'ChannelMapper', 'BFP'):
        assert name not in NECKS.not_ported and NECKS.get(name) is not None
    with pytest.raises(KeyError):
        NECKS.build(dict(type='NoSuchNeck'))
    with pytest.raises(NotImplementedError):
        HRNet(norm_cfg=dict(type='GN'))
    with pytest.raises(NotImplementedError):
        RegNet(dcn=dict(type='DCN'), stage_with_dcn=(False, True, True, True))


FULL_WIDTH = {'hrnet_w18': 'configs/hrnet/faster_rcnn_hrnetv2p_w18_1x_coco.py',
              'regnet_mdconv': 'configs/regnet/'
              'mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py'}


@pytest.mark.parametrize('name', sorted(FULL_WIDTH))
def test_state_dict_from_jax_full_width(name):
    """The JAX detector's `jax.eval_shape` tree -> the port's keys and
    shapes, strictly; the JAX converter cannot carry the port's state dict
    of these backbones back (caveat 33): HRNet's transitions and fuse
    layers stay unmapped, RegNet's blocks go to nested ResNet scopes that
    the JAX RegNet's flat names never read."""
    path = os.path.join(ROOT, FULL_WIDTH[name])
    j_det = j_build_detector(JConfig.fromfile(path).model)
    shapes = jax.eval_shape(lambda: j_det.init_variables(
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
    model.to_empty(device='cpu').load_state_dict(sd, strict=True)
    backbone = {k: v.numpy() for k, v in sd.items()
                if k.startswith('backbone.')}
    conv = convert_torch_state_dict(backbone)

    def paths(tree):
        return {jax.tree_util.keystr(p) for p, _ in
                jax.tree_util.tree_leaves_with_path(tree['backbone'])}
    want = paths(shapes['params'])
    assert len(want - paths(conv['params'])) > len(want) // 2
    if name == 'hrnet_w18':
        assert any('fuse_layers' in k for k in conv['_unmapped'])
        assert any('transition' in k for k in conv['_unmapped'])
