"""The ResNet's remaining variants in the port against the JAX package on
the same weights: weight-standardized convs, GroupNorm through the trunk,
the FPN and the RoI heads, GCNet's `ContextBlock`, `GeneralizedAttention`,
the block plugins and the 'DCN'-typed DCN, and the configs they open.

The weights go JAX -> port: `jax.eval_shape` of the JAX init gives the
variable tree, `fill_tree` fills it from a numpy seed (every kernel
N(0, 1/fan_in), the zero-init convs of a ContextBlock included; norms near
identity; DCN offsets +-0.5; the attention blocks' `gamma` set to 1), and
`state_dict_from_jax` carries it onto the port's mmdet names strictly (the
JAX converter has no plugin or GroupNorm rule: the last test asserts its
gap). Inputs come from numpy seeds. In float32 on the CPU, each within
1e-5 of the largest |value| of its output (and, for a plugin, of its
residual, output minus input):
  * `ConvWS2d` against the JAX `ConvWS`, plain and grouped;
  * `ContextBlock` over both poolings and the fusions;
  * `GeneralizedAttention` on 1x32x12x16 over five `attention_type`s and
    `kv_stride` 1 and 2, with `spatial_range` 2, and with `q_stride` 2;
  * an R50 at base width 32 with both plugins at all three positions under
    stage gating and a 'DCN' dcn on c3-c5;
  * a GN + ConvWS ResNet-50 and ResNeXt-50 (grouped WS convs), their first
    two stages (past them float32's own error passes 1e-5 in both
    packages: the slice's trunk is held to that measure);
  * a GN + ConvWS FPN, the same with `no_norm_on_lateral`, and a BN FPN;
  * a ConvWS + GN `Shared4Conv1FCBBoxHead` net;
  * a mask head with `conv_cfg` / `norm_cfg`, equal to the same head
    without them (ROADMAP.md caveat 37);
  * the slice as a whole at FPN / RoI width 64 on a 2x3x64x96 batch: a
    Mask R-CNN on an R50 (base 16) with GCNet blocks on c3-c5 and GN +
    ConvWS everywhere: its FPN features no farther from the port's
    float64 ones than 3x the port's own float32 error (~1e-4 in both);
    `forward_test` on JAX's features against JAX's (the NMS through its
    plain version), detections within 5e-3 px and masks within the head
    bounds of tests/test_torch_port_mask_rcnn.py; the loss dict of the
    port's whole `forward_train` at rtol 2e-4;
  * every config of configs/gcnet/, empirical_attention/, gn/, gn+ws/,
    scratch/ and dcn/ (but the two RoI-pooling ones) builds on the meta
    device; `state_dict_from_jax` carries three of them at full width onto
    the port's keys and shapes, strictly.

The `ref` fixture traces every JAX program once and compiles each in a
thread as soon as it is traced, at LLVM -O0 (each runs once).
"""
import copy
import glob
import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment
from torch import nn

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.models.backbones.plugins import ContextBlock as JContextBlock
from ld_tpu.models.backbones.plugins import \
    GeneralizedAttention as JGeneralizedAttention
from ld_tpu.models.backbones.resnet import ResNet as JResNet
from ld_tpu.models.backbones.resnet import ResNeXt as JResNeXt
from ld_tpu.models.heads.mask_head import FCNMaskHead as JFCNMaskHead
from ld_tpu.models.heads.roi_head import Shared2FCBBoxHeadNet
from ld_tpu.models.layers import ConvWS as JConvWS
from ld_tpu.models.necks.fpn import FPN as JFPN
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones import ResNet, ResNeXt, SAConv2d
from ld_tpu_torch.models.backbones.plugins import (ContextBlock,
                                                   GeneralizedAttention)
from ld_tpu_torch.models.heads.mask_head import FCNMaskHead
from ld_tpu_torch.models.heads.roi_head import ConvFCBBoxHead
from ld_tpu_torch.models.layers import ConvWS2d
from ld_tpu_torch.models.necks import FPN
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_port_bridge import assert_losses_close, batches, fill_tree
from test_torch_port_mask_rcnn import assert_head_close, gt_masks_np
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse
from test_torch_port_two_stage import TEST_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
WS = dict(type='ConvWS')
GN = dict(type='GN', num_groups=32, requires_grad=True)
ALL = dict(num=10**6, pos_fraction=1.0)
CB = dict(type='ContextBlock', ratio=1. / 4)
GA = dict(type='GeneralizedAttention', spatial_range=-1, num_heads=4,
          attention_type='1111', kv_stride=2)
# both plugins at every position, gated by stage: a block of stage 1 holds
# plugins 2, 3 and 5, of stage 4 plugins 0, 1, 4 and 5 (two of a type)
PLUGINS = (
    dict(cfg=CB, stages=(False, True, True, True), position='after_conv3'),
    dict(cfg=GA, stages=(False, False, True, True), position='after_conv2'),
    dict(cfg=dict(CB, pooling_type='avg', fusion_types=('channel_mul', )),
         stages=(True, False, True, False), position='after_conv1'),
    dict(cfg=dict(GA, attention_type='0010'),
         stages=(True, True, False, False), position='after_conv3'),
    dict(cfg=dict(GA, attention_type='0100', kv_stride=1),
         stages=(False, True, False, True), position='after_conv1'),
    dict(cfg=dict(CB, ratio=1. / 16), stages=(True, False, False, True),
         position='after_conv2'))
DCN = dict(type='DCN', deform_groups=1, fallback_on_stride=False)
# the plugins under stage gating with a 'DCN' dcn on c3-c5 at 4 stages;
# GN + ConvWS at 2 stages (4 stages of them put float32's own error at
# ~5e-5 of the largest output in both packages, measured against the
# port's float64 run: the slice's trunk is held to that measure)
RESNETS = {
    'plugins_dcn': (ResNet, JResNet, dict(
        plugins=PLUGINS, dcn=DCN, stage_with_dcn=(False, True, True, True))),
    'gn_ws': (ResNet, JResNet, dict(conv_cfg=WS, norm_cfg=GN, num_stages=2,
                                    out_indices=(0, 1), frozen_stages=1)),
    'gn_ws_resnext': (ResNeXt, JResNeXt, dict(
        conv_cfg=WS, norm_cfg=GN, groups=8, base_width=4, num_stages=2,
        out_indices=(0, 1))),
}
CONV_WS = {'plain': 1, 'grouped': 4}
CONTEXT_BLOCKS = [(pool, fusion) for pool in ('att', 'avg')
                  for fusion in (('channel_add', ), ('channel_mul', ),
                                 ('channel_add', 'channel_mul'))]
ATTENTIONS = [dict(attention_type=t, kv_stride=s)
              for t in ('1111', '0010', '1000', '0100', '0001')
              for s in (1, 2)] + [
    dict(attention_type='1111', kv_stride=1, spatial_range=2),
    dict(attention_type='1100', kv_stride=2, q_stride=2)]
FPNS = {'gn_ws': dict(conv_cfg=WS, norm_cfg=GN),
        'gn_ws_no_norm_on_lateral': dict(conv_cfg=WS, norm_cfg=GN,
                                         no_norm_on_lateral=True),
        'bn': dict(norm_cfg=dict(type='BN'))}
FPN_IN = [32, 64, 128, 256]
FPN_HW = ((16, 24), (8, 12), (4, 6), (2, 3))


def attention_id(kw):
    return '-'.join(f'{k}{v}' for k, v in kw.items())


def slice_cfg(rcnn_sampler=ALL):
    """Mask R-CNN on an R50 at base width 16 with GCNet blocks (r4) after
    conv3 on c3-c5, GN + ConvWS in the trunk, the FPN and the bbox head
    (Shared4Conv1FC), the mask head's conv_cfg / norm_cfg; width 64, 4
    classes; the samplers pick every candidate."""
    rcnn = dict(sampler=rcnn_sampler) if rcnn_sampler else {}
    return dict(
        type='MaskRCNN',
        backbone=dict(type='ResNet', depth=50, base_channels=16,
                      num_stages=4, out_indices=(0, 1, 2, 3),
                      frozen_stages=1, norm_eval=True, style='pytorch',
                      conv_cfg=WS, norm_cfg=GN, plugins=[dict(
                          cfg=CB, stages=(False, True, True, True),
                          position='after_conv3')]),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5, conv_cfg=WS, norm_cfg=GN),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=dict(type='StandardRoIHead', bbox_head=dict(
            type='Shared4Conv1FCBBoxHead', num_classes=4, in_channels=64,
            conv_out_channels=64, fc_out_channels=64, conv_cfg=WS,
            norm_cfg=GN),
            mask_head=dict(num_convs=2, in_channels=64,
                           conv_out_channels=64, conv_cfg=WS, norm_cfg=GN),
            bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32])),
        train_cfg=dict(rpn=dict(sampler=ALL), rcnn=rcnn),
        test_cfg=copy.deepcopy(TEST_CFG))


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def unit_gammas(tree):
    """`tree` with every attention block's `gamma` at 1, so that the
    attention branch weighs as much as the input it is added to."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.ones_like(x) if jax.tree_util.keystr(p).endswith(
            "['gamma']") else x, tree)


def filled(module, seed, *inputs):
    return unit_gammas(fill_tree(jax.eval_shape(
        module.init, jax.random.PRNGKey(0), *inputs), seed))


def nested(variables, *scopes):
    """Each collection of `variables` under `scopes` (outermost first)."""
    out = {}
    for coll, tree in variables.items():
        for scope in reversed(scopes):
            tree = {scope: tree}
        out[coll] = tree
    return out


def holder(**children) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


def load(module, variables, prefix):
    """`variables` (a JAX tree under the scopes of `prefix`'s package
    names) into `module`, whose state dict lives under `prefix`,
    strictly; `module` in eval."""
    keys = [prefix + k for k in module.state_dict()]
    sd = state_dict_from_jax(variables, keys)
    assert sorted(sd) == sorted(keys)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


def in_block(plugin, variables, j_name):
    """A plugin loaded from its JAX variables as `layer1_0/<j_name>` of a
    backbone; returns the port block's holder, its plugin at `abbr`."""
    root = holder(layer1=nn.Sequential(holder(**{plugin.abbr: plugin})))
    load(root, nested(variables, 'backbone', 'layer1_0', j_name),
         'backbone.')
    return plugin


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against, on numpy-filled
    variables: the slice's Mask R-CNN features, `forward_test` and loss
    dict on the bridge's test batch with gt masks, the R50s on 1x3x64x64,
    the modules on their inputs. Each program compiles in a thread as soon
    as it is traced (the traces hold the interpreter lock, XLA's compiles
    do not), the slice's, the largest, first. Returns numpy trees and
    outputs."""
    out, pending = {}, {}
    pool = ThreadPoolExecutor(8)

    def job(name, fn, *args):
        lowered = jax.jit(fn).lower(*args)
        pending[name] = (pool.submit(lowered.compile, compiler_options=dict(
            xla_backend_optimization_level=0)), args)

    j_batch, t_batch = batches()
    masks = gt_masks_np({k: v.numpy() for k, v in t_batch.items()}, 9)
    j_batch['gt_masks'] = jnp.asarray(masks)
    t_batch['gt_masks'] = torch.from_numpy(masks.astype(np.uint8))
    t_batch['gt_labels'] = t_batch['gt_labels'].long()
    j_batch['gt_labels'] = j_batch['gt_labels'].astype(jnp.int32)
    det = j_build_detector(slice_cfg())
    dv = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=80)
    out['slice'] = dv

    def slice_program(v, b):
        """The FPN features, `forward_test` (`ld_tpu/models/detectors/
        two_stage.py:152-158`, rescaled, unit scale factors) and
        `forward_train` (`:134-150`) of the slice, on one trace of the
        trunk: it has no BN that trains, so `extract` in training mode
        computes the same features."""
        feats, rpn_outs, roi_vars = det.extract(v, b['image'])
        hw, feats = b['img_hw'], list(feats)
        test = det.roi_head.simple_test(
            roi_vars, feats, *det.rpn_head.get_proposals(rpn_outs, hw), hw,
            jnp.ones((2, 4), jnp.float32), rescale=True)
        rng = jax.random.PRNGKey(5)
        losses = dict(det.rpn_head.loss(
            rpn_outs, b, [c.shape[1:3] for c in rpn_outs[0]],
            rng=jax.random.fold_in(rng, 1)))
        props, valid = det.rpn_head.get_proposals(
            rpn_outs, hw, cfg=det.train_cfg.get('rpn_proposal'))
        losses.update(det.roi_head.forward_train(
            roi_vars, feats, props, valid, b, rng=jax.random.fold_in(rng, 2)))
        return feats, test, losses
    try:
        job('slice', slice_program, dv, j_batch)

        x64 = randn(1, 1, 64, 64, 3)
        out['x64'] = x64
        for name, (_, j_cls, kw) in RESNETS.items():
            net = j_cls(depth=50, base_channels=32, **kw)
            v = filled(net, 40 + len(out), x64)
            out[f'resnet_{name}'] = v
            job(f'resnet_{name}', net.apply, v, x64)

        x12 = randn(0, 1, 12, 16, 32)                      # NHWC
        out['x12'] = x12
        for name, groups in CONV_WS.items():
            conv = JConvWS(16, (3, 3), padding=1,
                           feature_group_count=groups, use_bias=False)
            v = filled(conv, 1, x12[..., :16])
            out[f'ws_{name}'] = v
            job(f'ws_{name}', conv.apply, v, x12[..., :16])
        for i, (pooling, fusion) in enumerate(CONTEXT_BLOCKS):
            block = JContextBlock(pooling_type=pooling, fusion_types=fusion)
            out[f'cb_{i}'] = v = filled(block, 10 + i, x12)
            job(f'cb_{i}', block.apply, v, x12)
        for i, kw in enumerate(ATTENTIONS):
            block = JGeneralizedAttention(num_heads=4, **kw)
            out[f'ga_{i}'] = v = filled(block, 20 + i, x12)
            job(f'ga_{i}', block.apply, v, x12)

        feats = [randn(50 + i, 2, h, w, c)
                 for i, ((h, w), c) in enumerate(zip(FPN_HW, FPN_IN))]
        out['fpn_in'] = feats
        for name, kw in FPNS.items():
            neck = JFPN(in_channels=FPN_IN, out_channels=64, num_outs=5,
                        add_extra_convs='on_output', **kw)
            out[f'fpn_{name}'] = v = filled(neck, 60, feats)
            job(f'fpn_{name}', neck.apply, v, feats)

        rois = randn(70, 6, 7, 7, 64)
        net = Shared2FCBBoxHeadNet(num_classes=4, in_channels=64, fc_dim=64,
                                   num_convs=4, num_fcs=1, conv_dim=64,
                                   conv_cfg=WS, norm_cfg=GN)
        out['bbox_in'], out['bbox'] = rois, filled(net, 71, rois)
        job('bbox', net.apply, out['bbox'], rois)
        mask_rois = randn(72, 6, 14, 14, 64)
        head = JFCNMaskHead(num_classes=4, num_convs=2, in_channels=64,
                            conv_out_channels=64, conv_cfg=WS, norm_cfg=GN)
        out['mask_in'] = mask_rois
        out['mask'] = filled(head.net, 73, mask_rois)
        job('mask', head.net.apply, out['mask'], mask_rois)
        for k, (compiled, args) in pending.items():
            out[f'{k}_out'] = compiled.result()(*args)
    finally:
        pool.shutdown()
    return dict(jax.tree_util.tree_map(np.asarray, out), t_batch=t_batch)


def assert_close(got, want, rtol=RTOL):
    """NCHW port tensors against NHWC JAX arrays: max |diff| within `rtol`
    of the largest |value|."""
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        w = w.transpose(0, 3, 1, 2) if w.ndim == 4 else w
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rtol * np.abs(w).max(), \
            float(np.abs(g - w).max() / np.abs(w).max())


def nchw1(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---- ConvWS and the plugins -------------------------------------------------
@pytest.mark.parametrize('name', sorted(CONV_WS))
def test_conv_ws_matches_jax(ref, name):
    """`ConvWS2d` (3x3, 16 -> 16 channels) against the JAX `ConvWS`; the
    grouped one standardizes each output channel over its own 4 x 3 x 3
    kernel values."""
    groups = CONV_WS[name]
    conv = ConvWS2d(16, 16, 3, 1, 1, groups=groups, bias=False)
    load(holder(conv1=conv), nested(ref[f'ws_{name}'], 'backbone', 'conv1'),
         'backbone.')
    w = conv.standardized_weight().detach()
    assert w.shape == (16, 16 // groups, 3, 3)
    flat = w.flatten(1)
    assert float(flat.mean(1).abs().max()) < 1e-6
    # unit std but for the eps on the kernel's own std (~0.08)
    np.testing.assert_allclose(flat.std(1).numpy(), 1.0, rtol=1e-3)
    with torch.no_grad():
        got = conv(nchw1(ref['x12'][..., :16]))
    assert_close(got, ref[f'ws_{name}_out'])


def assert_residual_close(got, want, x):
    """The block's output, and its residual (output minus input), within
    `RTOL` of their largest |value|."""
    assert_close(got, want)
    assert_close(got - nchw1(x), np.asarray(want) - x)


@pytest.mark.parametrize('i', range(len(CONTEXT_BLOCKS)),
                         ids=['-'.join((p, ) + f) for p, f in CONTEXT_BLOCKS])
def test_context_block_matches_jax(ref, i):
    pool, fusion = CONTEXT_BLOCKS[i]
    block = in_block(ContextBlock(32, pooling_type=pool,
                                  fusion_types=fusion),
                     ref[f'cb_{i}'], 'context_block')
    assert hasattr(block, 'conv_mask') == (pool == 'att')
    for f in fusion:
        layers = getattr(block, f'{f}_conv')
        assert layers[0].out_channels == 8
        assert tuple(layers[1].weight.shape) == (8, 1, 1)
    with torch.no_grad():
        got = block(nchw1(ref['x12']))
    assert_residual_close(got, ref[f'cb_{i}_out'], ref['x12'])


@pytest.mark.parametrize('i', range(len(ATTENTIONS)),
                         ids=[attention_id(kw) for kw in ATTENTIONS])
def test_generalized_attention_matches_jax(ref, i):
    kw = ATTENTIONS[i]
    block = in_block(GeneralizedAttention(32, num_heads=4, **kw),
                     ref[f'ga_{i}'], 'generalized_attention')
    at = kw['attention_type']
    assert hasattr(block, 'appr_bias') == (at[2] == '1')
    assert hasattr(block, 'geom_bias') == (at[3] == '1')
    assert hasattr(block, 'query_conv') == (at[0] == '1' or at[1] == '1')
    if at[2] == '1':
        assert tuple(block.appr_bias.shape) == (32, )
    with torch.no_grad():
        got = block(nchw1(ref['x12']))
    assert_residual_close(got, ref[f'ga_{i}_out'], ref['x12'])


def test_plugin_init_and_dtype():
    """The JAX initializers: a ContextBlock's fusion ends in a zero conv
    and an attention block's `gamma` is 0, so both start as the identity;
    a bf16 input computes in float32, as the JAX blocks promote it."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 32, 12, 16, generator=gen)
    for block in (ContextBlock(32, fusion_types=('channel_add', )),
                  GeneralizedAttention(32, num_heads=4)):
        block.init_weights(gen)
        with torch.no_grad():
            assert torch.equal(block(x), x)
            out = block(x.to(torch.bfloat16))
        assert out.dtype == torch.float32
    assert float(block.appr_bias.detach().std()) > 0
    assert float(block.gamma.detach()) == 0


# ---- the trunks -------------------------------------------------------------
@pytest.mark.parametrize('name', sorted(RESNETS))
def test_resnet_variant_matches_jax(ref, name):
    cls, _, kw = RESNETS[name]
    model = cls(depth=50, base_channels=32, **kw)
    load(model, nested(ref[f'resnet_{name}'], 'backbone'), 'backbone.')
    with torch.no_grad():
        got = model(torch.from_numpy(
            ref['x64'].transpose(0, 3, 1, 2).copy()))
    assert [tuple(g.shape[1:]) for g in got] == [
        (128, 16, 16), (256, 8, 8), (512, 4, 4), (1024, 2, 2)][:len(got)]
    assert_close(got, ref[f'resnet_{name}_out'])
    if name == 'plugins_dcn':
        # stage gating and mmcv's names (a second plugin of a type in a
        # block: its index among the stage's plugins)
        assert model.layer1[0].plugin_names == dict(
            after_conv1=['context_block'],
            after_conv2=['context_block_2'],
            after_conv3=['gen_attention_block'])
        assert model.layer2[1].plugin_names == dict(
            after_conv1=['gen_attention_block_2'], after_conv2=[],
            after_conv3=['context_block', 'gen_attention_block'])
        assert model.layer4[2].plugin_names == dict(
            after_conv1=['gen_attention_block_2'],
            after_conv2=['gen_attention_block', 'context_block_3'],
            after_conv3=['context_block'])
        assert model.layer1[0].context_block.pooling_type == 'avg'
        assert model.layer4[0].gen_attention_block.qk_dim == 256 // 4
        # the 'DCN' type: the DCNv2 layer on c3-c5, its offsets from the
        # filled tree (non-zero)
        dcns = [m for m in model.modules()
                if isinstance(m, ModulatedDeformConv2d)]
        assert len(dcns) == 4 + 6 + 3 and not isinstance(
            model.layer1[0].conv2, ModulatedDeformConv2d)
        assert float(dcns[0].conv_offset.weight.abs().min()) > 0
        return
    assert type(model.conv1) is ConvWS2d and hasattr(model, 'gn1')
    block = model.layer2[0]
    assert {type(block.conv2), type(block.downsample[0])} == {ConvWS2d}
    assert block.gn3.num_groups == 32 and not hasattr(block, 'bn3')
    if name == 'gn_ws_resnext':
        assert block.conv2.groups == 8 and block.conv2.in_channels == 32
    else:
        # frozen_stages=1: the stem's and layer1's GN affine are frozen
        assert not any(p.requires_grad for m in (model.gn1, model.layer1)
                       for p in m.parameters())
        assert all(p.requires_grad for p in model.layer2.parameters())


def test_dcn_v1_checkpoint_names_caveat_36():
    """A 'DCN' dcn builds DCNv2 (3 x 9 offset / mask channels a deform
    group); an mmcv DCNv1 checkpoint's 2 x 9 conv_offset rows fail to load
    with an error naming caveat 36."""
    model = ResNet(depth=50, base_channels=16, dcn=DCN,
                   stage_with_dcn=(False, True, True, True))
    sd = model.state_dict()
    key = 'layer2.0.conv2.conv_offset.weight'
    assert sd[key].shape[0] == 27
    sd[key] = sd[key][:18]
    sd[key.replace('weight', 'bias')] = sd[key.replace('weight',
                                                       'bias')][:18]
    with pytest.raises(RuntimeError, match='caveat 36'):
        model.load_state_dict(sd)


def test_zero_init_residual_and_basic_block_plugins():
    """`zero_init_residual` zeroes each block's last norm (GN and BN alike)
    at init; a BasicBlock ResNet drops its plugins with a warning, as the
    JAX package drops them; `sac` builds SAConv2d on the selected stages
    of a Bottleneck ResNet and is refused by a BasicBlock one."""
    gen = torch.Generator().manual_seed(0)
    for norm in (None, GN):
        model = ResNet(depth=50, base_channels=16, norm_cfg=norm,
                       zero_init_residual=True)
        model.init_weights(gen)
        last = [b.last_norm for n in model.res_layers
                for b in getattr(model, n)]
        assert len(last) == 16 and all(
            float(m.weight.abs().max()) == 0 for m in last)
        assert float(model.layer1[0].norm1.weight.min()) == 1.0
    with pytest.warns(UserWarning, match='BasicBlock.*caveat 39'):
        r18 = ResNet(depth=18, plugins=[dict(cfg=CB,
                                             position='after_conv3')])
    assert not any(isinstance(m, ContextBlock) for m in r18.modules())
    # SAC builds on the stages `stage_with_sac` selects, never on a
    # BasicBlock
    with torch.device('meta'):
        sac = ResNet(depth=50, sac=dict(type='SAC'),
                     stage_with_sac=(False, True, False, False))
    assert [n for n, m in sac.named_modules()
            if isinstance(m, SAConv2d)] == [f'layer2.{i}.conv2'
                                            for i in range(4)]
    with pytest.raises(ValueError, match='sac'):
        ResNet(depth=18, sac=dict(type='SAC'),
               stage_with_sac=(False, True, True, True))


# ---- neck and RoI heads -----------------------------------------------------
@pytest.mark.parametrize('name', sorted(FPNS))
def test_fpn_norms_match_jax(ref, name):
    kw = FPNS[name]
    neck = load(FPN(in_channels=FPN_IN, out_channels=64, num_outs=5,
                    add_extra_convs='on_output', **kw),
                nested(ref[f'fpn_{name}'], 'neck'), 'neck.')
    lateral, out = neck.lateral_convs[0], neck.fpn_convs[4]
    assert (lateral.norm_name is None) == (name == 'gn_ws_no_norm_on_lateral')
    assert (lateral.conv.bias is None) == (lateral.norm_name is not None)
    assert out.norm_name == ('bn' if name == 'bn' else 'gn')
    assert out.conv.bias is None and out.conv.stride == (2, 2)
    assert (type(out.conv) is ConvWS2d) == ('ws' in name)
    with torch.no_grad():
        got = neck([nchw1(f) for f in ref['fpn_in']])
    assert [tuple(g.shape[-2:]) for g in got] == list(FPN_HW) + [(1, 2)]
    assert_close(got, ref[f'fpn_{name}_out'])


def test_gn_ws_shared4conv1fc_bbox_head_matches_jax(ref):
    head = load(holder(roi_head=holder(bbox_head=ConvFCBBoxHead(
        4, 64, 7, num_convs=4, num_fcs=1, conv_out_channels=64,
        fc_out_channels=64, conv_cfg=WS, norm_cfg=GN))),
        nested(ref['bbox'], 'roi_head', 'bbox'), '').roi_head.bbox_head
    conv = head.shared_convs[3]
    assert type(conv.conv) is ConvWS2d and conv.conv.bias is None
    assert conv.gn.num_groups == 32
    with torch.no_grad():
        got = head(nchw1(ref['bbox_in']))
    for g, w in zip(got, ref['bbox_out']):
        assert_close(g, w)


def test_mask_head_drops_conv_and_norm_cfg_as_jax(ref):
    """The mask head reads neither `conv_cfg` nor `norm_cfg` (ROADMAP.md
    caveat 37): plain biased convs, the same logits as the head without the
    keys on the same weights, and the JAX head's within 1e-5."""
    with pytest.warns(UserWarning, match='caveat 37'):
        head = FCNMaskHead(num_classes=4, num_convs=2, in_channels=64,
                           conv_out_channels=64, conv_cfg=WS, norm_cfg=GN)
    plain = FCNMaskHead(num_classes=4, num_convs=2, in_channels=64,
                        conv_out_channels=64)
    load(holder(roi_head=holder(mask_head=head)),
         nested(ref['mask'], 'roi_head', 'mask'), '')
    assert sorted(head.state_dict()) == sorted(plain.state_dict())
    assert all(type(m.conv) is not ConvWS2d and m.conv.bias is not None
               for m in head.convs)
    plain.load_state_dict(head.state_dict(), strict=True)
    x = nchw1(ref['mask_in'])
    with torch.no_grad():
        got = head.logits(head.tower(x))
        assert torch.equal(got, plain.logits(plain.tower(x)))
    assert_close(got, ref['mask_out'])


# ---- the slice as a whole ---------------------------------------------------
@pytest.fixture(scope='module')
def slice_model(ref):
    with pytest.warns(UserWarning, match='caveat 37'):
        model = build_detector(slice_cfg())
    model.load_state_dict(state_dict_from_jax(
        ref['slice'], model.state_dict().keys()), strict=True)
    return model


def pair_detections(g_dets, g_labels, w_dets, w_labels):
    """Index arrays pairing one image's detections one to one, each with the
    one of its label nearest in box and score: equal scores (identical
    rois clipped to the image's edge) leave the NMS order between them
    free (ROADMAP.md caveat 2)."""
    cost = np.abs(g_dets[:, None] - w_dets[None]).sum(-1) + 1e6 * (
        g_labels[:, None] != w_labels[None])
    return linear_sum_assignment(cost)


def float32_error(got, want, exact):
    """max |got - exact| over max |exact| of each output."""
    return [float((g.double() - e).abs().max() / e.abs().max())
            for g, e in zip(got, exact)] if want is None else [
        float(np.abs(np.asarray(w, np.float64) - e.numpy()).max() /
              e.abs().max()) for w, e in zip(want, exact)]


def test_gcnet_gn_ws_mask_rcnn_forward_test_matches_jax(ref, slice_model,
                                                        monkeypatch):
    """The trunk (R50 + GCNet + GN + ConvWS, FPN): JAX's float32 features no
    farther from the port's float64 features than 3x the port's own float32
    ones (1e-5 of the largest is below float32's error here: ~1e-4 on both
    sides). The heads: `forward_test` on JAX's features against JAX's, the
    same kept set, boxes within 5e-3 px, each detection's mask within the
    head bounds. Then the port's own `forward_test`, whole."""
    assert sum(isinstance(m, ContextBlock)
               for m in slice_model.backbone.modules()) == 4 + 6 + 3
    t = ref['t_batch']
    j_feats, want, _ = ref['slice_out']
    slice_model.eval()
    with torch.no_grad():
        feats = slice_model.extract_feat(t['image'])
        exact = copy.deepcopy(slice_model).double().extract_feat(
            t['image'].double())
    own, jax_err = float32_error(feats, None, exact), float32_error(
        None, [w.transpose(0, 3, 1, 2) for w in j_feats], exact)
    assert all(j <= 3 * p + 1e-6 for j, p in zip(jax_err, own)), \
        (jax_err, own)
    batch = dict(image=t['image'], img_hw=t['img_hw'],
                 scale_factor=torch.ones(2, 4))
    with torch.no_grad():
        whole = slice_model.forward_test(batch, rescale=True)
        monkeypatch.setattr(slice_model, 'extract_feat',
                            lambda images: [nchw1(f) for f in j_feats])
        got = slice_model.forward_test(batch, rescale=True)
    assert len(got) == 4 and got[3].shape == (2, 100, 28, 28)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    for i in range(2):
        ok = want[2][i]
        assert ok.sum() > 10
        g, w = pair_detections(*(a[i][ok] for a in (got[0].numpy(),
                                                     got[1].numpy(),
                                                     want[0], want[1])))
        np.testing.assert_array_equal(got[1][i].numpy()[ok][g],
                                      want[1][i][ok][w])
        np.testing.assert_allclose(got[0][i].numpy()[ok][g],
                                   want[0][i][ok][w], rtol=0, atol=5e-3)
        assert_head_close(got[3][i].numpy()[ok][g], want[3][i][ok][w])
    assert [tuple(a.shape) for a in whole] == [tuple(a.shape) for a in got]
    assert int(whole[2].sum()) > 0 and all(
        bool(torch.isfinite(a.float()).all()) for a in whole)


def test_gcnet_gn_ws_mask_rcnn_losses_match_jax(ref, slice_model):
    """The loss dict of the port's whole `forward_train`, samplers picking
    every candidate: the RPN's, the RoI head's and loss_mask at rtol
    2e-4."""
    want = ref['slice_out'][2]
    assert sorted(want) == ['loss_bbox', 'loss_cls', 'loss_mask',
                            'loss_rpn_bbox', 'loss_rpn_cls']
    got = slice_model.train().forward_train(
        ref['t_batch'], torch.Generator().manual_seed(0))
    assert_losses_close(got, want)


# ---- configs and weights ----------------------------------------------------
CONFIGS = sorted(
    os.path.relpath(p, ROOT) for d in ('gcnet', 'empirical_attention', 'gn',
                                       'gn+ws', 'scratch', 'dcn')
    for p in glob.glob(os.path.join(ROOT, 'configs', d, '*.py'))
    if 'pool' not in os.path.basename(p))


@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    """Each of the 49 configs builds on the meta device in its own dtype,
    with its variant where the config puts it."""
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')    # the mask heads' caveat 37
        with torch.device('meta'):
            model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    backbone = model.backbone
    mods = list(backbone.modules())
    plugins = cfg.model.backbone.get('plugins') or []
    n_cb = sum(isinstance(m, ContextBlock) for m in mods)
    n_ga = sum(isinstance(m, GeneralizedAttention) for m in mods)
    assert (n_cb > 0) == any(p['cfg']['type'] == 'ContextBlock'
                             for p in plugins)
    assert (n_ga > 0) == any(p['cfg']['type'] == 'GeneralizedAttention'
                             for p in plugins)
    if n_ga:
        # c4-c5 after conv2, 8 heads
        assert n_ga == 6 + 3 and backbone.layer3[0].gen_attention_block \
            .num_heads == 8
    dcns = sum(isinstance(m, ModulatedDeformConv2d) for m in mods)
    assert (dcns > 0) == (cfg.model.backbone.get('dcn') is not None)
    gn = (cfg.model.backbone.get('norm_cfg') or {}).get('type') == 'GN'
    assert hasattr(backbone, 'gn1') == gn
    ws = (cfg.model.backbone.get('conv_cfg') or {}).get('type') == 'ConvWS'
    assert (type(backbone.layer1[0].conv1) is ConvWS2d) == ws
    if gn:
        assert model.neck.lateral_convs[0].norm_name == 'gn'


FULL_WIDTH = {
    'cascade_x101_dcn_gcb': 'configs/gcnet/cascade_mask_rcnn_x101_32x4d_fpn_'
    'syncbn-backbone_dconv_c3-c5_r4_gcb_c3-c5_1x_coco.py',
    'attention_1111': 'configs/empirical_attention/'
    'faster_rcnn_r50_fpn_attention_1111_1x_coco.py',
    'gn_ws_mask': 'configs/gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py'}


@pytest.mark.parametrize('name', sorted(FULL_WIDTH))
def test_state_dict_from_jax_full_width(name):
    """The JAX detector's `jax.eval_shape` tree -> the port's keys and
    shapes, strictly. The JAX converter cannot carry the port's state dict
    back: it has no plugin or GN rule, leaves `context_block` /
    `gen_attention_block` and `gnX` keys unmapped, and maps a GN shortcut
    norm (`downsample.1`) into a BN's scope."""
    path = os.path.join(ROOT, FULL_WIDTH[name])
    j_det = j_build_detector(JConfig.fromfile(path).model)
    shapes = jax.eval_shape(lambda: j_det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 64, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')    # the mask head's caveat 37
        with torch.device('meta'):
            model = build_detector(Config.fromfile(path).model)
    own = model.state_dict()
    sd = state_dict_from_jax(tree, own.keys())
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    # strict, and in place of the meta tensors (no copy of ~100M values)
    model.load_state_dict(sd, strict=True, assign=True)
    assert not any(p.is_meta for p in model.parameters())
    conv = convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items() if k.startswith('backbone.')})
    unmapped = conv['_unmapped']
    if name == 'gn_ws_mask':
        assert any('.gn1.' in k for k in unmapped)
        paths = {jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_leaves_with_path(conv['params'])}
        assert any("['downsample_norm']['bn']" in p for p in paths)
    else:
        plugin = 'context_block' if 'gcb' in name else 'gen_attention_block'
        assert any(plugin in k for k in unmapped)
