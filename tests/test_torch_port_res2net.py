"""The port's Res2Net and ResNet-V1d against the JAX package on the same
weights, and the Res2Net-101-DCN teacher rows of configs/im/ and
configs/imv2/.

The weights go JAX -> port: `jax.eval_shape` of the JAX module's init
gives the variable tree, numpy fills it from a seed (BN statistics and
affine random, variances positive; DCN `conv_offset` kernels large enough
that the taps move by pixels), and `state_dict_from_jax` carries it onto
the port's mmdet names. (The JAX package's `convert_torch_state_dict`
cannot go the other way for these backbones: ROADMAP.md Queue C,
caveat 16.) Inputs come from numpy seeds, at sizes divisible by 32, where
the avg-down pool's floor equals mmdet's ceil (caveat 15):
  * a 2-stage Res2Net-50 (DCN on stage 2, the stem frozen) at 1x3x64x64:
    the forward within 1e-4 of the largest output, the parameter gradients
    of a random cotangent against `jax.grad` within 2e-4 of each tensor's
    largest (the frozen stem gets none), and in bf16 against the JAX bf16
    module within the JAX package's bf16 bound of 0.15;
  * a full Res2Net-50-DCN with the configs' stage_with_dcn and
    frozen_stages=1, and a ResNet-V1d-50 at base_channels 16, at
    1x3x64x96: the forward within 1e-4 of the largest output, the BN
    fold's pair count equal to the JAX fold's (the split BNs stay
    unfolded) with the folded forward equal to the unfolded one, and the
    state dict's names and tensors;
  * the slice as a whole: `forward_test` of the GFLv2-Res2Net-DCN teacher
    config at depth 50 and 64x96 against the JAX detector's dets and
    labels (the NMS through its plain version); the six Res2Net configs
    built on the meta device; one port step of the IMv2 R2N101-DCN -> R101
    config with an R18 student and that teacher.

Most of the file's time is JAX tracing and compiling (a Res2Net-DCN traces
slowly: every DCN layer is a few hundred ops), so the `ref` fixture traces
each JAX program once and compiles them side by side.
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
from ld_tpu.models.backbones import Res2Net as JRes2Net
from ld_tpu.models.backbones import ResNetV1d as JResNetV1d
from ld_tpu.utils.fuse_conv_bn import fuse_conv_bn as jax_fuse_conv_bn
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones import Res2Net, ResNet, ResNetV1d
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                   make_train_step)
from ld_tpu_torch.testing import detection_batch
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
from ld_tpu_torch.utils.registry import BACKBONES
from test_torch_port_bridge import O0, assert_dets_close
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DCN = dict(type='DCNv2', deform_groups=1, fallback_on_stride=False)
# the configs' Res2Net-101-DCN, cut to depth 50
R2N50_DCN = dict(depth=50, scales=4, base_width=26, frozen_stages=1,
                 norm_eval=True, dcn=DCN,
                 stage_with_dcn=(False, True, True, True))
# two stages: stride-1 and stride-2 stage blocks, normal blocks, both
# shortcuts, DCN splits at stride 2 and 1; its tree is the first two
# stages' share of R2N50_DCN's
R2N50_2STAGE = dict(depth=50, num_stages=2, out_indices=(0, 1),
                    frozen_stages=0, dcn=DCN,
                    stage_with_dcn=(False, True, False, False))
V1D50 = dict(depth=50, base_channels=16, frozen_stages=1)
TEACHER_CFG = os.path.join(ROOT, 'configs/imv2/gflv2_r2n101_dcn_fpn_2x.py')
IM_CFG = os.path.join(ROOT, 'configs/imv2/im_r101_gflv2_r2n101_dcn_2x.py')
RES2NET_CONFIGS = ('configs/imv2/gflv2_r2n101_dcn_fpn_2x.py',
                   'configs/imv2/im_r101_gflv2_r2n101_dcn_2x.py',
                   'configs/imv2/im_gflv2_r2n101_dcn_self-2x.py',
                   'configs/imv2/im_gflv2_x101-32x4dr2n101_dcn_2x.py',
                   'configs/im/gflv2_r2n101_dcn_fpn_2x.py',
                   'configs/im/im_gflv2_r2n101_dcn_fpn_2x.py')
HW = (64, 96)
TWO_STAGE_HW = (64, 64)
IMG_HW = np.array([[64, 90]], np.float32)


def filled_variables(shapes, seed):
    """A variable tree of `jax.eval_shape` shapes filled with numpy from
    `seed`: conv kernels of std 1/sqrt(fan_in), DCN `conv_offset` kernels
    of std 2/sqrt(fan_in) and biases of std 1 (taps moved by about 2
    pixels), other biases, BN and GN affine and BN statistics uniform
    around their identity values, the head's level scales 0.8 to 1.2."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [getattr(p, 'key', None) for p in path]
        name, shape = keys[-1], leaf.shape
        if name == 'kernel':
            std = (2.0 if 'conv_offset' in keys else 1.0) / np.sqrt(
                np.prod(shape[:-1]))
            value = rng.standard_normal(shape, np.float32) * std
        elif name == 'bias' and 'conv_offset' in keys:
            value = rng.standard_normal(shape, np.float32)
        elif name in ('scale', 'var'):
            value = rng.uniform(0.8, 1.2, shape)
        elif name in ('bias', 'mean'):
            value = rng.uniform(-0.1, 0.1, shape)
        elif name == 'scales':
            value = np.float32([1.0, 1.1, 0.9, 1.2, 0.8])
        else:
            raise KeyError(keys)
        return np.asarray(value, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def init_variables(module, inputs, seed):
    return filled_variables(jax.eval_shape(
        module.init, jax.random.PRNGKey(0), inputs), seed)


def two_stage_variables(variables):
    return {coll: {k: v for k, v in tree.items()
                   if k.startswith(('stem_', 'layer1_', 'layer2_'))}
            for coll, tree in variables.items()}


def as_backbone(variables):
    return {coll: {'backbone': tree} for coll, tree in variables.items()}


def nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def image(seed, hw=HW):
    return np.random.RandomState(seed).randn(1, 3, *hw).astype(np.float32)


def _teacher_cfg(package_config):
    cfg = package_config.fromfile(TEACHER_CFG)
    cfg.model.backbone.depth = 50
    return cfg


@pytest.fixture(scope='module')
def ref():
    """Every JAX result the tests hold the port against, on numpy-filled
    variables:
      * the Res2Net-50-DCN (R2N50_DCN) and the ResNet-V1d-50 on `image(5)`;
      * the 2-stage model on `image(0, TWO_STAGE_HW)`: its outputs and the
        parameter gradients of the summed product with `cots`; in bf16 (the
        input rounded to bf16), compiled with XLA's excess precision off,
        so that every op rounds to bf16 as it does run op by op (under a
        plain jit XLA keeps float32 between fused bf16 ops);
      * the depth-50 teacher detector's dets on `image(5)`: its FPN, head
        and decode on the Res2Net-50-DCN's outputs (cls bias 0, so that
        the decode sees candidates).
    Returns a dict of numpy trees and outputs."""
    x, x2 = nhwc(image(5)), nhwc(image(0, TWO_STAGE_HW))
    x2_16 = jnp.asarray(x2, jnp.bfloat16)
    r2n, two, v1d = (JRes2Net(**R2N50_DCN), JRes2Net(**R2N50_2STAGE),
                     JResNetV1d(**V1D50))
    two16 = JRes2Net(**R2N50_2STAGE, dtype=jnp.bfloat16)
    det = jax_build_detector(_teacher_cfg(JConfig).model)
    out = dict(r2n50=init_variables(r2n, x, seed=6),
               v1d=init_variables(v1d, x, seed=7),
               cots=[np.random.RandomState(2 + i).randn(1, *hw, c).astype(
                   np.float32) for i, (hw, c) in enumerate(
                       (((16, 16), 256), ((8, 8), 512)))])
    two_vars = two_stage_variables(out['r2n50'])

    def two_grads(params):
        outs = two.apply(dict(two_vars, params=params), x2)
        return sum(jnp.sum(o * c) for o, c in zip(outs, out['cots'])), outs

    def tail(neck, head, feats):
        fpn = det.neck.apply(neck, feats)
        return det.bbox_head.get_bboxes(det.bbox_head.net.apply(
            head, list(fpn)), jnp.asarray(IMG_HW))

    # each program compiles (at LLVM -O0) in a thread as soon as it is
    # traced; the bf16 one with XLA's excess precision off too
    pool = ThreadPoolExecutor(5)
    lowered, compiled = {}, {}

    def submit(name, lowering, **options):
        lowered[name] = lowering
        compiled[name] = pool.submit(lowering.compile,
                                     compiler_options=dict(O0, **options))
    submit('r2n50', jax.jit(r2n.apply).lower(out['r2n50'], x))
    submit('two', jax.jit(jax.grad(two_grads, has_aux=True)).lower(
        two_vars['params']))
    submit('two16', jax.jit(two16.apply).lower(two_vars, x2_16),
           xla_allow_excess_precision=False)
    submit('v1d', jax.jit(v1d.apply).lower(out['v1d'], x))
    feats = lowered['r2n50'].out_info
    neck = init_variables(det.neck, feats, seed=8)
    head = init_variables(det.bbox_head.net, list(jax.eval_shape(
        det.neck.apply, neck, feats)), seed=9)
    head['params']['gfl_cls']['bias'][:] = 0
    submit('tail', jax.jit(tail).lower(neck, head, feats))
    compiled = {k: f.result() for k, f in compiled.items()}
    pool.shutdown()

    out['r2n50_out'] = compiled['r2n50'](out['r2n50'], x)
    out['v1d_out'] = compiled['v1d'](out['v1d'], x)
    out['two_grads'], out['two_out'] = compiled['two'](two_vars['params'])
    out['two16_out'] = compiled['two16'](two_vars, x2_16)
    out['dets'] = compiled['tail'](neck, head, out['r2n50_out'])
    out['teacher'] = {
        'params': dict(backbone=out['r2n50']['params'],
                       neck=neck['params'], head_net=head['params']),
        'batch_stats': dict(backbone=out['r2n50']['batch_stats'])}
    return jax.device_get(out)


def port_backbone(cls, kw, variables, dtype=None):
    """The port backbone `cls(**kw)` holding the JAX `variables`, loaded
    strictly, in eval."""
    model = cls(**kw, dtype=dtype)
    keys = [f'backbone.{k}' for k in model.state_dict()]
    sd = state_dict_from_jax(as_backbone(variables), keys)
    model.load_state_dict({k[len('backbone.'):]: v for k, v in sd.items()},
                          strict=True)
    return model.eval()


def assert_outputs_close(got, want, tol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().float().numpy(), nchw(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


def jax_fold_pairs(variables):
    folded = jax_fuse_conv_bn(variables)
    return sum(1 for path, leaf in jax.tree_util.tree_leaves_with_path(
        folded['batch_stats'])
        if path[-1].key == 'var' and np.allclose(leaf, 1.0 - 1e-5))


# ---- a 2-stage Res2Net-50: forward, gradients, bf16 -------------------------
def test_two_stage_res2net_forward_and_grads_match_jax(ref):
    variables = two_stage_variables(ref['r2n50'])
    model = port_backbone(Res2Net, R2N50_2STAGE, variables).train()
    assert isinstance(model.layer2[0].convs[0], ModulatedDeformConv2d)
    assert model.layer2[0].convs[0].stride == 2
    got = model(torch.from_numpy(image(0, TWO_STAGE_HW)))
    assert_outputs_close(got, ref['two_out'])
    sum((o * torch.from_numpy(nchw(c))).sum()
        for o, c in zip(got, ref['cots'])).backward()

    keys = [f'backbone.{k}' for k in model.state_dict()]
    want_grads = state_dict_from_jax(
        {'params': {'backbone': ref['two_grads']}}, keys)
    checked = 0
    for name, p in model.named_parameters():
        w = want_grads[f'backbone.{name}'].numpy()
        if name.startswith('stem.'):
            # frozen: no gradient here, zeros behind the JAX stop_gradient
            assert not p.requires_grad and p.grad is None, name
            assert not w.any(), name
            continue
        assert np.abs(w).max() > 0, name
        assert np.abs(p.grad.numpy() - w).max() <= 2e-4 * np.abs(w).max(), \
            name
        checked += 1
    assert checked == len(list(model.parameters())) - 9


def test_two_stage_res2net_bf16_matches_jax(ref):
    """The port's bf16 trunk against the JAX bf16 module, both on the
    float32 variables (caveat 13)."""
    model = port_backbone(Res2Net, R2N50_2STAGE,
                          two_stage_variables(ref['r2n50']), 'bfloat16')
    with torch.no_grad():
        got = model(torch.from_numpy(image(0, TWO_STAGE_HW)).to(
            torch.bfloat16))
    for g, w in zip(got, ref['two16_out']):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        diff = np.abs(g.float().numpy() - nchw(w))
        assert diff.max() <= 0.15, float(diff.max())


# ---- the full Res2Net-50-DCN and ResNet-V1d-50 -------------------------------
BACKBONE_CASES = {'res2net50_dcn': (Res2Net, R2N50_DCN, 'r2n50', 39),
                  'resnetv1d50': (ResNetV1d, V1D50, 'v1d', 55)}


@pytest.fixture(scope='module')
def backbones(ref):
    """Each backbone in the port on `image(5)`: {name: (port model, JAX
    variables, port outputs, JAX outputs)}."""
    out = {}
    for name, (cls, kw, key, _) in BACKBONE_CASES.items():
        model = port_backbone(cls, kw, ref[key])
        with torch.no_grad():
            got = model(torch.from_numpy(image(5)))
        out[name] = (model, ref[key], got, ref[f'{key}_out'])
    return out


@pytest.mark.parametrize('name', sorted(BACKBONE_CASES))
def test_backbone_matches_jax(backbones, name):
    model, _, got, want = backbones[name]
    assert_outputs_close(got, want)
    if name == 'res2net50_dcn':
        assert [tuple(g.shape[1:]) for g in got] == [
            (256, 16, 24), (512, 8, 12), (1024, 4, 6), (2048, 2, 3)]
        assert sum(isinstance(m, ModulatedDeformConv2d)
                   for m in model.modules()) == 3 * (4 + 6 + 3)
        # frozen_stages=1: the stem and layer1 get no gradient
        assert not any(p.requires_grad for m in (model.stem, model.layer1)
                       for p in m.parameters())
        assert all(p.requires_grad for p in model.layer2.parameters())


@pytest.mark.parametrize('name', sorted(BACKBONE_CASES))
def test_backbone_fold(backbones, name):
    """The fold pairs what the JAX fold pairs: the stem's, `bn1`, `bn3` (and
    a ResNet's `bn2`) and the shortcut's BN, never a Res2Net `bns`; the
    folded backbone computes the unfolded one's outputs."""
    model, variables, got, _ = backbones[name]
    folded = copy.deepcopy(model)
    pairs = fuse_conv_bn(folded)
    assert pairs == jax_fold_pairs(variables) == BACKBONE_CASES[name][3]
    with torch.no_grad():
        after = folded(torch.from_numpy(image(5)))
    for a, b in zip(after, got):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert torch.equal(folded.stem[4].running_mean,
                       torch.zeros_like(model.stem[4].running_mean))
    if name == 'res2net50_dcn':
        # the split BNs and their DCN convs stay as they were
        block, before = folded.layer3[0], model.layer3[0]
        assert torch.equal(block.bns[0].running_var,
                           before.bns[0].running_var)
        assert torch.equal(block.convs[0].weight, before.convs[0].weight)
        assert not torch.equal(block.conv1.weight, before.conv1.weight)


@pytest.mark.parametrize('name', sorted(BACKBONE_CASES))
def test_backbone_state_dict_from_jax(backbones, name):
    """JAX tree -> mmdet names: the deep stem, the avg-down shortcut's conv
    and BN behind its pool, a DCN split's conv_offset; every tensor of the
    strictly loaded model is the carried one."""
    model, variables = backbones[name][:2]
    own = model.state_dict()
    keys = [f'backbone.{k}' for k in own]
    sd = state_dict_from_jax(as_backbone(variables), keys)
    assert sorted(sd) == sorted(keys)
    for k, v in own.items():
        assert torch.equal(sd[f'backbone.{k}'], v), k
    p = variables['params']
    np.testing.assert_array_equal(
        own['stem.3.weight'].numpy(),
        p['stem_conv2']['kernel'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(own['stem.7.running_var'].numpy(),
                                  variables['batch_stats']['stem_norm3']
                                  ['bn']['var'])
    np.testing.assert_array_equal(
        own['layer2.0.downsample.1.weight'].numpy(),
        p['layer2_0']['downsample_conv']['kernel'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        own['layer2.0.downsample.2.weight'].numpy(),
        p['layer2_0']['downsample_norm']['bn']['scale'])
    assert isinstance(model.layer2[0].downsample[0], torch.nn.AvgPool2d)
    assert isinstance(model.layer1[0].downsample[0], torch.nn.Identity)
    if name == 'res2net50_dcn':
        assert own['layer4.2.convs.2.conv_offset.weight'].shape == (
            27, 208, 3, 3)
        np.testing.assert_array_equal(
            own['layer1.1.bns.2.weight'].numpy(),
            p['layer1_1']['bns2']['bn']['scale'])
        # a Res2Net tree tells its layout without the target's keys
        assert sorted(state_dict_from_jax(as_backbone(variables))) == \
            sorted(keys)
    else:
        # a ResNet tree does not: without keys, the plain layout
        assert 'backbone.layer1.0.downsample.0.weight' in \
            state_dict_from_jax(as_backbone(variables))


# ---- the slice as a whole ----------------------------------------------------
def test_teacher_forward_test_matches_jax(ref):
    """The GFLv2-Res2Net-DCN teacher config at depth 50 (full FPN and head
    width): the port's forward_test at 1x3x64x96 against the JAX
    detector's backbone, neck, head and decode, the NMS through its plain
    version on both sides."""
    model = build_detector(_teacher_cfg(Config).model)
    model.load_state_dict(state_dict_from_jax(
        ref['teacher'], model.state_dict().keys()), strict=True)
    with torch.no_grad():
        got = model.eval().forward_test(dict(
            image=torch.from_numpy(image(5)),
            img_hw=torch.from_numpy(IMG_HW)))
    assert int(got[2].sum()) > 10
    assert_dets_close(got, ref['dets'], tol=1e-3)


def test_res2net_configs_build():
    """Every Res2Net config of configs/im/ and configs/imv2/ builds (on the
    meta device); the R2N101-DCN teacher has 3 DCN splits a block in
    stages 2-4, 90 in all."""
    assert not {'Res2Net', 'ResNetV1d'} & set(BACKBONES.not_ported)
    assert isinstance(ResNet(depth=50, deep_stem=True, avg_down=True).stem,
                      torch.nn.Sequential)
    with pytest.raises(KeyError):
        Res2Net(depth=18)
    with pytest.raises(NotImplementedError, match='DCN'):
        Res2Net(depth=50, dcn=dict(type='DCN'),
                stage_with_dcn=(False, True, True, True))
    for path in RES2NET_CONFIGS:
        cfg = Config.fromfile(os.path.join(ROOT, path))
        with torch.device('meta'):
            model = build_detector(cfg.model, dtype='bfloat16')
        teacher = getattr(model, 'teacher', model)
        assert isinstance(teacher.backbone, Res2Net), path
        dcns = [m for m in teacher.backbone.modules()
                if isinstance(m, ModulatedDeformConv2d)]
        assert len(dcns) == 90, path
        assert {m.in_channels for m in dcns} == {52, 104, 208}
        if teacher is model:
            # the served teacher is lowered with the config's dtype
            assert {m.compute_dtype for m in dcns} == {torch.bfloat16}
        else:
            # a teacher named by path stays float32
            assert {m.compute_dtype for m in dcns} == {None}
            if 'self' in path:
                assert {m.compute_dtype for m in model.backbone.modules()
                        if isinstance(m, ModulatedDeformConv2d)} == {
                            torch.bfloat16}


def test_imv2_res2net_step_runs(ref):
    """One step of the IMv2 R2N101-DCN -> R101 config with an R18 student
    (widths kept) from seed 0 and the depth-50 teacher on `ref`'s weights,
    BNs folded, at 1x3x64x96: the loss terms finite, the GI imitation loss
    positive, the frozen stage untouched."""
    cfg = Config.fromfile(IM_CFG)
    cfg.model.backbone.depth = 18
    cfg.model.neck.in_channels = [64, 128, 256, 512]
    cfg.model.teacher_config = dict(model=_teacher_cfg(Config).model)
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.teacher.load_state_dict(state_dict_from_jax(
        ref['teacher'], model.teacher.state_dict().keys()), strict=True)
    assert model.fold_teacher_bn()
    schedule = build_lr_schedule(cfg.optimizer['lr'], cfg.lr_config, 100,
                                 cfg.runner['max_epochs'])
    optimizer, scheduler = build_optimizer(cfg.optimizer, schedule, model)
    step = make_train_step(model, optimizer, scheduler)
    frozen = model.backbone.layer1[0].conv1.weight.clone()
    losses = step(detection_batch(1, *HW, seed=3, device='cpu'))
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert float(losses['loss_im']) > 0
    assert torch.equal(model.backbone.layer1[0].conv1.weight, frozen)
