"""The port's DetectoRS pieces (SAConv2d, DetectoRS_ResNet, the RFP neck) and
the remaining necks (NAS-FPN, FPN_CARAFE, NASFCOS_FPN, FPG, PAFPN,
ChannelMapper) against the JAX package on the same weights and inputs, and
the configs of configs/detectors/, fpg/, carafe/, nas_fcos/, nas_fpn/ and
pafpn/.

Weights go JAX -> port: `jax.eval_shape` of the JAX init, `fill_tree` from a
numpy seed (which also makes the zero-init SAC switch and contexts and the
RFP gates non-zero, so that no blend is constant) and `state_dict_from_jax`
onto the port's names. The JAX converter carries none of the new names
(asserted). Float32 on the CPU:
  * `SAConv2d` at stride 1 and 2 on a 2x8x16x16 input: within 1e-5 of the
    output's largest;
  * `DetectoRS_ResNet` at depth 50, SAC on stages 2-4, in eval on a
    1x3x64x64 input: each stage within 1e-4 of its largest;
  * each neck at width 32 on the four maps of a 128x128 image (so every
    resize ratio is an integer), `stack_times` 2: each level within 1e-5
    of the largest output;
  * DetectoRS Cascade R-CNN and NAS-FPN RetinaNet at full width on the
    meta device: the port's state-dict names and shapes are exactly
    `state_dict_from_jax` of the JAX `jax.eval_shape` tree, and the
    RetinaNet's `forward_test` runs there;
  * every config of the six folders builds.

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
from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.models.backbones.resnet import SAConv as JSAConv
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu.utils.registry import BACKBONES as JAX_BACKBONES
from ld_tpu.utils.registry import NECKS as JAX_NECKS
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones import DetectoRS_ResNet, SAConv2d
from ld_tpu_torch.models.heads import NASFCOSHead
from ld_tpu_torch.models.necks import RFP
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import BACKBONES, NECKS
from test_torch_port_bridge import fill_tree
from test_torch_port_paa_fsaf_freeanchor import numpy_tree
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ('detectors', 'fpg', 'carafe', 'nas_fcos', 'nas_fpn', 'pafpn')
CONFIGS = sorted(os.path.relpath(p, ROOT) for g in GROUPS
                 for p in glob.glob(os.path.join(ROOT, 'configs', g, '*.py')))
CHANS = [16, 32, 64, 128]
CARAFE_CFG = dict(type='carafe', up_kernel=5, up_group=1, encoder_kernel=3,
                  encoder_dilation=1, compressed_channels=16)
NECK_CFGS = {
    'NASFPN': dict(type='NASFPN', in_channels=CHANS[1:], out_channels=32,
                   num_outs=5, stack_times=2, start_level=1),
    'FPN_CARAFE': dict(type='FPN_CARAFE', in_channels=CHANS, out_channels=32,
                       num_outs=5, upsample_cfg=CARAFE_CFG),
    'NASFCOS_FPN': dict(type='NASFCOS_FPN', in_channels=CHANS,
                        out_channels=32, num_outs=5, start_level=1),
    'FPG': dict(type='FPG', in_channels=CHANS, out_channels=32, num_outs=5,
                stack_times=2),
    'RFP': dict(type='RFP', in_channels=CHANS, out_channels=32, num_outs=5,
                rfp_steps=2),
    'PAFPN': dict(type='PAFPN', in_channels=CHANS, out_channels=32,
                  num_outs=5),
    'PAFPN_on_input': dict(type='PAFPN', in_channels=CHANS, out_channels=32,
                           num_outs=5, start_level=1,
                           add_extra_convs='on_input',
                           relu_before_extra_convs=True),
    'ChannelMapper': dict(type='ChannelMapper', in_channels=CHANS,
                          out_channels=32),
}
# a name of each neck's that only the port's mapping knows
NEW_NAMES = {
    'NASFPN': ['fpn_stages.1.gp_64_4.out_conv.conv.weight',
               'extra_downsamples.2.0.conv.bias'],
    'FPN_CARAFE': ['upsample_modules.2.content_encoder.weight',
                   'upsample_modules.0.channel_compressor.bias'],
    'NASFCOS_FPN': ['cells.3.gn.weight', 'extra_convs.1.conv.weight'],
    'FPG': ['stages.1.0.across.gn.bias', 'stages.0.4.up.conv.weight',
            'stages.1.3.down.conv.bias'],
    'RFP': ['rfp_aspp.0.4.aspp.3.weight', 'rfp_refine.0.2.bias',
            'rfp_weight.0.0.weight'],
    'PAFPN': ['downsample_convs.2.conv.weight', 'pafpn_convs.0.conv.bias'],
    'PAFPN_on_input': ['pafpn_convs.1.conv.weight'],
    'ChannelMapper': ['convs.3.conv.weight'],
}
# one config of each group, held at full width by names and shapes
FULL_WIDTH = {
    'detectors': 'configs/detectors/detectors_cascade_rcnn_r50_1x_coco.py',
    'nas_fpn': 'configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py',
}
SAC_BACKBONE = dict(depth=50, num_stages=4, out_indices=(0, 1, 2, 3),
                    frozen_stages=1, sac=dict(type='SAC'),
                    stage_with_sac=(False, True, True, True))


def neck_inputs(seed=0):
    """The four maps of a 128x128 image (strides 4-32), NHWC numpy."""
    rs = np.random.RandomState(seed)
    return [rs.randn(1, 128 // s, 128 // s, c).astype(np.float32)
            for c, s in zip(CHANS, (4, 8, 16, 32))]


def nchw(arrays):
    return [torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2))) for a in arrays]


@pytest.fixture(scope='module')
def ref():
    """The JAX trees (numpy) and outputs of every module the tests hold the
    port against."""
    out, jobs = {}, {}
    ins = [jnp.asarray(x) for x in neck_inputs()]
    for name, cfg in NECK_CFGS.items():
        kw = dict(cfg)
        net = JAX_NECKS.get(kw.pop('type'))(**kw)
        tree = fill_tree(jax.eval_shape(
            lambda net=net: net.init(jax.random.PRNGKey(0), ins)), seed=1)
        out[name] = tree
        jobs[name] = (net.apply, (tree, ins))
    rs = np.random.RandomState(2)
    for stride in (1, 2):
        x = jnp.asarray(rs.randn(2, 16, 16, 8).astype(np.float32))
        net = JSAConv(12, stride=stride)
        tree = fill_tree(jax.eval_shape(
            lambda net=net, x=x: net.init(jax.random.PRNGKey(0), x)),
            seed=3 + stride)
        out[f'saconv{stride}'] = (tree, np.asarray(x))
        jobs[f'saconv{stride}'] = (net.apply, (tree, x))
    # the full-width DetectoRS Cascade R-CNN's tree, whose SAC R50 is the
    # trunk the tests run
    det = j_build_detector(JConfig.fromfile(os.path.join(
        ROOT, FULL_WIDTH['detectors'])).model)
    shapes = out['detectors_shapes'] = jax.eval_shape(
        lambda: det.init_variables(jax.random.PRNGKey(0), (1, 128, 128, 3)))
    trunk = JAX_BACKBONES.get('DetectoRS_ResNet')(**SAC_BACKBONE)
    image = jnp.asarray(rs.randn(1, 64, 64, 3).astype(np.float32))
    tree = fill_tree({c: t['backbone'] for c, t in shapes.items()}, seed=6)
    out['trunk'] = (tree, np.asarray(image))
    jobs['trunk'] = (lambda v, x: trunk.apply(v, x, train=False),
                     (tree, image))

    o0 = dict(xla_backend_optimization_level=0)
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=o0)
                   for k, (fn, args) in jobs.items()}
    for k, (fn, args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*args)
    shapes = out.pop('detectors_shapes')
    return dict(numpy_tree(out), detectors_shapes=shapes)


def assert_close(got, want, rtol):
    """Each output within `rtol` of the largest magnitude of all."""
    want = [np.asarray(w) for w in want]
    bound = rtol * max(np.abs(w).max() for w in want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy().transpose(0, 2, 3, 1)
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= bound


def port_neck(name, tree):
    neck = NECKS.build(dict(NECK_CFGS[name]))
    keys = ['neck.' + k for k in neck.state_dict()]
    sd = state_dict_from_jax({coll: {'neck': t} for coll, t in tree.items()},
                             keys)
    assert sorted(sd) == sorted(keys)
    neck.load_state_dict({k[len('neck.'):]: v for k, v in sd.items()},
                         strict=True)
    return neck


# ---- SAC and the DetectoRS ResNet -------------------------------------------
@pytest.mark.parametrize('stride', (1, 2))
def test_saconv_matches_jax(ref, stride):
    tree, x = ref[f'saconv{stride}']
    assert float(np.abs(tree['params']['switch']['kernel']).max()) > 0
    conv = SAConv2d(8, 12, stride)
    sd = state_dict_from_jax({'params': {'backbone': {'layer2_0': {
        'conv2': tree['params']}}}})
    prefix = 'backbone.layer2.0.conv2.'
    assert sorted(sd) == sorted(prefix + k for k in conv.state_dict())
    conv.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = conv(nchw([x])[0])
    assert_close([got], [ref[f'saconv{stride}_out']], 1e-5)


def test_detectors_resnet_matches_jax(ref):
    tree, image = ref['trunk']
    model = BACKBONES.build(dict(SAC_BACKBONE, type='DetectoRS_ResNet'))
    keys = ['backbone.' + k for k in model.state_dict()]
    sd = state_dict_from_jax({c: {'backbone': t} for c, t in tree.items()},
                             keys)
    assert sorted(sd) == sorted(keys)
    model.load_state_dict({k[len('backbone.'):]: v for k, v in sd.items()},
                          strict=True)
    with torch.no_grad():
        got = model.eval()(nchw([image])[0])
    for g, w in zip(got, ref['trunk_out']):
        assert_close([g], [w], 1e-4)
    sacs = [n for n, m in model.named_modules() if isinstance(m, SAConv2d)]
    assert len(sacs) == 4 + 6 + 3 and not any(
        n.startswith('layer1') for n in sacs)


def test_sac_takes_precedence_over_dcn_and_defaults():
    with torch.device('meta'):
        both = DetectoRS_ResNet(50, sac=dict(type='SAC'),
                                dcn=dict(type='DCNv2'),
                                stage_with_dcn=(False, False, True, True))
        plain = DetectoRS_ResNet(50)
        resnet = BACKBONES.build(dict(type='ResNet', depth=50,
                                      sac=dict(type='SAC')))
    assert isinstance(both.layer3[0].conv2, SAConv2d)
    assert not any(isinstance(m, ModulatedDeformConv2d)
                   for m in both.modules())
    assert not any(isinstance(m, SAConv2d) for m in plain.modules())
    # the plain ResNet's stage_with_sac is all False, as in JAX
    assert not any(isinstance(m, SAConv2d) for m in resnet.modules())
    gen = torch.Generator().manual_seed(0)
    sac = SAConv2d(8, 8)
    sac.init_weights(gen)
    x = torch.randn(1, 8, 8, 8, generator=gen)
    # S = 0.5 at init: the even blend of the two dilations
    want = 0.5 * (torch.nn.functional.conv2d(x, sac.weight, None, 1, 1) +
                  torch.nn.functional.conv2d(x, sac.weight, None, 1, 3, 3))
    torch.testing.assert_close(sac(x), want, rtol=1e-5, atol=1e-6)


# ---- the necks --------------------------------------------------------------
@pytest.mark.parametrize('name', sorted(NECK_CFGS))
def test_neck_matches_jax(ref, name):
    neck = port_neck(name, ref[name])
    with torch.no_grad():
        got = neck(nchw(neck_inputs()))
    assert_close(got, ref[f'{name}_out'], 1e-5)


@pytest.mark.parametrize('name', sorted(NECK_CFGS))
def test_neck_names_and_converter_gap(ref, name):
    neck = port_neck(name, ref[name])
    names = set(neck.state_dict())
    conv = convert_torch_state_dict({f'neck.{k}': v.numpy()
                                     for k, v in neck.state_dict().items()})
    for key in NEW_NAMES[name]:
        assert key in names, key
        assert f'neck.{key}' in conv['_unmapped'], key


def test_rfp_gate_starts_at_the_even_blend():
    """The zero-init gate gives sigmoid(0) = 0.5 (ROADMAP.md caveat 62),
    not the plain FPN the JAX docstring names."""
    neck = RFP(CHANS, 32, 5)
    neck.init_weights(torch.Generator().manual_seed(0))
    x = nchw(neck_inputs())
    with torch.no_grad():
        got = neck(x)
        fpn = neck.fpn(x)
        for lvl, (g, f) in enumerate(zip(got, fpn)):
            ref_ = torch.relu(neck.rfp_refine[0][lvl](
                neck.rfp_aspp[0][lvl](f)))
            torch.testing.assert_close(g, 0.5 * f + 0.5 * ref_)
            assert float((g - f).abs().max()) > 1e-3


def test_carafe_reads_only_three_upsample_keys():
    """ROADMAP.md caveat 64: `up_group` and `encoder_dilation` are read by
    neither package."""
    cfg = NECK_CFGS['FPN_CARAFE']
    other = dict(cfg, upsample_cfg=dict(CARAFE_CFG, up_group=2,
                                        encoder_dilation=2))
    shapes = [{k: v.shape for k, v in NECKS.build(dict(c)).state_dict()
               .items()} for c in (cfg, other)]
    assert shapes[0] == shapes[1]
    enc = NECKS.build(dict(cfg)).upsample_modules[0].content_encoder
    assert enc.out_channels == 4 * 25 and enc.dilation == (1, 1)


def test_unported_necks_name_their_item():
    """Every neck of the JAX package builds now: BFP too (Queue A item 4,
    ported with the stacked necks) and YOLOV3Neck (Queue A item 7, ported
    with the YOLOv3 head)."""
    assert not NECKS.not_ported
    assert type(NECKS.build(dict(type='BFP'))).__name__ == 'BFP'
    assert type(NECKS.build(dict(type='YOLOV3Neck'))).__name__ == \
        'YOLOV3Neck'
    assert not {'DetectoRS_ResNet'} & set(BACKBONES.not_ported)


# ---- the configs ------------------------------------------------------------
@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg.model),
                               dtype=cfg.get('dtype'))
    assert type(model).__name__ == cfg.model.type
    neck = cfg.model.neck.type
    assert type(model.neck).__name__ == neck
    if neck == 'FPG':
        assert len(model.neck.stages) == 9
    if neck == 'NASFPN':
        assert len(model.neck.fpn_stages) == 7
    if cfg.model.backbone.get('sac'):
        assert sum(isinstance(m, SAConv2d)
                   for m in model.backbone.modules()) == 13
    if 'nashead' in path:
        assert isinstance(model.bbox_head, NASFCOSHead)


@pytest.mark.parametrize('group', sorted(FULL_WIDTH))
def test_full_width_names_and_shapes_match_jax(ref, group):
    """The port's names and shapes are `state_dict_from_jax` of the JAX
    `jax.eval_shape` tree; a single-stage detector's `forward_test` runs on
    the meta device to its (1, 100) detections (a two-stage one's RoI
    routing is data-dependent: its features' shapes)."""
    path = os.path.join(ROOT, FULL_WIDTH[group])
    hw = (128, 128)
    if group == 'detectors':
        shapes = ref['detectors_shapes']
    else:
        det = j_build_detector(JConfig.fromfile(path).model)
        shapes = jax.eval_shape(lambda: det.init_variables(
            jax.random.PRNGKey(0), (1, ) + hw + (3, )))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path).model).eval()
        own = model.state_dict()
        sd = state_dict_from_jax(tree, own.keys())
        assert sorted(sd) == sorted(own)
        for k, v in own.items():
            assert tuple(sd[k].shape) == tuple(v.shape), k
        batch = dict(image=torch.empty(1, 3, *hw),
                     img_hw=torch.tensor([hw], dtype=torch.float32))
        if group == 'detectors':
            feats = model.extract_feat(batch['image'])
            assert [tuple(t.shape) for t in feats] == [
                (1, 256, hw[0] // s, hw[1] // s) for s in (4, 8, 16, 32, 64)]
            return
        outs = model.forward_test(batch)
    assert [tuple(t.shape) for t in outs] == [(1, 100, 5), (1, 100),
                                              (1, 100)]
