"""The port's YOLOv3 and TridentNet against the JAX package on the same
weights and inputs: Darknet-53, the YOLOv3 neck and head (outputs, the
responsible-anchor loss and its gradient, the decode), `GridAssigner`,
`MSELoss`, `TridentResNet` (each branch's output), `TridentRoIHead` and
`TridentFasterRCNN` (losses on the branch-tiled gts, the test branch's
detections), with each reference quirk the port follows.

The weights go JAX -> port: `jax.eval_shape` of the JAX init filled from a
numpy seed (`fill_tree`, BN statistics too), carried onto the port's mmdet
names by `state_dict_from_jax` strictly (the JAX converter has no Darknet,
YOLO or trident rule). Float32 on the CPU, the 2x64x96 batch of the
Cascade RPN / TOOD file:
  * YOLOv3 D53 (full width: the JAX Darknet has no width knob; 4
    classes): backbone and neck maps within 5e-3 of their largest, head
    outputs within 5e-3, the loss dict to rtol 1e-3, detections within
    5e-3 px; the head alone (width 64/32/16 on random maps): outputs within
    1e-5, losses to rtol 2e-4, each parameter's gradient within 1e-4 of
    its largest, detections within 1e-3 (float32 at boxes of 10-1000
    px);
  * `GridAssigner`: every field equal; `MSELoss` to rtol 1e-6;
  * TridentNet on a narrow trunk (the config with one ResNet-50 stage, so
    the trident stage is res2 at stride 4, a 64-wide C4 RPN and a
    one-stage shared head): each branch's map within 5e-3 of its largest,
    the loss dict to rtol 1e-3 (both samplers taking every candidate),
    the test branch's detections as multisets within 5e-3.

The `ref` fixture traces every JAX program once and compiles each in a
thread at LLVM -O0 (each runs once).
"""
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
from ld_tpu.ops.extra_assigners import GridAssigner as JGridAssigner
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu.utils.registry import LOSSES as JAX_LOSSES
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.backbones.darknet import ConvBNLeaky
from ld_tpu_torch.models.backbones.resnet import TridentConv
from ld_tpu_torch.ops.extra_assigners import GridAssigner
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from test_torch_port_bridge import O0, assert_losses_close, fill_tree, nchw
from test_torch_port_crpn_tood import (assert_assign_equal,
                                       assert_grads_close, gt_batches,
                                       load_port, numpy_tree)
from test_torch_port_guided_anchoring import (assert_dets_close,
                                              assert_dets_match,
                                              assert_levels_close)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YOLO_CONFIG = os.path.join(ROOT, 'configs/yolo/yolov3_d53_coco.py')
TRIDENT_CONFIG = os.path.join(
    ROOT, 'configs/tridentnet/tridentnet_r50_caffe_1x_coco.py')
CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs/yolo/*.py')) +
                 glob.glob(os.path.join(ROOT, 'configs/tridentnet/*.py')))
YOLO_TEST = dict(nms_pre=60, score_thr=0.05, conf_thr=0.005,
                 nms=dict(type='nms', iou_threshold=0.45), max_per_img=100)
# the head alone: 64/32/16 wide on maps of a 64x96 image
HEAD_CFG = dict(type='YOLOV3Head', num_classes=4, in_channels=[64, 32, 16],
                test_cfg=YOLO_TEST)
HEAD_SIZES = [(2, 3), (4, 6), (8, 12)]
# both samplers take every candidate
ALL = dict(num=10**6, pos_fraction=1.0)
DET_TOL = 5e-3


def yolo_cfg(cfg):
    model = cfg['model']
    model['bbox_head']['num_classes'] = 4
    model['test_cfg'] = dict(YOLO_TEST)
    return model


def trident_cfg(cfg):
    """One ResNet-50 stage (res2, the trident stage at stride 4), a 64-wide
    RPN on it, the shared head at res3 (4 blocks, 256 -> 512), 4 classes,
    60 / 50 proposals an image."""
    model = cfg['model']
    model['backbone'].update(num_stages=1, strides=(1, ), dilations=(1, ),
                             out_indices=(0, ))
    model['rpn_head'].update(in_channels=256, feat_channels=64)
    model['rpn_head']['anchor_generator']['strides'] = [4]
    roi = model['roi_head']
    roi['shared_head']['stage'] = 1
    roi['bbox_roi_extractor'].update(out_channels=256, featmap_strides=[4])
    roi['bbox_head'].update(in_channels=512, num_classes=4)
    model['train_cfg']['rpn']['sampler'] = dict(ALL)
    model['train_cfg']['rpn_proposal'].update(nms_pre=400, max_per_img=60)
    model['train_cfg']['rcnn']['sampler'] = dict(ALL)
    model['test_cfg']['rpn'].update(nms_pre=300, max_per_img=50)
    model['test_cfg']['rcnn'].update(score_thr=0.0, max_per_img=40)
    return model


def head_feats(seed=14):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, h, w, c).astype(np.float32)
            for (h, w), c in zip(HEAD_SIZES, (64, 32, 16))]


def grid_inputs(seed=15):
    """Anchors (40, 4) and their (2, 40, G) responsibility for the
    batch's gts."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 70, (40, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(8, 50, (40, 2))], 1)
    flags = rs.uniform(0, 1, (2, 40, 6)) < 0.4
    return boxes.astype(np.float32), flags


@pytest.fixture(scope='module')
def ref():
    j_batch, t_batch = gt_batches()
    out, jobs = {}, {}

    # ---- YOLOv3 D53: the backbone's and neck's maps, outputs, loss, decode
    det = j_build_detector(yolo_cfg(JConfig.fromfile(YOLO_CONFIG)))
    v = out['yolo'] = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 96, 3))), seed=3)

    def yolo_run(v, b):
        (outs, neck), mut = det.net.apply(v, b['image'], train=True,
                                          output_features=True,
                                          mutable=['batch_stats'])
        back = det.backbone.apply(
            {'params': v['params']['backbone'],
             'batch_stats': v['batch_stats']['backbone']}, b['image'])
        sizes = [c.shape[1:3] for c in outs[0]]
        return (back, neck, outs, det.bbox_head.loss(outs, b, sizes),
                det.bbox_head.get_bboxes(outs, b['img_hw']), mut)
    jobs['yolo'] = (yolo_run, (v, j_batch))

    # ---- the head alone: loss gradient and decode
    j_head = JAX_HEADS.build(HEAD_CFG)
    feats = [jnp.asarray(f) for f in head_feats()]
    hv = out['head'] = fill_tree(jax.eval_shape(lambda: j_head.net.init(
        jax.random.PRNGKey(0), feats)), seed=4)

    def head_run(v, feats, b):
        def total(v):
            outs = j_head.net.apply(v, feats)
            losses = j_head.loss(outs, b, HEAD_SIZES)
            return sum(losses.values()), (outs, losses)
        (_, (outs, losses)), grads = jax.value_and_grad(
            total, has_aux=True)(v)
        return outs, losses, grads, j_head.get_bboxes(outs, b['img_hw'])
    jobs['head'] = (head_run, (hv, feats, j_batch))

    # ---- GridAssigner and MSELoss
    boxes, flags = grid_inputs()
    grid = JGridAssigner(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.1)
    mse = JAX_LOSSES.build(dict(type='MSELoss', loss_weight=2.0))
    jobs['grid'] = (lambda bx, f, gb, gl, gv: (
        tuple(jax.vmap(lambda f, gb, gl, gv: grid.assign(
            bx, f, gb, gl, gv, num_classes=4))(f, gb, gl, gv)),
        mse(bx[:20], bx[20:], weight=f[0, :20, :4].astype(jnp.float32),
            avg_factor=7.0)),
        (boxes, flags, *(j_batch[k] for k in ('gt_bboxes', 'gt_labels',
                                              'gt_valid'))))

    # ---- TridentNet on the narrow trunk
    tdet = j_build_detector(trident_cfg(JConfig.fromfile(TRIDENT_CONFIG)))
    tv = out['trident'] = fill_tree(jax.eval_shape(
        lambda: tdet.init_variables(jax.random.PRNGKey(0), (1, 64, 96, 3))),
        seed=6)

    def trident_run(v, b):
        feats = tdet.extract(v, b['image'])[0]
        return (feats, tdet.forward_train(v, b, jax.random.PRNGKey(2)),
                tdet.forward_test(v, b))
    jobs['trident'] = (trident_run, (tv, j_batch))

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile,
                                  compiler_options=O0)
                   for k, (fn, args) in jobs.items()}
    for k, (_, args) in jobs.items():
        out[f'{k}_out'] = futures[k].result()(*args)
    return dict(numpy_tree(out), t_batch=t_batch)


def port_detector(cfg, tree):
    det = build_detector(cfg)
    keys = list(det.state_dict())
    det.load_state_dict(state_dict_from_jax(tree, keys), strict=True)
    return det


def yolo_detector(ref):
    return port_detector(yolo_cfg(Config.fromfile(YOLO_CONFIG)), ref['yolo'])


def trident_detector(ref):
    return port_detector(trident_cfg(Config.fromfile(TRIDENT_CONFIG)),
                         ref['trident'])


def assert_maps_close(got, want, tol=DET_TOL):
    """NCHW port maps against NHWC JAX ones, within `tol` of the largest."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy().transpose(0, 2, 3, 1)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


# ---- YOLOv3 ---------------------------------------------------------------------
def test_darknet_and_neck_match_jax(ref):
    det = yolo_detector(ref).train()
    back, neck = ref['yolo_out'][:2]
    image = ref['t_batch']['image']
    feats = det.backbone(image)
    assert [f.shape[1] for f in feats] == [256, 512, 1024]
    assert_maps_close(feats, back)
    assert_maps_close(det.neck(feats), neck)


def test_yolo_detector_matches_jax(ref):
    det = yolo_detector(ref).train()
    b = ref['t_batch']
    _, _, w_outs, w_losses, w_dets, _ = ref['yolo_out']
    outs = det(b['image'])
    assert_maps_close(outs[0], w_outs[0])
    assert_losses_close(det.forward_train(b), w_losses, rtol=1e-3)
    with torch.no_grad():
        dets = det.eval().forward_test(b)
    assert_dets_match(dets, w_dets, DET_TOL)


def test_yolo_batch_norms_never_update(ref):
    """Caveat 86: every ConvBNLeaky runs its BN on its statistics, in
    training too, in both packages (the JAX training forward's
    `batch_stats` equal the filled ones)."""
    det = yolo_detector(ref)
    before = {k: v.clone() for k, v in det.state_dict().items()
              if 'running' in k}
    det.train()
    with torch.no_grad():
        train_out = det(ref['t_batch']['image'])[0]
        after = det.state_dict()
        eval_out = det.eval()(ref['t_batch']['image'])[0]
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    assert all(torch.equal(a, b) for a, b in zip(train_out, eval_out))
    bns = [m for m in det.modules() if isinstance(m, ConvBNLeaky)]
    assert len(bns) == 52 + 17 + 3 and all(m.norm_eval for m in bns)
    mut = ref['yolo_out'][5]['batch_stats']
    for scope in ('backbone', 'neck', 'head_net'):
        for a, b in zip(jax.tree_util.tree_leaves(mut[scope]),
                        jax.tree_util.tree_leaves(
                            ref['yolo']['batch_stats'][scope])):
            np.testing.assert_array_equal(a, b)


def port_head(ref):
    return load_port(HEADS.build(HEAD_CFG), ref['head'], 'head_net',
                     'bbox_head.')


def test_yolo_head_matches_jax(ref):
    """Outputs, the responsible-anchor loss and its gradient, the decode
    on random maps."""
    head = port_head(ref).train()
    outs = head(nchw(head_feats()))
    w_outs, w_losses, grads, w_dets = ref['head_out']
    for g, w in zip(outs[0], w_outs[0]):
        g = g.detach().numpy().transpose(0, 2, 3, 1)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    losses = head.loss(outs, ref['t_batch'], HEAD_SIZES)
    assert_losses_close(losses, w_losses)
    sum(losses.values()).backward()
    assert_grads_close(head, grads, 'head_net', 'bbox_head.')
    with torch.no_grad():
        dets = head.eval().get_bboxes(
            tuple([o.detach() for o in part] for part in outs),
            ref['t_batch']['img_hw'])
    assert_dets_close(dets, w_dets, 1e-3)


def test_yolo_decode_quirks(ref):
    """Caveat 88: `conf_thr` and `min_bbox_size` are not read; caveat 87:
    each gt is the responsibility of its best anchor of all nine."""
    head = port_head(ref).eval()
    with torch.no_grad():
        outs = head(nchw(head_feats()))
        hw = ref['t_batch']['img_hw']
        base = head.get_bboxes(outs, hw)
        other = head.get_bboxes(outs, hw, cfg=dict(
            YOLO_TEST, conf_thr=0.9, min_bbox_size=1000))
    for a, b in zip(base, other):
        assert torch.equal(a, b)
    b = ref['t_batch']
    num_pos = [float(head._loss_level(o, b['gt_bboxes'], b['gt_labels'],
                                      b['gt_valid'], lvl)['num_pos'])
               for lvl, o in enumerate(outs[0])]
    assert sum(num_pos) == float(b['gt_valid'].sum())


def test_grid_assigner_and_mse_loss_match_jax(ref):
    boxes, flags = grid_inputs()
    b = ref['t_batch']
    res = GridAssigner(pos_iou_thr=0.5, neg_iou_thr=0.3,
                       min_pos_iou=0.1).assign(
        torch.from_numpy(boxes), torch.from_numpy(flags), b['gt_bboxes'],
        b['gt_labels'], b['gt_valid'], num_classes=4)
    want, w_mse = ref['grid_out']
    assert int(res.pos_mask.sum()) > 0
    assert_assign_equal(res, want)
    t = torch.from_numpy(boxes)
    mse = LOSSES.build(dict(type='MSELoss', loss_weight=2.0))(
        t[:20], t[20:], weight=torch.from_numpy(flags[0, :20, :4]).float(),
        avg_factor=7.0)
    assert abs(float(mse) - float(w_mse)) <= 1e-6 * abs(float(w_mse))


# ---- TridentNet -----------------------------------------------------------------
def test_trident_branches_match_jax(ref):
    """Each branch's map: the same shared 3x3 weights at dilations 1, 2, 3,
    branch-major in the batch."""
    det = trident_detector(ref).train()
    feats = det.extract_feat(ref['t_batch']['image'])
    want = ref['trident_out'][0]
    assert feats[0].shape[0] == 6
    for i in range(3):
        assert_maps_close([feats[0][2 * i:2 * i + 2]],
                          [want[0][2 * i:2 * i + 2]])
    convs = [m for m in det.backbone.modules() if isinstance(m, TridentConv)]
    assert len(convs) == 3 and convs[0].dilations == (1, 2, 3)
    # the branches differ
    assert not torch.allclose(feats[0][:2], feats[0][2:4])


def test_trident_detector_matches_jax(ref):
    det = trident_detector(ref).train()
    b = ref['t_batch']
    _, w_losses, w_dets = ref['trident_out']
    got = det.forward_train(b, torch.Generator().manual_seed(0))
    assert_losses_close(got, w_losses, rtol=1e-3)
    with torch.no_grad():
        dets = det.eval().forward_test(b)
    assert_dets_match(dets, w_dets, DET_TOL)


def test_trident_quirks(ref):
    """Caveats 90-92: the training RPN and RoI head see the gts tiled a
    branch, the test keeps the `test_branch_idx` third, every block is
    'pytorch'-style whatever the config says, and `test_branch_idx=-1`
    raises."""
    det = trident_detector(ref).train()
    b = ref['t_batch']
    seen = {}

    class Seen(Exception):
        pass

    def spy(outs, batch, sizes, generator=None):
        seen.update(gts=batch['gt_bboxes'], images=outs[0][0].shape[0])
        raise Seen      # the RoI head's part is held above
    det.rpn_head.loss = spy
    with pytest.raises(Seen):
        det.forward_train(b, torch.Generator().manual_seed(0))
    assert seen['images'] == 6
    assert torch.equal(seen['gts'], b['gt_bboxes'].repeat(3, 1, 1))
    with torch.no_grad():
        det.eval()
        feats, rpn = det(b['image'])
        det.backbone.test_branch_idx = 2
        got = det.forward_test(b)
        props, valid = det._proposals(
            tuple([x[4:] for x in part] for part in rpn), b['img_hw'])
        want = det.roi_head.simple_test([f[4:] for f in feats], props, valid,
                                        b['img_hw'])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cfg = Config.fromfile(TRIDENT_CONFIG)
    with torch.device('meta'):
        full = build_detector(cfg.model)
    assert cfg.model.backbone.style == 'caffe'
    block = full.backbone.layer2[0]
    assert block.conv1.stride == (1, 1) and block.conv2.stride == (2, 2)
    roi = dict(cfg.model.roi_head, test_branch_idx=-1)
    with pytest.raises(NotImplementedError, match='caveat 92'):
        HEADS.build(roi)


@pytest.mark.parametrize('path', CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_config_builds(path):
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        det = build_detector(cfg.model, dtype=cfg.get('dtype'))
    assert type(det).__name__ in ('YOLOV3', 'TridentFasterRCNN')
