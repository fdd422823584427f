"""The CUDA greedy-NMS kernel against its plain PyTorch version, bit for bit.

Needs a CUDA card and skips without one: the kernel has no CPU mode. This
file imports neither jax nor ld_tpu, so it also runs on a GPU host without
JAX, where tests/conftest.py (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

The hand-made edge sets of the block-wise sweep come from
`ld_tpu_torch.testing`; `chip_smoke.py` checks the kernel on the same sets.
The training caller, `LDHead._gi_mask`, is checked at the GI path's shapes,
the LDv2 head's GI masks at full width, and the loader's `DevicePrefetcher`
against a plain copy to the card. The ops of the DCN teachers that run in
plain torch on the card, the DCN layer and the voting NMS, are held against
the CPU, and so are a Res2Net-50-DCN trunk, the GI masks of an IMv2
step with the Res2Net-101-DCN teacher, a Faster R-CNN's forward and a
Mask R-CNN's losses and masks, the ResNet variants' blocks
(weight-standardized conv, GCNet's ContextBlock, GeneralizedAttention), a
GN + WS Mask R-CNN's `forward_test`, VFNet's star DeformConv, head and
varifocal loss, the RoI head's NMS at LVIS's 1203 classes, the GA-Retina,
GA-RPN and RepPoints heads (outputs, losses, decode or proposals), their
assigners and the bounded IoU loss, the FoveaBox (plain and align) and
SSD300 heads (outputs, losses, decode), a ResNeSt-50 trunk and the Mask
Scoring RoI head's losses, the PAA, FSAF, FreeAnchor and SABL RetinaNet
heads (outputs, losses, PAA's reassigned positives, decode) and the SABL
and SABL Cascade RoI heads (losses, bucket decode, `simple_test`).
"""
import pytest
import torch

from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
from ld_tpu_torch.testing import NMS_CHECK_KB, NMS_SETS, nms_batch


def _candidates(b, k, seed):
    """Score-sorted clustered boxes, class-offset as multiclass_nms builds
    them (80 classes, offset 4096), ~10% invalid."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand(b, max(k // 8, 1), 2, generator=g) * 1200
    pick = torch.randint(0, centers.shape[1], (b, k), generator=g)
    c = torch.gather(centers, 1, pick[..., None].expand(b, k, 2))
    c = c + torch.randn(b, k, 2, generator=g) * 8
    wh = torch.rand(b, k, 2, generator=g) * 150 + 10
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    boxes += (torch.randint(0, 80, (b, k), generator=g) * 4096.0)[..., None]
    return boxes, torch.rand(b, k, generator=g) > 0.1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the NMS kernel has no CPU mode')


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version():
    _need_card()
    for b, k in ((1, 8), (1, 1000), (8, 1024), (2, 2048), (3, 4100),
                 (1, 4819), (2, 4819), (1, 8819)):
        boxes, valid = _candidates(b, k, seed=b * k)
        launches = nms_keep.launches
        got = nms_keep(boxes.cuda(), valid.cuda(), 0.6)
        torch.cuda.synchronize()
        assert nms_keep.launches == launches + 1
        assert torch.equal(got, nms_keep_ref(boxes.cuda(), valid.cuda(), 0.6))
        assert torch.equal(got.cpu(), nms_keep_ref(boxes, valid, 0.6))


@pytest.mark.cuda
@pytest.mark.parametrize('k,b', NMS_CHECK_KB)
@pytest.mark.parametrize('name', NMS_SETS)
def test_cuda_kernel_edge_sets(name, k, b):
    _need_card()
    boxes, valid, want = nms_batch(name, b, k, seed=k)
    for thr in (0.5, 0.6):
        launches = nms_keep.launches
        got = nms_keep(boxes, valid, thr)
        torch.cuda.synchronize()
        assert nms_keep.launches == launches + 1
        assert torch.equal(got, nms_keep_ref(boxes, valid, thr))
        if want is not None:
            assert torch.equal(got.cpu(), want)


def _gi_inputs(h, w, b=2, seed=0):
    """One FPN level's head outputs of a batch of b images, flattened and
    pooled as `LDHead._imitation_loss` pools them: student / teacher class
    logits (b*h*w, 80), box logits (b*h*w, 68), anchor centres in strides."""
    g = torch.Generator().manual_seed(seed)
    n = b * h * w
    cls = torch.randn(n, 80, generator=g) - 4.0
    soft = torch.randn(n, 80, generator=g) - 4.0
    pred = torch.randn(n, 68, generator=g) * 2
    soft_pred = torch.randn(n, 68, generator=g) * 2
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing='ij')
    centers = torch.stack([xs, ys], -1).reshape(-1, 2).float().repeat(b, 1)
    return [t.cuda() for t in (cls, soft, pred, soft_pred, centers)]


@pytest.mark.cuda
@pytest.mark.parametrize('h,w', [(7, 11), (100, 168)])
def test_gi_mask_kernel_equals_plain_keep(h, w):
    """The training caller: the GI-region mask of one level pooled over
    B = 2 at 800x1344 (stride 128: K = 154 candidates; stride 8: K = 512 of
    33600) through the kernel and through `nms_keep_ref`, bit for bit."""
    _need_card()
    from ld_tpu_torch.utils.registry import HEADS
    head = HEADS.build(dict(type='LDHead', num_classes=80, in_channels=16,
                            stacked_convs=1, feat_channels=16))
    inputs = _gi_inputs(h, w)
    launches = nms_keep.launches
    got = head._gi_mask(*inputs, keep_fn=nms_keep)
    torch.cuda.synchronize()
    assert nms_keep.launches == launches + 1
    want = head._gi_mask(*inputs, keep_fn=nms_keep_ref)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) <= head.gi_top


@pytest.mark.cuda
def test_ldv2_gi_masks_kernel_equals_plain_keep():
    """The LDv2 step's GI region (raw teacher logits minus student
    probabilities, one NMS a level): configs/ldv2/ld_r50_gflv2_r101_fpn_1x.py
    at full width (R50 from seed 0, GFocalV2-R101 teacher from seed 1) on
    1x3x128x192, its 5 masks through the kernel and through
    `nms_keep_ref`, bit for bit."""
    _need_card()
    import os

    from ld_tpu_torch import Config
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.testing import detection_batch
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(
        root, 'configs/ldv2/ld_r50_gflv2_r101_fpn_1x.py'))
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    model = model.cuda().eval()
    image = detection_batch(1, 128, 192, seed=0)['image']
    with torch.no_grad():
        outs, t_outs = model(image), model.teacher(image)
        launches = nms_keep.launches
        got = model.bbox_head.gi_masks(outs, t_outs, keep_fn=nms_keep)
        torch.cuda.synchronize()
        assert nms_keep.launches == launches + 5
        want = model.bbox_head.gi_masks(outs, t_outs, keep_fn=nms_keep_ref)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(0 < int(g.sum()) <= model.bbox_head.gi_top for g in got)


@pytest.mark.cuda
def test_device_prefetcher_equals_a_plain_copy():
    """Batches through the pinned slots and the side stream equal a plain
    `.to('cuda')` of the same collated batches: 11 batches over two pad
    buckets, more than the slots, all held until the end; and after a
    skip."""
    _need_card()
    import numpy as np

    from ld_tpu_torch.data import (DataLoader, DevicePrefetcher,
                                   SyntheticDetectionDataset)
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)
    pipe = [dict(type='FusedPreprocess', img_scale=(128, 72), **norm),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    ds = SyntheticDetectionDataset(num_images=22, hw=(60, 90),
                                   num_classes=20, pipeline=pipe)
    loader = DataLoader(ds, 2, [(64, 96), (96, 128)], max_gts=8, seed=1,
                        batch_scales=[(96, 40), (128, 72)],
                        scale_sampling='image_range_grouped')
    loader.set_epoch(1)
    plain = list(loader)
    prefetcher = DevicePrefetcher(loader, 'cuda')
    got = list(prefetcher)
    torch.cuda.synchronize()
    assert len(got) == len(plain) == 11
    assert len({b['image'].shape for b in plain}) == 2
    for g, p in zip(got, plain):
        assert sorted(g) == sorted(p)
        for k in DevicePrefetcher.HOST_KEYS:      # img_ids, img_idx
            np.testing.assert_array_equal(g[k], p[k])
        for k, v in p.items():
            if k not in DevicePrefetcher.HOST_KEYS:
                want = torch.from_numpy(v).to('cuda')
                assert g[k].device.type == 'cuda'
                assert g[k].dtype == want.dtype and torch.equal(g[k], want), k
    tail = list(prefetcher.iterate(skip=8))
    assert [b['img_ids'].tolist() for b in tail] == \
        [b['img_ids'].tolist() for b in plain[8:]]
    assert all(torch.equal(a['image'], b['image'])
               for a, b in zip(tail, got[8:]))


@pytest.fixture
def no_tf32():
    """cuDNN's TF32 off (torch's default is on for convs), as chip_smoke.py
    runs: the offsets of a DCN layer come from a conv."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        flags


def _dcn_layer(c, stride, groups, seed=0):
    from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
    from ld_tpu_torch.testing import randomize_dcn_offsets
    layer = ModulatedDeformConv2d(c, c, 3, stride, groups=groups)
    layer.init_weights(torch.Generator().manual_seed(seed))
    randomize_dcn_offsets(layer, seed)
    return layer


@pytest.mark.cuda
@pytest.mark.parametrize('c,hw,stride,groups', [
    (64, (50, 84), 1, 1), (128, (100, 168), 2, 1), (512, (25, 42), 1, 32)])
def test_dcn_layer_on_the_card_equals_the_cpu(no_tf32, c, hw, stride,
                                              groups):
    """The DCN layer (plain torch, no kernel of its own) on the card against
    the same weights and input on the CPU, with seeded non-zero offsets, to
    1e-4 of the largest output; and its input, weight and conv_offset
    gradients the same way."""
    _need_card()
    layer = _dcn_layer(c, stride, groups)
    x = torch.randn(2, c, *hw, generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for device in ('cpu', 'cuda'):
        m = _dcn_layer(c, stride, groups).to(device)
        m.load_state_dict(layer.state_dict())
        xi = x.detach().to(device).requires_grad_(True)
        out = m(xi)
        out.square().mean().backward()
        outs.append(out.detach().cpu())
        grads.append([t.grad.cpu() for t in (xi, m.weight,
                                             m.conv_offset.weight)])
    assert outs[1].shape == outs[0].shape
    assert float((outs[1] - outs[0]).abs().max()) <= \
        1e-4 * float(outs[0].abs().max())
    for g, c_ in zip(grads[1], grads[0]):
        assert float((g - c_).abs().max()) <= 1e-4 * float(c_.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('groups', [1, 32])
def test_dcn_layer_with_zero_offsets_is_the_conv(no_tf32, groups):
    """Zero offsets and mask logits of 30 (sigmoid 1.0 in float32): the
    layer is `F.conv2d` of its weight."""
    _need_card()
    layer = _dcn_layer(512, 1, groups).cuda()
    with torch.no_grad():
        layer.conv_offset.weight.zero_()
        layer.conv_offset.bias.zero_()
        layer.conv_offset.bias[-9:] = 30.0
        x = torch.randn(2, 512, 25, 42, device='cuda')
        got = layer(x)
        want = torch.nn.functional.conv2d(x, layer.weight, padding=1,
                                          groups=groups)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_voting_nms_on_the_card_equals_the_cpu():
    """`multiclass_nms_voting` (plain torch: its DIoU test is not the keep
    kernel's) on the card against the CPU: labels and valid identical,
    boxes and scores within 1e-4 relative; no nms_keep launch."""
    _need_card()
    from ld_tpu_torch.ops.nms import multiclass_nms_voting
    g = torch.Generator().manual_seed(3)
    xy = torch.rand(2, 4000, 2, generator=g) * 1200
    boxes = torch.cat([xy, xy + 10 + torch.rand(2, 4000, 2, generator=g) *
                       150], -1)
    scores = torch.rand(2, 4000, 20, generator=g) ** 3
    launches = nms_keep.launches
    got = multiclass_nms_voting(boxes.cuda(), scores.cuda(), 0.05, 0.6)
    torch.cuda.synchronize()
    assert nms_keep.launches == launches
    want = multiclass_nms_voting(boxes, scores, 0.05, 0.6)
    dets, labels, valid = (t.cpu() for t in got)
    assert int(valid.sum()) > 0
    assert torch.equal(labels, want[1]) and torch.equal(valid, want[2])
    assert torch.allclose(dets, want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_two_ranks_step_on_the_card_equals_one_process(no_tf32, tmp_path):
    """The GI config at R18 over 2 spawned ranks sharing the card on gloo,
    1 image each, against one process at 2 images: the loss terms, the GI
    masks (5 kernel launches a step a rank) and the parameters after SGD."""
    import os

    import numpy as np

    from ld_tpu_torch import Config
    from ld_tpu_torch.testing import detection_batch_np, ld_step_rank, spawn
    _need_card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(
        root, 'configs/ld/ld_r50_gflv1_r101_fpn_coco_1x_gi.py'))
    teacher = Config.fromfile(os.path.join(root, cfg.model.teacher_config))
    for m in (cfg.model, teacher.model):
        m.backbone.depth = 18
        m.neck.in_channels = [64, 128, 256, 512]
    cfg.model.teacher_config = dict(model=teacher.model)
    batch = detection_batch_np(2, 128, 192, seed=5)
    ranks = spawn(ld_step_rank, 2, 'gloo', str(tmp_path), device='cuda',
                  args=(cfg, batch))
    ref = ld_step_rank(0, 1, 'cuda', cfg, batch)
    for r in ranks:
        assert r['launches'] == ref['launches'] == 5
        for k, v in ref['metrics'].items():
            assert r['metrics'][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for lvl, m in enumerate(ref['masks']):
        assert np.array_equal(np.concatenate([r['masks'][lvl]
                                              for r in ranks]), m)
    scale = max(np.abs(p).max() for p in ref['params'].values())
    for k, p in ref['params'].items():
        assert np.abs(ranks[0]['params'][k] - p).max() <= 1e-5 * scale, k


@pytest.mark.cuda
def test_res2net_dcn_on_the_card_equals_the_cpu(no_tf32):
    """A Res2Net-50 with the configs' DCN splits (plain torch: convs, the
    DCN layer, the split adds and the avg-down pools) on the card against
    the same weights and input on the CPU at 1x3x128x192, with seeded
    non-zero offsets, each stage to 1e-4 of its largest output."""
    _need_card()
    from ld_tpu_torch.models.backbones import Res2Net
    from ld_tpu_torch.testing import randomize_dcn_offsets
    model = Res2Net(depth=50, frozen_stages=1,
                    dcn=dict(type='DCNv2', deform_groups=1),
                    stage_with_dcn=(False, True, True, True))
    model.init_weights(torch.Generator().manual_seed(0))
    assert randomize_dcn_offsets(model, seed=0) == 39
    x = torch.randn(1, 3, 128, 192, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.eval()(x)
        got = model.cuda()(x.cuda())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


@pytest.mark.cuda
def test_imv2_res2net_gi_masks_on_the_card_equal_the_cpu(no_tf32):
    """The GI masks of one IMv2 Res2Net step (configs/imv2/
    im_r101_gflv2_r2n101_dcn_2x.py at full width, the R101 student from
    seed 0, the R2N101-DCN teacher from seed 1, offsets seeded, BNs folded)
    on 1x3x128x192: through the kernel on the card (5 launches) and through
    the plain keep mask on the CPU, identical."""
    _need_card()
    import copy
    import os

    from ld_tpu_torch import Config
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.testing import detection_batch, randomize_dcn_offsets
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(
        root, 'configs/imv2/im_r101_gflv2_r2n101_dcn_2x.py'))
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    assert randomize_dcn_offsets(model.teacher, seed=1) == 90
    assert model.fold_teacher_bn()
    masks = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(model).to(device).eval()
        image = detection_batch(1, 128, 192, seed=0, device=device)['image']
        with torch.no_grad():
            outs, t_outs = m(image), m.teacher(image)
            launches = nms_keep.launches
            masks[device] = [g.cpu() for g in m.bbox_head.gi_masks(
                outs, t_outs, keep_fn=nms_keep)]
        assert nms_keep.launches == launches + (5 if device == 'cuda' else 0)
    assert all(torch.equal(g, c) for g, c in zip(masks['cuda'],
                                                 masks['cpu']))
    assert all(0 < int(g.sum()) for g in masks['cuda'])


@pytest.mark.cuda
def test_two_stage_forward_on_the_card_equals_the_cpu(no_tf32):
    """Faster R-CNN (R18, width 64) at 1x3x128x192: the FPN and RPN outputs
    on the card within 5e-3 / 2e-4 of the CPU's, the proposals of the RPN
    with the kernel the same as the plain keep mask's, and the RoI head's
    detections on the CPU's proposals the same set, boxes within 1e-3."""
    _need_card()
    import copy
    from ld_tpu_torch.models import build_detector
    model = build_detector(dict(
        type='FasterRCNN',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=dict(type='StandardRoIHead', bbox_head=dict(
            num_classes=4, in_channels=64, fc_out_channels=64))))
    model.init_weights(torch.Generator().manual_seed(0))
    # fc_cls at 10x its init: peaked enough for detections above
    # score_thr, short of the saturated softmax whose equal scores would
    # leave the final order to each device
    with torch.no_grad():
        model.roi_head.bbox_head.fc_cls.weight.mul_(10.0)
    cpu, card = model.eval(), copy.deepcopy(model).cuda().eval()
    x = torch.randn(1, 3, 128, 192, generator=torch.Generator().manual_seed(1))
    hw = torch.tensor([[128.0, 192.0]])
    with torch.inference_mode():
        c_feats, c_rpn = cpu(x)
        g_feats, g_rpn = card(x.cuda())
        for c, g in zip(c_feats + c_rpn[0] + c_rpn[1],
                        g_feats + g_rpn[0] + g_rpn[1]):
            diff = (g.cpu() - c).abs()
            assert float(diff.max()) < 5e-3
            assert float((diff / (c.abs() + 1e-2)).median()) < 2e-4
        launches = nms_keep.launches
        props = card.rpn_head.get_proposals(g_rpn, hw.cuda())
        assert nms_keep.launches == launches + 1
        plain = card.rpn_head.get_proposals(g_rpn, hw.cuda(),
                                            keep_fn=nms_keep_ref)
        assert all(torch.equal(a, b) for a, b in zip(props, plain))
        c_props = cpu.rpn_head.get_proposals(c_rpn, hw)
        got = card.roi_head.simple_test(g_feats, c_props[0].cuda(),
                                        c_props[1].cuda(), hw.cuda())
        want = cpu.roi_head.simple_test(c_feats, *c_props, hw)
    assert int(want[2].sum()) > 0
    assert torch.equal(got[2].cpu(), want[2])
    # as sets of (score, label, box): equal scores may come in either order
    for i in range(want[2].shape[0]):
        rows = []
        for dets, labels in ((got[0][i].cpu(), got[1][i].cpu()),
                             (want[0][i], want[1][i])):
            ok = want[2][i]
            dets, labels = dets[ok].double(), labels[ok]
            key = sorted(range(len(labels)), key=lambda j: (
                -round(float(dets[j, 4]), 5), int(labels[j]),
                round(float(dets[j, 0]), 2)))
            rows.append((dets[key], labels[key]))
        assert torch.equal(rows[0][1], rows[1][1])
        assert float((rows[0][0] - rows[1][0]).abs().max()) < 1e-3


@pytest.mark.cuda
def test_mask_rcnn_on_the_card_equals_the_cpu(no_tf32):
    """Mask R-CNN (R18, width 64) at 1x3x128x192 with samplers that pick
    every candidate and uint8 gt masks: every loss of the card, loss_mask
    included, on the CPU's proposals within rtol 1e-3 of the CPU's, and the
    masks of the CPU's detections within 5e-3."""
    _need_card()
    import copy
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.testing import detection_batch
    every = dict(num=10**6, pos_fraction=1.0)
    model = build_detector(dict(
        type='MaskRCNN',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=dict(type='StandardRoIHead',
                      bbox_head=dict(num_classes=4, in_channels=64,
                                     fc_out_channels=64),
                      mask_head=dict(num_classes=4, in_channels=64,
                                     conv_out_channels=64)),
        train_cfg=dict(rpn=dict(sampler=every), rcnn=dict(sampler=every))))
    model.init_weights(torch.Generator().manual_seed(0))
    batch = detection_batch(1, 128, 192, num_classes=4, seed=0,
                            device='cpu')
    g = torch.Generator().manual_seed(2)
    masks = torch.zeros(1, 100, 32, 48, dtype=torch.uint8)
    for j in torch.nonzero(batch['gt_valid'][0]).flatten().tolist():
        x1, y1, x2, y2 = (batch['gt_bboxes'][0, j] / 4).long().tolist()
        masks[0, j, y1:y2 + 1, x1:x2 + 1] = (torch.rand(
            y2 + 1 - y1, x2 + 1 - x1, generator=g) > 0.3).to(torch.uint8)
    batch['gt_masks'] = masks
    peaked = copy.deepcopy(model).eval()
    with torch.inference_mode():
        peaked.roi_head.bbox_head.fc_cls.weight.mul_(10.0)
        dets = peaked.forward_test(batch)[:3]
    assert int(dets[2].sum()) > 0
    losses, out, props = {}, {}, None
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(model).to(device).train()
        b = {k: v.to(device) for k, v in batch.items()}
        gen = torch.Generator(device=device).manual_seed(0)
        feats, rpn_outs = m(b['image'])
        sizes = [tuple(c.shape[-2:]) for c in rpn_outs[0]]
        got = m.rpn_head.loss(rpn_outs, b, sizes, gen)
        if props is None:
            props = m._proposals(rpn_outs, b['img_hw'])
        got.update(m.roi_head.forward_train(
            feats, *(p.to(device) for p in props), b, gen))
        losses[device] = {k: float(v.detach()) for k, v in got.items()}
        with torch.inference_mode():
            out[device] = m.eval().roi_head.simple_test_mask(
                [f.detach() for f in feats],
                *(d.to(device) for d in dets)).cpu()
    assert losses['cpu']['loss_mask'] > 0
    for k, c in losses['cpu'].items():
        assert losses['cuda'][k] == pytest.approx(c, rel=1e-3), k
    assert float((out['cuda'] - out['cpu']).abs().max()) <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['CascadeRoIHead', 'HybridTaskCascadeRoIHead'])
def test_cascade_head_on_the_card_equals_the_cpu(no_tf32, kind):
    """The cascade heads (Cascade Mask R-CNN's, HTC's with its semantic
    head; R18, width 64, 4 classes) at 1x3x128x192 with samplers that pick
    every candidate and uint8 gt masks: every stage's losses (the mask and
    semantic losses included) on the CPU's proposals within rtol 1e-3 of
    the CPU's, and the detections of the card's `simple_test` on those
    proposals the CPU's (the last stage's NMS through the kernel): the same
    valid mask and labels, boxes within 1e-3 as sets; Cascade Mask R-CNN's
    averaged masks of the CPU's detections within 5e-3."""
    _need_card()
    import copy
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.testing import detection_batch
    every = dict(num=10**6, pos_fraction=1.0)
    roi = dict(type=kind, num_stages=3, stage_loss_weights=[1, 0.5, 0.25],
               bbox_head=dict(num_classes=4, in_channels=64,
                              fc_out_channels=64),
               mask_head=dict(num_classes=4, in_channels=64,
                              conv_out_channels=64))
    if kind == 'HybridTaskCascadeRoIHead':
        roi['semantic_head'] = dict(num_classes=7, in_channels=64,
                                    conv_out_channels=64)
    model = build_detector(dict(
        type='CascadeRCNN',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=roi,
        train_cfg=dict(rpn=dict(sampler=every), rcnn=dict(sampler=every))))
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for head in model.roi_head.bbox_head:
            head.fc_cls.weight.mul_(10.0)
    batch = detection_batch(1, 128, 192, num_classes=4, seed=0,
                            device='cpu')
    g = torch.Generator().manual_seed(2)
    masks = torch.zeros(1, 100, 32, 48, dtype=torch.uint8)
    for j in torch.nonzero(batch['gt_valid'][0]).flatten().tolist():
        x1, y1, x2, y2 = (batch['gt_bboxes'][0, j] / 4).long().tolist()
        masks[0, j, y1:y2 + 1, x1:x2 + 1] = (torch.rand(
            y2 + 1 - y1, x2 + 1 - x1, generator=g) > 0.3).to(torch.uint8)
    batch['gt_masks'] = masks
    losses, outs, masks, props = {}, {}, {}, None
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(model).to(device).train()
        b = {k: v.to(device) for k, v in batch.items()}
        feats, rpn_outs = m(b['image'])
        if props is None:
            props = [p[:, :200] for p in m._proposals(rpn_outs,
                                                       b['img_hw'])]
        p = [x.to(device) for x in props]
        got = m.roi_head.forward_train(
            feats, *p, b, torch.Generator(device=device).manual_seed(0))
        losses[device] = {k: float(v.detach()) for k, v in got.items()}
        feats = [f.detach() for f in feats]
        with torch.inference_mode():
            outs[device] = [o.cpu() for o in m.eval().roi_head.simple_test(
                feats, *p, b['img_hw'])]
            if m.roi_head.with_test_masks:
                masks[device] = m.roi_head.simple_test_mask(
                    feats, *(o.to(device) for o in outs['cpu'][:3])).cpu()
    assert {'loss_mask_s2', 'loss_bbox_s2'} <= set(losses['cpu'])
    for k, c in losses['cpu'].items():
        assert losses['cuda'][k] == pytest.approx(c, rel=1e-3), k
    got, want = outs['cuda'], outs['cpu']
    assert len(got) == (4 if kind == 'CascadeRoIHead' else 3)
    assert int(want[2].sum()) > 0 and torch.equal(got[2], want[2])
    ok = want[2][0]
    key = lambda d, lab: sorted(range(len(lab)), key=lambda j: (  # noqa
        -round(float(d[j, 4]), 5), int(lab[j]), round(float(d[j, 0]), 2)))
    rows = []
    for dets, labels in ((got[0][0][ok], got[1][0][ok]),
                         (want[0][0][ok], want[1][0][ok])):
        order = key(dets, labels)
        rows.append((dets[order].double(), labels[order]))
    assert torch.equal(rows[0][1], rows[1][1])
    assert float((rows[0][0] - rows[1][0]).abs().max()) < 1e-3
    if masks:
        assert float((masks['cuda'] - masks['cpu']).abs().max()) <= 5e-3


@pytest.mark.cuda
def test_hrnet_hrfpn_on_the_card_equal_the_cpu(no_tf32):
    """A small HRNet (two modules in stage 3) and its HRFPN (plain torch:
    convs, nearest and bilinear resizes, the fuse adds, the pools) on the
    card against the same weights and input on the CPU at 1x3x128x192,
    each level to 1e-4 of its largest output."""
    _need_card()
    from ld_tpu_torch.models.backbones import HRNet
    from ld_tpu_torch.models.necks import HRFPN
    chans = (8, 16, 32, 64)
    extra = dict(stage1=dict(num_modules=1, num_branches=1,
                             block='BOTTLENECK', num_blocks=(1, ),
                             num_channels=(16, )))
    for s in (2, 3, 4):
        extra[f'stage{s}'] = dict(num_modules=2 if s == 3 else 1,
                                  num_branches=s, block='BASIC',
                                  num_blocks=(1, ) * s,
                                  num_channels=chans[:s])
    model = torch.nn.Sequential(HRNet(extra=extra),
                                HRFPN(list(chans), 64, stride=2))
    for m in model:
        m.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 128, 192, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.eval()(x)
        got = model.cuda()(x.cuda())
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


@pytest.mark.cuda
def test_regnet_dcn_block_on_the_card_equals_the_cpu(no_tf32):
    """A RegNetX-3.2GF stage-3 block with its grouped DCN conv2 (9 groups of
    48 channels, stride 2, a shortcut) on the card against the same weights
    and input on the CPU, with seeded non-zero offsets, within 1e-4 of its
    largest output."""
    _need_card()
    from ld_tpu_torch.models.backbones import RegNet
    from ld_tpu_torch.testing import randomize_dcn_offsets
    model = RegNet(arch='regnetx_3.2gf', dcn=dict(type='DCNv2',
                                                  deform_groups=1),
                   stage_with_dcn=(False, True, True, True))
    model.init_weights(torch.Generator().manual_seed(0))
    block = model.layer3[0].eval()
    assert randomize_dcn_offsets(block, seed=0) == 1
    assert block.conv2.groups == 9 and block.downsample is not None
    x = torch.randn(2, 192, 50, 84, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = block(x)
        got = block.cuda()(x.cuda()).cpu()
    assert got.shape == want.shape == (2, 432, 25, 42)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _plugin_layer(kind):
    """One block of the ResNet variants at its c4 shape (2 x C x 50 x 84),
    seeded, with its zero-init parts drawn so that it changes its input:
    a weight-standardized 3x3 conv (256 channels), GCNet's ContextBlock
    after conv3 (1024), an attention block '1111' after conv2 (256, 8
    heads, K / V pooled by 2)."""
    from ld_tpu_torch.models.backbones.plugins import (ContextBlock,
                                                       GeneralizedAttention)
    from ld_tpu_torch.models.layers import ConvWS2d, lecun_normal_
    from ld_tpu_torch.testing import randomize_plugin_gates
    gen = torch.Generator().manual_seed(0)
    if kind == 'conv_ws':
        layer = ConvWS2d(256, 256, 3, 1, 1, bias=False)
        lecun_normal_(layer.weight, gen)
        return layer, 256
    if kind == 'context_block':
        layer = ContextBlock(1024, ratio=1. / 4)
        c = 1024
    else:
        layer = GeneralizedAttention(256, num_heads=8, kv_stride=2,
                                     attention_type='1111')
        c = 256
    layer.init_weights(gen)
    assert randomize_plugin_gates(layer, seed=0) == 1
    return layer, c


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['conv_ws', 'context_block',
                                  'gen_attention'])
def test_resnet_variant_block_on_the_card_equals_the_cpu(no_tf32, kind):
    """`ConvWS2d`, `ContextBlock` and `GeneralizedAttention` (plain torch) on
    the card against the same weights and input on the CPU at their c4
    shape, the output (and a plugin's residual, output minus input) within
    1e-4 of its largest |value|."""
    _need_card()
    layer, c = _plugin_layer(kind)
    x = torch.randn(2, c, 50, 84, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = layer(x)
        got = layer.cuda()(x.cuda()).cpu()
    assert got.shape == want.shape
    outs = [(got, want)] if kind == 'conv_ws' else [(got, want),
                                                    (got - x, want - x)]
    for g, w in outs:
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_gn_ws_mask_rcnn_forward_test_on_the_card_equals_the_cpu(no_tf32):
    """A Mask R-CNN with GN + ConvWS in the trunk (R18), the FPN and the
    Shared4Conv1FC bbox head, and its mask head's conv_cfg / norm_cfg (not
    read, caveat 37), width 64, 4 classes: `forward_test` at 1x3x128x192 on
    the card against the CPU, the same kept set, each detection paired with
    the CPU's of its label nearest in box and score (equal scores may come
    in either order), boxes within 5e-3 px, masks within 5e-3."""
    _need_card()
    import copy
    import warnings
    from scipy.optimize import linear_sum_assignment
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.testing import detection_batch
    ws, gn = dict(type='ConvWS'), dict(type='GN', num_groups=32)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')      # the mask head's caveat 37
        model = build_detector(dict(
            type='MaskRCNN',
            backbone=dict(type='ResNet', depth=18, frozen_stages=1,
                          conv_cfg=ws, norm_cfg=gn),
            neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                      out_channels=64, num_outs=5, conv_cfg=ws,
                      norm_cfg=gn),
            rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
            roi_head=dict(type='StandardRoIHead', bbox_head=dict(
                type='Shared4Conv1FCBBoxHead', num_classes=4,
                in_channels=64, conv_out_channels=64, fc_out_channels=64,
                conv_cfg=ws, norm_cfg=gn),
                mask_head=dict(num_classes=4, in_channels=64,
                               conv_out_channels=64, conv_cfg=ws,
                               norm_cfg=gn))))
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.roi_head.bbox_head.fc_cls.weight.mul_(10.0)
    batch = detection_batch(1, 128, 192, num_classes=4, seed=0,
                            device='cpu')
    with torch.inference_mode():
        want = [t.numpy() for t in model.eval().forward_test(batch)]
        card = copy.deepcopy(model).cuda()
        got = [t.cpu().numpy() for t in card.forward_test(
            {k: v.cuda() for k, v in batch.items()})]
    ok = want[2][0]
    assert ok.sum() > 0 and (got[2][0] == ok).all()
    g_dets, w_dets = got[0][0][ok], want[0][0][ok]
    g_labels, w_labels = got[1][0][ok], want[1][0][ok]
    cost = abs(g_dets[:, None] - w_dets[None]).sum(-1) + 1e6 * (
        g_labels[:, None] != w_labels[None])
    gi, wi = linear_sum_assignment(cost)
    assert (g_labels[gi] == w_labels[wi]).all()
    assert abs(g_dets[gi] - w_dets[wi]).max() <= 5e-3
    assert abs(got[3][0][ok][gi] - want[3][0][ok][wi]).max() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize('hw', [(100, 168), (13, 21)])
def test_star_deform_conv_on_the_card_equals_the_cpu(no_tf32, hw):
    """VFNet's star DeformConv (plain torch, offsets from the caller) at a
    P3 and a P6 map of 800x1344, 256 channels, offsets of +-4 cells: the
    card against the CPU within 1e-4 of the largest output, and the input's,
    offsets' and weight's gradients the same way."""
    _need_card()
    from ld_tpu_torch.ops.deform_conv import DeformConv
    gen = torch.Generator().manual_seed(0)
    layer = DeformConv(256, 256)
    layer.init_weights(gen)
    x = torch.randn(1, 256, *hw, generator=gen)
    offset = (torch.rand(1, 18, *hw, generator=gen) - 0.5) * 8
    outs, grads = [], []
    for device in ('cpu', 'cuda'):
        m = DeformConv(256, 256).to(device)
        m.load_state_dict(layer.state_dict())
        xi = x.detach().to(device).requires_grad_(True)
        oi = offset.detach().to(device).requires_grad_(True)
        out = m(xi, oi)
        out.square().mean().backward()
        outs.append(out.detach().cpu())
        grads.append([t.grad.cpu() for t in (xi, oi, m.weight)])
    assert float((outs[1] - outs[0]).abs().max()) <= \
        1e-4 * float(outs[0].abs().max())
    for g, c in zip(grads[1], grads[0]):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


def _vfnet_head(seed=0):
    from ld_tpu_torch.models.heads import VFNetHead
    head = VFNetHead(num_classes=4, in_channels=64, stacked_convs=2,
                     feat_channels=64, dcn_on_last_conv=True)
    head.init_weights(torch.Generator().manual_seed(seed))
    from ld_tpu_torch.testing import randomize_dcn_offsets
    randomize_dcn_offsets(head, seed)
    with torch.no_grad():
        head.vfnet_cls.bias.zero_()
    return head


@pytest.mark.cuda
def test_vfnet_head_on_the_card_equals_the_cpu(no_tf32):
    """The VFNet head (width 64, the DCN tower option, 4 classes) on random
    FPN features of a 2x3x128x192 batch: its three outputs within 5e-3,
    its losses within rtol 1e-3 a term, and the decode of the CPU's outputs
    on the card (one nms_keep launch) with the same labels and kept set,
    boxes and scores within 1e-4."""
    _need_card()
    import copy
    from ld_tpu_torch.testing import detection_batch
    head = _vfnet_head()
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn(2, 64, h, w, generator=gen)
             for h, w in ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
    batch = detection_batch(2, 128, 192, num_classes=4, seed=0,
                            device='cpu')
    sizes = [tuple(f.shape[-2:]) for f in feats]
    runs = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(head).to(device).train()
        outs = m([f.to(device) for f in feats])
        losses = m.loss(outs, {k: v.to(device) for k, v in batch.items()},
                        sizes)
        runs[device] = ([[x.detach().cpu() for x in part] for part in outs],
                        {k: float(v.detach()) for k, v in losses.items()})
    (c_outs, c_loss), (g_outs, g_loss) = runs['cpu'], runs['cuda']
    for cp, gp in zip(c_outs, g_outs):
        for c, g in zip(cp, gp):
            assert float((g - c).abs().max()) <= 5e-3
    for k, c in c_loss.items():
        assert abs(g_loss[k] - c) <= 1e-3 * abs(c), k
    with torch.no_grad():
        want = head.eval().get_bboxes(c_outs, batch['img_hw'])
        launches = nms_keep.launches
        got = head.cuda().get_bboxes([[x.cuda() for x in part]
                                      for part in c_outs],
                                     batch['img_hw'].cuda())
        torch.cuda.synchronize()
    assert nms_keep.launches == launches + 1
    got = [t.cpu() for t in got]
    assert want[2].sum() > 0 and torch.equal(got[2], want[2])
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_varifocal_loss_on_the_card_equals_the_cpu():
    _need_card()
    from ld_tpu_torch.models.losses import VarifocalLoss
    gen = torch.Generator().manual_seed(0)
    pred = torch.randn(2, 5000, 80, generator=gen) * 3
    target = torch.zeros_like(pred)
    pos = torch.rand(2, 5000, generator=gen) < 0.02
    target[pos, torch.randint(0, 80, (int(pos.sum()), ), generator=gen)] = \
        torch.rand(int(pos.sum()), generator=gen)
    loss = VarifocalLoss()
    vals, grads = [], []
    for device in ('cpu', 'cuda'):
        p = pred.detach().to(device).requires_grad_(True)
        v = loss(p, target.to(device), avg_factor=float(pos.sum()))
        v.backward()
        vals.append(float(v.detach()))
        grads.append(p.grad.cpu())
    assert abs(vals[1] - vals[0]) <= 1e-5 * abs(vals[0])
    assert float((grads[1] - grads[0]).abs().max()) <= \
        1e-5 * float(grads[0].abs().max())


@pytest.mark.cuda
def test_lvis_scale_roi_nms_on_the_card():
    """The RoI head's class-aware NMS at LVIS's width: 1000 rois x 1203
    classes of class-specific boxes, score_thr 0.0001, every pair above it
    at random weights, so the candidates stop at the max_candidates cap
    (K = 1024): one launch, the detections identical with the plain keep
    mask."""
    _need_card()
    from ld_tpu_torch.ops.nms import multiclass_nms
    gen = torch.Generator().manual_seed(0)
    n, c = 1000, 1203
    scores = torch.softmax(torch.randn(1, n, c + 1, generator=gen) * 0.3,
                           -1)[..., :c].cuda()
    xy = torch.rand(1, n, c, 2, generator=gen) * 1000
    boxes = torch.cat([xy, xy + torch.rand(1, n, c, 2, generator=gen) * 300
                       + 1], -1).cuda()
    assert bool((scores > 1e-4).all())
    launches = nms_keep.launches
    got = multiclass_nms(boxes, scores, 1e-4, 0.5, max_per_img=300)
    torch.cuda.synchronize()
    assert nms_keep.launches == launches + 1
    want = multiclass_nms(boxes, scores, 1e-4, 0.5, max_per_img=300,
                          keep_fn=nms_keep_ref)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[2].sum()) == 300


def _dense_head(cfg, seed=0):
    """A GA or RepPoints head at width 64, 4 classes, its offset convs
    seeded off the grid, the class and location biases at 0."""
    from ld_tpu_torch.testing import randomize_head_offsets
    from ld_tpu_torch.utils.registry import HEADS
    head = HEADS.build(dict(cfg))
    head.init_weights(torch.Generator().manual_seed(seed))
    randomize_head_offsets(head, seed)
    with torch.no_grad():
        getattr(head, head.cls_pred_name).bias.zero_()
        if hasattr(head, 'conv_loc'):
            head.conv_loc.bias.zero_()
    return head


_GA = dict(type='GARetinaHead', num_classes=4, in_channels=64,
           feat_channels=64, stacked_convs=2)
_GA_RPN = dict(type='GARPNHead', in_channels=64, feat_channels=64,
               test_cfg=dict(nms_pre=300, max_per_img=200,
                             nms=dict(iou_threshold=0.7)))
_REPPOINTS = dict(type='RepPointsHead', num_classes=4, in_channels=64,
                  feat_channels=64, point_feat_channels=64, stacked_convs=2)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['ga', 'ga_rpn', 'reppoints_moment',
                                  'reppoints_grid'])
def test_dense_offset_head_on_the_card_equals_the_cpu(no_tf32, kind):
    """A GA-Retina, GA-RPN or RepPoints (moment, or grid + minmax) head on
    random FPN features of a 2x3x128x192 batch: its outputs within 5e-3,
    its losses within rtol 1e-3 a term, and the decode (detections, or
    GA-RPN's proposals) of the CPU's outputs on the card, one nms_keep
    launch, with the same valid mask (and labels), boxes within 1e-4."""
    _need_card()
    import copy
    from ld_tpu_torch.testing import detection_batch
    cfg = {'ga': _GA, 'ga_rpn': _GA_RPN, 'reppoints_moment': _REPPOINTS,
           'reppoints_grid': dict(_REPPOINTS, transform_method='minmax',
                                  use_grid_points=True)}[kind]
    head = _dense_head(cfg)
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn(2, 64, h, w, generator=gen)
             for h, w in ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
    batch = detection_batch(2, 128, 192, num_classes=4, seed=0,
                            device='cpu')
    sizes = [tuple(f.shape[-2:]) for f in feats]
    runs = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(head).to(device).train()
        outs = m([f.to(device) for f in feats])
        losses = m.loss(outs, {k: v.to(device) for k, v in batch.items()},
                        sizes)
        runs[device] = ([[x.detach().cpu() for x in part] for part in outs],
                        {k: float(v.detach()) for k, v in losses.items()})
    (c_outs, c_loss), (g_outs, g_loss) = runs['cpu'], runs['cuda']
    for cp, gp in zip(c_outs, g_outs):
        for c, g in zip(cp, gp):
            assert float((g - c).abs().max()) <= 5e-3
    for k, c in c_loss.items():
        assert abs(g_loss[k] - c) <= 1e-3 * abs(c), k
    decode = 'get_proposals' if kind == 'ga_rpn' else 'get_bboxes'
    with torch.no_grad():
        want = getattr(head.eval(), decode)(c_outs, batch['img_hw'])
        launches = nms_keep.launches
        got = getattr(head.cuda(), decode)(
            [[x.cuda() for x in part] for part in c_outs],
            batch['img_hw'].cuda())
        torch.cuda.synchronize()
    assert nms_keep.launches == launches + 1
    got = [t.cpu() for t in got]
    assert want[-1].sum() > 0 and torch.equal(got[-1], want[-1])
    if kind != 'ga_rpn':
        assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_dense_assigners_on_the_card_equal_the_cpu():
    """`PointAssigner`, `ApproxMaxIoUAssigner` and the MaxIoU assigner with
    a box set for each image on a 2x800x1344 batch's GA geometry (strides 8-128,
    100 gts an image): every field identical."""
    _need_card()
    from ld_tpu_torch.models.heads import GARetinaHead, RepPointsHead
    from ld_tpu_torch.ops.extra_assigners import (ApproxMaxIoUAssigner,
                                                  PointAssigner)
    from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
    from ld_tpu_torch.testing import detection_batch
    sizes = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
    batch = detection_batch(2, 800, 1344, seed=0, device='cpu')
    squares, approxs, num_lvl, strides = GARetinaHead().geometry(sizes,
                                                                 'cpu')
    centers, pstrides, _ = RepPointsHead().points(sizes, 'cpu')
    gen = torch.Generator().manual_seed(0)
    boxes = squares + torch.randn(2, *squares.shape, generator=gen) * 4
    runs = []
    for device in ('cpu', 'cuda'):
        gts = [batch[k].to(device) for k in ('gt_bboxes', 'gt_labels',
                                             'gt_valid')]
        runs.append([
            PointAssigner(scale=4, pos_num=1).assign(
                torch.cat([centers, pstrides[:, None]], -1).to(device),
                None, *gts),
            ApproxMaxIoUAssigner().assign(squares.to(device), num_lvl,
                                          *gts, approxs=approxs.to(device)),
            MaxIoUAssigner().assign(boxes.to(device), num_lvl, *gts)])
    for c_res, g_res in zip(*runs):
        assert int(c_res.pos_mask.sum()) > 0
        for c, g in zip(c_res, g_res):
            assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
def test_bounded_iou_loss_on_the_card_equals_the_cpu():
    _need_card()
    from ld_tpu_torch.models.losses import BoundedIoULoss
    gen = torch.Generator().manual_seed(0)
    xy = torch.rand(2, 20000, 2, generator=gen) * 1000
    pred = torch.cat([xy, xy + torch.rand(2, 20000, 2, generator=gen) * 300
                      + 1], -1).reshape(-1, 4)
    target = pred + torch.randn(pred.shape, generator=gen) * 20
    weight = (torch.rand(pred.shape[0], generator=gen) < 0.05).float()
    vals, grads = [], []
    for device in ('cpu', 'cuda'):
        p = pred.detach().to(device).requires_grad_(True)
        v = BoundedIoULoss()(p, target.to(device), weight=weight.to(device),
                             avg_factor=float(weight.sum()))
        v.backward()
        vals.append(float(v.detach()))
        grads.append(p.grad.cpu())
    assert abs(vals[1] - vals[0]) <= 1e-5 * abs(vals[0])
    assert float((grads[1] - grads[0]).abs().max()) <= \
        1e-5 * float(grads[0].abs().max())


_FOVEA = dict(type='FoveaHead', num_classes=4, in_channels=64,
              feat_channels=64, stacked_convs=2)
_SSD = dict(type='SSDHead', num_classes=4, in_channels=(16, ) * 6)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['fovea', 'fovea_align', 'ssd'])
def test_fovea_ssd_head_on_the_card_equals_the_cpu(no_tf32, kind):
    """A FoveaBox head (plain, and align with its offsets seeded off the
    grid) on random FPN features of a 2x3x128x192 batch, or an SSD300 head
    on random features of its six level sizes and a 2x3x300x300 batch: its
    outputs within 5e-3, its losses within rtol 1e-3 a term (SSD's hard
    negatives ranked alike), and the decode of the CPU's outputs on the
    card, one nms_keep launch, with the same valid mask and labels, boxes
    within 1e-4."""
    _need_card()
    import copy
    from ld_tpu_torch.testing import detection_batch
    gen = torch.Generator().manual_seed(1)
    if kind == 'ssd':
        from ld_tpu_torch.utils.registry import HEADS
        head = HEADS.build(dict(_SSD))
        head.init_weights(torch.Generator().manual_seed(0))
        sizes = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
        feats = [torch.randn(2, 16, h, w, generator=gen) for h, w in sizes]
        batch = detection_batch(2, 300, 300, num_classes=4, seed=0,
                                device='cpu')
    else:
        head = _dense_head(dict(_FOVEA, with_deform=kind == 'fovea_align'))
        feats = [torch.randn(2, 64, h, w, generator=gen)
                 for h, w in ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
        batch = detection_batch(2, 128, 192, num_classes=4, seed=0,
                                device='cpu')
        sizes = [tuple(f.shape[-2:]) for f in feats]
    runs = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(head).to(device).train()
        outs = m([f.to(device) for f in feats])
        losses = m.loss(outs, {k: v.to(device) for k, v in batch.items()},
                        sizes)
        runs[device] = ([[x.detach().cpu() for x in part] for part in outs],
                        {k: float(v.detach()) for k, v in losses.items()})
    (c_outs, c_loss), (g_outs, g_loss) = runs['cpu'], runs['cuda']
    for cp, gp in zip(c_outs, g_outs):
        for c, g in zip(cp, gp):
            assert float((g - c).abs().max()) <= 5e-3
    for k, c in c_loss.items():
        assert abs(g_loss[k] - c) <= 1e-3 * abs(c), k
    with torch.no_grad():
        want = head.eval().get_bboxes(c_outs, batch['img_hw'])
        launches = nms_keep.launches
        got = head.cuda().get_bboxes([[x.cuda() for x in part]
                                      for part in c_outs],
                                     batch['img_hw'].cuda())
        torch.cuda.synchronize()
    assert nms_keep.launches == launches + 1
    got = [t.cpu() for t in got]
    assert want[2].sum() > 0 and torch.equal(got[2], want[2])
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_resnest_and_mask_scoring_on_the_card_equal_the_cpu(no_tf32):
    """A ResNeSt-50 trunk on running statistics at 1x3x128x192 (its four
    outputs within 5e-5 of each one's largest value), and the Mask Scoring
    RoI head (width 64, 4 classes, samplers that pick every candidate) on
    random FPN features: its losses, `loss_mask_iou` included, within rtol
    1e-3 a term."""
    _need_card()
    import copy
    from ld_tpu_torch.models.backbones import ResNeSt
    from ld_tpu_torch.testing import detection_batch
    from ld_tpu_torch.utils.registry import HEADS
    trunk = ResNeSt(depth=50, frozen_stages=1, norm_eval=False)
    trunk.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 128, 192, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        c_outs = trunk.eval()(x)
        g_outs = copy.deepcopy(trunk).cuda().eval()(x.cuda())
    for c, g in zip(c_outs, g_outs):
        assert float((g.cpu() - c).abs().max()) <= 5e-5 * float(c.abs().max())
    everything = dict(num=10**6, pos_fraction=1.0)
    head = HEADS.build(dict(
        type='MaskScoringRoIHead',
        bbox_head=dict(num_classes=4, in_channels=64, fc_out_channels=64),
        mask_head=dict(num_convs=4, in_channels=64, conv_out_channels=64),
        mask_iou_head=dict(conv_out_channels=64, fc_out_channels=64),
        bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32]),
        train_cfg=dict(sampler=everything)))
    head.init_weights(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    feats = [torch.randn(2, 64, h, w, generator=gen)
             for h, w in ((32, 48), (16, 24), (8, 12), (4, 6))]
    batch = detection_batch(2, 128, 192, num_classes=4, seed=0,
                            device='cpu')
    batch['gt_masks'] = (torch.rand(2, batch['gt_bboxes'].shape[1], 32, 48,
                                    generator=gen) > 0.5).to(torch.uint8)
    props = batch['gt_bboxes'] + torch.randn(batch['gt_bboxes'].shape,
                                             generator=gen) * 3
    runs = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(head).to(device).train()
        b = {k: v.to(device) for k, v in batch.items()}
        losses = m.forward_train([f.to(device) for f in feats],
                                 props.to(device), b['gt_valid'], b,
                                 torch.Generator(device=device).manual_seed(0))
        runs[device] = {k: float(v.detach()) for k, v in losses.items()}
    assert 'loss_mask_iou' in runs['cpu'] and runs['cpu']['loss_mask_iou'] > 0
    for k, c in runs['cpu'].items():
        assert abs(runs['cuda'][k] - c) <= 1e-3 * abs(c), k


_PAA_FAMILY = dict(
    paa=dict(type='PAAHead', anchor_generator=dict(
        ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
        strides=[8, 16, 32, 64, 128])),
    fsaf=dict(type='FSAFHead', train_cfg=dict(assigner=dict(
        type='CenterRegionAssigner', pos_scale=0.5, neg_scale=0.8))),
    free_anchor=dict(type='FreeAnchorRetinaHead'),
    sabl_retina=dict(type='SABLRetinaHead'))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', list(_PAA_FAMILY))
def test_paa_fsaf_free_anchor_sabl_head_on_the_card_equals_the_cpu(no_tf32,
                                                                   kind):
    """A PAA, FSAF, FreeAnchor or SABL RetinaNet head (width 64, 2 stacked
    convs, 4 classes) on random FPN features of a 2x3x128x192 batch: its
    outputs within 5e-3; its losses on the CPU's outputs within rtol 1e-3 a
    term (PAA's reassigned positives identical); the decode of the CPU's
    outputs on the card, one nms_keep launch, with the same valid mask and
    labels, boxes within 1e-4."""
    _need_card()
    import copy
    from ld_tpu_torch.testing import detection_batch
    head = _dense_head(dict(_PAA_FAMILY[kind], num_classes=4, in_channels=64,
                            feat_channels=64, stacked_convs=2))
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn(2, 64, h, w, generator=gen)
             for h, w in ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
    batch = detection_batch(2, 128, 192, num_classes=4, seed=0,
                            device='cpu')
    sizes = [tuple(f.shape[-2:]) for f in feats]
    with torch.no_grad():
        c_outs = head.eval()(feats)
        g_outs = copy.deepcopy(head).cuda().eval()([f.cuda() for f in feats])
    for cp, gp in zip(c_outs, g_outs):
        for c, g in zip(cp, gp):
            assert float((g.cpu() - c).abs().max()) <= 5e-3
    runs = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(head).to(device).train()
        outs = [[x.to(device) for x in part] for part in c_outs]
        b = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            losses = m.loss(outs, b, sizes)
            keep = m.reassigned(outs, b, sizes)['keep'].cpu() \
                if kind == 'paa' else None
        runs[device] = ({k: float(v) for k, v in losses.items()}, keep)
    for k, c in runs['cpu'][0].items():
        assert abs(runs['cuda'][0][k] - c) <= 1e-3 * abs(c), k
    if kind == 'paa':
        assert runs['cpu'][1].sum() > 0
        assert torch.equal(runs['cuda'][1], runs['cpu'][1])
    with torch.no_grad():
        want = head.get_bboxes(c_outs, batch['img_hw'])
        launches = nms_keep.launches
        got = head.cuda().get_bboxes([[x.cuda() for x in part]
                                      for part in c_outs],
                                     batch['img_hw'].cuda())
        torch.cuda.synchronize()
    assert nms_keep.launches == launches + 1
    got = [t.cpu() for t in got]
    assert want[2].sum() > 0 and torch.equal(got[2], want[2])
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('cascade', [False, True])
def test_sabl_roi_head_on_the_card_equals_the_cpu(no_tf32, cascade):
    """A SABL (or SABL Cascade) RoI head (width 64, 4 classes, samplers
    that pick every candidate) on random FPN features and noisy gt
    proposals: its losses within rtol 1e-3 a term, the bucket decode of the
    CPU's predictions on the card within 1e-4 (boxes and confidence), and
    `simple_test` on the card, one nms_keep launch, with the same valid
    mask and labels, boxes within 1e-4."""
    _need_card()
    import copy
    from ld_tpu_torch.testing import detection_batch
    from ld_tpu_torch.utils.registry import HEADS
    everything = dict(num=10**6, pos_fraction=1.0)
    bh = dict(type='SABLHead', num_classes=4, in_channels=64,
              cls_out_channels=64, reg_in_channels=64)
    head = HEADS.build(dict(
        type='CascadeSABLRoIHead' if cascade else 'SABLRoIHead',
        bbox_head=[dict(bh) for _ in range(3)] if cascade else bh,
        bbox_roi_extractor=dict(featmap_strides=[4, 8, 16, 32]),
        train_cfg=dict(sampler=everything),
        test_cfg=dict(score_thr=0.01, nms=dict(iou_threshold=0.5),
                      max_per_img=100)))
    head.init_weights(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    feats = [torch.randn(2, 64, h, w, generator=gen)
             for h, w in ((32, 48), (16, 24), (8, 12), (4, 6))]
    batch = detection_batch(2, 128, 192, num_classes=4, seed=0,
                            device='cpu')
    props = torch.cat([batch['gt_bboxes'] + torch.randn(
        batch['gt_bboxes'].shape, generator=gen) * s for s in (2, 6, 12)], 1)
    valid = batch['gt_valid'].repeat(1, 3)
    runs = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(head).to(device).train()
        b = {k: v.to(device) for k, v in batch.items()}
        losses = m.forward_train([f.to(device) for f in feats],
                                 props.to(device), valid.to(device), b,
                                 torch.Generator(device=device).manual_seed(0))
        runs[device] = {k: float(v.detach()) for k, v in losses.items()}
    for k, c in runs['cpu'].items():
        assert abs(runs['cuda'][k] - c) <= 1e-3 * abs(c), k
    coder = head.coders[-1] if cascade else head.coder
    bucket = torch.randn(2, 50, 28, generator=gen) * 3
    offset = torch.randn(2, 50, 28, generator=gen)
    want = coder.decode(props[:, :50], (bucket, offset),
                        max_shape=batch['img_hw'])
    got = coder.decode(props[:, :50].cuda(), (bucket.cuda(), offset.cuda()),
                       max_shape=batch['img_hw'].cuda())
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4
    with torch.no_grad():
        c_feats = [f for f in feats]
        want = head.eval().simple_test(c_feats, props, valid,
                                       batch['img_hw'])
        launches = nms_keep.launches
        got = head.cuda().simple_test([f.cuda() for f in feats],
                                      props.cuda(), valid.cuda(),
                                      batch['img_hw'].cuda())
        torch.cuda.synchronize()
    assert nms_keep.launches == launches + 1
    got = [t.cpu() for t in got]
    assert want[2].sum() > 0 and torch.equal(got[2], want[2])
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-4
