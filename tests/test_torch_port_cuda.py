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
the CPU, and so are a Res2Net-50-DCN trunk and the GI masks of an IMv2
step with the Res2Net-101-DCN teacher.
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
    for b, k in ((1, 8), (1, 1000), (8, 1024), (2, 2048), (3, 4100)):
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
