"""The CUDA greedy-NMS kernel against its plain PyTorch version, bit for bit.

Needs a CUDA card and skips without one: the kernel has no CPU mode. This
file imports neither jax nor ld_tpu, so it also runs on a GPU host without
JAX, where tests/conftest.py (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

The hand-made edge sets of the block-wise sweep come from
`ld_tpu_torch.testing`; `chip_smoke.py` checks the kernel on the same sets.
The training caller, `LDHead._gi_mask`, is checked at the GI path's shapes,
and the loader's `DevicePrefetcher` against a plain copy to the card.
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
