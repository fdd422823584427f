"""The CUDA greedy-NMS kernel against its plain PyTorch version, bit for bit.

Needs a CUDA card and skips without one: the kernel has no CPU mode. This
file imports neither jax nor ld_tpu, so it also runs on a GPU host without
JAX, where tests/conftest.py (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""
import pytest
import torch

from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref


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


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the NMS kernel has no CPU mode')
    for b, k in ((1, 8), (1, 1000), (8, 1024), (2, 2048), (3, 4100)):
        boxes, valid = _candidates(b, k, seed=b * k)
        launches = nms_keep.launches
        got = nms_keep(boxes.cuda(), valid.cuda(), 0.6)
        torch.cuda.synchronize()
        assert nms_keep.launches == launches + 1
        assert torch.equal(got, nms_keep_ref(boxes.cuda(), valid.cuda(), 0.6))
        assert torch.equal(got.cpu(), nms_keep_ref(boxes, valid, 0.6))
