"""ld_tpu_torch box / anchor / integral primitives against the JAX package.

The same numpy inputs go through `ld_tpu.ops` (JAX on the CPU) and
`ld_tpu_torch.ops`; both compute in float32 in the same operation order, so
the tolerance is 1e-6 absolute.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ld_tpu.ops import anchors as jax_anchors
from ld_tpu.ops import boxes as jax_boxes
from ld_tpu.ops.integral import integral as jax_integral
from ld_tpu_torch.ops import anchors as port_anchors
from ld_tpu_torch.ops import boxes as port_boxes
from ld_tpu_torch.ops.integral import integral as port_integral
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

TOL = 1e-6


def _boxes(rng, shape, scale=100.0):
    xy = rng.uniform(0, scale, shape + (2, ))
    wh = rng.uniform(0.5, scale / 2, shape + (2, ))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _close(port, ref, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=TOL)


@pytest.mark.parametrize('mode', ['iou', 'iof', 'giou', 'diou', 'ciou'])
@pytest.mark.parametrize('aligned', [False, True])
def test_bbox_overlaps_matches_jax(mode, aligned):
    rng = np.random.RandomState(0)
    a = _boxes(rng, (2, 37))
    b = _boxes(rng, (2, 37 if aligned else 23))
    # disjoint and degenerate pairs exercise the clamps
    b[0, 0] = [500, 500, 510, 510]
    a[1, 1] = [5, 5, 5, 9]
    got = port_boxes.bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b),
                                   mode=mode, is_aligned=aligned)
    want = jax_boxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b),
                                   mode=mode, is_aligned=aligned)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_box_coders_match_jax():
    rng = np.random.RandomState(1)
    pts = rng.uniform(0, 200, (2, 50, 2)).astype(np.float32)
    dist = rng.uniform(0, 80, (2, 50, 4)).astype(np.float32)
    max_shape = np.array([[120, 150], [90, 200]], np.float32)
    for ms in (None, max_shape, max_shape[0]):
        got = port_boxes.distance2bbox(
            torch.from_numpy(pts), torch.from_numpy(dist),
            None if ms is None else torch.from_numpy(ms))
        want = jax_boxes.distance2bbox(jnp.asarray(pts), jnp.asarray(dist),
                                       None if ms is None else
                                       jnp.asarray(ms))
        _close(got, want)
    bb = _boxes(rng, (2, 50))
    for max_dis in (None, 16):
        _close(port_boxes.bbox2distance(torch.from_numpy(pts),
                                        torch.from_numpy(bb), max_dis),
               jax_boxes.bbox2distance(jnp.asarray(pts), jnp.asarray(bb),
                                       max_dis))
    _close(port_boxes.anchor_center(torch.from_numpy(bb)),
           jax_boxes.anchor_center(jnp.asarray(bb)))


@pytest.mark.parametrize('ag_cfg', [
    dict(ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
         strides=[8, 16, 32, 64, 128]),
    dict(ratios=[0.5, 1.0, 2.0], octave_base_scale=4, scales_per_octave=3,
         strides=[8, 16, 32], center_offset=0.5),
])
def test_anchor_generator_matches_jax(ag_cfg):
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)][:len(ag_cfg['strides'])]
    port = port_anchors.AnchorGenerator(**ag_cfg)
    ref = jax_anchors.AnchorGenerator(**ag_cfg)
    assert port.num_base_anchors == ref.num_base_anchors
    for got, want in zip(port.grid_anchors(sizes), ref.grid_anchors(sizes)):
        assert got.dtype == torch.float32
        _close(got, want)
    for img_hw in ((50.0, 90.0), (64.0, 96.0), (17.0, 5.0)):
        for got, want in zip(port.valid_flags(sizes, img_hw),
                             ref.valid_flags(sizes, img_hw)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_integral_matches_jax():
    x = np.random.RandomState(2).randn(3, 40, 68).astype(np.float32) * 3
    got = port_integral(torch.from_numpy(x), 16)
    want = jax_integral(jnp.asarray(x), 16)
    assert tuple(got.shape) == (3, 40, 4)
    # expected distances reach 16 bins, where one float32 ulp is 1.9e-6, and
    # the two softmaxes differ by a few ulps: 1e-6 relative
    _close(got, want, rtol=1e-6)
