"""ld_tpu_torch NMS against the JAX package.

  * `nms_keep_ref` (the plain version of the CUDA kernel) must EQUAL the JAX
    fixpoint `_cluster_nms_keep` and the Pallas kernel run in interpret mode,
    as `tests/test_pallas_nms.py` runs it.
  * The port's batched `multiclass_nms` must match the JAX one per image:
    dets within 1e-5, labels and valid exact (continuous random scores, so
    the top-k has no ties among valid candidates).
The kernel itself is held against its plain version on the card in
tests/test_torch_port_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ld_tpu.ops import nms as jax_nms
from ld_tpu.ops.pallas_nms import pallas_nms_keep
from ld_tpu_torch.ops import nms as port_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep, nms_keep_ref
from ld_tpu_torch.testing import NMS_SETS, nms_set
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse


def _sorted_candidates(rng, k, classes=4):
    """Score-sorted clustered boxes, class-offset as multiclass_nms builds
    them, with ~10% invalid entries."""
    centers = rng.uniform(0, 300, (max(k // 8, 1), 2))
    c = centers[rng.randint(0, len(centers), k)] + rng.normal(0, 6, (k, 2))
    wh = rng.uniform(10, 60, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    boxes += (rng.randint(0, classes, k) * 4096.0)[:, None]
    scores = np.sort(rng.uniform(0.01, 1, k))[::-1]
    valid = rng.uniform(size=k) > 0.1
    return (boxes.astype(np.float32), scores.astype(np.float32).copy(),
            valid)


def _keep_case(rng, k, name):
    """(boxes, scores, valid, keep mask fixed by construction or None): the
    random clustered set when `name` is None, else the hand-made set."""
    if name is None:
        return (*_sorted_candidates(rng, k), None)
    boxes, valid, want = nms_set(name, k, seed=k)
    return boxes, np.linspace(1, 0.01, k, dtype=np.float32), valid, want


@pytest.mark.parametrize('k,name', [
    *[pytest.param(k, None, id=str(k)) for k in (8, 64, 512, 1024)],
    *[(k, name) for name in NMS_SETS for k in (63, 65, 128, 1024)]])
def test_nms_keep_ref_equals_cluster_nms_keep(k, name):
    rng = np.random.RandomState(k)
    for thr in (0.5, 0.6):
        boxes, scores, valid, fixed = _keep_case(rng, k, name)
        want = np.asarray(jax_nms._cluster_nms_keep(
            jnp.asarray(boxes), jnp.asarray(scores), thr,
            valid=jnp.asarray(valid)))
        got = nms_keep_ref(torch.from_numpy(boxes)[None],
                           torch.from_numpy(valid)[None], thr)[0]
        np.testing.assert_array_equal(got.numpy(), want)
        if fixed is not None:
            np.testing.assert_array_equal(want, fixed)
        if name is None and k >= 64:   # the clusters make suppression chains
            assert 0 < want.sum() < valid.sum()


@pytest.mark.parametrize('k,name', [
    *[pytest.param(k, None, id=str(k)) for k in (8, 64, 512)],
    *[(k, name) for name in NMS_SETS for k in (65, 128)]])
def test_nms_keep_ref_equals_pallas_interpret(k, name):
    rng = np.random.RandomState(100 + k)
    boxes, _, valid, fixed = _keep_case(rng, k, name)
    want = np.asarray(pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(valid),
                                      0.6, interpret=True))
    got = nms_keep_ref(torch.from_numpy(boxes)[None],
                       torch.from_numpy(valid)[None], 0.6)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    if fixed is not None:
        np.testing.assert_array_equal(want, fixed)


def test_nms_keep_cpu_takes_plain_version_batched():
    rng = np.random.RandomState(7)
    sets = [_sorted_candidates(rng, 96) for _ in range(3)]
    boxes = torch.from_numpy(np.stack([s[0] for s in sets]))
    valid = torch.from_numpy(np.stack([s[2] for s in sets]))
    launches = nms_keep.launches
    got = nms_keep(boxes, valid, 0.6)
    assert nms_keep.launches == launches          # no kernel on the CPU
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(),
            nms_keep_ref(boxes[i:i + 1], valid[i:i + 1], 0.6)[0].numpy())
    with pytest.raises(TypeError):
        nms_keep(boxes.double(), valid, 0.6)
    with pytest.raises(ValueError):
        nms_keep(boxes, valid[:, :5], 0.6)


def _mc_inputs(rng, b, n, c, density=1.0):
    xy = rng.uniform(0, 700, (b, n, 2))
    wh = rng.uniform(8, 200, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # distinct scores: float32 uniforms tie among the top 1024 of 160k pairs,
    # and the order of tied pairs is left open by both top-ks
    scores = (rng.permutation(b * n * c).reshape(b, n, c) + 0.5) / (b * n * c)
    scores *= rng.uniform(size=(b, n, c)) < density
    return boxes, scores.astype(np.float32)


def _check_multiclass(boxes, scores, **kw):
    got = port_nms.multiclass_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), 0.05, 0.6, **kw)
    for i in range(boxes.shape[0]):
        want = jax_nms.multiclass_nms(jnp.asarray(boxes[i]),
                                      jnp.asarray(scores[i]), 0.05, 0.6, **kw)
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        assert np.asarray(want[2]).sum() > 10
    return got


@pytest.mark.parametrize('n,density,preprune', [
    (2000, 1.0, None),     # N <= 2k: plain flat top-k
    (2000, 1.0, True),     # the exact anchor pre-prune, forced
    (3000, 1.0, None),     # N > 2k: the pre-prune by default
    (300, 0.02, None),     # < 1024 scores above score_thr: invalid tail
])
def test_multiclass_nms_matches_jax(n, density, preprune):
    rng = np.random.RandomState(n + int(density * 10))
    boxes, scores = _mc_inputs(rng, 2, n, 80, density)
    _check_multiclass(boxes, scores, exact_preprune=preprune)


def test_multiclass_nms_giant_box_engages_offset_bound():
    rng = np.random.RandomState(3)
    boxes, scores = _mc_inputs(rng, 1, 500, 8)
    # one giant box, top-scored in class 2 and in class 3: with the offset
    # left at 4096 the two class bands would overlap at IoU 0.67 and one
    # would suppress the other; the bound max(4096, max+1) keeps both
    boxes[0, :2] = [0, 0, 40000, 40000]
    scores[0, :2] = 0
    scores[0, 0, 2] = 1.0
    scores[0, 1, 3] = 0.99995
    got = _check_multiclass(boxes, scores)
    assert got[1][0, :2].tolist() == [2, 3]


def test_nms_matches_jax():
    rng = np.random.RandomState(5)
    boxes, scores = _mc_inputs(rng, 1, 300, 1)
    boxes, scores = boxes[0], scores[0, :, 0]
    for max_out, score_thr in ((50, float('-inf')), (300, 0.3)):
        want_idx, want_valid = jax_nms.nms(jnp.asarray(boxes),
                                           jnp.asarray(scores), 0.5, max_out,
                                           score_thr)
        idx, valid = port_nms.nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), 0.5, max_out,
                                  score_thr)
        want_valid = np.asarray(want_valid)
        np.testing.assert_array_equal(valid.numpy(), want_valid)
        np.testing.assert_array_equal(idx.numpy()[want_valid],
                                      np.asarray(want_idx)[want_valid])


@pytest.mark.parametrize('kw', [
    dict(approx_topk=0.95),
    dict(nms_cfg=dict(approx_topk=0.95)),
    dict(nms_cfg=dict(type='soft_nms')),
    dict(nms_cfg=dict(type='voting_cluster_diounms')),
])
def test_unported_nms_keys_raise(kw):
    """The keys not ported raise; the voting type, ported, routes to
    `multiclass_nms_voting` and returns `max_per_img` rows an image."""
    boxes, scores = _mc_inputs(np.random.RandomState(0), 1, 20, 3)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), 0.05, 0.6)
    if kw.get('nms_cfg', {}).get('type') == 'voting_cluster_diounms':
        dets, labels, valid = port_nms.multiclass_nms(*args, max_per_img=30,
                                                      **kw)
        assert dets.shape == (1, 30, 5) and labels.shape == valid.shape == \
            (1, 30)
        assert 0 < int(valid.sum()) <= 30
        for got, want in zip((dets, labels, valid),
                             port_nms.multiclass_nms_voting(*args, 30)):
            assert torch.equal(got, want)
        return
    with pytest.raises(NotImplementedError):
        port_nms.multiclass_nms(*args, **kw)

