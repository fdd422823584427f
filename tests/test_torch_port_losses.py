"""The port's losses, ATSS assigner, GFL head loss and LR schedule against
the JAX package.

The same numpy inputs go through `ld_tpu` (JAX on the CPU) and
`ld_tpu_torch`:
  * QFL, DFL, the IoU family and the KD KL: values and input gradients to
    rtol 1e-5 (the same float32 formulas; only the summation order differs);
  * `GFLHead.loss` of configs/gfl/gfl_r18_fpn_1x_coco.py at full width on
    JAX-initialised weights and a `detection_batch_np` batch at 64x96, term
    by term to rtol 2e-4;
  * the weighted-loss contract's avg_factor rules;
  * ATSS `assign` and `get_vlr_region` identical on gt sets built to tie:
    integer coordinates with centres midway between anchor centres, where
    several anchors are equally near a gt and the k nearest depend on the
    order among ties;
  * the LR schedule at the warmup start, inside it, and past each step;
  * the port's modules and `chip_smoke.py` import neither jax nor ld_tpu.
"""
import ast
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as jax_build_detector
from ld_tpu.models.losses import gfocal_loss as j_gfocal
from ld_tpu.models.losses import iou_loss as j_iou
from ld_tpu.models.losses import kd_loss as j_kd
from ld_tpu.ops.anchors import AnchorGenerator as JAnchorGenerator
from ld_tpu.ops.atss_assigner import ATSSAssigner as JATSSAssigner
from ld_tpu.parallel.optim import build_lr_schedule as j_build_lr_schedule
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.losses import gfocal_loss, iou_loss, kd_loss
from ld_tpu_torch.models.losses.utils import weight_reduce_loss
from ld_tpu_torch.ops.anchors import AnchorGenerator
from ld_tpu_torch.ops.atss_assigner import ATSSAssigner
from ld_tpu_torch.parallel.optim import build_lr_schedule
from ld_tpu_torch.testing import detection_batch_np
from ld_tpu_torch.utils.checkpoint import load_from_jax
from test_torch_port_bridge import O0, fill_tree
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _both(j_loss, t_loss, inputs, wrt=0):
    """Value and gradient (w.r.t. inputs[wrt]) of a scalar loss through the
    JAX loss object and the port's; inputs are numpy arrays or tuples."""
    def jax_in(x):
        return tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple) \
            else jnp.asarray(x)

    def torch_in(x):
        return tuple(torch.from_numpy(a) for a in x) if isinstance(x, tuple) \
            else torch.from_numpy(x)

    j_args = [jax_in(x) for x in inputs]

    def j_fn(v):
        args = list(j_args)
        args[wrt] = v
        return j_loss(*args)

    # one program at -O0 (op by op, each new primitive compiles apart)
    j_val, j_grad = jax.jit(jax.value_and_grad(j_fn)).lower(
        j_args[wrt]).compile(O0)(j_args[wrt])
    t_args = [torch_in(x) for x in inputs]
    t_args[wrt] = t_args[wrt].clone().requires_grad_(True)
    t_val = t_loss(*t_args)
    t_val.backward()
    return (float(j_val), np.asarray(j_grad)), (float(t_val.detach()),
                                                t_args[wrt].grad.numpy())


def _check(j_loss, t_loss, inputs, **kw):
    (jv, jg), (tv, tg) = _both(j_loss, t_loss, inputs)
    assert np.isfinite(jv) and abs(jv) > 0
    _close(tv, jv)
    _close(tg, jg, atol=RTOL * np.abs(jg).max())


@pytest.mark.parametrize('use_avg_factor', [False, True])
def test_quality_focal_loss_matches_jax(use_avg_factor):
    rng = np.random.RandomState(0)
    n, c = 300, 20
    pred = rng.randn(n, c).astype(np.float32) * 3
    label = rng.randint(0, c + 1, n).astype(np.int64)     # c = background
    score = rng.uniform(0, 1, n).astype(np.float32)
    weight = (rng.uniform(size=n) > 0.2).astype(np.float32)
    kw = dict(avg_factor=37.5) if use_avg_factor else {}
    cfg = dict(use_sigmoid=True, beta=2.0, loss_weight=1.5)
    j = j_gfocal.QualityFocalLoss(**cfg)
    t = gfocal_loss.QualityFocalLoss(**cfg)
    _check(lambda p, tgt, w: j(p, (tgt[0].astype(jnp.int32), tgt[1]),
                               weight=w, **kw),
           lambda p, tgt, w: t(p, tgt, weight=w, **kw),
           [pred, (label, score), weight])


def test_distribution_focal_loss_matches_jax():
    rng = np.random.RandomState(1)
    n = 400
    pred = rng.randn(n, 17).astype(np.float32) * 2
    label = rng.uniform(0, 16, n).astype(np.float32)
    # integer targets, and targets in the last bin (dis_left clipped to 15)
    label[:20] = np.arange(20) % 16
    label[20:30] = 15.9
    weight = rng.uniform(0, 1, n).astype(np.float32)
    j = j_gfocal.DistributionFocalLoss(loss_weight=0.25)
    t = gfocal_loss.DistributionFocalLoss(loss_weight=0.25)
    _check(lambda p, y, w: j(p, y, weight=w, avg_factor=4.0 * 51.3),
           lambda p, y, w: t(p, y, weight=w, avg_factor=4.0 * 51.3),
           [pred, label, weight])


def _boxes(rng, n, scale=60.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(1.0, scale / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize('name', ['IoULoss', 'GIoULoss', 'DIoULoss',
                                  'CIoULoss'])
@pytest.mark.parametrize('weight_dims', [1, 2])
def test_iou_losses_match_jax(name, weight_dims):
    rng = np.random.RandomState(2)
    n = 200
    pred, target = _boxes(rng, n), _boxes(rng, n)
    target[:40] = pred[:40] + rng.uniform(-3, 3, (40, 4)).astype(np.float32)
    target[40:50] = [200, 200, 210, 215]                     # disjoint
    w = rng.uniform(0, 1, n).astype(np.float32)
    weight = w if weight_dims == 1 else np.repeat(w[:, None], 4, 1)
    j = getattr(j_iou, name)(loss_weight=2.0)
    t = getattr(iou_loss, name)(loss_weight=2.0)
    assert t.eps == 1e-6        # the class default, passed on to giou_loss
    _check(lambda p, y, wt: j(p, y, weight=wt, avg_factor=w.sum() + 1e-6),
           lambda p, y, wt: t(p, y, weight=wt, avg_factor=w.sum() + 1e-6),
           [pred, target, weight])


@pytest.mark.parametrize('T,loss_weight,avg_factor', [(10, 0.25, 4.0),
                                                      (2, 10, None)])
def test_kd_kl_div_loss_matches_jax(T, loss_weight, avg_factor):
    rng = np.random.RandomState(3)
    n, k = 256, 17
    pred = rng.randn(n, k).astype(np.float32) * 3
    soft = rng.randn(n, k).astype(np.float32) * 3
    weight = rng.uniform(0, 1, n).astype(np.float32)
    kw = dict(avg_factor=avg_factor) if avg_factor else {}
    j = j_kd.KnowledgeDistillationKLDivLoss(loss_weight=loss_weight, T=T)
    t = kd_loss.KnowledgeDistillationKLDivLoss(loss_weight=loss_weight, T=T)
    _check(lambda p, s, w: j(p, s, weight=w, **kw),
           lambda p, s, w: t(p, s, weight=w, **kw), [pred, soft, weight])
    # the target is detached: no gradient reaches the teacher's logits
    p = torch.from_numpy(pred).requires_grad_(True)
    s = torch.from_numpy(soft).requires_grad_(True)
    t(p, s, weight=torch.from_numpy(weight)).backward()
    assert p.grad.abs().max() > 0 and s.grad is None


def test_im_loss_and_both_kd_registry_names():
    from ld_tpu_torch.utils.registry import LOSSES
    assert (LOSSES.get('LocalizationDistillationLoss') is
            LOSSES.get('KnowledgeDistillationKLDivLoss'))
    rng = np.random.RandomState(4)
    x = rng.randn(3, 8, 5).astype(np.float32)
    y = rng.randn(3, 8, 5).astype(np.float32)
    _check(lambda a, b: j_kd.IMLoss(loss_weight=2)(a, b),
           lambda a, b: kd_loss.IMLoss(loss_weight=2)(a, b), [x, y])


def test_weight_reduce_loss_avg_factor_rules():
    loss = torch.tensor([1.0, 2.0, 3.0])
    w = torch.tensor([1.0, 0.0, 2.0])
    assert float(weight_reduce_loss(loss, w, 'mean', avg_factor=2.0)) == 3.5
    assert float(weight_reduce_loss(loss, w, 'mean')) == pytest.approx(7 / 3)
    assert float(weight_reduce_loss(loss, w, 'sum')) == 7.0
    assert torch.equal(weight_reduce_loss(loss, w, 'none', avg_factor=2.0),
                       loss * w)
    with pytest.raises(ValueError, match='avg_factor'):
        weight_reduce_loss(loss, w, 'sum', avg_factor=2.0)


def test_gfl_head_loss_matches_jax():
    path = os.path.join(ROOT, 'configs/gfl/gfl_r18_fpn_1x_coco.py')
    det = jax_build_detector(JConfig.fromfile(path).model)
    # the init's shapes, drawn from a numpy seed (running the init costs
    # 8-20 s here)
    variables = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(2), (1, 64, 96, 3))), 2)
    model = load_from_jax(build_detector(Config.fromfile(path).model),
                          variables).train()
    batch = detection_batch_np(2, 64, 96, num_classes=80, seed=3)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_batch['image'] = jnp.asarray(batch['image'].transpose(0, 2, 3, 1))
    j_batch['gt_labels'] = jnp.asarray(batch['gt_labels'].astype(np.int32))
    want = jax.jit(det.forward_train).lower(variables, j_batch).compile(
        compiler_options=O0)(variables, j_batch)
    got = model.forward_train({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert sorted(got) == ['loss_bbox', 'loss_cls', 'loss_dfl']
    for k, v in got.items():
        v = float(v.detach())
        assert np.isfinite(v) and v > 0, k
        _close(v, float(want[k]), rtol=2e-4)


# ---- ATSS on tied distances ---------------------------------------------
ANCHOR_CFG = dict(ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
                  strides=[8, 16, 32, 64, 128])


def _tie_gts(rng, n, h, w):
    """Integer gt boxes whose centres sit midway between anchor centres:
    centre coordinates at odd multiples of 4 (midway at stride 8), of 8
    (midway at stride 16) or of 16 (midway at stride 32)."""
    half = rng.choice([4, 8, 16], n)
    cx = (2 * rng.randint(0, w // 8, n) + 1) * half
    cy = (2 * rng.randint(0, h // 8, n) + 1) * half
    cx, cy = np.minimum(cx, w - 4), np.minimum(cy, h - 4)
    bw = rng.randint(2, 40, n)
    bh = rng.randint(2, 40, n)
    return np.stack([cx - bw, cy - bh, cx + bw, cy + bh], -1).astype(
        np.float32)


def _tie_case(seed, h=128, w=160, g=12, b=3):
    rng = np.random.RandomState(seed)
    gt = np.stack([_tie_gts(rng, g, h, w) for _ in range(b)])
    # duplicated gts tie on IoU too (the first gt wins the anchor)
    gt[:, 1] = gt[:, 0]
    labels = rng.randint(0, 20, (b, g)).astype(np.int64)
    valid = rng.uniform(size=(b, g)) > 0.15
    valid[:, :2] = True
    img_hw = np.array([[h, w], [h - 40, w], [h, w - 70]][:b], np.float32)
    return gt, labels, valid, img_hw


@functools.lru_cache(maxsize=None)
def _j_atss_ties(num_lvl):
    """The JAX ATSS assignment and VLR region of each image, as one jitted
    program (op by op, the first case took ~11 s of compiles)."""
    j_assigner = JATSSAssigner(topk=9)

    def one(anchors, gt, labels, valid, vf):
        return (j_assigner.assign(anchors, list(num_lvl), gt, labels, valid,
                                  vf, num_classes=20),
                j_assigner.get_vlr_region(anchors, list(num_lvl), gt, valid,
                                          vf))
    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0, 0)))


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_atss_assign_and_vlr_identical_on_ties(seed):
    h, w = 128, 160
    gt, labels, valid, img_hw = _tie_case(seed, h, w)
    sizes = [(-(-h // s), -(-w // s)) for s in ANCHOR_CFG['strides']]
    j_gen, t_gen = JAnchorGenerator(**ANCHOR_CFG), AnchorGenerator(**ANCHOR_CFG)
    j_anchors = jnp.concatenate(j_gen.grid_anchors(sizes))
    anchors = torch.cat(t_gen.grid_anchors(sizes))
    num_lvl = [a.shape[0] for a in t_gen.grid_anchors(sizes)]
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(j_anchors))
    vf = torch.stack([torch.cat(t_gen.valid_flags(sizes, hw))
                      for hw in torch.from_numpy(img_hw)])

    got = ATSSAssigner(topk=9).assign(
        anchors, num_lvl, torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(valid), vf, num_classes=20)
    got_vlr = ATSSAssigner(topk=9).get_vlr_region(
        anchors, num_lvl, torch.from_numpy(gt), torch.from_numpy(valid), vf)
    wants, want_vlrs = _j_atss_ties(tuple(num_lvl))(
        j_anchors, jnp.asarray(gt), jnp.asarray(labels.astype(np.int32)),
        jnp.asarray(valid), jnp.asarray(vf.numpy()))
    ties = 0
    for i in range(len(gt)):
        want = jax.tree_util.tree_map(lambda a: np.asarray(a)[i], wants)
        np.testing.assert_array_equal(got.assigned_gt_inds[i].numpy(),
                                      np.asarray(want.assigned_gt_inds))
        np.testing.assert_array_equal(got.labels[i].numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_array_equal(got.pos_mask[i].numpy(),
                                      np.asarray(want.pos_mask))
        _close(got.max_overlaps[i], want.max_overlaps, rtol=0, atol=1e-6)
        want_vlr = np.asarray(want_vlrs)[i]
        np.testing.assert_array_equal(got_vlr[i].numpy() > 0, want_vlr > 0)
        _close(got_vlr[i], want_vlr, rtol=0, atol=1e-6)
        # the set does tie: some gt has two equally near anchors at the
        # 9th place of the stride-8 level, where the order decides
        c = (anchors[:num_lvl[0], :2] + anchors[:num_lvl[0], 2:]) / 2
        gc = (torch.from_numpy(gt[i, :, :2]) + torch.from_numpy(gt[i, :, 2:])
              ) / 2
        d = torch.cdist(gc, c).sort(dim=-1).values
        ties += int((d[:, 8] == d[:, 9]).sum())
    assert got.pos_mask.any() and (got_vlr > 0).any()
    assert ties > 0


def test_lr_schedule_matches_jax():
    lr_config = dict(policy='step', warmup='linear', warmup_iters=500,
                     warmup_ratio=0.001, step=[8, 11])
    want = j_build_lr_schedule(0.01, lr_config, steps_per_epoch=100,
                               max_epochs=12)
    got = build_lr_schedule(0.01, lr_config, steps_per_epoch=100,
                            max_epochs=12)
    assert got(0) == pytest.approx(0.01 * 0.001)
    for count in (0, 1, 250, 499, 500, 799, 800, 1100, 1199):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)
    cos = dict(lr_config, policy='cosine', warmup_iters=10)
    want = j_build_lr_schedule(0.02, cos, 50, 4)
    got = build_lr_schedule(0.02, cos, 50, 4)
    for count in (0, 5, 10, 100, 199, 250):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-5,
                                           abs=1e-9)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_neither_jax_nor_ld_tpu():
    """Every module of ld_tpu_torch imported in a fresh interpreter loads no
    jax / flax / ld_tpu module and no cv2 (which only decoding an image
    file imports, at first use), and no source of the port or chip_smoke.py
    names jax / flax / ld_tpu in an import statement."""
    code = ('import pkgutil, sys, importlib, ld_tpu_torch; '
            '[importlib.import_module(m.name) for m in pkgutil.walk_packages('
            'ld_tpu_torch.__path__, "ld_tpu_torch.")]; '
            'import ld_tpu_torch.tools.train, chip_smoke; '
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "optax", "ld_tpu", "cv2")); '
            'print(bad)')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
    sources = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, _, files in os.walk(os.path.join(ROOT, 'ld_tpu_torch')):
        sources += [os.path.join(d, f) for f in files if f.endswith('.py')]
    for path in sources:
        bad = [m for m in _imports(path)
               if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                      'ld_tpu')]
        assert not bad, (path, bad)
