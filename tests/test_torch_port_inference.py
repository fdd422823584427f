"""ld_tpu_torch inference API and test pipeline against the JAX package.

  * `inference_detector` matches `ld_tpu`'s on the same weights, on an image
    whose keep-ratio resize is the identity (so both pipelines see the same
    pixels);
  * the port's bilinear `Resize` matches cv2 INTER_LINEAR (used by the JAX
    package, and present here for the test only) within one grey level;
    `Normalize`, `Pad` and `collate_batch` match the JAX ones exactly;
  * entry points refuse to fall back to the CPU, and importing the port
    pulls in neither jax nor ld_tpu.
"""
import ast
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from ld_tpu.apis import inference as jax_inference
from ld_tpu.data import transforms as jax_transforms
from ld_tpu.models import build_detector as jax_build_detector
from ld_tpu.utils.checkpoint import save_variables
from ld_tpu.utils.config import Config as JaxConfig
from ld_tpu_torch.apis import inference_detector, init_detector
from ld_tpu_torch.data import transforms
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from ld_tpu_torch.utils.config import Config
from test_torch_port_model import jax_variables, model_cfg
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _match_sets(got, want, tol):
    """Same detections up to `tol`, in any order: detections whose scores
    differ by less than the two models' fp32 difference may swap places."""
    assert len(got['boxes']) == len(want['boxes']) > 0
    d = np.abs(got['boxes'][:, None, :] - want['boxes'][None, :, :]).max(-1)
    d[got['labels'][:, None] != want['labels'][None, :]] = np.inf
    nearest = d.argmin(1)
    assert len(set(nearest.tolist())) == len(nearest)
    assert d[np.arange(len(d)), nearest].max() < tol


def test_inference_detector_matches_jax(tmp_path):
    """The JAX `init_detector` loads the weights from a `.npz` (its own
    random init, op by op, costs ~20 s)."""
    cfg = model_cfg(18)
    cfg['test_cfg'] = dict(cfg['test_cfg'], max_per_img=1000)
    variables = jax_variables(jax_build_detector(cfg), seed=7,
                              cls_bias_zero=True)
    path = str(tmp_path / 'gfl.npz')
    save_variables(path, variables)
    det, loaded = jax_inference.init_detector(JaxConfig(dict(model=cfg)),
                                              checkpoint=path)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, loaded, variables))
    model = init_detector(Config(dict(model=cfg)), device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    img = np.random.RandomState(8).randint(0, 256, (64, 96, 3), np.uint8)
    kw = dict(img_scale=(96, 64), pad_hw=((64, 96), (96, 64)))
    want = jax_inference.inference_detector(det, variables, img, **kw)
    got = inference_detector(model, img, **kw)
    assert got['boxes'].shape[1] == 5
    _match_sets(got, want, 2e-3)


def test_init_detector_loads_mmdet_checkpoint(tmp_path):
    cfg = Config(dict(model=model_cfg(50)))
    model = init_detector(cfg, device='cpu', seed=3)
    path = str(tmp_path / 'gfl.pth')
    torch.save(dict(state_dict=model.state_dict(), meta={}), path)
    loaded = init_detector(cfg, checkpoint=path, device='cpu', seed=4)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              loaded.state_dict().items()):
        assert torch.equal(a, b), k
    other = init_detector(cfg, device='cpu', seed=4)
    assert not torch.equal(other.bbox_head.gfl_reg.weight,
                           model.bbox_head.gfl_reg.weight)


@pytest.mark.parametrize('src_hw,dst_wh', [((37, 53), (80, 56)),
                                           ((120, 90), (61, 45)),
                                           ((64, 96), (96, 64))])
def test_resize_matches_cv2_within_one_grey_level(src_hw, dst_wh):
    img = np.random.RandomState(sum(src_hw)).randint(
        0, 256, src_hw + (3, ), np.uint8)
    got = transforms.resize_bilinear(img, *dst_wh)
    want = cv2.resize(img, dst_wh, interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_pipeline_matches_jax_exactly():
    img = np.random.RandomState(9).randint(0, 256, (50, 70, 3), np.uint8)
    steps = [dict(type='Resize', img_scale=(70, 50), keep_ratio=True),
             dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                  std=[58.395, 57.12, 57.375], to_rgb=True),
             dict(type='Pad', size_divisor=32)]
    got = transforms.Compose(steps)(dict(img=img, img_shape=img.shape))
    want = jax_transforms.Compose([dict(s) for s in steps])(
        dict(img=img, img_shape=img.shape))
    np.testing.assert_array_equal(got['img'], want['img'])
    np.testing.assert_array_equal(got['scale_factor'], want['scale_factor'])
    buckets = ((64, 96), (96, 64), (128, 128))
    g = transforms.collate_batch([got], buckets)
    w = jax_transforms.collate_batch([want], buckets, max_gts=1)
    np.testing.assert_array_equal(g['image'], w['image'].transpose(0, 3, 1, 2))
    for key in ('img_hw', 'scale_factor'):
        np.testing.assert_array_equal(g[key], w[key])


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        init_detector(Config(dict(model=model_cfg(18))))
    model = init_detector(Config(dict(model=model_cfg(18))), device='cpu')
    # an image path is decoded; a missing file raises, nothing falls back
    with pytest.raises(FileNotFoundError):
        inference_detector(model, os.path.join(ROOT, 'no_such_image.jpg'))


def test_port_imports_neither_jax_nor_ld_tpu():
    code = ('import sys, ld_tpu_torch, ld_tpu_torch.apis, '
            'ld_tpu_torch.utils.checkpoint; '
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "ld_tpu")); print(bad)')
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
    # and no source file of the port, nor chip_smoke.py, names them
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, _, names in os.walk(os.path.join(ROOT, 'ld_tpu_torch')):
        files += [os.path.join(d, n) for n in names if n.endswith('.py')]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split('.')[0] not in ('jax', 'jaxlib', 'flax',
                                               'ld_tpu'), (path, m)

