"""The ld_tpu_torch GFL detector against the JAX package on the same weights.

JAX variables (the init's shapes, drawn from a numpy seed) ->
`state_dict_from_jax` -> the port, then the same numpy image through both
(the JAX side jitted: op by op it costs ~5x the time):
  * per-level cls/reg outputs within 5e-3 max abs and 2e-4 median relative
    (the bounds of tests/test_torch_parity.py: fp32 reassociation over ~30
    conv layers between XLA and oneDNN);
  * the port's `state_dict()` through `convert_torch_state_dict` gives the
    JAX tree back with nothing unmapped;
  * `get_bboxes` on identical head outputs matches to 1e-4.
Small sizes: R18 and R50 at base width 16, FPN/head width 64, 2 stacked
convs, 64x96 inputs, plus a 72x100 input whose FPN upsamples are not 2x.
(At width 32 each of the 32 GroupNorm groups holds one channel, and on the
1x1 top level one value, which torch's GroupNorm refuses.)
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ld_tpu.models import build_detector as jax_build_detector
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_port_bridge import fill_tree
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

TEST_CFG = dict(nms_pre=50, score_thr=0.05,
                nms=dict(type='nms', iou_threshold=0.6), max_per_img=100)


def model_cfg(depth=18, base=16, num_classes=4):
    expansion = 4 if depth >= 50 else 1
    return dict(
        type='GFL',
        backbone=dict(type='ResNet', depth=depth, base_channels=base,
                      frozen_stages=1, norm_eval=True, style='pytorch'),
        neck=dict(type='FPN',
                  in_channels=[base * 2**i * expansion for i in range(4)],
                  out_channels=64, start_level=1,
                  add_extra_convs='on_output', num_outs=5),
        bbox_head=dict(
            type='GFLHead', num_classes=num_classes, in_channels=64,
            stacked_convs=2, feat_channels=64, reg_max=16,
            anchor_generator=dict(type='AnchorGenerator', ratios=[1.0],
                                  octave_base_scale=8, scales_per_octave=1,
                                  strides=[8, 16, 32, 64, 128]),
            loss_cls=dict(type='QualityFocalLoss', use_sigmoid=True,
                          beta=2.0, loss_weight=1.0),
            loss_dfl=dict(type='DistributionFocalLoss', loss_weight=0.25),
            loss_bbox=dict(type='GIoULoss', loss_weight=2.0)),
        test_cfg=TEST_CFG)


def jax_variables(det, seed, cls_bias_zero=False):
    """JAX variables as numpy in the shapes of the init (`jax.eval_shape`:
    running the init, op by op or compiled, costs 8-20 s here), drawn from
    a numpy seed (`fill_tree`: kernels at the init's lecun-normal scale,
    BN statistics and affine, GN affine and biases random), and set level
    scales, so that every mapped tensor matters."""
    v = fill_tree(jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(seed), (1, 64, 96, 3))), seed)
    v['params']['head_net']['scales'] = np.float32([1.0, 1.1, 0.9, 1.2, 0.8])
    if cls_bias_zero:
        v['params']['head_net']['gfl_cls']['bias'][:] = 0
    return v


def port_model(cfg, variables):
    model = build_detector(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _image(seed, h, w):
    return np.random.RandomState(seed).randn(1, 3, h, w).astype(np.float32)


@pytest.mark.parametrize('depth,hw', [(18, (64, 96)), (50, (64, 96)),
                                      (50, (72, 100))])
def test_detector_outputs_match_jax(depth, hw):
    cfg = model_cfg(depth)
    det = jax_build_detector(cfg)
    variables = jax_variables(det, seed=depth)
    model = port_model(cfg, variables)
    x = _image(1, *hw)
    j_cls, j_reg = jax.jit(det.apply)(variables,
                                      jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        t_cls, t_reg = model(torch.from_numpy(x))
    assert len(t_cls) == len(t_reg) == 5
    for lvl in range(5):
        for j, t in ((j_cls[lvl], t_cls[lvl]), (j_reg[lvl], t_reg[lvl])):
            t_np = t.numpy().transpose(0, 2, 3, 1)
            assert t_np.shape == np.asarray(j).shape
            diff = np.abs(np.asarray(j) - t_np)
            assert diff.max() < 5e-3, (lvl, float(diff.max()))
            assert np.median(diff / (np.abs(t_np) + 1e-2)) < 2e-4, lvl


@pytest.mark.parametrize('depth', [18, 50])
def test_state_dict_round_trips_through_converter(depth):
    cfg = model_cfg(depth)
    det = jax_build_detector(cfg)
    variables = jax_variables(det, seed=depth + 1)
    model = port_model(cfg, variables)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_torch_state_dict(sd)
    assert back.pop('_unmapped') == []
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert set(flat_back) == set(flat_want)
    for path, want in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), want,
                                      err_msg=jax.tree_util.keystr(path))


def _match_dets(got, want, tol):
    """Detections equal up to `tol`, in the same order."""
    dets, labels, valid = (np.asarray(a) for a in got)
    w_dets, w_labels, w_valid = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_array_equal(labels, w_labels)
    np.testing.assert_allclose(dets, w_dets, rtol=0, atol=tol)


def test_get_bboxes_matches_jax_on_identical_head_outputs():
    cfg = model_cfg(18)
    det = jax_build_detector(cfg)
    variables = jax_variables(det, seed=3, cls_bias_zero=True)
    x = np.concatenate([_image(4, 64, 96), _image(5, 64, 96)])
    j_cls, j_reg = jax.jit(det.apply)(variables,
                                      jnp.asarray(x.transpose(0, 2, 3, 1)))
    img_hw = np.array([[60, 90], [64, 70]], np.float32)
    sf = np.array([[1.5, 1.25, 1.5, 1.25], [0.5, 0.5, 0.5, 0.5]], np.float32)
    want = jax.jit(lambda c, r, hw, f: det.bbox_head.get_bboxes(
        (c, r), hw, f, rescale=True))(j_cls, j_reg, jnp.asarray(img_hw),
                                      jnp.asarray(sf))
    head = build_detector(cfg).bbox_head.eval()

    def nchw(xs):
        return [torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())
                for a in xs]

    got = head.get_bboxes((nchw(j_cls), nchw(j_reg)), torch.from_numpy(img_hw),
                          torch.from_numpy(sf), rescale=True)
    assert tuple(got[0].shape) == (2, 100, 5)
    assert got[2].sum() > 0
    _match_dets(got, want, 1e-4)
