"""Helpers that hold a port head against the JAX package on the same
weights; this file holds no test of its own.

The weights go port -> JAX: a port head (or detector) is initialised from a
seed, with random GN affine and level scales (and BN statistics and affine
in a backbone) so that every mapped tensor matters, and its `state_dict()`
goes through `ld_tpu.utils.checkpoint.convert_torch_state_dict`, checked
leaf by leaf against the JAX module's own parameter tree. A head runs at
width 64 (GN 32, so 2 channels a group) with 2 stacked convs and 4
classes, on random 64-channel FPN features of a 2-image 64x96 batch: JAX
compiles per shape.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.utils.checkpoint import (convert_torch_state_dict,
                                     validate_variables)
from ld_tpu.utils.registry import HEADS as JAX_HEADS
from ld_tpu_torch.testing import detection_batch_np
from ld_tpu_torch.utils.registry import HEADS

HW = (64, 96)
NUM_CLASSES = 4
TEST_CFG = dict(nms_pre=50, score_thr=0.05,
                nms=dict(type='nms', iou_threshold=0.6), max_per_img=100)
# the heads' config keys
HEAD_KW = dict(num_classes=NUM_CLASSES, in_channels=64, stacked_convs=2,
               feat_channels=64)
# the bounds of the port's forward tests: fp32 reassociation over many conv
# layers between XLA and oneDNN
OUT_ABS, OUT_MEDIAN_REL = 5e-3, 2e-4
LOSS_RTOL = 2e-4


def randomize_norms(model, seed):
    """Random BN statistics and affine, GN affine and level scales."""
    rng = np.random.RandomState(seed)
    head = getattr(model, 'bbox_head', model)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.uniform(-0.2, 0.2, m.num_features)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.8, 1.2, m.num_features)))
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                m.weight.copy_(torch.from_numpy(
                    rng.uniform(0.8, 1.2, m.weight.shape)))
                m.bias.copy_(torch.from_numpy(
                    rng.uniform(-0.1, 0.1, m.bias.shape)))
        for s, v in zip(getattr(head, 'scales', ()),
                        (1.0, 1.1, 0.9, 1.2, 0.8)):
            s.scale.fill_(v)


def to_jax_variables(model, det, input_shape=(1, ) + HW + (3, )):
    """A port detector's weights as the JAX detector's variables, checked
    leaf by leaf against the JAX parameter tree."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    conv = convert_torch_state_dict(sd)
    assert conv.pop('_unmapped') == []
    template = jax.eval_shape(
        lambda: det.init_variables(jax.random.PRNGKey(0), input_shape))
    validate_variables(conv, template)
    return conv


def bare_heads(head_cfg, train_cfg=None):
    """The head `head_cfg` alone in both packages: (jax head, port head)."""
    cfg = dict(head_cfg, **HEAD_KW, train_cfg=train_cfg, test_cfg=TEST_CFG)
    return JAX_HEADS.build(dict(cfg)), HEADS.build(dict(cfg))


def fpn_feats(seed, b=2):
    """Random 64-channel FPN features of a (b, 64, 96) batch, NHWC numpy,
    strides 8 to 128."""
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, w, HEAD_KW['in_channels']).astype(np.float32)
            for h, w in ((8, 12), (4, 6), (2, 3), (1, 2), (1, 1))]


def port_and_jax_head(head_cfg, seed, train_cfg=None, cls_bias=0.0):
    """The port head `head_cfg` from `seed` (its cls prediction bias set to
    `cls_bias`, so that a decode sees candidates) and the JAX head with the
    same weights: (port head in eval, jax head, jax head-net variables)."""
    j_head, head = bare_heads(head_cfg, train_cfg)
    head.init_weights(torch.Generator().manual_seed(seed))
    randomize_norms(head, seed)
    with torch.no_grad():
        getattr(head, head.cls_pred_name).bias.fill_(cls_bias)
    conv = convert_torch_state_dict({f'bbox_head.{k}': v.numpy()
                                     for k, v in head.state_dict().items()})
    assert conv.pop('_unmapped') == []
    variables = {'params': conv['params']['head_net']}
    template = jax.eval_shape(lambda: j_head.net.init(
        jax.random.PRNGKey(0), [jnp.zeros(f.shape) for f in fpn_feats(0)]))
    validate_variables(variables, template)
    return head.eval(), j_head, variables


def nhwc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))


def nchw(levels):
    """JAX per-level NHWC arrays -> port NCHW tensors."""
    return [torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())
            for a in levels]


def both_head_forward(head, j_head, variables, feats):
    """The same NHWC numpy features through both heads: (jax outputs as
    tuples of per-level NHWC arrays, port outputs as tuples of NCHW
    tensors)."""
    j_outs = jax.jit(j_head.net.apply)(variables,
                                       [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        t_outs = head(nchw(feats))
    return tuple(tuple(part) for part in j_outs), t_outs


def assert_outputs_close(j_outs, t_outs):
    assert len(j_outs) == len(t_outs)
    for j_part, t_part in zip(j_outs, t_outs):
        assert len(j_part) == len(t_part) == 5
        for lvl, (j, t) in enumerate(zip(j_part, t_part)):
            t_np = t.numpy().transpose(0, 2, 3, 1)
            assert t_np.shape == np.asarray(j).shape
            diff = np.abs(np.asarray(j) - t_np)
            assert diff.max() < OUT_ABS, (lvl, float(diff.max()))
            assert np.median(diff / (np.abs(t_np) + 1e-2)) < OUT_MEDIAN_REL


def batches(b=2, seed=3):
    """The same padded gt batch for both packages: (jax, port)."""
    np_batch = detection_batch_np(b, *HW, num_classes=NUM_CLASSES,
                                  max_gts=6, seed=seed)
    j = {k: jnp.asarray(v) for k, v in np_batch.items()}
    j['image'] = nhwc(np_batch['image'])
    t = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    return j, t


def random_like(j_outs, seed, scale=2.0):
    """Random per-level NHWC arrays of the shapes of `j_outs`: a teacher."""
    rs = np.random.RandomState(seed)
    return tuple(tuple(jnp.asarray((rs.randn(*np.shape(a)) * scale)
                                   .astype(np.float32)) for a in part)
                 for part in j_outs)


def port_outs(j_outs):
    return tuple(nchw(part) for part in j_outs)


def assert_losses_close(got, want, rtol=LOSS_RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = float(torch.as_tensor(got[k]).detach()), float(want[k])
        assert np.isfinite(g), k
        assert abs(g - w) <= rtol * abs(w) + 1e-7, (k, g, w)


def assert_dets_close(got, want, tol=1e-4):
    """Detections equal up to `tol`, in the same order, with the same
    labels and valid mask."""
    dets, labels, valid = (np.asarray(a) for a in got)
    w_dets, w_labels, w_valid = (np.asarray(a) for a in want)
    assert valid.sum() > 0
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_array_equal(labels, w_labels)
    np.testing.assert_allclose(dets, w_dets, rtol=0, atol=tol)
