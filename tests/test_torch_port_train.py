"""The port's LD training step against the JAX package, on the same weights.

JAX init (student and teacher) -> `load_from_jax` -> the port, then the same
numpy batch through both, on the CPU in float32:
  * the full LD loss dict on configs/ld/ld_r18_self_2x_3x_voc.py, term by
    term to rtol 2e-4 (the tolerance of `__graft_entry__.dryrun_multichip`);
  * the student gradients of one LD step: max abs difference at most 1e-4 of
    the largest gradient (fp32 reassociation through ~30 conv layers);
  * three SGD steps (`make_train_step` + `build_optimizer` on both sides,
    through the warmup) tracking the JAX losses to rtol 1e-3;
  * the GI arm (loss_im weight 2, gibox) with identical GI masks per level;
  * the teacher: hidden from the student's parameters and state dict, kept
    in eval, moved with the student, and after its BN fold equal to itself
    before it to 1e-5 of the largest output;
  * the optimizer's parameter groups, and the step's loss sum and gradient
    clip.
All at 64x96 (the dry run's batch) at full width: 256-channel FPN, 4+4
towers.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft_entry
import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.models import build_detector as jax_build_detector
from ld_tpu.models.heads.gfl_head import flatten_levels as j_flatten
from ld_tpu.ops import anchor_center as j_anchor_center
from ld_tpu.parallel import build_lr_schedule as j_build_lr_schedule
from ld_tpu.parallel import build_optimizer as j_build_optimizer
from ld_tpu.parallel import make_train_step as j_make_train_step
from ld_tpu.parallel.train_step import TrainState
from ld_tpu_torch import Config
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                   make_train_step)
from ld_tpu_torch.testing import detection_batch_np
from ld_tpu_torch.utils.checkpoint import load_from_jax, state_dict_from_jax
from ld_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn_cfg_ok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LD_CFG = os.path.join(ROOT, 'configs/ld/ld_r18_self_2x_3x_voc.py')
GFL_CFG = os.path.join(ROOT, 'configs/gfl/gfl_r18_fpn_1x_coco.py')
INPUT = (1, 64, 96, 3)
RTOL = 2e-4
LD_KEYS = ('loss_cls', 'loss_bbox', 'loss_dfl', 'loss_ld', 'loss_ld_vlr',
           'loss_kd', 'loss_kd_neg', 'loss_im')


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(batch):
    """A JAX batch (NHWC image) -> the port's (NCHW, int64 labels)."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    out['gt_labels'] = out['gt_labels'].long()
    return out


def _assert_losses_close(got, want, keys, rtol):
    for k in keys:
        g, w = float(torch.as_tensor(got[k]).detach()), float(want[k])
        assert np.isfinite(g), k
        assert abs(g - w) <= rtol * abs(w) + 1e-7, (k, g, w)


def _ld_configs(loss_im_weight=0):
    """The LD config in both packages, loss_im at `loss_im_weight`."""
    jcfg, cfg = JConfig.fromfile(LD_CFG), Config.fromfile(LD_CFG)
    for c in (jcfg, cfg):
        c.model.bbox_head.loss_im = dict(type='IMLoss',
                                         loss_weight=loss_im_weight)
    return jcfg, cfg


@pytest.fixture(scope='module')
def ld():
    """The LD config through both packages on the same weights, and the JAX
    loss dict and student gradients of one LD step.

    The networks and the loss are jitted apart and chained by `jax.vjp` at
    the head outputs: XLA's fused program of the whole step computes some
    gradients only to ~1e-3 (the reg tower's third conv), while the split
    programs agree with the port's float64 gradients to ~1e-6 of the
    largest."""
    jcfg, cfg = _ld_configs()
    det = jax_build_detector(jcfg.model)
    variables = _np_tree(jax.jit(det.init_variables, static_argnums=1)(
        jax.random.PRNGKey(0), INPUT))
    teacher = _np_tree(jax.jit(det.init_teacher_variables, static_argnums=1)(
        jax.random.PRNGKey(1), INPUT))
    model = load_from_jax(build_detector(cfg.model), variables, teacher)
    batch = graft_entry._make_batch(jnp, 2, 64, 96)
    student = jax.jit(lambda v: det.apply(v, batch['image'], train=True,
                                          output_features=True))
    t_outs, t_feats = jax.jit(lambda t: det.teacher.apply(
        t, batch['image'], output_features=True))(teacher)

    def total(outs, feats):
        losses = det.bbox_head.loss(
            outs, batch, [c.shape[1:3] for c in outs[0]], tuple(t_outs),
            student_feats=feats, teacher_feats=t_feats)
        return sum(v for k, v in losses.items() if 'loss' in k), losses

    (outs, feats), net_vjp = jax.vjp(
        lambda p: student({'params': p,
                           'batch_stats': variables['batch_stats']}),
        variables['params'])
    (_, losses), out_grads = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(outs, feats)
    grads, = net_vjp(out_grads)
    return dict(det=det, variables=variables, teacher=teacher, model=model,
                batch=batch, losses=losses, grads=_np_tree(grads),
                outs=(outs, feats), t_outs=(t_outs, t_feats))


def test_ld_loss_dict_matches_jax(ld):
    got = ld['model'].train().forward_train(_torch_batch(ld['batch']))
    assert sorted(got) == sorted(LD_KEYS)
    assert float(got['loss_kd_neg']) == 0.0 and float(got['loss_im']) == 0.0
    _assert_losses_close(got, ld['losses'], LD_KEYS, RTOL)


def test_ld_student_gradients_match_jax(ld):
    model = ld['model'].train()
    model.zero_grad(set_to_none=True)
    losses = model.forward_train(_torch_batch(ld['batch']))
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    want = state_dict_from_jax({'params': ld['grads']})
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert trainable and all(p.grad is not None for p in trainable.values())
    # the frozen stem and stage 1 get no gradient in the port
    assert all(p.grad is None for p in model.parameters()
               if not p.requires_grad)
    largest = max(float(np.abs(want[n].numpy()).max()) for n in trainable)
    worst = max(float((p.grad - want[n]).abs().max())
                for n, p in trainable.items())
    assert largest > 0 and worst <= 1e-4 * largest, (worst, largest)
    # the teacher is frozen: no gradient reaches it
    assert all(p.grad is None for p in model.teacher.parameters())


def test_three_sgd_steps_track_jax(ld):
    det, variables, teacher = ld['det'], ld['variables'], ld['teacher']
    cfg = Config.fromfile(LD_CFG)
    # a short warmup at a larger lr, so that three steps move the weights
    opt_cfg = dict(cfg.optimizer, lr=0.01)
    lr_config = dict(cfg.lr_config, warmup_iters=2, warmup_ratio=0.1)
    j_sched = j_build_lr_schedule(0.01, lr_config, 100, 12)
    j_opt = j_build_optimizer(opt_cfg, j_sched, variables['params'],
                              frozen_prefixes=det.frozen_param_paths())
    state = TrainState(params=variables['params'],
                       batch_stats=variables['batch_stats'],
                       opt_state=j_opt.init(variables['params']),
                       step=jnp.zeros((), jnp.int32))
    j_step = jax.jit(j_make_train_step(det, j_opt, has_teacher=True))

    model = load_from_jax(build_detector(cfg.model), variables, teacher)
    optimizer, scheduler = build_optimizer(
        opt_cfg, build_lr_schedule(0.01, lr_config, 100, 12), model)
    step = make_train_step(model, optimizer, scheduler)
    batch = _torch_batch(ld['batch'])
    lrs = []
    for _ in range(3):
        lrs.append(optimizer.param_groups[0]['lr'])
        state, want = j_step(state, ld['batch'], teacher)
        got = step(batch)
        _assert_losses_close(got, want, LD_KEYS + ('loss', ), 1e-3)
    assert lrs == pytest.approx([0.001, 0.0055, 0.01])
    # the frozen stages and the teacher did not move
    sd = state_dict_from_jax(variables)
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), sd[name]), name


def _jax_gi_masks(head, outs, t_outs):
    """The JAX head's GI mask of each level, computed as its
    `_imitation_loss` computes them."""
    cls_flat, pred_flat = j_flatten(outs[0]), j_flatten(outs[1])
    soft_label, soft_target = j_flatten(t_outs[0]), j_flatten(t_outs[1])
    anchors, num_lvl, _, _ = head.level_geometry(
        [c.shape[1:3] for c in outs[0]])
    b, masks, lo = cls_flat.shape[0], [], 0
    for lvl, n in enumerate(num_lvl):
        hi = lo + n
        centers = jnp.tile(j_anchor_center(anchors[lo:hi]) /
                           head.anchor_generator.strides[lvl][0], (b, 1))
        masks.append(np.asarray(head._gi_mask(
            cls_flat[:, lo:hi].reshape(-1, head.cls_out_channels),
            soft_label[:, lo:hi].reshape(-1, head.cls_out_channels),
            pred_flat[:, lo:hi].reshape(-1, pred_flat.shape[-1]),
            soft_target[:, lo:hi].reshape(-1, pred_flat.shape[-1]),
            centers, gi_candidates=head.gi_candidates, gi_top=head.gi_top)))
        lo = hi
    return masks


def test_gi_arm_matches_jax(ld):
    """loss_im at weight 2 with gibox: the GI masks of the 5 levels (one NMS
    each, pooled over the batch) identical, the loss dict to rtol 2e-4."""
    jcfg, cfg = _ld_configs(loss_im_weight=2)
    head = jax_build_detector(jcfg.model).bbox_head
    (outs, feats), (t_outs, t_feats) = ld['outs'], ld['t_outs']
    want = jax.jit(lambda o, f, to, tf: head.loss(
        o, ld['batch'], [c.shape[1:3] for c in o[0]], tuple(to),
        student_feats=f, teacher_feats=tf))(outs, feats, t_outs, t_feats)
    model = load_from_jax(build_detector(cfg.model), ld['variables'],
                          ld['teacher'])
    tb = _torch_batch(ld['batch'])
    got = model.train().forward_train(tb)
    assert float(got['loss_im'].detach()) > 0
    _assert_losses_close(got, want, LD_KEYS, RTOL)

    with torch.no_grad():
        masks = model.bbox_head.gi_masks(model(tb['image']),
                                         model.teacher(tb['image']))
    want_masks = _jax_gi_masks(head, outs, t_outs)
    assert len(masks) == 5
    for got_m, want_m in zip(masks, want_masks):
        np.testing.assert_array_equal(got_m.numpy(), want_m)
        assert 0 < got_m.sum() <= model.bbox_head.gi_top


def _randomize_bn(module, seed):
    """Random BN statistics and affine, so that a fold changes the convs."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, lo, hi in ((m.running_mean, -0.2, 0.2),
                                  (m.running_var, 0.5, 1.5),
                                  (m.weight, 0.8, 1.2), (m.bias, -0.1, 0.1)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, n)))


def test_teacher_is_hidden_frozen_and_folds_exactly(ld):
    model = build_detector(Config.fromfile(LD_CFG).model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    teacher = model.teacher
    ids = {id(p) for p in teacher.parameters()}
    assert not ids & {id(p) for p in model.parameters()}
    assert not any(k.startswith('teacher') for k in model.state_dict())
    assert not any(p.requires_grad for p in teacher.parameters())
    model.train()
    assert model.training and not teacher.training
    model.double()
    assert next(teacher.parameters()).dtype == torch.float64
    model.float()
    optimizer, _ = build_optimizer(dict(type='SGD', lr=0.01),
                                   lambda count: 0.01, model)
    in_opt = {id(p) for g in optimizer.param_groups for p in g['params']}
    assert in_opt == {id(p) for p in model.parameters() if p.requires_grad}

    _randomize_bn(teacher, seed=5)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 64, 96)
                         .astype(np.float32))
    with torch.no_grad():
        before = teacher(x, output_features=True)
        assert model.fold_teacher_bn()
        after = teacher(x, output_features=True)
    flat_b = [t for part in before[0] for t in part] + list(before[1])
    flat_a = [t for part in after[0] for t in part] + list(after[1])
    for b_, a_ in zip(flat_b, flat_a):
        assert float((a_ - b_).abs().max()) <= 1e-5 * float(b_.abs().max())
    for m in teacher.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert torch.all(m.weight == 1) and torch.all(m.running_mean == 0)
    assert not fuse_conv_bn_cfg_ok(dict(backbone=dict(
        conv_cfg=dict(type='ConvWS'))))


def test_paramwise_groups_decide_norm_by_module_type():
    model = build_detector(Config.fromfile(GFL_CFG).model)
    optimizer, _ = build_optimizer(
        dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4,
             paramwise_cfg=dict(norm_decay_mult=0.0, bias_decay_mult=0.5,
                                bias_lr_mult=2.0)),
        lambda count: 0.01, model)
    group_of = {id(p): g for g in optimizer.param_groups for p in g['params']}
    named = dict(model.named_parameters())
    # a BatchNorm named neither bn nor norm
    for name in ('backbone.layer2.0.downsample.1.weight',
                 'backbone.layer2.0.bn1.bias', 'bbox_head.cls_convs.0.gn.bias'):
        g = group_of[id(named[name])]
        assert g['weight_decay'] == 0.0 and g['lr'] == pytest.approx(0.01)
    g = group_of[id(named['bbox_head.gfl_cls.bias'])]
    assert g['weight_decay'] == pytest.approx(5e-5)
    assert g['lr'] == pytest.approx(0.02)
    g = group_of[id(named['bbox_head.gfl_cls.weight'])]
    assert g['weight_decay'] == pytest.approx(1e-4)
    # frozen stem and stage 1: in no group
    assert id(named['backbone.conv1.weight']) not in group_of
    assert id(named['backbone.layer1.0.bn1.weight']) not in group_of


def test_train_step_sums_loss_keys_and_clips_the_global_norm():
    """make_train_step: 'loss' is the sum of the loss entries, and with
    grad_clip the gradient the optimizer steps on has the clipped norm."""
    model = build_detector(Config.fromfile(GFL_CFG).model)
    model.init_weights(torch.Generator().manual_seed(0))
    optimizer, scheduler = build_optimizer(
        dict(type='SGD', lr=0.01, momentum=0.9), lambda count: 0.01, model)
    params = [p for g in optimizer.param_groups for p in g['params']]
    norms = []
    optimizer.register_step_pre_hook(lambda *_: norms.append(float(
        torch.linalg.vector_norm(torch.stack([p.grad.norm()
                                              for p in params])))))
    step = make_train_step(model, optimizer, scheduler,
                           grad_clip=dict(max_norm=0.01, norm_type=2))
    batch = {k: torch.from_numpy(v) for k, v in
             detection_batch_np(2, 64, 96, seed=4).items()}
    out = step(batch)
    assert sorted(out) == ['loss', 'loss_bbox', 'loss_cls', 'loss_dfl']
    assert float(out['loss']) == pytest.approx(
        sum(float(out[k]) for k in ('loss_bbox', 'loss_cls', 'loss_dfl')))
    assert norms[0] <= 0.01 * (1 + 1e-5)
    assert scheduler.last_epoch == 1
