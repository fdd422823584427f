"""Data parallelism in the port (`ld_tpu_torch/parallel/dist.py` and its
callers), over gloo on the CPU.

The JAX package's step is one objective over the global batch of its
'data' mesh; the port's step at R ranks x b images must equal the port's
one-process step over the R x b images (itself held against JAX). One
spawn of 2 gloo ranks (`ld_tpu_torch.testing.spawn`; the children import
the port alone and run one intra-op thread) carries every rank-side check:
  * `parallel.dist` at world 1 is the identity, and its backend rules
    ('xla' is the device's collective; NCCL raises on the CPU and where
    ranks outnumber cards);
  * the loader's rank slices concatenate to the one-replica global batches
    (img_ids, pad shape, `len`) at R = 1, 2, 3, pad buckets from mstrain
    scales and from varied image sizes included;
  * LDHead (gibox), LDv2Head, LDATSSHead, LDFCOSHead and LDRetinaHead at
    64x96: the ranks' mean of their logged loss dicts equals the JAX head's
    loss on the 2-image batch (jitted, in this process) to rtol 2e-4;
  * the R18 LD detector step (GI config, grad clip) at 2 ranks x 1 image
    equals the one-process step at 2 images: losses rtol 1e-5, GI masks
    identical, gradients after the clip within 1e-5 of their largest value,
    parameters after SGD atol 1e-6;
  * the R18 Mask R-CNN step at 64x64 (samplers that pick every candidate,
    since each rank draws its own keys) at 2 ranks x 1 image equals the
    one-process step at 2 images: losses (`loss_mask`, a per-image mean,
    included) rtol 1e-5, parameters after SGD atol 1e-6;
  * `tools/train.py --launcher pytorch` and `train_detector` at R = 2:
    rank 0 alone writes, its checkpoint loads at R = 1 and through
    `convert_torch_state_dict`, a SIGTERM to rank 0 stops both ranks at one
    step, and the resumed run repeats the img_ids and LR of the run
    through;
  * `eval_detector` and `tools/test.py --launcher pytorch` at R = 2 give
    each image once, in dataset order, equal to R = 1.
Without `global_sum` (a plain DDP wrap) the head and step checks fail:
a count of one rank's images normalises that rank's terms.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu_torch import Config
from ld_tpu_torch.apis import eval_detector
from ld_tpu_torch.data import build_dataloader, build_dataset
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.parallel import dist as pdist
from ld_tpu_torch.testing import (detection_batch_np, head_losses_rank,
                                  ld_step_rank, loader_batches_rank,
                                  rank_calls, spawn, step_rank,
                                  train_eval_rank)
from ld_tpu_torch.utils.checkpoint import load_checkpoint
from ld_tpu_torch.utils.registry import HEADS
from test_torch_port_bridge import (HEAD_KW, HW, NUM_CLASSES, TEST_CFG,
                                    assert_losses_close, bare_heads,
                                    fpn_feats, nchw, randomize_norms)
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GI_CFG = os.path.join(ROOT, 'configs/ld/ld_r50_gflv1_r101_fpn_coco_1x_gi.py')
MASK_CFG = os.path.join(ROOT, 'configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py')
LD_CFG = os.path.join(ROOT, 'configs/ld/ld_r18_self_2x_3x_voc.py')
TEACHER_CFG = os.path.join(ROOT, 'configs/gfl/gfl_r18_fpn1x_voc.py')
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
WORLD = 2
MAX_IOU = dict(assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.5,
                             neg_iou_thr=0.4, min_pos_iou=0,
                             ignore_iof_thr=-1))
GFOCAL = dict(type='GFocalHead', reg_topk=4, reg_channels=64, add_mean=True)
# head -> (head cfg, train cfg)
LD_HEADS = {
    'LDHead': (dict(type='LDHead', imitation_method='gibox',
                    loss_im=dict(type='IMLoss', loss_weight=2)), None),
    'LDv2Head': (dict(GFOCAL, type='LDv2Head'), None),
    'LDATSSHead': (dict(type='LDATSSHead'), None),
    'LDFCOSHead': (dict(type='LDFCOSHead'), MAX_IOU),
    'LDRetinaHead': (dict(type='LDRetinaHead'), MAX_IOU),
}


# ---- inputs ----------------------------------------------------------------
def _head_case(name, seed):
    """A head's outputs on random FPN features of the 2-image batch (its
    own forward, seeded weights), a random teacher tuple of the same
    shapes (probabilities where the head's scores are), and for gibox the
    FPN features; numpy NCHW."""
    head_cfg, train_cfg = LD_HEADS[name]
    cfg = dict(head_cfg, **HEAD_KW, train_cfg=train_cfg, test_cfg=TEST_CFG)
    head = HEADS.build(dict(cfg))
    head.init_weights(torch.Generator().manual_seed(seed))
    randomize_norms(head, seed)
    with torch.no_grad():
        outs = head(nchw(fpn_feats(seed)))
    outs = [[a.numpy() for a in part] for part in outs]
    rs = np.random.RandomState(seed + 100)
    teacher = [[(rs.randn(*a.shape) * 2).astype(np.float32) for a in part]
               for part in outs]
    if name == 'LDv2Head':
        teacher[0] = [rs.uniform(0.01, 0.99, a.shape).astype(np.float32)
                      for a in outs[0]]
    feats = None
    if name == 'LDHead':
        feats = [[a.transpose(0, 3, 1, 2).copy() for a in fpn_feats(s)]
                 for s in (seed + 1, seed + 2)]
    batch = detection_batch_np(2, *HW, num_classes=NUM_CLASSES, max_gts=6,
                               seed=3)
    return dict(head=cfg, outs=outs, teacher=teacher, feats=feats,
                batch=batch)


def _jax_head_loss(name, case):
    j_head, _ = bare_heads(*LD_HEADS[name])
    nhwc = [[jnp.asarray(a.transpose(0, 2, 3, 1)) for a in part]
            for part in case['outs']]
    teacher = [[jnp.asarray(a.transpose(0, 2, 3, 1)) for a in part]
               for part in case['teacher']]
    batch = {k: jnp.asarray(v) for k, v in case['batch'].items()}
    batch['image'] = jnp.asarray(case['batch']['image'].transpose(0, 2, 3, 1))
    sizes = [a.shape[1:3] for a in nhwc[0]]
    feats = [None, None] if case['feats'] is None else [
        [jnp.asarray(a.transpose(0, 2, 3, 1)) for a in part]
        for part in case['feats']]
    return jax.jit(lambda o, t, sf, tf: j_head.loss(
        o, batch, sizes, t, student_feats=sf, teacher_feats=tf))(
            nhwc, teacher, *feats)


def _r18(model_cfg, width=64):
    model_cfg.backbone.depth = 18
    model_cfg.neck.in_channels = [64, 128, 256, 512]
    model_cfg.neck.out_channels = width
    model_cfg.bbox_head.in_channels = width
    model_cfg.bbox_head.feat_channels = width
    return model_cfg


def _step_cfg():
    """The GI config at R18, width 64, with an R18 teacher and a grad clip
    that binds the global gradient (norm ~805 here) but not half of it: a
    step whose objective lacks the factor R is not clipped, and differs."""
    cfg = Config.fromfile(GI_CFG)
    teacher = _r18(Config.fromfile(os.path.join(
        ROOT, cfg.model.teacher_config)).model)
    _r18(cfg.model)
    cfg.model.teacher_config = dict(model=teacher)
    cfg.model.teacher_ckpt = None
    cfg.optimizer_config = dict(grad_clip=dict(max_norm=600.0,
                                               norm_type=2))
    return cfg


def _mask_step_cfg():
    """Mask R-CNN at R18, width 64, samplers that pick every candidate,
    100 proposals an image, SGD at lr 0.01 from the first step."""
    cfg = Config.fromfile(MASK_CFG)
    m = cfg.model
    m.backbone.depth = 18
    m.neck.in_channels = [64, 128, 256, 512]
    m.neck.out_channels = 64
    m.rpn_head.in_channels = m.rpn_head.feat_channels = 64
    m.roi_head.bbox_head.update(in_channels=64, fc_out_channels=64)
    m.roi_head.mask_head.update(in_channels=64, conv_out_channels=64)
    every = dict(num=10**6, pos_fraction=1.0)
    m.train_cfg = dict(rpn=dict(sampler=every), rcnn=dict(sampler=every))
    # 100 proposals an image: the mask tower runs on every roi here
    m.test_cfg.rpn = dict(nms_pre=200, max_per_img=100)
    cfg.lr_config = dict(step=[8, 11], warmup_iters=1, warmup_ratio=1.0)
    return cfg


def _mask_step_batch():
    """Two 64x64 images with gt masks inside their boxes, holes drawn."""
    batch = detection_batch_np(2, 64, 64, num_classes=80, seed=3)
    rs = np.random.RandomState(4)
    masks = np.zeros(batch['gt_bboxes'].shape[:2] + (16, 16), np.uint8)
    for i, j in zip(*np.nonzero(batch['gt_valid'])):
        x1, y1, x2, y2 = (batch['gt_bboxes'][i, j] / 4).astype(int)
        masks[i, j, y1:y2 + 1, x1:x2 + 1] = rs.rand(
            y2 + 1 - y1, x2 + 1 - x1) > 0.3
    batch['gt_masks'] = masks
    return batch


def _train_cfg(tmp):
    """configs/ld/ld_r18_self_2x_3x_voc.py at width 64 on 8 synthetic
    64x96 train images (1 a rank: 4 steps an epoch) and 5 val images, 2
    epochs with an eval each; dumped for tools/test.py."""
    cfg = Config.fromfile(LD_CFG)
    teacher = Config.fromfile(TEACHER_CFG).model
    for m in (cfg.model, teacher):
        m.neck.out_channels = 64
        m.bbox_head.in_channels = 64
        m.bbox_head.feat_channels = 64
    cfg.model.teacher_config = dict(model=teacher)
    cfg.model.teacher_ckpt = None
    pipe = [dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    synth = dict(type='SyntheticDetectionDataset', hw=(64, 96),
                 num_classes=20, max_boxes=4, draw_boxes=True)
    val = dict(synth, num_images=5, seed=1,
               pipeline=[pipe[0], dict(type='Collect', keys=['img'])])
    cfg.data = dict(samples_per_gpu=1, train=dict(synth, num_images=8,
                                                  pipeline=pipe),
                    val=val, test=val)
    cfg.pad_to = (64, 96)
    cfg.runner = dict(max_epochs=2)
    cfg.optimizer = dict(cfg.optimizer, lr=0.01)
    cfg.lr_config = dict(step=[1], warmup_iters=3, warmup_ratio=0.1)
    cfg.log_config = dict(interval=1)
    cfg.checkpoint_config = dict(interval=1, max_keep_ckpts=2)
    cfg.evaluation = dict(interval=1, metric='bbox', save_best='bbox_mAP')
    # a model 8 steps old scores below the config's 0.05
    cfg.model.test_cfg.score_thr = 0.001
    cfg.dtype = 'float32'
    path = os.path.join(tmp, 'train_cfg.py')
    cfg.dump(path)
    return cfg, path


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every rank-side check in one spawn of 2 gloo ranks; returns the
    inputs and the ranks' outputs."""
    tmp = str(tmp_path_factory.mktemp('dist'))
    cases = {name: _head_case(name, seed)
             for seed, name in enumerate(sorted(LD_HEADS))}
    step_cfg = _step_cfg()
    step_batch = detection_batch_np(2, 64, 96, num_classes=80, seed=3)
    train_cfg, cfg_path = _train_cfg(tmp)
    work_dir = os.path.join(tmp, 'work')
    ckpt = os.path.join(work_dir, 'full', 'checkpoints', '8.pth')
    mask_cfg, mask_batch = _mask_step_cfg(), _mask_step_batch()
    calls = [(loader_batches_rank, AGREED_LOADER),
             (head_losses_rank, ([cases[n] for n in sorted(cases)], )),
             (ld_step_rank, (step_cfg, step_batch)),
             (train_eval_rank, (cfg_path, work_dir, 3)),
             (step_rank, (mask_cfg, mask_batch))]
    out = spawn(rank_calls, WORLD, 'gloo', os.path.join(tmp, 'spawn'),
                args=(calls, ))
    return dict(cases=cases, step_cfg=step_cfg, step_batch=step_batch,
                train_cfg=train_cfg, work_dir=work_dir, ckpt=ckpt,
                mask_cfg=mask_cfg, mask_batch=mask_batch,
                loader=[o[0] for o in out], heads=[o[1] for o in out],
                step=[o[2] for o in out], train=[o[3] for o in out],
                mask_step=[o[4] for o in out])


# ---- parallel.dist -----------------------------------------------------------
def test_dist_is_the_identity_at_world_one():
    t = torch.tensor([1.5, -2.0])
    assert pdist.get_dist_info() == (0, 1)
    assert pdist.global_sum(t) is t
    assert torch.equal(pdist.global_mean(t), t.mean())
    assert pdist.all_gather(t) is t
    assert pdist.all_reduce_host([3.0, 1.0], 'max') == [3.0, 1.0]
    metrics = dict(loss=torch.tensor(2.0))
    assert pdist.all_reduce_mean(metrics) is metrics
    assert pdist.broadcast_object({'a': 1}) == {'a': 1}
    assert pdist.all_gather_object(5) == [5]
    pdist.barrier()


def test_backend_rules(monkeypatch):
    resolve = pdist.resolve_backend
    assert resolve('xla', 'cuda', 2, 2) == 'nccl'
    assert resolve(None, 'cpu', 4, 0) == 'gloo'
    assert resolve('xla', 'cpu', 2, 0) == 'gloo'
    assert resolve('gloo', 'cuda', 2, 1) == 'gloo'
    # NCCL refuses two ranks on one card: raise with the fix, never switch
    for backend in ('nccl', 'xla'):
        with pytest.raises(RuntimeError, match='dist_params.backend=gloo'):
            resolve(backend, 'cuda', 2, 1)
    with pytest.raises(ValueError, match='nccl'):
        resolve('nccl', 'cpu', 1, 0)
    with pytest.raises(ValueError):
        resolve('mpi', 'cpu', 1, 0)
    with pytest.raises(ValueError, match='launcher'):
        pdist.init_dist('slurm')
    monkeypatch.delenv('RANK', raising=False)
    with pytest.raises(RuntimeError, match='torch.distributed.run'):
        pdist.init_dist('pytorch', device='cpu')


# ---- the loader's rank slices ------------------------------------------------
def _synth(n, hw=(48, 64), varied=False, seed=0):
    """A synthetic set; `varied` gives each image its own size (cropped)."""
    pipe = [dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    ds = build_dataset(dict(type='SyntheticDetectionDataset', num_images=n,
                            hw=hw, num_classes=5, max_boxes=3,
                            pipeline=pipe, seed=seed))
    if varied:
        # landscape, height / width from 1/4 to 1: resized to 24..64 x 96
        rs = np.random.RandomState(seed)
        for i in range(n):
            h, w = rs.randint(16, 49), rs.randint(48, 65)
            ds._images[i] = ds._images[i][:h, :w]
            ds.img_infos[i].update(height=h, width=w)
            ann = ds.annotations[i]
            ann['bboxes'] = np.minimum(ann['bboxes'], [w - 1, h - 1] * 2)
    return ds


LOADER_CASES = {
    # fixed scale, varied sizes: the buckets follow the images
    'fixed': dict(varied=True, pad=[(32, 96), (48, 96), (64, 96)]),
    'image_range': dict(scale_sampling='image_range'),
    'image_range_grouped': dict(scale_sampling='image_range_grouped'),
    'batch': dict(scale_sampling='batch'),
}


@pytest.mark.parametrize('world', [1, 2, 3])
@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_rank_slices_concatenate_to_the_global_batches(case, world):
    kw = dict(LOADER_CASES[case])
    ds = _synth(40, varied=kw.pop('varied', False))
    pad = kw.pop('pad', [(32, 64), (48, 64), (64, 96), (96, 128)])
    if 'scale_sampling' in kw:
        kw['batch_scales'] = [(64, 32), (96, 48), (96, 64), (128, 96)]
    b = 2
    one = build_dataloader(ds, b * world, 1, pad, 8, seed=4,
                           num_workers=0, **kw)
    parts = [build_dataloader(ds, b, world, pad, 8, seed=4, rank=r,
                              num_workers=0, **kw) for r in range(world)]
    shapes = set()
    for epoch in range(2):
        for loader in (one, *parts):
            loader.set_epoch(epoch)
        want = list(one)
        got = [list(p) for p in parts]
        assert all(len(g) == len(want) == len(one) == len(p)
                   for g, p in zip(got, parts))
        for n, w in enumerate(want):
            for key in ('img_ids', 'img_idx', 'gt_bboxes', 'img_hw'):
                np.testing.assert_array_equal(
                    np.concatenate([g[n][key] for g in got]), w[key])
            for g in got:
                assert g[n]['image'].shape[-2:] == w['image'].shape[-2:]
            np.testing.assert_array_equal(
                np.concatenate([g[n]['image'] for g in got]), w['image'])
            shapes.add(w['image'].shape[-2:])
    assert len(shapes) > 1      # the case exercises several buckets


# a resize that does not keep the ratio: no pad bucket can be predicted
# from the image sizes, and the ranks agree on each global batch's over the
# process group (then re-pad)
AGREED_LOADER = (
    dict(type='SyntheticDetectionDataset', num_images=20, hw=(48, 64),
         num_classes=5, max_boxes=3,
         pipeline=[dict(type='Resize', img_scale=(96, 64), keep_ratio=False),
                   dict(type='Normalize', **NORM),
                   dict(type='Pad', size_divisor=32),
                   dict(type='Collect',
                        keys=['img', 'gt_bboxes', 'gt_labels'])]),
    2, [(32, 64), (64, 96), (64, 128), (96, 128)],
    dict(seed=4, batch_scales=[(64, 32), (128, 96)],
         scale_sampling='image_range'))


def test_rank_slices_agree_on_the_pad_bucket_over_the_group(ranks):
    ds_cfg, b, pad, kw = AGREED_LOADER
    one = build_dataloader(build_dataset(ds_cfg), b * WORLD, 1, pad, 8,
                           num_workers=0, **kw)
    with pytest.raises(ValueError, match='not up'):
        build_dataloader(build_dataset(ds_cfg), b, WORLD, pad, 8, **kw)
    shapes = set()
    for epoch, got in enumerate(zip(*ranks['loader'])):
        one.set_epoch(epoch)
        want = list(one)
        assert all(len(g) == len(want) for g in got)
        for n, w in enumerate(want):
            np.testing.assert_array_equal(
                np.concatenate([g[n][0] for g in got]), w['img_ids'])
            np.testing.assert_array_equal(
                np.concatenate([g[n][1] for g in got]), w['image'])
            shapes.add(w['image'].shape[-2:])
    assert len(shapes) > 1


def test_bad_rank_is_refused():
    ds = _synth(4)
    with pytest.raises(ValueError, match='rank'):
        build_dataloader(ds, 2, 2, (64, 96), rank=2)


# ---- heads -------------------------------------------------------------------
@pytest.mark.parametrize('name', sorted(LD_HEADS))
def test_rank_mean_of_head_losses_equals_jax(ranks, name):
    i = sorted(LD_HEADS).index(name)
    got = [r[i] for r in ranks['heads']]
    mean = {k: np.mean([g[k] for g in got]) for k in got[0]}
    want = _jax_head_loss(name, ranks['cases'][name])
    assert_losses_close(mean, want)
    if name == 'LDHead':
        assert mean['loss_im'] > 0


# ---- the step ----------------------------------------------------------------
def test_two_ranks_step_equals_one_process_step(ranks):
    ref = ld_step_rank(0, 1, 'cpu', ranks['step_cfg'], ranks['step_batch'])
    got = ranks['step']
    for r in got:
        assert sorted(r['metrics']) == sorted(ref['metrics'])
        for k, v in ref['metrics'].items():
            assert r['metrics'][k] == pytest.approx(v, rel=1e-5, abs=1e-8), k
    assert ref['metrics']['loss_im'] > 0
    # each rank holds its rows of the one-process GI masks
    assert len(ref['masks']) == 5
    for lvl, m in enumerate(ref['masks']):
        np.testing.assert_array_equal(
            np.concatenate([r['masks'][lvl] for r in got]), m)
    # the clip binds (max_norm 600): the synced, clipped gradients and the
    # parameters after SGD are the one-process ones
    norm = np.sqrt(sum(float((g.astype(np.float64)**2).sum())
                       for g in ref['grads'].values()))
    assert norm == pytest.approx(600.0, rel=1e-4)
    # a batch of 1 and of 2 take other conv reductions: the gradients
    # within 1e-5 of their largest value (float32 reassociation)
    assert sorted(got[0]['grads']) == sorted(ref['grads'])
    gmax = max(np.abs(g).max() for g in ref['grads'].values())
    for k in ref['grads']:
        np.testing.assert_allclose(got[0]['grads'][k], ref['grads'][k],
                                   rtol=0, atol=1e-5 * gmax, err_msg=k)
    for k in ref['params']:
        np.testing.assert_allclose(got[0]['params'][k], ref['params'][k],
                                   rtol=0, atol=1e-6, err_msg=k)


def test_two_ranks_mask_rcnn_step_equals_one_process_step(ranks):
    ref = step_rank(0, 1, 'cpu', ranks['mask_cfg'], ranks['mask_batch'])
    assert ref['metrics']['loss_mask'] > 0
    for r in ranks['mask_step']:
        assert sorted(r['metrics']) == sorted(ref['metrics'])
        for k, v in ref['metrics'].items():
            assert r['metrics'][k] == pytest.approx(v, rel=1e-5, abs=1e-8), k
    got = ranks['mask_step'][0]['params']
    assert sorted(got) == sorted(ref['params'])
    moved = 0
    for k, v in ref['params'].items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
        moved += k.startswith('roi_head.mask_head.')
    assert moved == 12


# ---- train_detector and eval_detector ----------------------------------------
def test_train_detector_over_two_ranks(ranks):
    cfg, work_dir = ranks['train_cfg'], ranks['work_dir']
    full = [r['steps']['full'] for r in ranks['train']]
    cut = [r['steps']['cut'] for r in ranks['train']]
    assert [len(f) for f in full] == [8, 8]
    # each step's global batch: two images, none on both ranks
    for a, b in zip(*full):
        assert len(a[0]) == len(b[0]) == 1 and a[0] != b[0]
        assert a[1] == b[1]
    # a SIGTERM to rank 0 after its 3rd step stopped both ranks there, and
    # the resumed run repeats the img_ids and LR of the run through
    for r in ranks['train']:
        assert r['preempted'] and r['cut_step'] == 3
    assert cut == full
    # rank 0 alone wrote: one run header and one line a step and epoch
    with open(os.path.join(work_dir, 'full', 'log.json')) as f:
        lines = [json.loads(line) for line in f]
    assert [ln['iter'] for ln in lines if ln['mode'] == 'train'] == \
        list(range(1, 9))
    assert [ln['epoch'] for ln in lines if ln['mode'] == 'val'] == [1, 2]
    with open(os.path.join(work_dir, 'full', 'train.log')) as f:
        assert f.read().count('start training') == 1
    assert os.path.exists(os.path.join(work_dir, 'full', 'config_dump.py'))
    assert sorted(os.listdir(os.path.join(work_dir, 'full',
                                          'checkpoints'))) == ['4.pth',
                                                               '8.pth']
    # the checkpoint loads into a one-process model and into JAX's tree
    model = build_detector(cfg.model)
    load_checkpoint(model, ranks['ckpt'])
    sd = torch.load(ranks['ckpt'], weights_only=False)['state_dict']
    conv = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    assert conv.pop('_unmapped') == []


def test_eval_over_two_ranks_equals_one_process(ranks):
    cfg = ranks['train_cfg']
    model = build_detector(cfg.model)
    load_checkpoint(model, ranks['ckpt'])
    val = build_dataset(cfg.data['val'])
    want = eval_detector(model, val, samples_per_gpu=4, pad_hw=cfg.pad_to)
    assert sum(len(w['labels']) for w in want) > 0
    for r in ranks['train']:
        for results in (r['eval'], r['tool']):
            assert len(results) == len(val) == 5
            for g, w in zip(results, want):
                np.testing.assert_array_equal(g['labels'], w['labels'])
                np.testing.assert_allclose(g['boxes'], w['boxes'], rtol=0,
                                           atol=1e-4)


def test_aug_test_refuses_ranks(tmp_path, monkeypatch):
    """--aug-test runs in one process, as the JAX aug_test."""
    from ld_tpu_torch.tools import test as test_tool
    monkeypatch.setattr(test_tool, 'init_dist', lambda *a, **k: 'cpu')
    monkeypatch.setattr(test_tool, 'get_dist_info', lambda: (0, 2))
    monkeypatch.setattr(test_tool.dist, 'destroy_process_group',
                        lambda: None)
    with pytest.raises(NotImplementedError, match='aug-test'):
        test_tool.main([os.path.join(ROOT, 'configs/gfl/'
                                     'gfl_r18_fpn_1x_coco.py'),
                        '--aug-test', '--launcher', 'pytorch'])


def test_trained_bn_is_refused_over_ranks(monkeypatch):
    """Under pjit a training BN takes global-batch statistics; the port's
    ranks would not: such a model raises at R > 1."""
    from ld_tpu_torch.apis import train as train_api
    cfg = Config.fromfile(os.path.join(ROOT,
                                       'configs/gfl/gfl_r18_fpn_1x_coco.py'))
    cfg.model.backbone.norm_eval = False
    with torch.device('meta'):
        model = build_detector(cfg.model)
    train_api._check_frozen_bn(model, 1)
    with pytest.raises(NotImplementedError, match='BatchNorm'):
        train_api._check_frozen_bn(model, 2)
    cfg.model.backbone.norm_eval = True
    with torch.device('meta'):
        train_api._check_frozen_bn(build_detector(cfg.model), 2)
