"""The port's Mask R-CNN path (mask evaluation, masks through the data layer,
the FCN mask head and its targets, the RoI head's mask branch, MaskRCNN,
mask AP through eval_detector and tools/test.py) against the JAX package.

On numpy-seeded inputs, in float32 on the CPU unless named:
  * `poly_to_mask` and `decode_segmentation` bit-identical; `rle_encode`
    byte-identical, `rle_decode` its inverse;
  * `SegmEvaluator.evaluate` on a polygon-and-crowd set with random
    roi-space detections: every key within 1e-12;
  * `LoadAnnotations(with_mask=True)` -> `RandomFlip` -> `FusedPreprocess`
    -> `collate_batch`'s gt_masks bit-identical (the port's uint8, JAX's
    float32), and the synthetic dataset's;
  * `mask_targets` within 1e-6; the `FCNMaskHead` net (width 64, R18-sized
    rois) within the head bounds (5e-3 max abs, 2e-4 median relative) in
    float32 and 0.15 in bfloat16 (JAX op by op);
  * Mask R-CNN at R18, 64x96, 4 classes, its RPN and RoI nets filled from
    a numpy seed and carried JAX -> port by `state_dict_from_jax`:
    `loss_mask` on the port's sampled rois at rtol 1e-5 against the JAX
    head on the same rois (with the config's sampler the port runs the
    first 128 rois of an image, JAX all 512); `forward_test`'s dets and
    masks within the head bounds; `eval_detector` ->
    `evaluate(['bbox', 'segm'])` within 1e-9 of the JAX `forward_test`
    image by image -> the JAX evaluators (ROADMAP.md caveat 21: the JAX
    `eval_detector` cannot run a mask model); `tools/test.py --eval segm`;
  * `train_detector` steps with gt_masks and an eval hook on
    ['bbox', 'segm']; the entry points that take three outputs raise;
  * every config of configs/mask_rcnn/ but the C4 one builds on the meta
    device, and `state_dict_from_jax` of mask_rcnn_r50_fpn_1x_coco.py
    gives the port's keys and shapes exactly.
"""
import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.data import coco as j_coco
from ld_tpu.data import transforms as j_tf
from ld_tpu.evaluation import coco_mask as j_coco_mask
from ld_tpu.evaluation import segm_eval as j_segm
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.models.heads.mask_head import FCNMaskHeadNet
from ld_tpu.models.heads.mask_head import mask_targets as j_mask_targets
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu_torch import Config
from ld_tpu_torch.apis import (eval_detector, inference_detector,
                               train_detector)
from ld_tpu_torch.apis.aug_test import aug_test
from ld_tpu_torch.data import build_dataloader, build_dataset
from ld_tpu_torch.data import coco
from ld_tpu_torch.data import transforms as tf
from ld_tpu_torch.evaluation import coco_mask, segm_eval
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.models.heads.mask_head import FCNMaskHead, mask_targets
from ld_tpu_torch.testing import write_coco_instances
from ld_tpu_torch.tools.deployment.export import export_detector
from ld_tpu_torch.utils.checkpoint import load_from_jax, state_dict_from_jax
from test_torch_port_bridge import batches, fill_tree
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
CLASSES = ('person', 'bicycle', 'car', 'motorcycle')
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
ALL = dict(num=10**6, pos_fraction=1.0)
TEST_CFG = dict(rpn=dict(nms_pre=200, max_per_img=150,
                         nms=dict(iou_threshold=0.7)),
                rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                          max_per_img=100))
# the head bounds of the port's CPU tests
MAX_ABS, MEDIAN_REL = 5e-3, 2e-4


def mask_cfg(rcnn_sampler=ALL):
    """Mask R-CNN at R18, FPN / RPN / RoI width 64, 4 classes; the RPN's
    sampler picks every candidate, the RoI head's `rcnn_sampler` (None: the
    config's 512 rois, a quarter positive)."""
    rcnn = dict(sampler=rcnn_sampler) if rcnn_sampler else {}
    return dict(
        type='MaskRCNN',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      norm_eval=True, style='pytorch'),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=64, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=64, feat_channels=64),
        roi_head=dict(type='StandardRoIHead',
                      bbox_head=dict(num_classes=4, in_channels=64,
                                     fc_out_channels=64),
                      mask_head=dict(num_convs=4, in_channels=64,
                                     conv_out_channels=64),
                      bbox_roi_extractor=dict(featmap_strides=[4, 8, 16,
                                                               32])),
        train_cfg=dict(rpn=dict(sampler=ALL), rcnn=rcnn),
        test_cfg=copy.deepcopy(TEST_CFG))


def assert_head_close(got, want):
    """The port's head bounds: max abs 5e-3, median relative 2e-4."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= MAX_ABS, diff.max()
    assert np.median(diff / np.maximum(np.abs(want), 1e-6)) <= MEDIAN_REL


def assert_metrics_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= tol, (k, g, w)


# ---- masks and RLE ----------------------------------------------------------
def _polygons(rs, n, h, w):
    """Random polygons: star shapes, some across the border, some tiny, one
    degenerate (a line)."""
    out = []
    for i in range(n):
        k = rs.randint(3, 12)
        cx, cy = rs.uniform(-5, w + 5), rs.uniform(-5, h + 5)
        r = rs.uniform(0.3, 0.6 * min(h, w)) * rs.uniform(0.2, 1.0, k)
        ang = np.sort(rs.uniform(0, 2 * np.pi, k))
        out.append(np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                            -1).reshape(-1).tolist())
    out.append([3.0, 3.0, 20.0, 20.0, 3.0, 3.0])
    out.append([1.0, 1.0, 3.0, 1.0, 3.0, 3.0, 1.0, 3.0])  # 2x2 pixels
    return out


def test_poly_to_mask_and_decode_are_bit_identical():
    rs = np.random.RandomState(0)
    h, w = 37, 53
    polys = _polygons(rs, 40, h, w)
    sq = coco_mask.poly_to_mask([polys[-1]], h, w)
    assert sq.sum() == 4 and sq[1:3, 1:3].all()
    for i in range(0, len(polys), 3):
        got = coco_mask.poly_to_mask(polys[i:i + 3], h, w)
        want = j_coco_mask.poly_to_mask(polys[i:i + 3], h, w)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)
    m = rs.rand(h, w) > 0.6
    rle = j_segm.rle_encode(m)
    counts = np.diff(np.concatenate([[0], np.flatnonzero(np.diff(
        m.flatten('F').astype(np.int8))) + 1, [h * w]])).tolist()
    if m[0, 0]:
        counts = [0] + counts
    for seg in (None, polys[:2], dict(size=[h, w], counts=counts),
                rle, dict(rle, counts=rle['counts'].decode())):
        got = coco_mask.decode_segmentation(seg, h, w)
        np.testing.assert_array_equal(
            got, j_coco_mask.decode_segmentation(seg, h, w))
    np.testing.assert_array_equal(
        coco_mask.decode_segmentation(rle, h, w), m)


def test_rle_encode_is_byte_identical_and_decodes_back():
    rs = np.random.RandomState(1)
    masks = [rs.rand(31, 47) > t for t in (0.0, 0.3, 0.9, 1.0)]
    masks += [np.ones((5, 4), bool), np.zeros((0, 3), bool)]
    for m in masks:
        got = segm_eval.rle_encode(m)
        want = j_segm.rle_encode(m)
        assert got['size'] == want['size']
        assert isinstance(got['counts'], bytes)
        assert got['counts'] == want['counts']
        np.testing.assert_array_equal(segm_eval.rle_decode(got), m)
    cls_masks = [[masks[0], masks[1]], [], [masks[2]]]
    assert segm_eval.encode_mask_results(cls_masks) == \
        j_segm.encode_mask_results(cls_masks)


def _coco_set(root, n=6, sizes=((60, 80), (64, 96), (48, 72))):
    """write_coco_instances at 4 classes, plus one non-crowd RLE object
    (a gt without a polygon: the box in training, an empty mask in
    evaluation) in the first image."""
    ann_file, prefix = write_coco_instances(root, n, sizes=sizes,
                                            num_classes=4, seed=2)
    with open(ann_file) as f:
        data = json.load(f)
    h, w = sizes[0]
    region = np.zeros((h, w), np.uint8)
    region[5:25, 10:40] = 1
    rle = segm_eval.rle_encode(region)
    data['annotations'].append(dict(
        id=len(data['annotations']) + 1, image_id=1, category_id=2,
        bbox=[10.0, 5.0, 30.0, 20.0], area=600.0, iscrowd=0,
        segmentation=dict(rle, counts=rle['counts'].decode())))
    with open(ann_file, 'w') as f:
        json.dump(data, f)
    return ann_file, prefix


def _random_results(ds, seed):
    """Per image: the gts' boxes jittered and random boxes, random labels
    and scores, random smooth roi-space masks (28 x 28)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        h, w = ds.img_infos[i]['height'], ds.img_infos[i]['width']
        boxes = [b + rs.uniform(-3, 3, 4) for b in ann['bboxes']]
        for _ in range(rs.randint(2, 6)):
            x1, y1 = rs.uniform(0, w - 8), rs.uniform(0, h - 8)
            boxes.append([x1, y1, x1 + rs.uniform(6, w / 2),
                          y1 + rs.uniform(6, h / 2)])
        boxes = np.asarray(boxes, np.float32)
        n = len(boxes)
        labels = np.concatenate([ann['labels'], rs.randint(
            0, 4, n - len(ann['labels']))])
        labels[rs.rand(n) < 0.2] = rs.randint(0, 4)
        yy, xx = np.mgrid[:28, :28] / 27.0
        masks = np.stack([1 / (1 + np.exp(-(3 - 9 * ((xx - rs.uniform(
            0.3, 0.7))**2 + (yy - rs.uniform(0.3, 0.7))**2) * rs.uniform(
                2, 8)))) for _ in range(n)]).astype(np.float32)
        out.append(dict(boxes=np.concatenate(
            [boxes, rs.rand(n, 1).astype(np.float32)], 1),
            labels=labels, masks=masks))
    return out


def test_segm_evaluator_matches_jax(tmp_path):
    ann_file, prefix = _coco_set(str(tmp_path))
    ds = coco.CocoDataset(ann_file, [], img_prefix=prefix, classes=CLASSES,
                          test_mode=True)
    j_ds = j_coco.CocoDataset(ann_file, [], img_prefix=prefix,
                              classes=CLASSES, test_mode=True)
    assert sum(len(a['masks_ignore']) for a in ds.annotations) >= 2
    results = _random_results(ds, 3)
    got = ds.evaluate(results, metric=['bbox', 'segm'])
    want = j_ds.evaluate(results, metric=['bbox', 'segm'])
    assert got['segm_mAP'] > 0
    assert_metrics_close(got, want, 1e-12)
    # full-size bitmaps and RLEs take the decode path
    full = [dict(r, masks=[segm_eval.rle_encode(segm_eval.paste_mask(
        m, b, info['height'], info['width']))
        for m, b in zip(r['masks'], r['boxes'])])
        for r, info in zip(results, ds.img_infos)]
    assert_metrics_close(segm_eval.SegmEvaluator(ds).evaluate(full),
                         j_segm.SegmEvaluator(j_ds).evaluate(full), 1e-12)
    with pytest.raises(NotImplementedError, match='proposal'):
        ds.evaluate(results, metric='proposal')


# ---- masks through the data layer -------------------------------------------
def test_mask_pipeline_matches_jax(tmp_path):
    ann_file, prefix = _coco_set(str(tmp_path))
    pipe = [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', with_bbox=True, with_mask=True),
            dict(type='RandomFlip', flip_ratio=0.5),
            dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels',
                                       'gt_masks'])]
    ds = coco.CocoDataset(ann_file, pipe, img_prefix=prefix,
                          classes=CLASSES)
    j_ds = j_coco.CocoDataset(ann_file, pipe, img_prefix=prefix,
                              classes=CLASSES)
    got_s, want_s = [], []
    for i in range(len(ds)):
        for pkg, out in ((ds, got_s), (j_ds, want_s)):
            np.random.seed(10 + i)
            out.append(pkg[i])
    for g, w in zip(got_s, want_s):
        assert len(g['gt_masks']) == len(w['gt_masks'])
        for a, b in zip(g['gt_masks'], w['gt_masks']):
            np.testing.assert_array_equal(a, b)
    got = tf.collate_batch(got_s, [(64, 96), (96, 64)], max_gts=8)
    want = j_tf.collate_batch(want_s, [(64, 96), (96, 64)], max_gts=8)
    assert got['gt_masks'].dtype == np.uint8
    assert got['gt_masks'].shape == want['gt_masks'].shape == (
        len(ds), 8) + tuple(s // 4 for s in got['image'].shape[-2:])
    assert got['gt_masks'].sum() > 0
    np.testing.assert_array_equal(got['gt_masks'], want['gt_masks'])
    # FilterAnnotations drops masks with their boxes
    flt = tf.FilterAnnotations((12, 12))(dict(got_s[0]))
    j_flt = j_tf.FilterAnnotations((12, 12))(dict(want_s[0]))
    assert len(flt['gt_masks']) == len(j_flt['gt_masks'])
    # the loader's batches carry them; a pipeline without masks gets none
    loader = build_dataloader(ds, 2, 1, [(64, 96), (96, 64)], 8,
                              shuffle=False, num_workers=0)
    assert loader.with_masks
    for batch in loader:
        assert batch['gt_masks'].shape[1:] == (8, ) + tuple(
            s // 4 for s in batch['image'].shape[-2:])
    plain = build_dataloader(coco.CocoDataset(
        ann_file, pipe[:-1] + [dict(type='Collect', keys=['img'])],
        img_prefix=prefix, classes=CLASSES), 2, 1, [(64, 96), (96, 64)],
        num_workers=0, shuffle=False)
    assert not plain.with_masks and 'gt_masks' not in next(iter(plain))


def test_synthetic_dataset_masks_match_jax():
    pipe = [dict(type='RandomFlip', flip_ratio=0.5),
            dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels',
                                       'gt_masks'])]
    kw = dict(num_images=4, hw=(48, 64), num_classes=5, max_boxes=4,
              seed=6, pipeline=pipe)
    ds = coco.SyntheticDetectionDataset(**kw)
    j_ds = j_coco.SyntheticDetectionDataset(**kw)
    got_s, want_s = [], []
    for i in range(4):
        np.random.seed(i)
        got_s.append(ds[i])
        np.random.seed(i)
        want_s.append(j_ds[i])
        np.testing.assert_array_equal(np.stack(got_s[i]['gt_masks']),
                                      np.stack(want_s[i]['gt_masks']))
    got = tf.collate_batch(got_s, (64, 96), max_gts=6)
    want = j_tf.collate_batch(want_s, (64, 96), max_gts=6)
    np.testing.assert_array_equal(got['gt_masks'], want['gt_masks'])


# ---- the mask head ----------------------------------------------------------
def test_mask_targets_match_jax():
    rs = np.random.RandomState(4)
    gt = (rs.rand(2, 5, 16, 24) > 0.5).astype(np.uint8)
    xy = rs.uniform(-10, 90, (2, 30, 2))
    rois = np.concatenate([xy, xy + rs.uniform(1, 60, (2, 30, 2))],
                          -1).astype(np.float32)
    inds = rs.randint(0, 5, (2, 30))
    got = mask_targets(torch.from_numpy(gt), torch.from_numpy(rois),
                       torch.from_numpy(inds), 28, 4)
    # op by op: XLA's fused program rounds the sample coordinates
    # otherwise (2e-6 from the op-by-op values, which the port meets to 6e-8)
    with jax.disable_jit():
        want = jax.vmap(lambda m, r, i: j_mask_targets(m, r, i, 28, 4))(
            jnp.asarray(gt, jnp.float32), jnp.asarray(rois),
            jnp.asarray(inds))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().reshape(2, 30, 28, 28),
                               np.asarray(want), rtol=0, atol=1e-6)


def _mask_net_pair(dtype):
    """The JAX FCNMaskHeadNet (4 classes, width 64) filled from a seed and
    the port head with its weights."""
    net = FCNMaskHeadNet(num_classes=4, conv_out=64, dtype=dtype)
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 14, 14, 64))))['params']
    params = fill_tree(shapes, 7)
    sd = state_dict_from_jax(dict(params=dict(roi_head=dict(mask=params))))
    head = FCNMaskHead(num_classes=4, in_channels=64, conv_out_channels=64,
                       dtype=None if dtype == jnp.float32 else 'bfloat16')
    head.load_state_dict({k[len('roi_head.mask_head.'):]: v
                          for k, v in sd.items()}, strict=True)
    return net, params, head


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fcn_mask_head_net_matches_jax(dtype):
    net, params, head = _mask_net_pair(jnp.dtype(dtype))
    x = np.random.RandomState(5).randn(12, 14, 14, 64).astype(np.float32)
    apply = lambda v, a: net.apply(v, a)  # noqa: E731
    if dtype == 'float32':
        apply = jax.jit(apply)
    want = np.asarray(apply(dict(params=params), jnp.asarray(x)))
    with torch.no_grad():
        got = head(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.dtype == torch.float32 and got.shape == (12, 4, 28, 28)
    got = got.numpy().transpose(0, 2, 3, 1)
    if dtype == 'float32':
        assert_head_close(got, want)
    else:
        assert np.abs(got - want).max() <= 0.15


# ---- Mask R-CNN -------------------------------------------------------------
def jax_variables(det, seed):
    """The JAX detector's variables: backbone and FPN of a port R18 from
    `seed` through the JAX converter; the RPN, RoI and mask nets drawn
    from a numpy seed in the shapes of their JAX inits."""
    port = build_detector(mask_cfg())
    port.init_weights(torch.Generator().manual_seed(seed))
    conv = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()
         if k.startswith(('backbone.', 'neck.'))}, num_laterals=4)
    assert conv.pop('_unmapped') == []
    feats = [jnp.zeros((1, h, w, 64)) for h, w in
             ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
    params = dict(conv['params'])
    params['rpn_net'] = fill_tree(jax.eval_shape(
        lambda: det.rpn_head.net.init(jax.random.PRNGKey(0), feats))[
            'params'], seed + 10)
    roi = jax.eval_shape(lambda: det.roi_head.init_all_variables(
        jax.random.PRNGKey(0), 64))
    params['roi_head'] = fill_tree(roi, seed + 20)
    return dict(conv, params=params)


def gt_masks_np(batch_np, seed):
    """(B, G, H/4, W/4) float32 masks inside each valid gt's box, with
    random holes, so that a crop is not its box."""
    b, g = batch_np['gt_bboxes'].shape[:2]
    h, w = (s // 4 for s in batch_np['image'].shape[-2:])
    rs = np.random.RandomState(seed)
    out = np.zeros((b, g, h, w), np.float32)
    for i in range(b):
        for j in range(g):
            if not batch_np['gt_valid'][i, j]:
                continue
            x1, y1, x2, y2 = (batch_np['gt_bboxes'][i, j] / 4).astype(int)
            out[i, j, y1:y2 + 1, x1:x2 + 1] = rs.rand(
                *out[i, j, y1:y2 + 1, x1:x2 + 1].shape) > 0.3
    return out


@pytest.fixture(scope='module')
def mask():
    """Mask R-CNN in both packages on the same weights; the test batch with
    gt masks; the JAX features and proposals; the JAX `forward_test`
    (rescale, compiled once for batches of 2 at 64x96)."""
    det = j_build_detector(mask_cfg())
    variables = jax_variables(det, 0)
    model = load_from_jax(build_detector(mask_cfg()), variables).eval()
    j_batch, t_batch = batches()
    masks = gt_masks_np({k: v.numpy() for k, v in t_batch.items()}, 9)
    j_batch['gt_masks'] = jnp.asarray(masks)
    t_batch['gt_masks'] = torch.from_numpy(masks.astype(np.uint8))
    t_batch['gt_labels'] = t_batch['gt_labels'].long()
    j_batch['gt_labels'] = j_batch['gt_labels'].astype(jnp.int32)
    feats, rpn_outs, roi_vars = jax.jit(
        lambda v, x: det.extract(v, x))(variables, j_batch['image'])
    props, valid = jax.jit(lambda o, hw: det.rpn_head.get_proposals(o, hw))(
        rpn_outs, j_batch['img_hw'])
    forward_test = jax.jit(lambda v, b: det.forward_test(v, b, rescale=True))
    sf = jnp.ones((2, 4), jnp.float32)
    outs = forward_test(variables, dict(image=j_batch['image'],
                                        img_hw=j_batch['img_hw'],
                                        scale_factor=sf))
    return dict(det=det, variables=variables, model=model, j_batch=j_batch,
                t_batch=t_batch, feats=feats, roi_vars=roi_vars,
                props=props, valid=valid, forward_test=forward_test,
                outs=outs)


def _jax_mask_loss(f, s):
    """The JAX mask branch's loss (`roi_head.py:588-602`) on the port's
    sampled rois `s`: the tower on every roi, the others weighted 0."""
    if 'mask_loss' not in f:        # compiled once for both cases
        rh = f['det'].roi_head

        def one(roi_vars, img_feats, rois, pos, labels, inds, gm):
            mf = rh._extract_rois(roi_vars, img_feats, rois, pos, mask=True)
            return rh.mask_head.loss(rh._mask_vars(roi_vars), mf, rois, pos,
                                     labels, inds, gm)
        f['mask_loss'] = jax.jit(jax.vmap(one, in_axes=(None, ) + (0, ) * 6))
    per_img = f['mask_loss'](
        f['roi_vars'], list(f['feats'][:4]), *(jnp.asarray(s[k].numpy())
                                               for k in ('rois', 'roi_pos',
                                                         'labels',
                                                         'gt_inds')),
        f['j_batch']['gt_masks'])
    return float(per_img.mean())


@pytest.mark.parametrize('sampler', ['all_rois', 'positive_slice'])
def test_loss_mask_matches_jax_on_the_same_rois(mask, sampler):
    f = mask
    model = build_detector(mask_cfg(ALL if sampler == 'all_rois' else None))
    model.load_state_dict(f['model'].state_dict())
    roi_head = model.roi_head
    t = f['t_batch']
    feats = [torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())
             for a in f['feats']]
    s = roi_head.sample_rois(
        torch.from_numpy(np.array(f['props'])),
        torch.from_numpy(np.array(f['valid'])), t['gt_bboxes'],
        t['gt_labels'], t['gt_valid'], torch.Generator().manual_seed(1))
    n_pos = s['roi_pos'].sum(-1)
    assert (n_pos > 0).all()
    cap = roi_head.sampler.max_pos
    if sampler == 'positive_slice':
        # the tower runs on 128 of each image's rois
        assert cap == 128 < s['rois'].shape[1]
        assert not s['roi_pos'][:, cap:].any()
    with torch.no_grad():
        got = roi_head.mask_loss(feats, s, t['gt_masks'])
        losses = roi_head.forward_train(feats, torch.from_numpy(
            np.array(f['props'])), torch.from_numpy(np.array(f['valid'])),
            t, torch.Generator().manual_seed(1))
    want = _jax_mask_loss(f, s)
    assert want > 0
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert float(losses['loss_mask']) == float(got)


def _sorted_dets(dets, labels, ok, masks):
    """One image's valid detections and masks in (score, label, x1) order
    (equal scores may come in either order, ROADMAP.md caveat 2)."""
    d, lab, m = dets[ok], labels[ok], masks[ok]
    key = np.lexsort((d[:, 0].round(2), lab, -d[:, 4].round(5)))
    return d[key], lab[key], m[key]


def test_mask_rcnn_forward_test_matches_jax(mask):
    f = mask
    t = f['t_batch']
    with torch.no_grad():
        got = f['model'].forward_test(dict(
            image=t['image'], img_hw=t['img_hw'],
            scale_factor=torch.ones(2, 4)), rescale=True)
    assert len(got) == 4 and got[3].shape == (2, 100, 28, 28)
    assert 0 <= float(got[3].min()) and float(got[3].max()) <= 1
    want = [np.asarray(a) for a in f['outs']]
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert want[2].sum() > 0
    for i in range(2):
        g = _sorted_dets(*(a[i].numpy() for a in got))
        w = _sorted_dets(*(a[i] for a in want))
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=5e-3)
        assert_head_close(g[2], w[2])


@pytest.fixture(scope='module')
def coco_eval_set(tmp_path_factory, mask):
    """A 6-image polygon set at 96-128 x 144-192 (resized to 64 x 96); the
    fixture's Mask R-CNN with its mask logits' bias raised by 3 (so that
    its masks cover their boxes) in both packages, and the port's
    `eval_detector` results on the set; then the set's gts rewritten as
    the rectangles of each image's first two detections at least 12 px a
    side, so that both metrics are above 0."""
    root = str(tmp_path_factory.mktemp('coco_eval'))
    ann_file, prefix = write_coco_instances(
        root, 6, sizes=((96, 144), (128, 192), (120, 180)), num_classes=4,
        seed=5)
    test_pipe = [dict(type='LoadImageFromFile'),
                 dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
                 dict(type='Collect', keys=['img'])]
    ds_cfg = dict(type='CocoDataset', ann_file=ann_file, img_prefix=prefix,
                  classes=list(CLASSES), test_mode=True, pipeline=test_pipe)
    ds = build_dataset(ds_cfg)
    model = copy.deepcopy(mask['model'])
    with torch.no_grad():
        model.roi_head.mask_head.conv_logits.bias += 3.0
    variables = copy.deepcopy(mask['variables'])
    logits = variables['params']['roi_head']['mask']['conv_logits']
    logits['bias'] = logits['bias'] + 3.0
    results = eval_detector(model, ds, samples_per_gpu=2, pad_hw=HW)
    with open(ann_file) as fh:
        data = json.load(fh)
    anns = []
    for i, r in enumerate(results):
        b = r['boxes']
        big = np.flatnonzero(((b[:, 2:4] - b[:, :2]) >= 12).all(1))[:2]
        for j in big:
            x1, y1, x2, y2 = (float(v) for v in b[j, :4])
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(r['labels'][j]) + 1,
                             bbox=[x1, y1, x2 - x1, y2 - y1],
                             area=(x2 - x1) * (y2 - y1), iscrowd=0,
                             segmentation=[[x1, y1, x2, y1, x2, y2, x1,
                                            y2]]))
    assert len(anns) >= 8
    data['annotations'] = anns
    with open(ann_file, 'w') as fh:
        json.dump(data, fh)
    return dict(ds_cfg=ds_cfg, results=results, ann_file=ann_file,
                prefix=prefix, loader_ds=ds, model=model,
                variables=variables)


def test_eval_detector_segm_matches_jax(mask, coco_eval_set):
    f, e = mask, coco_eval_set
    results = e['results']
    assert all(r['masks'].shape == (len(r['boxes']), 28, 28) and
               r['masks'].dtype == np.float32 for r in results)
    assert sum(len(r['boxes']) for r in results) > 0
    ds = build_dataset(e['ds_cfg'])
    got = ds.evaluate(results, metric=['bbox', 'segm'])
    # JAX: forward_test per batch of the same loader, then its evaluators
    loader = build_dataloader(e['loader_ds'], 2, 1, HW, max_gts=1,
                              shuffle=False, num_workers=0)
    j_results = []
    for batch in loader:
        outs = f['forward_test'](e['variables'], dict(
            image=jnp.asarray(batch['image'].transpose(0, 2, 3, 1)),
            img_hw=jnp.asarray(batch['img_hw']),
            scale_factor=jnp.asarray(batch['scale_factor'])))
        dets, labels, valid, masks = (np.asarray(o) for o in outs)
        for i in range(len(batch['img_idx'])):
            m = valid[i]
            j_results.append(dict(boxes=dets[i][m], labels=labels[i][m],
                                  masks=masks[i][m]))
    j_ds = j_coco.CocoDataset(e['ann_file'], [], img_prefix=e['prefix'],
                              classes=CLASSES, test_mode=True)
    want = j_ds.evaluate(j_results, metric=['bbox', 'segm'])
    assert len(want) == 24 and want['segm_mAP'] > 0 and \
        want['bbox_mAP'] > 0
    assert_metrics_close(got, want, 1e-9)


def test_tools_test_eval_segm(mask, coco_eval_set, tmp_path):
    from ld_tpu_torch.tools import test as test_tool
    e = coco_eval_set
    cfg = Config(dict(model=mask_cfg(), dtype='float32', pad_to=HW,
                      data=dict(test=e['ds_cfg'])))
    cfg_path = str(tmp_path / 'mask_cfg.py')
    cfg.dump(cfg_path)
    ckpt = str(tmp_path / 'mask.pth')
    torch.save(dict(state_dict=e['model'].state_dict()), ckpt)
    out = test_tool.main([cfg_path, ckpt, '--eval', 'segm', '--device',
                          'cpu'])
    want = build_dataset(e['ds_cfg']).evaluate(e['results'], metric='segm')
    assert sorted(out['metrics']) == sorted(want) and len(want) == 12
    assert_metrics_close(out['metrics'], want, 0.0)


def test_train_detector_with_masks_and_segm_eval(tmp_path, coco_eval_set):
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py'))
    cfg.model = Config(dict(model=mask_cfg(None))).model
    pipe = [dict(type='RandomFlip', flip_ratio=0.5),
            dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels',
                                       'gt_masks'])]
    cfg.data = dict(samples_per_gpu=2, train=dict(
        type='SyntheticDetectionDataset', hw=(64, 96), num_classes=4,
        max_boxes=4, draw_boxes=True, num_images=4, pipeline=pipe),
        val=coco_eval_set['ds_cfg'])
    cfg.pad_to = HW
    cfg.runner = dict(max_epochs=1)
    cfg.log_config = dict(interval=1)
    cfg.evaluation = dict(interval=1, metric=['bbox', 'segm'],
                          save_best='segm_mAP')
    cfg.checkpoint_config = dict(interval=1)
    cfg.dtype = 'float32'
    ret = train_detector(cfg, str(tmp_path), device='cpu')
    assert ret['step'] == 2
    assert ret['metrics']['loss_mask'] > 0
    assert all(np.isfinite(float(v)) for v in ret['metrics'].values())
    with open(tmp_path / 'log.json') as fh:
        vals = [json.loads(line) for line in fh if '"val"' in line]
    assert vals and 'segm_mAP' in vals[-1] and 'bbox_mAP' in vals[-1]


def test_entry_points_without_masks_raise(mask):
    from ld_tpu_torch.tools.deployment.serve import make_server
    model = mask['model']
    img = np.zeros((48, 72, 3), np.uint8)
    cfg = Config(dict(model=mask_cfg(), dtype='float32'))
    for call in (lambda: inference_detector(model, img),
                 lambda: aug_test(model, [], (48, 72)),
                 lambda: export_detector(model, HW),
                 lambda: make_server(cfg, None, input_size=HW,
                                     device='cpu')):
        with pytest.raises(NotImplementedError, match='caveat 21'):
            call()


MASK_CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'configs', 'mask_rcnn', '*.py')))


@pytest.mark.parametrize('path', MASK_CONFIGS)
def test_mask_rcnn_config_builds(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with torch.device('meta'):
        model = build_detector(cfg.model, dtype=cfg.get('dtype'))
    assert type(model).__name__ == 'MaskRCNN'
    head = model.roi_head.mask_head
    c4 = 'c4' in path
    # the C4 mask head reads the shared res5's 7x7 output of 14x14 rois
    assert head.conv_logits.out_channels == 80 and \
        head.roi_size == (7 if c4 else 14)
    assert (model.roi_head.shared_head is not None) == c4
    assert model.roi_head.mask_roi_size == 14


def test_state_dict_from_jax_round_trip_of_the_r50_config():
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py'))
    det = j_build_detector(cfg.model)
    shapes = jax.eval_shape(lambda: det.init_variables(
        jax.random.PRNGKey(0), (1, 64, 64, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    with torch.device('meta'):
        model = build_detector(cfg.model)
    want = model.state_dict()
    got = state_dict_from_jax(tree, want.keys())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
