"""The port's data layer against the JAX package's, on the same seeded inputs.

  * LoadImageFromFile: identical arrays from JPEG and PNG files;
  * Resize in every scale mode: the same scale draws, boxes to 1e-6,
    images within one grey level (cv2's fixed-point rounding);
  * RandomFlip and FusedPreprocess (the same C++): identical;
  * collate_batch: identical up to the NCHW / NHWC transpose;
  * CocoDataset on a written COCO json: identical infos, annotations,
    flags and label maps;
  * GroupBatchSampler index lists and DataLoader batches over 2 epochs in
    every scale mode, on single-orientation sets: identical;
  * the two repairs of the JAX loader: a mixed-orientation set gives
    orientation-homogeneous batches and `len(loader)` batches exactly, and
    an exception in the producer reaches the consumer;
  * the thread pool's batches equal the serial ones.
"""
import json

import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.data import coco as j_coco
from ld_tpu.data import loader as j_loader
from ld_tpu.data import transforms as j_tf
from ld_tpu_torch.data import coco, loader, transforms as tf
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
COMMON_BATCH_KEYS = ('image', 'gt_bboxes', 'gt_labels', 'gt_valid', 'img_hw',
                     'scale_factor', 'img_ids')


def _sample(seed, hw=(50, 70), n=5):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, hw + (3, ), np.uint8)
    xy = rs.uniform(0, [hw[1] * 0.6, hw[0] * 0.6], (n, 2))
    wh = rs.uniform(2, [hw[1] * 0.5, hw[0] * 0.5], (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                gt_bboxes=boxes, gt_labels=rs.randint(0, 20, n),
                img_info=dict(id=seed))


def _copy(results):
    return {k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in results.items()}


@pytest.mark.parametrize('ext', ['jpg', 'png'])
@pytest.mark.parametrize('color_type', ['color', 'grayscale', 'unchanged'])
def test_load_image_from_file_matches_jax(tmp_path, ext, color_type):
    import cv2
    img = _sample(0, (37, 53))['img']
    cv2.imwrite(str(tmp_path / f'a.{ext}'), img)
    ann = dict(bboxes=np.array([[1, 2, 30, 20]], np.float64),
               labels=np.array([3]))
    results = dict(img_info=dict(filename=f'a.{ext}'), ann_info=ann,
                   img_prefix=str(tmp_path))
    want = j_tf.Compose([j_tf.LoadImageFromFile(color_type=color_type),
                         j_tf.LoadAnnotations()])(dict(results))
    got = tf.Compose([tf.LoadImageFromFile(color_type=color_type),
                      tf.LoadAnnotations()])(dict(results))
    for key in ('img', 'gt_bboxes', 'gt_labels'):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    assert got['img_shape'] == want['img_shape'] == got['ori_shape']
    # with_mask: the polygons filled by cv2.fillPoly, as in JAX
    poly = dict(results, ann_info=dict(
        ann, masks=[[[2.7, 3.1, 28.9, 4.0, 20.5, 18.8, 3.3, 15.2]]]))
    want = j_tf.Compose([j_tf.LoadImageFromFile(color_type=color_type),
                         j_tf.LoadAnnotations(with_mask=True)])(dict(poly))
    got = tf.Compose([tf.LoadImageFromFile(color_type=color_type),
                      tf.LoadAnnotations(with_mask=True)])(dict(poly))
    assert got['gt_masks'][0].sum() > 0
    np.testing.assert_array_equal(got['gt_masks'], want['gt_masks'])
    with pytest.raises(FileNotFoundError):
        tf.LoadImageFromFile()(dict(img_info=dict(filename='missing.png'),
                                    img_prefix=str(tmp_path)))


RESIZE_CASES = {
    'keep_ratio': dict(img_scale=(97, 61)),
    'keep_ratio_false': dict(img_scale=(97, 61), keep_ratio=False),
    'ratio_range': dict(img_scale=(80, 60), ratio_range=(0.5, 1.5)),
    'range': dict(img_scale=[(120, 40), (90, 70)]),
    'value': dict(img_scale=[(120, 40), (90, 70), (64, 64)],
                  multiscale_mode='value'),
    'no_clip': dict(img_scale=(97, 61), bbox_clip_border=False),
}


@pytest.mark.parametrize('case', sorted(RESIZE_CASES))
def test_resize_matches_jax(case):
    kwargs = RESIZE_CASES[case]
    got_t, want_t = tf.Resize(**kwargs), j_tf.Resize(**kwargs)
    for seed in range(4):
        s = _sample(seed)
        s['gt_bboxes'][0, 2:] = (200.0, 200.0)     # crosses the border
        np.random.seed(seed)
        want = want_t(_copy(s))
        np.random.seed(seed)
        got = got_t(_copy(s))
        assert got['img_shape'] == want['img_shape']
        np.testing.assert_array_equal(got['scale_factor'],
                                      want['scale_factor'])
        np.testing.assert_allclose(got['gt_bboxes'], want['gt_bboxes'],
                                   rtol=0, atol=1e-6)
        diff = np.abs(got['img'].astype(int) - want['img'].astype(int))
        assert diff.max() <= 1


def test_resize_scale_in_results_override_and_thread_local():
    s = _sample(1)
    for override in (False, True):
        kw = dict(img_scale=[(120, 40), (90, 70)], override=override)
        np.random.seed(3)
        want = j_tf.Resize(**kw)(dict(_copy(s), scale=(64, 48)))
        np.random.seed(3)
        got = tf.Resize(**kw)(dict(_copy(s), scale=(64, 48)))
        assert got['img_shape'] == want['img_shape']
        np.testing.assert_allclose(got['gt_bboxes'], want['gt_bboxes'],
                                   atol=1e-6)
    t = tf.Resize(img_scale=(97, 61))
    t.set_scale_override((40, 30))
    assert t(_copy(s))['img_shape'][:2] == (29, 40)
    t.set_scale_override(None)
    assert t(_copy(s))['img_shape'][:2] == (61, 85)


@pytest.mark.parametrize('direction', ['horizontal', 'vertical'])
def test_random_flip_matches_jax(direction):
    got_t = tf.RandomFlip(0.5, direction)
    want_t = j_tf.RandomFlip(0.5, direction)
    flips = []
    np.random.seed(11)
    wants = [want_t(_copy(_sample(i))) for i in range(8)]
    np.random.seed(11)
    gots = [got_t(_copy(_sample(i))) for i in range(8)]
    for got, want in zip(gots, wants):
        assert got['flip'] == want['flip']
        flips.append(got['flip'])
        for key in ('img', 'gt_bboxes'):
            np.testing.assert_array_equal(got[key], want[key])
    assert any(flips) and not all(flips)


@pytest.mark.parametrize('kwargs', [
    dict(img_scale=(97, 61)),
    dict(img_scale=(300, 200), size_divisor=16, to_rgb=False),
    dict(img_scale=[(120, 40), (90, 70)]),
    dict(img_scale=(80, 60), ratio_range=(0.5, 1.5)),
], ids=['single', 'upscale_no_rgb', 'range', 'ratio_range'])
def test_fused_preprocess_matches_jax_native(kwargs):
    """The JAX native pass and the port's run the same C++: the same bits;
    a float image goes through the unfused transforms in both."""
    from ld_tpu.native.build import load_imageprep
    assert load_imageprep() is not None
    kwargs = dict(kwargs)
    norm = dict(NORM, to_rgb=kwargs.pop('to_rgb', True))
    got_t = tf.FusedPreprocess(**kwargs, **norm)
    want_t = j_tf.FusedPreprocess(**kwargs, **norm)
    for seed in range(3):
        s = _sample(seed, (45 + seed * 7, 70))
        np.random.seed(seed)
        want = want_t(_copy(s))
        np.random.seed(seed)
        got = got_t(_copy(s))
        for key in ('img', 'scale_factor', 'gt_bboxes'):
            np.testing.assert_array_equal(got[key], want[key])
        assert got['img_shape'] == want['img_shape']
        assert got['pad_shape'] == want['pad_shape']
    # a float image (after PhotoMetricDistortion) takes the unfused
    # Resize, Normalize and Pad in both packages
    f = dict(_copy(s), img=s['img'].astype(np.float32))
    np.random.seed(5)
    want = want_t(_copy(f))
    np.random.seed(5)
    got = got_t(_copy(f))
    for key in ('img', 'scale_factor', 'gt_bboxes'):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3)
    assert got['pad_shape'] == want['pad_shape']


def test_collate_matches_jax():
    pipe = [dict(type='FusedPreprocess', img_scale=(97, 61), **NORM),
            dict(type='Pad', size=(64, 96)),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    samples = [_sample(i, n=3 + i) for i in range(3)]
    got_s = [tf.Compose(pipe)(_copy(s)) for s in samples]
    want_s = [j_tf.Compose(pipe)(_copy(s)) for s in samples]
    buckets = ((64, 96), (96, 64), (128, 128))
    got = tf.collate_batch(got_s, buckets, max_gts=4)
    want = j_tf.collate_batch(want_s, buckets, max_gts=4)
    np.testing.assert_array_equal(got['image'],
                                  want['image'].transpose(0, 3, 1, 2))
    for key in COMMON_BATCH_KEYS[1:]:
        np.testing.assert_array_equal(got[key], want[key])
    assert got['gt_valid'].sum(1).tolist() == [3, 4, 4]
    # the dtypes of ld_tpu_torch.testing.detection_batch
    assert (got['image'].dtype, got['gt_labels'].dtype,
            got['gt_valid'].dtype) == (np.float32, np.int64, np.bool_)
    # into reused buffers: the same batch, padding cleared
    out = {k: np.full(int(np.prod(tf.batch_shape(k, 3, (128, 128), 4))),
                      7, dtype) for k, (dtype, _) in
           tf.BATCH_LAYOUT.items()}
    again = tf.collate_batch(got_s, buckets, max_gts=4, out=out)
    for key in COMMON_BATCH_KEYS:
        np.testing.assert_array_equal(again[key], got[key])


def _write_coco(path):
    """A COCO json with crowds, ignored, degenerate, out-of-image and
    unknown-category annotations, an empty image and a small one, of both
    orientations."""
    rs = np.random.RandomState(5)
    images, anns = [], []
    for i in range(9):
        w, h = (640, 480) if i % 3 else (480, 640)
        if i == 7:
            w, h = 30, 20            # below min_size
        images.append(dict(id=100 + i, file_name=f'{i}.jpg', width=w,
                           height=h))
        if i == 4:
            continue                 # no annotation
        for j in range(rs.randint(1, 6)):
            x, y = rs.uniform(0, 300, 2)
            bw, bh = rs.uniform(0.5, 200, 2)
            anns.append(dict(id=len(anns), image_id=100 + i,
                             category_id=int(rs.choice([1, 3, 18, 90])),
                             bbox=[float(x), float(y), float(bw), float(bh)],
                             area=float(bw * bh * 0.8),
                             iscrowd=int(j == 2),
                             ignore=int(j == 4)))
    anns.append(dict(id=len(anns), image_id=101, category_id=1,
                     bbox=[700.0, 10.0, 20.0, 20.0], area=400.0, iscrowd=0))
    cats = [dict(id=1, name='person'), dict(id=3, name='car'),
            dict(id=18, name='dog'), dict(id=90, name='not_a_class')]
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)


@pytest.mark.parametrize('test_mode', [False, True])
def test_coco_dataset_matches_jax(tmp_path, test_mode):
    ann_file = str(tmp_path / 'ann.json')
    _write_coco(ann_file)
    got = coco.CocoDataset(ann_file, [], test_mode=test_mode)
    want = j_coco.CocoDataset(ann_file, [], test_mode=test_mode)
    assert got.img_infos == want.img_infos
    assert len(got) == len(want) == (9 if test_mode else 7)
    np.testing.assert_array_equal(got.flag, want.flag)
    assert set(got.flag) == {0, 1}
    assert got.cat_id_to_label == want.cat_id_to_label
    assert got.label_to_cat_id == want.label_to_cat_id
    for g, w in zip(got.annotations, want.annotations):
        assert sorted(g) == sorted(w)
        for key in g:
            if isinstance(w[key], list):    # polygons, crowd segmentations
                assert g[key] == w[key]
                continue
            np.testing.assert_array_equal(g[key], w[key])
            assert g[key].dtype == w[key].dtype
    assert sum(len(a['bboxes_ignore']) for a in got.annotations) > 0
    item = got[0]
    assert item['img_info'] == want.img_infos[0]


def _synthetic(pkg, n=10, hw=(48, 64), pipeline=None, seed=0):
    return pkg.SyntheticDetectionDataset(num_images=n, hw=hw, num_classes=20,
                                         max_boxes=4, seed=seed,
                                         pipeline=pipeline)


@pytest.mark.parametrize('b', [2, 3, 4])
@pytest.mark.parametrize('drop_last', [False, True])
def test_group_sampler_matches_jax_on_one_orientation(b, drop_last):
    keys = np.random.RandomState(b).randint(0, 3, 23)
    flags = np.zeros(23, np.uint8)
    got = loader.GroupBatchSampler(flags, b, seed=4, drop_last=drop_last)
    want = j_loader.GroupBatchSampler(flags, b, seed=4, drop_last=drop_last)
    for epoch in range(2):
        for k in (None, keys):
            g = got.epoch_batches(epoch, keys=k)
            w = want.epoch_batches(epoch, keys=k)
            assert [x.tolist() for x in g] == [x.tolist() for x in w]
            assert len(g) == got.num_batches()


SCALE_MODES = {
    'fixed': dict(),
    'fixed_buckets': dict(pad_hw=[(64, 96), (96, 96), (96, 128)]),
    'image_range': dict(batch_scales=[(96, 40), (128, 72)],
                        scale_sampling='image_range'),
    'image_value': dict(batch_scales=[(96, 40), (128, 72), (80, 64)],
                        scale_sampling='image_value'),
    'image_range_grouped': dict(batch_scales=[(96, 40), (128, 72)],
                                scale_sampling='image_range_grouped'),
    'image_value_grouped': dict(batch_scales=[(96, 40), (128, 72), (80, 64)],
                                scale_sampling='image_value_grouped'),
    'batch': dict(batch_scales=[(96, 40), (128, 72), (80, 64)],
                  scale_sampling='batch'),
}


@pytest.mark.parametrize('mode', sorted(SCALE_MODES))
def test_dataloader_matches_jax(mode):
    """Two epochs of the loader, with RandomFlip drawing from np.random:
    the same batches, bit for bit."""
    kwargs = dict(SCALE_MODES[mode])
    pad_hw = kwargs.pop('pad_hw', [(64, 96), (96, 128)])
    pipe = [dict(type='RandomFlip', flip_ratio=0.5),
            dict(type='FusedPreprocess', img_scale=(90, 60), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    got_l = loader.DataLoader(_synthetic(coco, 11, pipeline=pipe), 3,
                              pad_hw, max_gts=6, seed=2, **kwargs)
    want_l = j_loader.DataLoader(_synthetic(j_coco, 11, pipeline=pipe), 3,
                                 pad_hw, max_gts=6, seed=2, **kwargs)
    assert len(got_l) == len(want_l) == 4
    for epoch in range(2):
        got_l.set_epoch(epoch)
        want_l.set_epoch(epoch)
        np.random.seed(epoch)
        want = list(want_l)
        np.random.seed(epoch)
        got = list(got_l)
        assert len(got) == len(want) == len(got_l)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g['image'],
                                          w['image'].transpose(0, 3, 1, 2))
            for key in COMMON_BATCH_KEYS[1:]:
                np.testing.assert_array_equal(g[key], w[key])


class _Mixed:
    """Landscape and portrait images (flags 1 and 0) whose shapes fit only
    their own orientation's pad bucket."""

    def __init__(self, n, pipeline, fail_at=None):
        self.parts = [_synthetic(coco, n, (48, 64), pipeline),
                      _synthetic(coco, n, (64, 48), pipeline, seed=1)]
        order = np.random.RandomState(0).permutation(2 * n)
        self.index = [(int(i) % 2, int(i) // 2) for i in order]
        self.flag = np.array([1 - p for p, _ in self.index], np.uint8)
        self.img_infos = [self.parts[p].img_infos[j] for p, j in self.index]
        self.fail_at = fail_at

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f'cannot read sample {i}')
        p, j = self.index[i]
        return self.parts[p][j]


@pytest.mark.parametrize('n,b,drop_last', [(7, 2, False), (9, 4, False),
                                           (9, 4, True), (5, 3, False)])
def test_mixed_orientation_batches_are_homogeneous_and_counted(n, b,
                                                               drop_last):
    pipe = [dict(type='FusedPreprocess', img_scale=(64, 48), size_divisor=16,
                 **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    ds = _Mixed(n, pipe)
    dl = loader.DataLoader(ds, b, [(48, 64), (64, 48)], max_gts=4,
                           seed=3, drop_last=drop_last)
    per_flag = np.bincount(ds.flag)
    assert len(dl) == sum(c // b if drop_last else -(-c // b)
                          for c in per_flag)
    for epoch in range(3):
        dl.set_epoch(epoch)
        index_batches = dl.sampler.epoch_batches(epoch)
        assert all(len(set(ds.flag[x])) == 1 for x in index_batches)
        batches = list(dl)
        assert len(batches) == len(index_batches) == len(dl)
        for batch, idx in zip(batches, index_batches):
            hw = batch['image'].shape[2:]
            assert hw == ((48, 64) if ds.flag[idx[0]] else (64, 48))
    # the JAX sampler merges the tails of both orientations
    j_batches = j_loader.GroupBatchSampler(ds.flag, b, seed=3).epoch_batches(0)
    if not drop_last and any(c % b for c in per_flag):
        assert any(len(set(ds.flag[x])) == 2 for x in j_batches)


@pytest.mark.parametrize('num_workers', [0, 2])
def test_producer_exception_reaches_consumer(num_workers):
    pipe = [dict(type='FusedPreprocess', img_scale=(64, 48), size_divisor=16,
                 **NORM),
            dict(type='Collect', keys=['img'])]
    ds = _Mixed(4, pipe)
    dl = loader.DataLoader(ds, 2, [(48, 64), (64, 48)], shuffle=False,
                           num_workers=num_workers)
    order = [x.tolist() for x in dl.sampler.epoch_batches(0)]
    ds.fail_at = order[2][1]
    seen = []
    with pytest.raises(KeyError, match='cannot read sample'):
        for batch in dl:
            seen.append(batch['img_ids'].tolist())
    assert len(seen) == 2


def test_thread_pool_batches_equal_serial():
    """Per-image multi-scale draws (no flip), each handed to the shared
    pipeline by a thread-local override: the pool's batches are the serial
    ones, also with more threads than cores and a short switch interval;
    and the CPU DevicePrefetcher wraps them as tensors."""
    import os
    import sys
    pipe = [dict(type='FusedPreprocess', img_scale=(90, 60), **NORM),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]
    runs = []
    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-5)
        for workers in (0, 3, 2 * (os.cpu_count() or 1)):
            dl = loader.DataLoader(_synthetic(coco, 13, pipeline=pipe), 4,
                                   [(64, 96), (96, 128)], seed=1,
                                   num_workers=workers,
                                   batch_scales=[(96, 40), (128, 72)],
                                   scale_sampling='image_range_grouped')
            dl.set_epoch(1)
            runs.append(list(dl))
    finally:
        sys.setswitchinterval(interval)
    assert [len(r) for r in runs] == [4, 4, 4]
    assert len({b['image'].shape for b in runs[0]}) == 2
    for serial, pooled in ((runs[0], runs[1]), (runs[0], runs[2])):
        for g, w in zip(serial, pooled):
            for key in COMMON_BATCH_KEYS:
                np.testing.assert_array_equal(g[key], w[key])
    prefetcher = loader.DevicePrefetcher(dl, 'cpu')
    assert len(prefetcher) == 4
    skipped = list(prefetcher.iterate(skip=1))
    assert len(skipped) == 3
    for g, w in zip(skipped, runs[1][1:]):
        assert isinstance(g['image'], torch.Tensor)
        assert isinstance(g['img_ids'], np.ndarray)
        np.testing.assert_array_equal(g['image'].numpy(), w['image'])
        np.testing.assert_array_equal(g['img_ids'], w['img_ids'])
