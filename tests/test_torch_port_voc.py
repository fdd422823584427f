"""The port's VOC path against the JAX package's, on the same seeded inputs.

  * VOCDataset on tests/fixtures/voc_mini (images written with cv2) and on a
    two-year 07+12 list, with and without `min_size`: the same infos,
    annotations (1-based shift, difficult and small boxes as ignores),
    flags and pipeline outputs (LoadImageFromFile, LoadAnnotations,
    RandomFlip, FusedPreprocess, DefaultFormatBundle, ImageToTensor,
    Collect);
  * ConcatDataset, RepeatDataset, ClassBalancedDataset and a Repeat of a
    Concat: the same `len`, `flag`, `indices`, annotations and image sizes
    (`_image_dims`), and the same loader batches over 2 epochs;
  * eval_map / average_precision / eval_recalls on random detections with
    ignored gts, at IoU 0.5 and 0.75 in both AP modes, and
    `VOCDataset.evaluate('mAP' | 'AP50:95')`: equal to 1e-12;
  * MultiScaleFlipAug's views, and FilterAnnotations: identical;
  * get_classes: the same tables.
"""
import contextlib
import glob
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.data import build_dataset as j_build_dataset
from ld_tpu.data import loader as j_loader
from ld_tpu.data import transforms as j_tf
from ld_tpu.evaluation import class_names as j_class_names
from ld_tpu.evaluation import mean_ap as j_mean_ap
from ld_tpu_torch import Config
from ld_tpu_torch.data import build_dataset, loader
from ld_tpu_torch.data import transforms as tf
from ld_tpu_torch.evaluation import class_names, mean_ap
from ld_tpu_torch.models import build_detector
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
from ld_tpu_torch.testing import write_voc_devkit
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the VOC configs of the LD and GFL tables (the R101-DCN teachers' too)
VOC_CONFIGS = sorted(
    [os.path.relpath(p, ROOT) for pattern in ('configs/ld/*_voc_1x.py',
                                              'configs/gfl/*voc*.py')
     for p in glob.glob(os.path.join(ROOT, pattern))] +
    ['configs/ld/ld_r18_self_2x_3x_voc.py'])
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
PIPELINE = [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', with_bbox=True),
            dict(type='RandomFlip', flip_ratio=0.5),
            dict(type='FusedPreprocess', img_scale=(128, 80), **NORM),
            dict(type='DefaultFormatBundle'),
            dict(type='ImageToTensor', keys=['img']),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]


@pytest.fixture(scope='module')
def voc_roots(tmp_path_factory):
    """voc_mini with its two images written, and a seeded two-year devkit
    (landscape images only, so that the loader's batches are those of one
    orientation, as the JAX loader needs)."""
    base = tmp_path_factory.mktemp('voc')
    mini = str(base / 'voc_mini')
    shutil.copytree(os.path.join(ROOT, 'tests', 'fixtures', 'voc_mini'),
                    mini)
    os.makedirs(os.path.join(mini, 'JPEGImages'))
    rs = np.random.RandomState(0)
    for img_id in ('000001', '000002'):
        cv2.imwrite(os.path.join(mini, 'JPEGImages', f'{img_id}.jpg'),
                    rs.randint(0, 256, (64, 96, 3)).astype(np.uint8))
    devkit = str(base / 'VOCdevkit')
    write_voc_devkit(devkit, {'VOC2007': {'trainval': 3, 'test': 2},
                              'VOC2012': {'trainval': 4}},
                     seed=1, sizes=((60, 90), (72, 96)))
    return mini, devkit


def _voc_cfg(voc_roots, which, min_size=None, pipeline=PIPELINE):
    mini, devkit = voc_roots
    if which == 'mini':
        cfg = dict(ann_file=os.path.join(mini, 'val.txt'),
                   img_prefix=mini + '/')
    else:
        years = ('VOC2007', 'VOC2012')
        cfg = dict(ann_file=[os.path.join(devkit, y, 'ImageSets', 'Main',
                                          'trainval.txt') for y in years],
                   img_prefix=[os.path.join(devkit, y) + '/' for y in years])
    return dict(cfg, type='VOCDataset', min_size=min_size,
                pipeline=[dict(t) for t in pipeline])


def _assert_ann_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype, key


def _assert_samples_equal(got, want):
    np.testing.assert_array_equal(got['img'], want['img'])
    for key in ('gt_bboxes', 'gt_labels', 'scale_factor'):
        np.testing.assert_array_equal(got[key], want[key])
    assert got['img_shape'] == want['img_shape']
    assert got['img_id'] == want['img_id']


@pytest.mark.parametrize('which,min_size', [('mini', None), ('mini', 20),
                                            ('two_year', None),
                                            ('two_year', 40)])
def test_voc_dataset_matches_jax(voc_roots, which, min_size):
    cfg = _voc_cfg(voc_roots, which, min_size)
    got, want = build_dataset(cfg), j_build_dataset(cfg)
    assert len(got) == len(want) == (2 if which == 'mini' else 7)
    assert got.img_infos == want.img_infos
    assert got.id_prefixes == want._id_prefixes
    assert got.img_prefix == want.img_prefix
    np.testing.assert_array_equal(got.flag, want.flag)
    for g, w in zip(got.annotations, want.annotations):
        _assert_ann_equal(g, w)
    if which == 'mini':      # the fixture: 1-based corners, one difficult
        np.testing.assert_array_equal(got.annotations[0]['bboxes'],
                                      [[8, 11, 55, 50], [59, 7, 90, 60]])
        np.testing.assert_array_equal(got.annotations[0]['bboxes_ignore'],
                                      [[1, 1, 12, 14]])
    else:
        assert [i['id'] for i in got.img_infos][3:] == [
            f'2008_{i:06d}' for i in range(6, 10)]
    n_ignored = sum(len(a['bboxes_ignore']) for a in got.annotations)
    assert n_ignored > 0
    for i in range(len(got)):
        np.random.seed(i)
        g = got[i]
        np.random.seed(i)
        _assert_samples_equal(g, want[i])


@pytest.mark.parametrize('path', VOC_CONFIGS)
def test_voc_configs_build(path):
    """Each split's pipeline (unwrapped from its RepeatDataset) builds, and
    the model builds with 20 classes (on the meta device: shapes only); a
    DCN teacher config with its DCN conv2s."""
    cfg = Config.fromfile(os.path.join(ROOT, path))
    for split in ('train', 'val', 'test'):
        d = cfg.data[split]
        while 'dataset' in d:
            d = d['dataset']
        assert d['type'] == 'VOCDataset'
        assert tf.Compose([dict(t) for t in d['pipeline']]).transforms
    assert cfg.evaluation['metric'] == 'AP50:95'
    with torch.device('meta'):
        model = build_detector(cfg.model)
    assert model.bbox_head.num_classes == 20
    dcns = [m for m in model.backbone.modules()
            if isinstance(m, ModulatedDeformConv2d)]
    assert len(dcns) == (30 if cfg.model.backbone.get('dcn') else 0)


def test_voc_classes_and_get_classes():
    for name in ('coco', 'voc'):
        assert class_names.get_classes(name) == \
            j_class_names.get_classes(name)
    assert len(class_names.get_classes('voc')) == 20
    with pytest.raises(KeyError):
        class_names.get_classes('lvis')


def _wrapper_cfg(voc_roots, kind):
    two_year = _voc_cfg(voc_roots, 'two_year')
    mini = _voc_cfg(voc_roots, 'mini')
    if kind == 'concat':
        return dict(type='ConcatDataset', datasets=[two_year, mini])
    if kind == 'repeat':
        return dict(type='RepeatDataset', times=3, dataset=two_year)
    if kind == 'class_balanced':
        return dict(type='ClassBalancedDataset', oversample_thr=0.3,
                    dataset=two_year)
    return dict(type='RepeatDataset', times=2,
                dataset=dict(type='ConcatDataset', datasets=[two_year, mini]))


@pytest.mark.parametrize('kind', ['concat', 'repeat', 'class_balanced',
                                  'repeat_concat'])
def test_dataset_wrappers_match_jax(voc_roots, kind):
    cfg = _wrapper_cfg(voc_roots, kind)
    got, want = build_dataset(cfg), j_build_dataset(cfg)
    assert len(got) == len(want) > 7
    assert got.CLASSES == want.CLASSES
    np.testing.assert_array_equal(got.flag, want.flag)
    if kind == 'class_balanced':
        np.testing.assert_array_equal(got.indices, want.indices)
        assert len(got.indices) > len(got.dataset)      # some oversampled
    np.testing.assert_array_equal(loader._image_dims(got),
                                  j_loader._image_dims(want))
    for i in range(len(got)):
        _assert_ann_equal(got.get_ann_info(i), want.get_ann_info(i))
    for i in (0, len(got) - 1):
        np.random.seed(i)
        g = got[i]
        np.random.seed(i)
        _assert_samples_equal(g, want[i])
    # the scale override reaches every wrapped pipeline
    assert len(loader._scale_carriers(got)) == \
        (2 if 'concat' in kind else 1)


def test_voc_ld_config_train_split_builds(voc_roots):
    """configs/ld/ld_r50_gflv1_r101_fpn_voc_1x.py merges voc0712's
    RepeatDataset over its COCO base's train set, which leaves that set's
    ann_file / img_prefix / pipeline beside `times` and `dataset`: the port
    builds the RepeatDataset and warns; the JAX package's refuses them."""
    _, devkit = voc_roots
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/ld/ld_r50_gflv1_r101_fpn_voc_1x.py'))
    train = cfg.data['train']
    assert {'ann_file', 'img_prefix', 'pipeline'} <= set(train)
    inner = train['dataset']
    inner['ann_file'] = [p.replace('data/VOCdevkit', devkit)
                         for p in inner['ann_file']]
    inner['img_prefix'] = [p.replace('data/VOCdevkit', devkit)
                           for p in inner['img_prefix']]
    with pytest.warns(UserWarning, match='RepeatDataset ignores'):
        ds = build_dataset(train)
    assert type(ds).__name__ == 'RepeatDataset' and len(ds) == 3 * 7
    assert [t['type'] for t in inner['pipeline']] == [
        'LoadImageFromFile', 'LoadAnnotations', 'Resize', 'RandomFlip',
        'Normalize', 'Pad', 'Collect']
    with pytest.raises(TypeError):
        j_build_dataset(train)
    with pytest.raises(TypeError, match='unexpected'):
        build_dataset(dict(type='RepeatDataset', times=2, dataset=inner,
                           time=3))


def test_loader_batches_over_repeat_of_concat_match_jax(voc_roots):
    """Two epochs of batch 3 over RepeatDataset(ConcatDataset(07+12, mini)),
    with RandomFlip drawing from np.random: the same index lists and the
    same batches; each image's `img_idx` is its index in the wrapper."""
    cfg = _wrapper_cfg(voc_roots, 'repeat_concat')
    got_l = loader.DataLoader(build_dataset(cfg), 3, (96, 128), max_gts=6,
                              seed=3)
    want_l = j_loader.DataLoader(j_build_dataset(cfg), 3, (96, 128),
                                 max_gts=6, seed=3)
    assert len(got_l) == len(want_l) == 6
    for epoch in range(2):
        got_l.set_epoch(epoch)
        want_l.set_epoch(epoch)
        index_lists = got_l.sampler.epoch_batches(epoch)
        assert [b.tolist() for b in index_lists] == \
            [b.tolist() for b in want_l.sampler.epoch_batches(epoch)]
        np.random.seed(epoch)
        want = list(want_l)
        np.random.seed(epoch)
        got = list(got_l)
        assert len(got) == len(want) == 6
        for g, w, idx in zip(got, want, index_lists):
            np.testing.assert_array_equal(g['image'],
                                          w['image'].transpose(0, 3, 1, 2))
            for key in ('gt_bboxes', 'gt_labels', 'gt_valid', 'img_hw',
                        'scale_factor'):
                np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_array_equal(g['img_idx'], idx)
            # VOC's string ids are not carried as integers
            assert (g['img_ids'] == -1).all()


def _random_dets(annotations, num_classes, seed):
    """Per image and class: jittered gts and ignored gts (some dropped,
    some relabelled), false positives, continuous scores."""
    rs = np.random.RandomState(seed)
    out = []
    for ann in annotations:
        boxes = np.concatenate([ann['bboxes'], ann['bboxes_ignore']])
        labels = np.concatenate([ann['labels'], ann['labels_ignore']])
        keep = rs.uniform(size=len(boxes)) < 0.85
        boxes = (boxes + rs.normal(0, 3, boxes.shape))[keep]
        labels = np.where(rs.uniform(size=len(labels)) < 0.1,
                          rs.randint(0, num_classes, len(labels)),
                          labels)[keep]
        fp = rs.randint(0, 4)
        xy = rs.uniform(0, 60, (fp, 2))
        boxes = np.concatenate([boxes, np.concatenate(
            [xy, xy + rs.uniform(5, 40, (fp, 2))], -1)])
        labels = np.concatenate([labels, rs.randint(0, num_classes, fp)])
        scores = rs.uniform(0.05, 1.0, len(boxes))
        dets = np.concatenate([boxes, scores[:, None]], -1).astype(np.float32)
        out.append([dets[labels == c] for c in range(num_classes)])
    return out


def _random_annotations(seed, n=12, num_classes=4):
    rs = np.random.RandomState(seed)
    anns = []
    for _ in range(n):
        g, ig = rs.randint(0, 6), rs.randint(0, 3)
        xy = rs.uniform(0, 50, (g + ig, 2))
        boxes = np.concatenate([xy, xy + rs.uniform(4, 40, (g + ig, 2))],
                               -1).astype(np.float32)
        labels = rs.randint(0, num_classes, g + ig)
        anns.append(dict(bboxes=boxes[:g], labels=labels[:g],
                         bboxes_ignore=boxes[g:], labels_ignore=labels[g:]))
    return anns


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('mode', ['area', '11points'])
@pytest.mark.parametrize('iou_thr', [0.5, 0.75])
def test_eval_map_matches_jax(seed, mode, iou_thr):
    anns = _random_annotations(seed)
    dets = _random_dets(anns, 4, seed + 10)
    got, got_cls = mean_ap.eval_map(dets, anns, iou_thr=iou_thr, mode=mode)
    want, want_cls = j_mean_ap.eval_map(dets, anns, iou_thr=iou_thr,
                                        mode=mode)
    assert 0 < got < 1
    assert got == pytest.approx(want, abs=1e-12)
    for g, w in zip(got_cls, want_cls):
        assert g['num_gts'] == w['num_gts'] and \
            g['num_dets'] == w['num_dets']
        assert g['ap'] == pytest.approx(w['ap'], abs=1e-12)
        assert g['recall'] == pytest.approx(w['recall'], abs=1e-12)
    gts = [a['bboxes'] for a in anns]
    props = [np.concatenate(d) for d in dets]
    np.testing.assert_allclose(
        mean_ap.eval_recalls(gts, props, (2, 5, 100), (0.5, iou_thr)),
        j_mean_ap.eval_recalls(gts, props, (2, 5, 100), (0.5, iou_thr)),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize('metric', ['mAP', 'AP50:95'])
@pytest.mark.parametrize('form', ['dict', 'per_class'])
def test_voc_evaluate_matches_jax(voc_roots, metric, form):
    cfg = _voc_cfg(voc_roots, 'two_year', pipeline=[])
    got_ds, want_ds = build_dataset(cfg), j_build_dataset(cfg)
    dets = _random_dets(got_ds.annotations, 20, 5)
    if form == 'dict':
        dets = [dict(boxes=np.concatenate(d), labels=np.concatenate(
            [np.full(len(x), c) for c, x in enumerate(d)])) for d in dets]
    got = got_ds.evaluate(dets, metric=metric)
    want = want_ds.evaluate(dets, metric=metric)
    assert sorted(got) == sorted(want)
    assert len(got) == (1 if metric == 'mAP' else 11)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert 0 < got['mAP'] < 1
    # the gts themselves score 1 at every threshold
    exact = [[a['bboxes'][a['labels'] == c] for c in range(20)]
             for a in got_ds.annotations]
    exact = [[np.concatenate([b, np.ones((len(b), 1))], -1) for b in d]
             for d in exact]
    assert all(v == 1.0 for v in got_ds.evaluate(exact, metric).values())


def test_average_precision_modes_match_jax():
    rs = np.random.RandomState(4)
    for _ in range(20):
        n = rs.randint(1, 30)
        recalls = np.sort(rs.uniform(size=n))
        precisions = rs.uniform(size=n)
        for mode in ('area', '11points'):
            assert mean_ap.average_precision(recalls, precisions, mode) == \
                pytest.approx(j_mean_ap.average_precision(
                    recalls, precisions, mode), abs=1e-12)
    with pytest.raises(ValueError):
        mean_ap.average_precision(recalls, precisions, 'bad')


@pytest.mark.parametrize('scales,flip', [([(96, 64)], False),
                                         ([(96, 64), (128, 80)], True)])
def test_multi_scale_flip_aug_views_match_jax(scales, flip):
    rs = np.random.RandomState(6)
    img = rs.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    boxes = np.array([[3, 4, 30, 40], [20, 10, 65, 45]], np.float32)
    step = dict(type='MultiScaleFlipAug', img_scale=scales, flip=flip,
                transforms=[dict(type='FusedPreprocess', **NORM),
                            dict(type='DefaultFormatBundle'),
                            dict(type='ImageToTensor', keys=['img']),
                            dict(type='Collect', keys=['img', 'gt_bboxes'])])

    def results():
        return dict(img=img.copy(), img_shape=img.shape, ori_shape=img.shape,
                    gt_bboxes=boxes.copy(), img_info=dict(id='000007'))
    with pytest.warns(UserWarning) if flip else contextlib.nullcontext():
        got = tf.Compose([dict(step)])(results())
    want = j_tf.Compose([dict(step)])(results())
    got_views = got.get('aug_views', [got])
    want_views = want.get('aug_views', [want])
    assert len(got_views) == len(want_views) == len(scales) * (1 + flip)
    for g, w in zip(got_views, want_views):
        assert g['flip'] == w['flip']
        _assert_samples_equal(dict(g, gt_labels=0), dict(w, gt_labels=0))
    if flip:                 # the mirror view's boxes are mirrored
        w = got_views[1]['img_shape'][1]
        np.testing.assert_allclose(got_views[1]['gt_bboxes'][:, [2, 0]],
                                   w - got_views[0]['gt_bboxes'][:, [0, 2]],
                                   atol=1e-4)


@pytest.mark.parametrize('min_wh', [(1, 1), (20, 12), (100, 100)])
def test_filter_annotations_and_transpose_match_jax(min_wh):
    boxes = np.array([[0, 0, 10, 30], [5, 5, 40, 12], [1, 1, 60, 60]],
                     np.float32)

    def results():
        return dict(gt_bboxes=boxes.copy(), gt_labels=np.arange(3),
                    img=np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    steps = [dict(type='FilterAnnotations', min_gt_bbox_wh=min_wh),
             dict(type='Transpose', keys=['img'], order=(2, 0, 1))]
    got = tf.Compose([dict(s) for s in steps])(results())
    want = j_tf.Compose([dict(s) for s in steps])(results())
    if want is None:
        assert got is None and min_wh == (100, 100)
        return
    for key in ('gt_bboxes', 'gt_labels', 'img'):
        np.testing.assert_array_equal(got[key], want[key])
    assert got['img'].shape == (4, 2, 3)
