"""The port's COCO evaluation against the JAX package's, on seeded detections.

  * `CocoEvaluator`: the same 12 metrics (and the classwise APs) as the JAX
    evaluator on a written COCO json with crowds, ignored and
    out-of-range gts, for dict results (with and without `valid`) and
    per-class list results;
  * the native matcher (`csrc/host/coco_match.cpp`) gives the same match
    and ignore flags as the plain numpy matcher, case by case and through
    the whole evaluator;
  * `results2json`: the same records and the same file.
"""
import json

import numpy as np
import pytest

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.data import coco as j_coco
from ld_tpu.evaluation import coco_eval as j_eval
from ld_tpu_torch.data import coco
from ld_tpu_torch.evaluation import coco_eval
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse


def _write_coco(path, n=12, seed=0):
    """Images of 640x480 and 480x640 with 1-7 boxes each of 3 categories,
    some crowds, an ignored one, and 'area' fields apart from the boxes."""
    rs = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n):
        w, h = (640, 480) if i % 2 else (480, 640)
        images.append(dict(id=10 + i, file_name=f'{i}.jpg', width=w,
                           height=h))
        for j in range(rs.randint(1, 8)):
            x, y = rs.uniform(0, 300, 2)
            bw, bh = np.exp(rs.uniform(np.log(8), np.log(300), 2))
            anns.append(dict(id=len(anns), image_id=10 + i,
                             category_id=int(rs.choice([1, 3, 18])),
                             bbox=[float(x), float(y), float(bw), float(bh)],
                             area=float(bw * bh * rs.uniform(0.5, 1.0)),
                             iscrowd=int(rs.uniform() < 0.1),
                             ignore=int(rs.uniform() < 0.03)))
    cats = [dict(id=1, name='person'), dict(id=3, name='car'),
            dict(id=18, name='dog')]
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)


def _detections(dataset, seed):
    """Per image: jittered gts (some relabelled), misses and false
    positives, continuous scores, and a few invalid slots."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        gts = np.concatenate([ann['bboxes'], ann['bboxes_ignore']])
        labels = np.concatenate([ann['labels'], ann['labels_ignore']])
        keep = rs.uniform(size=len(gts)) < 0.85
        jitter = rs.normal(0, 6, (len(gts), 4))
        boxes = (gts + jitter)[keep]
        labels = np.where(rs.uniform(size=len(gts)) < 0.1,
                          rs.randint(0, 3, len(gts)), labels)[keep]
        fp = rs.randint(0, 5)
        xy = rs.uniform(0, 400, (fp, 2))
        boxes = np.concatenate([boxes, np.concatenate(
            [xy, xy + rs.uniform(5, 150, (fp, 2))], -1)])
        labels = np.concatenate([labels, rs.randint(0, 3, fp)])
        scores = rs.uniform(0.05, 1.0, len(boxes))
        out.append(dict(boxes=np.concatenate([boxes, scores[:, None]], -1)
                        .astype(np.float32), labels=labels.astype(np.int64),
                        valid=rs.uniform(size=len(boxes)) < 0.95))
    return out


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    ann_file = str(tmp_path_factory.mktemp('coco') / 'ann.json')
    _write_coco(ann_file)
    kw = dict(classes=('person', 'car', 'dog'), test_mode=True)
    return (coco.CocoDataset(ann_file, [], **kw),
            j_coco.CocoDataset(ann_file, [], **kw))


def _assert_metrics_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == 'classwise':
            assert got[k] == pytest.approx(want[k], abs=1e-12)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                       equal_nan=True)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('form', ['dict', 'dict_no_valid', 'per_class'])
def test_coco_evaluator_matches_jax(datasets, seed, form):
    ds, j_ds = datasets
    dets = _detections(ds, seed)
    if form == 'dict_no_valid':
        dets = [dict(boxes=d['boxes'], labels=d['labels']) for d in dets]
    elif form == 'per_class':
        dets = [[d['boxes'][d['valid'] & (d['labels'] == c)]
                 for c in range(3)] for d in dets]
    got = coco_eval.CocoEvaluator(ds).evaluate(dets, classwise=True)
    want = j_eval.CocoEvaluator(j_ds).evaluate(dets, classwise=True)
    _assert_metrics_equal(got, want)
    assert 0 < got['bbox_mAP'] < 1
    _assert_metrics_equal(ds.evaluate(dets), j_ds.evaluate(dets))


def test_native_matcher_equals_numpy_matcher(datasets, monkeypatch):
    rs = np.random.RandomState(3)
    checked = 0
    for _ in range(200):
        d, g = rs.randint(0, 30), rs.randint(0, 12)
        gt = rs.uniform(0, 200, (g, 2))
        gt = np.concatenate([gt, gt + rs.uniform(2, 120, (g, 2))], -1)
        det = gt[rs.randint(0, max(g, 1), d)] if g else \
            rs.uniform(0, 200, (d, 4))
        det = det + rs.normal(0, 8, det.shape)
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
        scores = rs.uniform(size=d)
        crowd = rs.uniform(size=g) < 0.2
        areas = None if rs.uniform() < 0.5 else rs.uniform(10, 2e4, g)
        for arng in coco_eval.AREA_RNG.values():
            for max_det in coco_eval.MAX_DETS:
                args = (det, scores, gt, crowd, arng, max_det, areas)
                a = coco_eval._match_single(*args)
                b = coco_eval._match_single(
                    *args, matcher=coco_eval._match_numpy)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
                checked += int(a[0].any())
    assert checked > 100
    ds, _ = datasets
    dets = _detections(ds, 4)
    native = coco_eval.CocoEvaluator(ds).evaluate(dets)
    monkeypatch.setattr(coco_eval, '_match_native', coco_eval._match_numpy)
    _assert_metrics_equal(coco_eval.CocoEvaluator(ds).evaluate(dets), native)


def test_results2json_matches_jax(datasets, tmp_path):
    ds, j_ds = datasets
    dets = _detections(ds, 5)
    got = ds.results2json(dets, out_file=str(tmp_path / 'got.json'))
    want = j_ds.results2json(dets, out_file=str(tmp_path / 'want.json'))
    assert got == want and len(got) > 20
    assert (tmp_path / 'got.json').read_text() == \
        (tmp_path / 'want.json').read_text()
    per_class = [[d['boxes'][d['labels'] == c] for c in range(3)]
                 for d in dets]
    assert ds.results2json(per_class) == j_ds.results2json(per_class)
    # 'segm' is ported (tests/test_torch_port_mask_rcnn.py); the rest raise
    with pytest.raises(NotImplementedError):
        ds.evaluate(dets, metric='proposal')
