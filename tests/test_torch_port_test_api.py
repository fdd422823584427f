"""The port's test API on the CPU: eval_detector over VOC ids, TTA against
the JAX package, the image-path inference API, and the two tools.

  * eval_detector keys each result by its image's dataset index: on a VOC
    set with ids '000001' and '2008_000002' every image gets the result of
    its own `forward_test` (the JAX package, and the port before, looked
    results up by `int(img_id)` and returned none);
  * aug_test against the JAX aug_test on the same converted weights: an
    R18 at width 64, 2 views of a 64x96 image (one scale and its flip);
  * inference_detector on a path equals it on the decoded array, a missing
    file raises FileNotFoundError; show_result / imshow_gt_det_bboxes draw
    and write; async_inference_detector returns the same result;
  * ld_tpu_torch/tools/test.py with `--device cpu` on a narrowed VOC
    config: `--eval mAP --out` gives eval_detector's detections and the
    metrics it writes; `--aug-test` gives aug_test's; without a card and
    without `--device cpu` it raises;
  * ld_tpu_torch/tools/ap_parity_runbook.py: `--list-rows`, a
    `--dry-run --convert-only` of three rows (one of them not ported, which
    names its ROADMAP item) and a full dry run of gfl_r18_voc.
"""
import asyncio
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
import torch

import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu.apis.aug_test import aug_test as j_aug_test
from ld_tpu.apis.aug_test import build_aug_views as j_build_aug_views
from ld_tpu.models import build_detector as j_build_detector
from ld_tpu.utils.checkpoint import convert_torch_state_dict
from ld_tpu_torch import Config
from ld_tpu_torch.apis import (async_inference_detector, aug_test,
                               build_aug_views, eval_detector,
                               imshow_gt_det_bboxes, inference_detector,
                               init_detector, show_result)
from ld_tpu_torch.data import build_dataset, collate_batch
from ld_tpu_torch.testing import write_voc_devkit
from test_torch_port_model import model_cfg
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
TEST_PIPELINE = [dict(type='LoadImageFromFile'),
                 dict(type='FusedPreprocess', img_scale=(96, 64), **NORM),
                 dict(type='Collect', keys=['img'])]


def _tool(name):
    """A script of ld_tpu_torch/tools as a module."""
    path = os.path.join(ROOT, 'ld_tpu_torch', 'tools', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'port_tool_{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def devkit(tmp_path_factory):
    """07 trainval (1 image, '000001'), 07 test (3) and 12 trainval (2,
    '2008_000005' and '2008_000006'), 64x96."""
    root = str(tmp_path_factory.mktemp('voc') / 'VOCdevkit')
    write_voc_devkit(root, {'VOC2007': {'trainval': 1, 'test': 3},
                            'VOC2012': {'trainval': 2}},
                     seed=2, sizes=((64, 96), ), max_objects=3)
    return root


def _two_year(devkit, pipeline=TEST_PIPELINE):
    years = ('VOC2007', 'VOC2012')
    return build_dataset(dict(
        type='VOCDataset', pipeline=pipeline,
        ann_file=[os.path.join(devkit, y, 'ImageSets/Main/trainval.txt')
                  for y in years],
        img_prefix=[os.path.join(devkit, y) + '/' for y in years]))


def _model(seed=1, num_classes=20, cfg=None):
    """R18 at width 64 on the CPU, gfl_cls bias 0 so every image has
    detections."""
    cfg = cfg or model_cfg(18, num_classes=num_classes)
    model = init_detector(Config(dict(model=cfg)), device='cpu', seed=seed)
    with torch.no_grad():
        model.bbox_head.gfl_cls.bias.zero_()
    return model


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g['boxes'], w['boxes'])
        np.testing.assert_array_equal(g['labels'], w['labels'])


def test_eval_detector_keys_results_by_dataset_index(devkit):
    ds = _two_year(devkit)
    assert [i['id'] for i in ds.img_infos] == ['000001', '2008_000005',
                                               '2008_000006']
    model = _model()
    got = eval_detector(model, ds, samples_per_gpu=1, pad_hw=(64, 96))
    want = []
    with torch.inference_mode():
        for i in range(len(ds)):
            batch = collate_batch([ds[i]], (64, 96))
            dets, labels, valid = model.forward_test(
                {k: torch.from_numpy(batch[k])
                 for k in ('image', 'img_hw', 'scale_factor')}, rescale=True)
            m = valid[0].numpy()
            want.append(dict(boxes=dets[0].numpy()[m],
                             labels=labels[0].numpy()[m]))
    assert all(len(r['boxes']) > 0 for r in got)
    _assert_results_equal(got, want)
    # batched, with a tail that repeats an image: the same detections
    batched = eval_detector(model, ds, samples_per_gpu=2, pad_hw=(64, 96))
    for g, w in zip(batched, want):
        np.testing.assert_array_equal(g['labels'], w['labels'])
        np.testing.assert_allclose(g['boxes'], w['boxes'], rtol=0,
                                   atol=1e-4)


def test_aug_test_matches_jax():
    """The port's weights, converted into the JAX tree (the JAX package
    compiles each op of an eager run once per shape: one tower conv per
    level keeps that cheap)."""
    cfg = model_cfg(18)
    cfg['bbox_head'] = dict(cfg['bbox_head'], stacked_convs=1)
    model = _model(seed=11, num_classes=4, cfg=cfg)
    variables = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert variables.pop('_unmapped') == []
    det = j_build_detector(cfg)
    img = np.random.RandomState(12).randint(0, 256, (64, 96, 3), np.uint8)
    kw = dict(img_scales=[(96, 64)], flip=True, **NORM)
    views = build_aug_views(img, **kw)
    j_views = j_build_aug_views(img, **kw)
    for v, w in zip(views, j_views):
        np.testing.assert_array_equal(v['img'], w['img'])
    got = aug_test(model, views, img.shape[:2])
    want = j_aug_test(det, variables, j_views, img.shape[:2])
    assert len(got['boxes']) == len(want['boxes']) > 0
    # the merged detections in score order, untied
    assert (np.diff(want['boxes'][:, 4]) < 0).all()
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=0,
                               atol=1e-4)


def test_inference_api_on_paths_and_drawing(tmp_path):
    model = _model(num_classes=4)
    img = np.random.RandomState(3).randint(0, 256, (64, 96, 3), np.uint8)
    path = str(tmp_path / 'img.png')
    cv2.imwrite(path, img)
    kw = dict(img_scale=(96, 64), pad_hw=((64, 96), (96, 64)))
    from_array = inference_detector(model, img, **kw)
    from_path = inference_detector(model, path, **kw)
    assert len(from_array['boxes']) > 0
    _assert_results_equal([from_path], [from_array])
    from_async = asyncio.run(async_inference_detector(model, path, **kw))
    _assert_results_equal([from_async], [from_array])
    with pytest.raises(FileNotFoundError):
        inference_detector(model, str(tmp_path / 'missing.jpg'))

    out = str(tmp_path / 'shown.jpg')
    drawn = show_result(path, from_array, class_names=['a', 'b', 'c', 'd'],
                        score_thr=0.0, out_file=out)
    assert drawn.shape == img.shape and not np.array_equal(drawn, img)
    assert cv2.imread(out) is not None
    none = show_result(img, from_array, score_thr=2.0)
    np.testing.assert_array_equal(none, img)
    gt = imshow_gt_det_bboxes(img, dict(bboxes=np.array([[5, 5, 40, 30]]),
                                        labels=np.array([1])),
                              from_array, score_thr=2.0)
    assert (gt != img).any() and (gt[5, 5] == (255, 144, 30)).all()


def _narrow_config(tmp_path, devkit):
    """configs/gfl/gfl_r18_fpn1x_voc.py at FPN / head width 64 over the
    devkit's 07 test split at 64x96."""
    path = str(tmp_path / 'gfl_r18_voc_narrow.py')
    base = os.path.join(ROOT, 'configs/gfl/gfl_r18_fpn1x_voc.py')
    with open(path, 'w') as f:
        f.write(f"""_base_ = [{base!r}]
model = dict(neck=dict(out_channels=64),
             bbox_head=dict(in_channels=64, feat_channels=64,
                            stacked_convs=2))
test_pipeline = {TEST_PIPELINE!r}
data = dict(test=dict(ann_file={devkit!r} + '/VOC2007/ImageSets/Main/test.txt',
                      img_prefix={devkit!r} + '/VOC2007/',
                      pipeline=test_pipeline))
pad_to = [(64, 96), (96, 64)]
dtype = 'float32'
""")
    return path


@pytest.fixture(scope='module')
def narrow(tmp_path_factory, devkit):
    tmp_path = tmp_path_factory.mktemp('cli')
    cfg_path = _narrow_config(tmp_path, devkit)
    model = init_detector(cfg_path, device='cpu', seed=5)
    with torch.no_grad():
        model.bbox_head.gfl_cls.bias.zero_()
    ckpt = str(tmp_path / 'gfl_r18_narrow.pth')
    torch.save(dict(state_dict=model.state_dict()), ckpt)
    return cfg_path, ckpt, model, tmp_path


def test_tools_test_eval_and_out(narrow, monkeypatch):
    cfg_path, ckpt, model, tmp_path = narrow
    out = str(tmp_path / 'metrics.json')
    ret = _tool('test').main([cfg_path, ckpt, '--eval', 'mAP', '--out', out,
                              '--device', 'cpu', '--cfg-options',
                              'model.test_cfg.max_per_img=50'])
    with open(out) as f:
        assert json.load(f) == ret['metrics']
    assert set(ret['metrics']) == {'mAP'}
    ds = build_dataset(Config.fromfile(cfg_path).data['test'])
    monkeypatch.setitem(model.bbox_head.test_cfg, 'max_per_img', 50)
    want = eval_detector(model, ds, pad_hw=[(64, 96), (96, 64)])
    assert all(0 < len(r['boxes']) <= 50 for r in ret['results'])
    _assert_results_equal(ret['results'], want)


def test_tools_test_aug_test(narrow):
    cfg_path, ckpt, model, _ = narrow
    ret = _tool('test').main([cfg_path, ckpt, '--eval', 'AP50:95',
                              '--aug-test', '--aug-scales', '96', '64',
                              '128', '80', '--max-images', '2',
                              '--device', 'cpu'])
    assert len(ret['metrics']) == 11
    ds = build_dataset(Config.fromfile(cfg_path).data['test'])
    results = ret['results']
    assert len(results) == len(ds) == 3
    assert len(results[2]['boxes']) == 0              # past --max-images
    for i in range(2):
        img = cv2.imread(os.path.join(ds.img_prefix,
                                      ds.img_infos[i]['filename']))
        views = build_aug_views(img, [(96, 64), (128, 80)], flip=True,
                                **NORM)
        want = aug_test(model, views, img.shape[:2])
        assert len(want['boxes']) > 0
        _assert_results_equal([results[i]], [want])


def test_tools_test_needs_a_card_unless_told(narrow, monkeypatch):
    cfg_path, ckpt, _, _ = narrow
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        _tool('test').main([cfg_path, ckpt, '--eval', 'mAP'])


def test_runbook_rows_and_dry_runs(tmp_path, capsys):
    runbook = _tool('ap_parity_runbook')
    runbook.main(['--list-rows'])
    listed = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in listed] == list(runbook.ROWS)
    not_ported = runbook.main([
        '--dry-run', '--convert-only', '--row', 'gfl_r18_voc', '--row',
        'ld_r18_self_1x', '--row', 'ldv2_r50_1x', '--row', 'ld_r101_dcn_2x',
        '--work-dir', str(tmp_path), '--device', 'cpu'])
    assert not_ported == {}
    out = capsys.readouterr().out
    assert 'ldv2_r50_1x: synth teacher ckpt: strict load OK' in out
    # the R101-DCN teacher: conv_offset keys and DCN conv2 weights
    assert 'ld_r101_dcn_2x: synth teacher ckpt: strict load OK' in out
    assert runbook.main(['--dry-run', '--row', 'gfl_r18_voc', '--work-dir',
                         str(tmp_path), '--device', 'cpu']) == {}
    out = capsys.readouterr().out
    assert 'gfl_r18_voc: zero-train eval on synthetic data OK' in out
    assert "'AP50'" in out
