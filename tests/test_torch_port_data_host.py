"""The rest of the port's data layer against the JAX package's, on the same
seeded inputs: the train-time augmentations, AutoAugment, the corruption
benchmark and its tools, and the LVIS, Cityscapes, DeepFashion and
WIDER-Face datasets.

  * every transform over 24 seeds: `np.random` seeded, the JAX transform
    run, re-seeded, the port's run on a copy of the same input; images,
    boxes, labels, masks and shapes equal bit for bit (dtype included),
    and the next draw of `np.random` equal, so both drew as often:
    PhotoMetricDistortion (uint8 and float32 images), RandomCrop in its
    four crop types (with masks) and with `allow_negative_crop`, Expand,
    MinIoURandomCrop, the WIDER-Face chain of the three, CutOut (a count
    and a shape, a range and a ratio), RandomCenterCropPad (train, and its
    two test pads), Shear, Rotate, Translate, the four ColorTransforms,
    AutoAugment, and each of the eight corruptions at the severity the
    seed picks;
  * SegRescale and LoadProposals (cut, cap, empty) on fixed inputs;
  * LVISV1Dataset / LVISDataset, CityscapesDataset, DeepFashionDataset
    and WIDERFaceDataset read from annotation files written to a temp dir:
    the same CLASSES, label maps, `img_infos`, annotations and flags, and
    the same samples through LoadImageFromFile + LoadAnnotations (masks
    included);
  * the ImportError of Albu and InstaBoost without their packages, and the
    TypeError of a dataset's `proposal_file` (ROADMAP.md caveat 41), in
    both packages;
  * every config of configs/lvis/, cityscapes/, deepfashion/ and
    fpg/*crop640* builds its train and test sets on temp-dir files, and
    their first samples equal JAX's where JAX builds them; JAX cannot
    build the crop640 Faster / Mask R-CNN train and test sets, whose
    FusedPreprocess passes `keep_ratio` (ROADMAP.md caveat 46), and the
    port's give 640x640;
  * the robustness tools: `test_robustness.py` on an R18 GFL over a
    3-image synthetic COCO set (two corruptions, the clean run), and
    `robustness_eval.summarize` against the JAX tool's on its json.
"""
import copy
import glob
import importlib.util
import json
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import ld_tpu  # noqa: F401 — populates the JAX registries
from ld_tpu import Config as JConfig
from ld_tpu.data import corruptions as j_corr
from ld_tpu.data import extra_datasets as j_extra
from ld_tpu.data import transforms as j_tf
from ld_tpu.data.coco import CocoDataset as JCocoDataset
from ld_tpu.utils.registry import DATASETS as J_DATASETS
from ld_tpu_torch import Config
from ld_tpu_torch.data import build_dataset, corruptions
from ld_tpu_torch.data import extra_datasets as extra
from ld_tpu_torch.data import lvis
from ld_tpu_torch.data import transforms as tf
from ld_tpu_torch.data.coco import COCO_CLASSES, CocoDataset
from ld_tpu_torch.testing import write_coco_instances, write_lvis_instances
from test_torch_port_threads import one_intra_op_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(24)
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
RESULT_KEYS = ('img', 'gt_bboxes', 'gt_labels', 'gt_masks', 'img_shape',
               'pad_shape', 'border', 'proposals', 'gt_semantic_seg')


def sample(seed, hw=(48, 64), n=5, dtype=np.uint8, masks=False):
    """A seeded image with n boxes (some near the border) and labels."""
    rs = np.random.RandomState(1000 + seed)
    img = rs.randint(0, 256, hw + (3, )).astype(dtype)
    xy = rs.uniform(-4, [hw[1] * 0.8, hw[0] * 0.8], (n, 2))
    wh = rs.uniform(3, [hw[1] * 0.5, hw[0] * 0.5], (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).clip(
        0, [hw[1], hw[0], hw[1], hw[0]]).astype(np.float32)
    out = dict(img=img, img_shape=img.shape, ori_shape=img.shape,
               gt_bboxes=boxes, gt_labels=rs.randint(0, 20, n),
               img_info=dict(id=seed))
    if masks:
        out['gt_masks'] = [(rs.rand(*hw) > 0.5).astype(np.uint8)
                           for _ in range(n)]
    return out


def copied(results):
    return copy.deepcopy(results)


def assert_same(got, want):
    """Equal results, bit for bit and dtype for dtype (None for None)."""
    if want is None:
        assert got is None
        return
    assert got is not None
    for key in RESULT_KEYS:
        assert (key in got) == (key in want), key
        if key not in want:
            continue
        g, w = got[key], want[key]
        if isinstance(w, list):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype, key
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=key)
            assert g.dtype == w.dtype, key
        else:
            assert tuple(g) == tuple(w), key


def hold_over_seeds(j_fn, fn, make, seeds=SEEDS):
    """Each seed: the JAX transform and the port's on copies of `make(seed)`
    from the same `np.random` state; equal results and equal next draws.
    Returns how many seeds changed the image."""
    changed = 0
    for seed in seeds:
        inp = make(seed)
        np.random.seed(seed)
        want = j_fn(copied(inp))
        want_next = np.random.rand()
        np.random.seed(seed)
        got = fn(copied(inp))
        assert np.random.rand() == want_next, f'draw count, seed {seed}'
        assert_same(got, want)
        changed += want is None or want['img'].shape != inp['img'].shape \
            or not np.array_equal(want['img'], inp['img'])
    return changed


def both(name, **kw):
    """The JAX and the port transform `name` built from the same config."""
    cfg = dict(type=name, **kw)
    return (j_tf.Compose([dict(cfg)]).transforms[0],
            tf.Compose([dict(cfg)]).transforms[0])


# name -> (type, kwargs, sample kwargs)
TRANSFORMS = {
    'photometric_uint8': ('PhotoMetricDistortion', {}, {}),
    'photometric_float32': ('PhotoMetricDistortion', {},
                            dict(dtype=np.float32)),
    'crop_absolute': ('RandomCrop', dict(crop_size=(30, 40)),
                      dict(masks=True)),
    'crop_absolute_range': ('RandomCrop', dict(
        crop_size=(20, 40), crop_type='absolute_range'), dict(masks=True)),
    'crop_relative': ('RandomCrop', dict(crop_size=(0.5, 0.7),
                                         crop_type='relative'),
                      dict(masks=True)),
    'crop_relative_range': ('RandomCrop', dict(
        crop_size=(0.3, 0.6), crop_type='relative_range'), dict(masks=True)),
    'crop_negative': ('RandomCrop', dict(crop_size=(12, 12),
                                         allow_negative_crop=True),
                      dict(n=1, masks=True)),
    'expand_uint8': ('Expand', dict(mean=NORM['mean'], ratio_range=(1, 4)),
                     {}),
    'expand_float32': ('Expand', dict(mean=NORM['mean'], to_rgb=True,
                                      ratio_range=(1, 3), prob=0.7),
                       dict(dtype=np.float32)),
    'min_iou_crop': ('MinIoURandomCrop', {}, {}),
    'cutout_ratio': ('CutOut', dict(n_holes=(1, 4),
                                    cutout_ratio=(0.2, 0.3)), {}),
    'cutout_shape': ('CutOut', dict(n_holes=3, cutout_shape=(8, 10),
                                    fill_in=(7, 8, 9)), {}),
    'center_crop_pad': ('RandomCenterCropPad', dict(
        crop_size=(64, 64), ratios=(0.6, 0.8, 1.0), border=32, **NORM), {}),
    'center_crop_pad_large': ('RandomCenterCropPad', dict(
        crop_size=(48, 48), ratios=(0.9, 1.1), border=128, **NORM),
        dict(hw=(90, 120))),
    'center_pad_logical_or': ('RandomCenterCropPad', dict(
        test_mode=True, crop_size=None, ratios=None, border=None,
        test_pad_mode=('logical_or', 31), **NORM), {}),
    'center_pad_divisor': ('RandomCenterCropPad', dict(
        test_mode=True, crop_size=None, ratios=None, border=None,
        test_pad_mode=('size_divisor', 32), to_rgb=False,
        mean=NORM['mean'], std=NORM['std']), dict(hw=(45, 70))),
    'shear_h': ('Shear', dict(level=6, prob=0.7), {}),
    'shear_v': ('Shear', dict(level=8, prob=0.7, direction='vertical'), {}),
    'rotate': ('Rotate', dict(level=7, prob=0.7, max_rotate_angle=40), {}),
    'translate_h': ('Translate', dict(level=4, prob=0.7,
                                      max_translate_offset=60.), {}),
    'translate_v': ('Translate', dict(level=5, prob=0.7,
                                      direction='vertical',
                                      max_translate_offset=40.), {}),
    'color': ('ColorTransform', dict(kind='color', level=6, prob=0.7), {}),
    'brightness': ('ColorTransform', dict(kind='brightness', level=6,
                                          prob=0.7), {}),
    'contrast': ('ColorTransform', dict(kind='contrast', level=6, prob=0.7),
                 dict(dtype=np.float32)),
    'equalize': ('ColorTransform', dict(kind='equalize', prob=0.7), {}),
    'auto_augment': ('AutoAugment', dict(policies=[
        [dict(type='Shear', level=4, prob=0.8),
         dict(type='ColorTransform', kind='color', level=3, prob=0.6)],
        [dict(type='Rotate', level=5, prob=0.9)],
        [dict(type='Translate', level=6, prob=0.5, direction='vertical',
              max_translate_offset=50.),
         dict(type='ColorTransform', kind='equalize', prob=0.5)]]), {}),
}


@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_transform_matches_jax_over_seeds(name):
    kind, kw, sample_kw = TRANSFORMS[name]
    j_t, t = both(kind, **copy.deepcopy(kw))
    changed = hold_over_seeds(j_t, t, lambda s: sample(s, **sample_kw))
    assert changed > 0


def test_wider_face_chain_matches_jax_over_seeds():
    """PhotoMetricDistortion -> Expand -> MinIoURandomCrop -> RandomFlip on
    a float32 image, as configs/_base_/datasets/wider_face.py runs them."""
    cfgs = [dict(type='PhotoMetricDistortion'),
            dict(type='Expand', mean=NORM['mean'], to_rgb=True,
                 ratio_range=(1, 4)),
            dict(type='MinIoURandomCrop', min_ious=(0.1, 0.3, 0.5, 0.7,
                                                    0.9), min_crop_size=0.3),
            dict(type='RandomFlip', flip_ratio=0.5)]
    hold_over_seeds(j_tf.Compose(copy.deepcopy(cfgs)),
                    tf.Compose(copy.deepcopy(cfgs)),
                    lambda s: sample(s, dtype=np.float32))


@pytest.mark.parametrize('name', sorted(corruptions.CORRUPTIONS))
def test_corruption_matches_jax_over_seeds(name):
    assert sorted(corruptions.CORRUPTIONS) == sorted(j_corr.CORRUPTIONS)
    for seed in SEEDS:
        severity = seed % 5 + 1
        j_t = j_corr.Corrupt(name, severity)
        t = corruptions.Corrupt(name, severity)
        dtype = np.float32 if seed % 4 == 3 else np.uint8
        hold_over_seeds(j_t, t, lambda s: sample(s, hw=(40, 52),
                                                 dtype=dtype), [seed])
    with pytest.raises(ValueError):
        corruptions.Corrupt(name, 6)


def test_seg_rescale_matches_jax():
    rs = np.random.RandomState(0)
    seg = rs.randint(0, 9, (37, 53)).astype(np.uint8)
    for factor in (1, 0.125, 0.5, 2):
        j_t, t = both('SegRescale', scale_factor=factor)
        assert_same(t(dict(gt_semantic_seg=seg.copy())),
                    j_t(dict(gt_semantic_seg=seg.copy())))


def test_load_proposals_matches_jax():
    rs = np.random.RandomState(0)
    for proposals, cap in ((rs.rand(7, 5) * 50, None), (rs.rand(9, 4), 4),
                           (np.zeros((0, 5)), None), (rs.rand(3, 5), 0)):
        j_t, t = both('LoadProposals', num_max_proposals=cap)
        want = j_t(dict(proposals=proposals))
        got = t(dict(proposals=proposals))
        assert_same(got, want)
        assert got['proposals'].shape[1] == 4 and len(got['proposals']) >= 1
    with pytest.raises(ValueError):
        t(dict(proposals=rs.rand(3, 6)))


@pytest.mark.parametrize('kind', ['Albu', 'InstaBoost'])
def test_optional_packages_raise_import_error(kind):
    kw = dict(transforms=[dict(type='Blur')]) if kind == 'Albu' else {}
    for compose in (j_tf.Compose, tf.Compose):
        with pytest.raises(ImportError, match=kind):
            compose([dict(type=kind, **kw)])


def test_proposal_file_is_a_type_error_in_both(tmp_path):
    """ROADMAP.md caveat 41: neither CocoDataset takes a proposal_file."""
    ann_file, prefix = write_coco_instances(str(tmp_path), 2,
                                            sizes=((64, 80), ))
    for cls in (JCocoDataset, CocoDataset):
        with pytest.raises(TypeError, match='proposal_file'):
            cls(ann_file, [], img_prefix=prefix,
                proposal_file=str(tmp_path / 'proposals.pkl'))


# ---- datasets --------------------------------------------------------------
def write_coco_json(root, classes, num_images=4, seed=0,
                    sizes=((64, 80), (80, 64))):
    """A COCO-format set of `classes` (and one category of another name)
    with polygon gts, one crowd and one gt too thin to keep; PNG images.
    Returns (ann_file, img_prefix)."""
    import cv2
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, 'img'), exist_ok=True)
    cats = [dict(id=10 + 3 * i, name=n) for i, n in enumerate(classes)]
    cats.append(dict(id=7, name='not_a_class'))
    images, anns = [], []
    for i in range(num_images):
        h, w = sizes[i % len(sizes)]
        name = f'{i:04d}.png'
        cv2.imwrite(os.path.join(root, 'img', name),
                    rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        for j in range(4):
            x, y = rs.uniform(0, w * 0.5), rs.uniform(0, h * 0.5)
            bw, bh = rs.uniform(4, w * 0.4), rs.uniform(4, h * 0.4)
            if j == 3:
                bw = 0.5
            cat = cats[rs.randint(len(cats))]['id']
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=cat,
                bbox=[x, y, bw, bh], area=bw * bh, iscrowd=int(j == 2),
                segmentation=[[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]))
    ann_file = os.path.join(root, 'ann.json')
    with open(ann_file, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return ann_file, os.path.join(root, 'img') + os.sep


def write_wider(root, ids, seed=0):
    """WIDER-Face XMLs whose <folder> names each image's event directory,
    the images there, and the split file. Returns (ann_file, prefix)."""
    import cv2
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, 'Annotations'), exist_ok=True)
    for k, img_id in enumerate(ids):
        folder = f'{k % 2}--Event'
        h, w = (60, 80) if k % 2 else (80, 60)
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        cv2.imwrite(os.path.join(root, folder, f'{img_id}.jpg'),
                    rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        ann = ET.Element('annotation')
        ET.SubElement(ann, 'folder').text = folder
        size = ET.SubElement(ann, 'size')
        ET.SubElement(size, 'width').text = str(w)
        ET.SubElement(size, 'height').text = str(h)
        for j in range(3):
            obj = ET.SubElement(ann, 'object')
            ET.SubElement(obj, 'name').text = 'face'
            ET.SubElement(obj, 'difficult').text = str(int(j == 2))
            box = ET.SubElement(obj, 'bndbox')
            x1, y1 = rs.randint(1, w // 2), rs.randint(1, h // 2)
            for key, v in (('xmin', x1), ('ymin', y1),
                           ('xmax', x1 + rs.randint(5, w // 2)),
                           ('ymax', y1 + rs.randint(5, h // 2))):
                ET.SubElement(box, key).text = str(v)
        ET.ElementTree(ann).write(os.path.join(root, 'Annotations',
                                               f'{img_id}.xml'))
    ann_file = os.path.join(root, 'val.txt')
    with open(ann_file, 'w') as f:
        f.write('\n'.join(ids) + '\n')
    return ann_file, root + os.sep


def assert_same_dataset(got, want):
    assert tuple(got.CLASSES) == tuple(want.CLASSES)
    assert len(got) == len(want) > 0
    assert got.img_infos == want.img_infos
    np.testing.assert_array_equal(got.flag, want.flag)
    for attr in ('cat_id_to_label', 'label_to_cat_id'):
        assert getattr(got, attr, None) == getattr(want, attr, None)
    for g, w in zip(got.annotations, want.annotations):
        assert sorted(g) == sorted(w)
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(g[key], value)
                assert g[key].dtype == value.dtype
            else:
                assert g[key] == value, key


LOAD = [dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations', with_bbox=True, with_mask=True)]


def dataset_cases(tmp):
    """name -> (JAX class, port class, args, kwargs) over files in `tmp`."""
    cases = {}
    ann, prefix = write_lvis_instances(os.path.join(tmp, 'lvis'), 4,
                                       sizes=((60, 80), (80, 60)),
                                       num_classes=40)
    for name in ('LVISV1Dataset', 'LVISDataset'):
        cases[name] = (J_DATASETS.get(name), lvis.LVISV1Dataset,
                       (ann, LOAD), dict(img_prefix=prefix))
    for cls, j_cls in ((extra.CityscapesDataset, j_extra.CityscapesDataset),
                       (extra.DeepFashionDataset,
                        j_extra.DeepFashionDataset)):
        ann, prefix = write_coco_json(os.path.join(tmp, cls.__name__),
                                      cls.CLASSES)
        cases[cls.__name__] = (j_cls, cls, (ann, LOAD),
                               dict(img_prefix=prefix))
    ann, prefix = write_wider(os.path.join(tmp, 'wider'),
                              ['0_Event_1', '1_Event_2', '0_Event_3'])
    cases['WIDERFaceDataset'] = (j_extra.WIDERFaceDataset,
                                 extra.WIDERFaceDataset, (ann, LOAD[:1] + [
                                     dict(type='LoadAnnotations')]),
                                 dict(img_prefix=prefix, min_size=17))
    return cases


DATASET_NAMES = ('LVISV1Dataset', 'LVISDataset', 'CityscapesDataset',
                 'DeepFashionDataset', 'WIDERFaceDataset')


@pytest.fixture(scope='module')
def dataset_files(tmp_path_factory):
    return dataset_cases(str(tmp_path_factory.mktemp('datasets')))


@pytest.mark.parametrize('name', DATASET_NAMES)
def test_dataset_matches_jax(dataset_files, name):
    j_cls, cls, args, kw = dataset_files[name]
    from ld_tpu_torch.utils.registry import DATASETS
    assert DATASETS.get(name) is cls
    for test_mode in (False, True):
        want = j_cls(*args, test_mode=test_mode, **kw)
        got = cls(*args, test_mode=test_mode, **kw)
        assert_same_dataset(got, want)
        for i in range(len(want)):
            np.random.seed(i)
            w = want[i]
            np.random.seed(i)
            assert_same(got[i], w)
    if name.startswith('LVIS'):
        info = got.img_infos[0]
        assert '/' in info['filename'] and info['neg_category_ids']
        assert len(got.CLASSES) == 40
        assert list(got.cat_id_to_label) == sorted(got.cat_id_to_label)
    if name == 'WIDERFaceDataset':
        assert got.img_infos[1]['filename'].startswith('1--Event')


# ---- configs ---------------------------------------------------------------
DATA_CONFIGS = sorted(
    glob.glob(os.path.join(ROOT, 'configs/lvis/*.py')) +
    glob.glob(os.path.join(ROOT, 'configs/cityscapes/*.py')) +
    glob.glob(os.path.join(ROOT, 'configs/deepfashion/*.py')) +
    glob.glob(os.path.join(ROOT, 'configs/fpg/*crop640*.py')))


def pointed(split, ann_file, prefix):
    """A dataset config (through its wrappers) reading `ann_file`."""
    split = copy.deepcopy(dict(split))
    node = split
    while 'dataset' in node:
        node = node['dataset']
    node.update(ann_file=ann_file, img_prefix=prefix)
    return split


@pytest.fixture(scope='module')
def config_files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('config_data'))
    sizes = ((64, 80), (80, 64))
    return dict(
        lvis=write_lvis_instances(os.path.join(tmp, 'lvis'), 3, sizes=sizes),
        cityscapes=write_coco_json(os.path.join(tmp, 'cityscapes'),
                                   extra.CityscapesDataset.CLASSES),
        deepfashion=write_coco_json(os.path.join(tmp, 'deepfashion'),
                                    extra.DeepFashionDataset.CLASSES),
        fpg=write_coco_json(os.path.join(tmp, 'coco'), COCO_CLASSES))


def first_samples(build, cfg, files):
    out = []
    for split in ('train', 'test'):
        ds = build(pointed(cfg.data[split], *files))
        assert len(ds) > 0
        np.random.seed(3)
        out.append(ds[0])
    return out


@pytest.mark.parametrize('path', DATA_CONFIGS, ids=os.path.basename)
def test_config_data_builds(config_files, path):
    files = config_files[os.path.basename(os.path.dirname(path))]
    got = first_samples(build_dataset, Config.fromfile(path), files)
    j_cfg = JConfig.fromfile(path)
    crop640 = 'crop640' in path and 'retinanet' not in path
    if crop640:
        # the JAX FusedPreprocess takes no keep_ratio (caveat 46)
        with pytest.raises(TypeError, match='keep_ratio'):
            first_samples(lambda c: J_DATASETS.build(dict(c)), j_cfg, files)
        assert [s['img'].shape for s in got] == [(640, 640, 3)] * 2
        return
    want = first_samples(lambda c: J_DATASETS.build(dict(c)), j_cfg, files)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert_same(g, w)


# ---- the robustness tools ----------------------------------------------------
def load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_robustness_tools(tmp_path):
    ann_file, prefix = write_coco_instances(str(tmp_path), 3,
                                            sizes=((64, 96), ))
    cfg_file = tmp_path / 'gfl_r18.py'
    cfg_file.write_text(f"""
_base_ = '{ROOT}/configs/gfl/gfl_r50_fpn_1x_coco.py'
dtype = 'float32'
model = dict(backbone=dict(depth=18),
             neck=dict(in_channels=[64, 128, 256, 512], out_channels=64),
             bbox_head=dict(in_channels=64, feat_channels=64))
pad_to = [(64, 96)]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='FusedPreprocess', img_scale=(96, 64), size_divisor=32),
    dict(type='Collect', keys=['img'])]
data = dict(test=dict(ann_file='{ann_file}', img_prefix='{prefix}',
                      pipeline=test_pipeline))
""")
    tool = load_script(os.path.join(
        ROOT, 'ld_tpu_torch/tools/analysis_tools/test_robustness.py'),
        'port_test_robustness')
    out = tmp_path / 'robustness.json'
    res = tool.main([str(cfg_file), '--corruptions', 'gaussian_noise',
                     'jpeg_compression', '--severities', '3', '--device',
                     'cpu', '--out', str(out)])
    with open(out) as f:
        written = json.load(f)
    assert sorted(written) == ['gaussian_noise', 'jpeg_compression']
    assert sorted(written['gaussian_noise']) == ['0', '3']
    # the clean run is every corruption's severity 0 (NaN where a range
    # holds no gt)
    assert json.dumps(written['gaussian_noise']['0'], sort_keys=True) == \
        json.dumps(res['results']['jpeg_compression'][0], sort_keys=True)
    assert 'bbox_mAP' in written['jpeg_compression']['3']
    # the summary against the JAX tool's, on the same json
    port_eval = load_script(os.path.join(
        ROOT, 'ld_tpu_torch/tools/analysis_tools/robustness_eval.py'),
        'port_robustness_eval')
    jax_eval = load_script(os.path.join(
        ROOT, 'tools/analysis_tools/robustness_eval.py'),
        'jax_robustness_eval')
    for aggregate in ('benchmark', 'all'):
        got = port_eval.summarize(written, aggregate=aggregate)
        want = jax_eval.summarize(written, aggregate=aggregate)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    assert abs(float(got[2][got[0].index('bbox_mAP')]) -
               res['summary']['mPC']) < 1e-6
    printed = port_eval.main([str(out), '--metric', 'bbox_mAP'])
    assert printed['metrics'] == ['bbox_mAP']
