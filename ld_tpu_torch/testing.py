"""Seeded inputs for checking the port: NMS edge sets and detection batches.

The edge sets of the greedy-NMS kernel's block-wise sweep: boxes that are
all equal, all disjoint or all invalid, suppression chains with invalid
boxes inside, chains laid across the 64-box boundaries, and sets where few
or most boxes are kept. The CPU tests hold `nms_keep_ref` on them against
the JAX package, the `cuda` tests and `chip_smoke.py` hold the kernel
against `nms_keep_ref`.

`detection_batch` is a synthetic training batch: the layout of the data
layer's padded batches (100 gt slots per image), with the valid gts of
varied size and class. The CPU tests and `chip_smoke.py`'s train phase take
their batches from it. Needs numpy and torch only.

`randomize_dcn_offsets` gives every DCN layer of a model seeded non-zero
offsets and masks: with `conv_offset` at its zero init a DCN layer is half
a plain conv, and a check of it would see neither the offset layout nor the
bilinear sample.

`write_voc_devkit` writes a seeded synthetic PASCAL VOC devkit (XML
annotations, JPEGs, split files) that VOC configs read through their
`data_root`; `write_coco_instances` a seeded COCO-format instance set
(polygon objects, RLE crowds, PNGs) for the mask path. Both need cv2 to
write the images.

`spawn` runs a function in R spawned processes joined in a process group
over a FileStore (no port to clash over), with one intra-op thread each;
the rank-side checks of data parallelism live here
(`loader_batches_rank`, `head_losses_rank`, `ld_step_rank`, `step_rank`,
`train_eval_rank`), so that a spawned child imports the port alone, never
a test module.
"""
import os
import time

import numpy as np
import torch

from ld_tpu_torch.data.voc import VOC_CLASSES

NMS_SETS = ('identical', 'disjoint', 'invalid', 'chain_invalid',
            'boundary_chain', 'sparse_kept', 'dense_kept')
# (K, B) checked on the card: each side of the 64-box blocks, K = 512 (the GI
# path) and 1024 (multiclass_nms), runs longer than the sweep's staging
# window (K > 2048), K = 4819 and 8819, the RPN proposals' candidates at
# 800x1344 (nms_pre 1000 and 2000 on four levels, and P6's 819 anchors), and
# K = 16800, the anchor count of stride 8 at 800x1344 (exact GI mode,
# gi_candidates >= the level's anchors)
NMS_CHECK_KB = (*[(k, b) for k in (1, 8, 63, 64, 65, 127, 128, 512, 1000,
                                   1024, 2048, 4100, 8192)
                  for b in (1, 3, 8)], (4819, 1), (4819, 2), (8819, 1),
                (16800, 1))


def nms_set(name, k, seed=0):
    """One image of a hand-made NMS set: score-sorted boxes (k, 4) float32,
    valid (k,) bool, and the greedy keep mask at IoU thresholds 0.5 and 0.6
    where the construction fixes it (else None).

    Two boxes 10 px wide and tall, the second shifted 2 px, overlap at IoU
    80/120 = 0.67; shifted 4 px, at 60/140 = 0.43. A 10x10 box A holding
    B (10x7) holding C (7x7) gives IoU(A, B) = IoU(B, C) = 0.7 and
    IoU(A, C) = 0.49. Boxes on a 20 px grid do not overlap at all.
    """
    rng = np.random.RandomState(seed)
    idx = np.arange(k)
    grid = np.stack([idx % 128 * 20.0, idx // 128 * 20.0], -1)
    side = np.full((k, 2), 10.0)
    valid = np.ones(k, bool)
    want = None
    if name == 'identical':       # only the first of k equal boxes is kept
        grid[:] = (30.0, 40.0)
        want = idx == 0
    elif name == 'disjoint':      # nothing overlaps: all kept
        want = valid.copy()
    elif name == 'invalid':       # all overlap, none valid: none kept
        grid = rng.uniform(0, 8, (k, 2))
        valid[:] = False
        want = valid.copy()
    elif name == 'chain_invalid':
        # chains of 150 boxes, each 2 px right of the one before, so greedy
        # keeps every other valid box; every 7th box is invalid, neither
        # kept nor suppressing, and restarts the alternation. Each chain
        # crosses two or three 64-box boundaries.
        grid = np.stack([idx % 150 * 2.0, idx // 150 * 20.0], -1)
        valid = idx % 7 != 3
        want = np.zeros(k, bool)
        for j in idx:
            want[j] = valid[j] and not (j % 150 and want[j - 1])
    elif name == 'boundary_chain':
        # disjoint boxes, except that boxes 64m-1, 64m, 64m+1 are A, B, C
        # nested at A's place: box 63 of a block suppresses box 0 of the
        # next, which would have suppressed box 1. Greedy keeps A and C.
        want = valid.copy()
        for a in range(63, k - 2, 64):
            grid[a + 1] = grid[a + 2] = grid[a]
            side[a + 1] = (10.0, 7.0)
            side[a + 2] = (7.0, 7.0)
            want[a + 1] = False
    elif name == 'sparse_kept':   # few heavily overlapping clusters
        centers = rng.uniform(0, 400, (k // 128 + 1, 2))
        grid = centers[rng.randint(0, len(centers), k)] + rng.normal(0, 3,
                                                                    (k, 2))
        side = rng.uniform(40, 60, (k, 2))
        valid = rng.uniform(size=k) > 0.1
    elif name == 'dense_kept':
        # clustered boxes, class-offset as multiclass_nms builds them (80
        # classes, offset 4096), ~10% invalid: most are kept
        centers = rng.uniform(0, 1200, (max(k // 8, 1), 2))
        grid = centers[rng.randint(0, len(centers), k)] + rng.normal(0, 8,
                                                                    (k, 2))
        side = rng.uniform(10, 160, (k, 2))
        grid += rng.randint(0, 80, (k, 1)) * 4096.0
        valid = rng.uniform(size=k) > 0.1
    else:
        raise ValueError(name)
    boxes = np.concatenate([grid, grid + side], -1).astype(np.float32)
    return boxes, valid, want


def nms_batch(name, b, k, seed=0, device='cuda'):
    """`nms_set` for b images (seeds seed*100 + i) as (B, K, 4) / (B, K)
    tensors on `device`, and the (B, K) keep mask where it is fixed."""
    sets = [nms_set(name, k, seed * 100 + i) for i in range(b)]
    want = None if sets[0][2] is None else torch.from_numpy(
        np.stack([s[2] for s in sets]))
    return (torch.from_numpy(np.stack([s[0] for s in sets])).to(device),
            torch.from_numpy(np.stack([s[1] for s in sets])).to(device), want)


def detection_batch_np(b, h, w, num_classes=80, max_gts=100, seed=0):
    """A synthetic padded detection batch as numpy arrays, NCHW.

    image (B, 3, H, W) float32, normal noise (a normalised image);
    img_hw (B, 2) float32, each image's size inside the (H, W) pad, 75-100%
    of it per side; gt_bboxes (B, max_gts, 4) float32 xyxy inside the
    image, gt_labels (B, max_gts) int64, gt_valid (B, max_gts) bool. Each
    image has 4-24 valid gts of classes drawn from num_classes, sides
    log-uniform from 8 px to 60% of the image's shorter side, aspect ratios
    from 1:2 to 2:1; the rest are zero padding.
    """
    rs = np.random.RandomState(seed)
    image = rs.randn(b, 3, h, w).astype(np.float32)
    img_hw = np.zeros((b, 2), np.float32)
    gt = np.zeros((b, max_gts, 4), np.float32)
    labels = np.zeros((b, max_gts), np.int64)
    valid = np.zeros((b, max_gts), bool)
    for i in range(b):
        ih = rs.randint(int(h * 0.75), h + 1)
        iw = rs.randint(int(w * 0.75), w + 1)
        img_hw[i] = ih, iw
        n = min(rs.randint(4, 25), max_gts)
        side = np.exp(rs.uniform(np.log(8.0), np.log(0.6 * min(ih, iw)), n))
        aspect = np.exp(rs.uniform(-0.7, 0.7, n))
        bw = np.minimum(side * aspect, iw)
        bh = np.minimum(side / aspect, ih)
        cx = rs.uniform(bw / 2, iw - bw / 2)
        cy = rs.uniform(bh / 2, ih - bh / 2)
        gt[i, :n] = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                              cy + bh / 2], -1)
        labels[i, :n] = rs.randint(0, num_classes, n)
        valid[i, :n] = True
    return dict(image=image, gt_bboxes=gt, gt_labels=labels, gt_valid=valid,
                img_hw=img_hw)


def detection_batch(b, h, w, num_classes=80, max_gts=100, seed=0,
                    device='cuda'):
    """`detection_batch_np` as torch tensors on `device`."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in detection_batch_np(b, h, w, num_classes, max_gts,
                                           seed).items()}


def randomize_dcn_offsets(model, seed=0, shift=2.0):
    """Seeded normal `conv_offset` weights and biases for every
    `ModulatedDeformConv2d` of `model`, in place: weights of std
    shift / sqrt(fan_in), so that on unit-scale inputs the taps move by
    about `shift` pixels and some fall off the map, and biases of std 1
    (offsets and mask logits). Returns the number of layers."""
    from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
    rs = np.random.RandomState(seed)
    layers = [m for m in model.modules()
              if isinstance(m, ModulatedDeformConv2d)]
    with torch.no_grad():
        for m in layers:
            w, b = m.conv_offset.weight, m.conv_offset.bias
            std = shift / np.sqrt(w[0].numel())
            w.copy_(torch.from_numpy(
                (rs.randn(*w.shape) * std).astype(np.float32)))
            b.copy_(torch.from_numpy(rs.randn(*b.shape).astype(np.float32)))
    return len(layers)


def randomize_head_offsets(model, seed=0, shift=2.0):
    """Seeded normal weights (std shift / sqrt(fan_in)) and biases (std 1)
    for the convs whose outputs place a dense head's DeformConv taps, in
    place: GA's `feature_adaption_*.conv_offset` and RepPoints'
    `reppoints_pts_init_out`, which start at zero or near it, so that the
    taps fall a few pixels off the regular grid. Returns the number of
    convs."""
    rs = np.random.RandomState(seed)
    convs = [m.conv_offset for name, m in model.named_modules()
             if name.rsplit('.', 1)[-1].startswith('feature_adaption')]
    convs += [m for name, m in model.named_modules()
              if name.rsplit('.', 1)[-1] == 'reppoints_pts_init_out']
    with torch.no_grad():
        for conv in convs:
            w, b = conv.weight, conv.bias
            w.copy_(torch.from_numpy((rs.randn(*w.shape) * shift /
                                      np.sqrt(w[0].numel())).astype(
                                          np.float32)))
            b.copy_(torch.from_numpy(rs.randn(*b.shape).astype(np.float32)))
    return len(convs)


def randomize_plugin_gates(model, seed=0, scale=1.0):
    """Seeded values for the parts of `model`'s backbone plugins that start
    at zero (the JAX initializers make each block the identity), in place:
    each `ContextBlock` fusion's last conv weights of std scale /
    sqrt(fan_in), and each `GeneralizedAttention`'s `gamma` at `scale`, so
    that the plugins change a random model's outputs. Returns the number
    of plugins."""
    from ld_tpu_torch.models.backbones.plugins import (ContextBlock,
                                                       GeneralizedAttention)
    rs = np.random.RandomState(seed)
    blocks = [m for m in model.modules()
              if isinstance(m, (ContextBlock, GeneralizedAttention))]
    with torch.no_grad():
        for m in blocks:
            if isinstance(m, GeneralizedAttention):
                m.gamma.fill_(scale)
                continue
            for fusion in m.fusion_types:
                w = getattr(m, f'{fusion}_conv')[3].weight
                w.copy_(torch.from_numpy((rs.randn(*w.shape) * scale /
                                          np.sqrt(w[0].numel()))
                                         .astype(np.float32)))
    return len(blocks)


def _voc_xml(img_id, folder, w, h, objects):
    lines = ['<annotation>', f'  <folder>{folder}</folder>',
             f'  <filename>{img_id}.jpg</filename>',
             f'  <size><width>{w}</width><height>{h}</height>'
             '<depth>3</depth></size>']
    for name, difficult, (x1, y1, x2, y2) in objects:
        lines += ['  <object>', f'    <name>{name}</name>',
                  f'    <difficult>{difficult}</difficult>',
                  f'    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>'
                  f'<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>',
                  '  </object>']
    return '\n'.join(lines + ['</annotation>', ''])


def write_voc_devkit(root, splits, seed=0, sizes=((375, 500), (500, 375)),
                     max_objects=4, difficult_share=0.2):
    """A seeded synthetic VOC devkit under `root`.

    splits: {year folder: {split: image count}}, e.g. {'VOC2007':
    {'trainval': 6, 'test': 8}, 'VOC2012': {'trainval': 6}}. Ids follow
    VOC's forms: '000001', ... in VOC2007 and '2008_000001', ... in the
    other years. Image sizes (h, w) alternate over `sizes` (VOC's 375x500
    landscape and 500x375 portrait by default). Each image holds 1 to
    `max_objects` objects of the 20 classes, 1-based corners, at least
    24 px a side, each painted in a colour of its class over a dim noise
    background; each but the first is `difficult` with probability
    `difficult_share`.
    Writes Annotations/<id>.xml, JPEGImages/<id>.jpg and
    ImageSets/Main/<split>.txt per year; returns {(year, split): ids}.
    """
    from ld_tpu_torch.data.transforms import _cv2
    cv2 = _cv2()
    rs = np.random.RandomState(seed)
    written = {}
    count = 0
    for year, year_splits in splits.items():
        for sub in ('Annotations', 'JPEGImages', 'ImageSets/Main'):
            os.makedirs(os.path.join(root, year, sub), exist_ok=True)
        for split, n in year_splits.items():
            ids = []
            for _ in range(n):
                count += 1
                img_id = f'{count:06d}' if year == 'VOC2007' \
                    else f'2008_{count:06d}'
                h, w = sizes[count % len(sizes)]
                img = (rs.randint(0, 256, (h, w, 3)) // 4).astype(np.uint8)
                objects = []
                for j in range(rs.randint(1, max_objects + 1)):
                    bw = rs.randint(24, w // 2)
                    bh = rs.randint(24, h // 2)
                    x1 = rs.randint(1, w - bw)
                    y1 = rs.randint(1, h - bh)
                    label = rs.randint(len(VOC_CLASSES))
                    color = np.random.RandomState(label + 1).randint(100, 256,
                                                                     3)
                    img[y1 - 1:y1 - 1 + bh, x1 - 1:x1 - 1 + bw] = color
                    objects.append((VOC_CLASSES[label],
                                    int(j > 0 and
                                        rs.uniform() < difficult_share),
                                    (x1, y1, x1 + bw, y1 + bh)))
                with open(os.path.join(root, year, 'Annotations',
                                       f'{img_id}.xml'), 'w') as f:
                    f.write(_voc_xml(img_id, year, w, h, objects))
                cv2.imwrite(os.path.join(root, year, 'JPEGImages',
                                         f'{img_id}.jpg'), img)
                ids.append(img_id)
            with open(os.path.join(root, year, 'ImageSets', 'Main',
                                   f'{split}.txt'), 'w') as f:
                f.write('\n'.join(ids) + '\n')
            written[(year, split)] = ids
    return written


def _polygon(rs, cx, cy, radius, n):
    """A star-shaped polygon of n vertices around (cx, cy), flat xy."""
    ang = np.sort(rs.uniform(0, 2 * np.pi, n))
    r = radius * rs.uniform(0.45, 1.0, n)
    return np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                    -1).reshape(-1)


def _poly_area(flat):
    x, y = flat[0::2], flat[1::2]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) -
                           np.dot(y, np.roll(x, -1))))


def write_coco_instances(root, num_images=8, sizes=((480, 640), ),
                         num_classes=80, seed=0, max_objects=4):
    """A seeded COCO-format instance set under `root`: PNG images (dim
    noise, each object painted in a colour of its class) and
    `instances.json`. Image i has size sizes[i % len(sizes)] (h, w) and 1
    to `max_objects` objects of the first `num_classes` COCO classes, each
    a star-shaped polygon (6-10 vertices; the first object of every third
    image is two polygons), its bbox the polygon's bounds and its area the
    polygon's; every second image also holds a crowd whose segmentation is
    an RLE of a box region (compressed on odd images of those, else
    uncompressed). Returns (ann_file, img_prefix)."""
    from ld_tpu_torch.data.coco import COCO_CLASSES
    from ld_tpu_torch.data.transforms import _cv2
    from ld_tpu_torch.evaluation.segm_eval import rle_encode
    cv2 = _cv2()
    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []

    def add(img_id, label, bbox, area, seg, crowd=0):
        anns.append(dict(id=len(anns) + 1, image_id=img_id,
                         category_id=label + 1, bbox=bbox, area=area,
                         segmentation=seg, iscrowd=crowd))
    for i in range(num_images):
        h, w = sizes[i % len(sizes)]
        img = (rs.randint(0, 256, (h, w, 3)) // 4).astype(np.uint8)
        for j in range(rs.randint(1, max_objects + 1)):
            label = int(rs.randint(num_classes))
            radius = rs.uniform(0.08, 0.3) * min(h, w)
            cx = rs.uniform(radius, w - radius)
            cy = rs.uniform(radius, h - radius)
            polys = [_polygon(rs, cx, cy, radius, rs.randint(6, 11))]
            if j == 0 and i % 3 == 0:
                polys.append(_polygon(rs, cx + radius * 0.6, cy,
                                      radius * 0.5, 6))
            color = np.random.RandomState(label + 1).randint(100, 256, 3)
            cv2.fillPoly(img, [np.round(p.reshape(-1, 2)).astype(np.int32)
                               for p in polys], color.tolist())
            pts = np.concatenate([p.reshape(-1, 2) for p in polys])
            x1, y1 = pts.min(0)
            x2, y2 = pts.max(0)
            add(i + 1, label, [float(x1), float(y1), float(x2 - x1),
                               float(y2 - y1)],
                sum(_poly_area(p) for p in polys),
                [[float(v) for v in p] for p in polys])
        if i % 2 == 1:
            bw, bh = int(w * 0.3), int(h * 0.25)
            x1, y1 = int(rs.randint(0, w - bw)), int(rs.randint(0, h - bh))
            region = np.zeros((h, w), np.uint8)
            region[y1:y1 + bh, x1:x1 + bw] = 1
            rle = rle_encode(region)
            if i % 4 == 1:
                counts = [int(c) for c in np.diff(np.concatenate([
                    [0], np.flatnonzero(np.diff(region.flatten('F'))) + 1,
                    [h * w]]))]
                if region[0, 0]:
                    counts = [0] + counts
                rle = dict(size=[h, w], counts=counts)
            else:
                rle = dict(rle, counts=rle['counts'].decode())
            add(i + 1, int(rs.randint(num_classes)),
                [float(x1), float(y1), float(bw), float(bh)],
                float(bw * bh), rle, crowd=1)
        name = f'{i + 1:06d}.png'
        cv2.imwrite(os.path.join(img_dir, name), img)
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
    ann_file = os.path.join(root, 'instances.json')
    import json
    with open(ann_file, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=c + 1, name=COCO_CLASSES[c])
            for c in range(num_classes)]), f)
    return ann_file, img_dir + os.sep


def write_lvis_instances(root, num_images=8, sizes=((480, 640), ),
                         num_classes=1203, seed=0, max_objects=4,
                         split='train2017'):
    """A seeded LVIS-v1-format instance set under `root`: JPEG images (PIL,
    quality 90; dim noise, each object painted in a colour of its class)
    under `root/<split>/` and `lvis_v1.json`. As in LVIS v1, an image
    carries no `file_name`, only a `coco_url` whose last two parts are
    `<split>/<12-digit id>.jpg`, and its `neg_category_ids` /
    `not_exhaustive_category_ids`; the `num_classes` categories (ids 1 to
    num_classes, names 'lvis_<id>') come in shuffled order. Image i has
    size sizes[i % len(sizes)] (h, w) and 1 to `max_objects` star-shaped
    polygon objects of any class. Returns (ann_file, img_prefix)."""
    import json

    from PIL import Image
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    images, anns = [], []
    for i in range(num_images):
        h, w = sizes[i % len(sizes)]
        img_id = 1000 + 7 * i
        img = (rs.randint(0, 256, (h, w, 3)) // 4).astype(np.uint8)
        for _ in range(rs.randint(1, max_objects + 1)):
            cat = int(rs.randint(num_classes)) + 1
            radius = rs.uniform(0.08, 0.3) * min(h, w)
            cx = rs.uniform(radius, w - radius)
            cy = rs.uniform(radius, h - radius)
            poly = _polygon(rs, cx, cy, radius, rs.randint(6, 11))
            pts = poly.reshape(-1, 2)
            x1, y1 = pts.min(0)
            x2, y2 = pts.max(0)
            color = np.random.RandomState(cat).randint(100, 256, 3)
            # a box-shaped paint of the object is enough to detect it
            img[int(y1):int(y2), int(x1):int(x2)] = color
            anns.append(dict(id=len(anns) + 1, image_id=img_id,
                             category_id=cat,
                             bbox=[float(x1), float(y1), float(x2 - x1),
                                   float(y2 - y1)],
                             area=_poly_area(poly),
                             segmentation=[[float(v) for v in poly]]))
        name = f'{img_id:012d}.jpg'
        Image.fromarray(img[..., ::-1]).save(
            os.path.join(root, split, name), format='JPEG', quality=90)
        images.append(dict(
            id=img_id, height=h, width=w,
            coco_url=f'http://images.cocodataset.org/{split}/{name}',
            neg_category_ids=sorted(int(c) + 1 for c in rs.choice(
                num_classes, 3, replace=False)),
            not_exhaustive_category_ids=[int(rs.randint(num_classes)) + 1]))
    cats = [dict(id=int(c) + 1, name=f'lvis_{c + 1}', frequency='rcf'[c % 3])
            for c in rs.permutation(num_classes)]
    ann_file = os.path.join(root, 'lvis_v1.json')
    with open(ann_file, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return ann_file, root + os.sep


# ---- data parallelism: spawned ranks ----------------------------------------

SPAWN_TIMEOUT_S = 600.0


def spawn(fn, world_size, backend, tmp_dir, device='cpu', args=()):
    """Run `fn(rank, world_size, device, *args)` in `world_size` spawned
    processes, joined in a `backend` process group over a FileStore under
    `tmp_dir` (`parallel.dist.init_dist` from RANK / WORLD_SIZE /
    LOCAL_RANK; with device 'cuda', rank r takes card r % count). Each child
    sets one intra-op thread and this process's TF32 switches. Returns the
    ranks' return values in rank order; a failed rank raises here, and so
    does a run past SPAWN_TIMEOUT_S seconds (its processes are killed)."""
    import torch.multiprocessing as mp
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, 'store')
    if os.path.exists(store):
        os.remove(store)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, backend, tmp_dir, device, tf32,
                          args),
        nprocs=world_size, join=False, start_method='spawn')
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f'{world_size} spawned ranks ran past '
                                   f'{SPAWN_TIMEOUT_S} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(tmp_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(world_size)]


def _rank_main(rank, fn, world_size, backend, tmp_dir, device, tf32, args):
    import torch.distributed as dist
    from ld_tpu_torch.parallel.dist import init_dist
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    device = init_dist('pytorch', backend, device=device,
                       init_method='file://' + os.path.join(tmp_dir, 'store'))
    try:
        out = fn(rank, world_size, device, *args)
        torch.save(out, os.path.join(tmp_dir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def rank_calls(rank, world, device, calls):
    """Each (fn, args) of `calls` as fn(rank, world, device, *args), in
    order: several rank-side checks in one spawn."""
    return [fn(rank, world, device, *args) for fn, args in calls]


def rank_slice(batch_np, rank, world, device):
    """Rank `rank`'s images of a global numpy batch, as tensors."""
    b = len(batch_np['gt_bboxes']) // world
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[rank * b:(rank + 1) * b])).to(device) for k, v in batch_np.items()}


def loader_batches_rank(rank, world, device, dataset_cfg, samples_per_gpu,
                        pad_hw, kwargs, epochs=2):
    """This rank's loader batches, (img_ids, image) numpy each, for
    `epochs` epochs."""
    from ld_tpu_torch.data import build_dataloader, build_dataset
    loader = build_dataloader(build_dataset(dataset_cfg), samples_per_gpu,
                              world, pad_hw, 8, rank=rank, num_workers=0,
                              **kwargs)
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append([(b['img_ids'].copy(), b['image'].copy())
                    for b in loader])
    return out


def head_losses_rank(rank, world, device, cases):
    """The port head's loss dict of each case on this rank's images, as the
    train step logs it (R x the rank's share; the ranks' mean is the
    global batch's loss). A case: dict(head=registry cfg, outs=the
    student's per-part lists of per-level NCHW numpy arrays of the global
    batch, teacher=the same for the teacher, batch=a numpy batch,
    feats=(student, teacher) FPN features, or None)."""
    from ld_tpu_torch.utils.registry import HEADS

    def mine(parts):
        b = len(parts[0][0]) // world
        return tuple([torch.from_numpy(np.ascontiguousarray(
            a[rank * b:(rank + 1) * b])).to(device) for a in part]
            for part in parts)

    out = []
    for case in cases:
        head = HEADS.build(dict(case['head'])).to(device)
        outs = mine(case['outs'])
        kw = {}
        if case.get('feats') is not None:
            feats = mine(case['feats'])
            kw = dict(student_feats=feats[0], teacher_feats=feats[1])
        losses = head.loss(outs, rank_slice(case['batch'], rank, world,
                                            device),
                           [tuple(a.shape[-2:]) for a in outs[0]],
                           mine(case['teacher']), **kw)
        out.append({k: float(v) * world for k, v in losses.items()})
    return out


def ld_step_rank(rank, world, device, cfg, batch_np, steps=1,
                 profile=False):
    """`make_train_step` steps of the LD config `cfg` (float32; student
    from seed 0, teacher from seed 1 with its BNs folded) on this rank's
    images of the global numpy batch `batch_np`. Returns dict(metrics
    (the first step's, as logged), masks (the first step's GI masks of
    this rank's rows, per level), launches (nms_keep kernel launches a
    step), step_ms (host clock, synced, each step), peak_bytes (the card's
    peak) and, on rank 0, params and grads (after the clip) of the first
    step, numpy); the schedule takes 1000 steps an epoch. With `profile`, one more step runs under
    torch.profiler (at R > 1), `collectives` holds its collective ops (name ->
    (calls, host ms); an asynchronous one shows only its enqueue), and
    `allreduce_ms` the host time of all-reducing the student's gradients
    as one flat tensor (`grad_bytes`), the mean of 3, synced."""
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.ops import nms_cuda
    from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                       make_train_step)
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.init_teacher_weights(torch.Generator().manual_seed(1))
    model.fold_teacher_bn()
    model.to(device)
    schedule = build_lr_schedule(cfg.optimizer['lr'], cfg.lr_config, 1000,
                                 cfg.runner['max_epochs'])
    optimizer, scheduler = build_optimizer(cfg.optimizer, schedule, model)
    step = make_train_step(model, optimizer, scheduler,
                           (cfg.get('optimizer_config') or {}).get(
                               'grad_clip'))
    masks = []
    head = model.bbox_head
    gi_mask = head._gi_mask

    def record(*args, **kwargs):
        m = gi_mask(*args, **kwargs)
        masks.append(m.cpu().numpy())
        return m
    head._gi_mask = record
    batch = rank_slice(batch_np, rank, world, device)
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = dict(step_ms=[])
    launches = nms_cuda.nms_keep.launches
    for n in range(steps):
        t0 = time.perf_counter()
        metrics = step(batch)
        if cuda:
            torch.cuda.synchronize()
        out['step_ms'].append((time.perf_counter() - t0) * 1e3)
        if n == 0:
            out['metrics'] = {k: float(v) for k, v in metrics.items()}
            out['masks'] = list(masks)
            if rank == 0:
                out['params'] = {k: p.detach().cpu().numpy().copy()
                                 for k, p in model.named_parameters()}
                out['grads'] = {k: p.grad.cpu().numpy().copy()
                                for k, p in model.named_parameters()
                                if p.grad is not None}
    out['launches'] = (nms_cuda.nms_keep.launches - launches) / steps
    out['peak_bytes'] = torch.cuda.max_memory_allocated() if cuda else 0
    if profile and world > 1:
        from torch.profiler import ProfilerActivity, profile as prof
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with prof(activities=acts) as p:
            step(batch)
            if cuda:
                torch.cuda.synchronize()
        out['collectives'] = {
            e.key: (e.count, e.cpu_time_total / 1e3)
            for e in p.key_averages()
            if e.key.startswith(('c10d::', 'gloo:', 'nccl:'))}
        import torch.distributed as dist
        flat = torch.cat([p.grad.flatten() for p in model.parameters()
                          if p.grad is not None])
        out['grad_bytes'] = flat.numel() * flat.element_size()
        times = []
        for _ in range(4):
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out['allreduce_ms'] = sum(times[1:]) / 3
    return out


def step_rank(rank, world, device, cfg, batch_np):
    """One `make_train_step` step of the detector of `cfg` (float32, from
    seed 0) on this rank's images of the global numpy batch `batch_np`.
    Returns dict(metrics (as logged), and on rank 0 params after the
    step, numpy)."""
    from ld_tpu_torch.models import build_detector
    from ld_tpu_torch.parallel import (build_lr_schedule, build_optimizer,
                                       make_train_step)
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device)
    schedule = build_lr_schedule(cfg.optimizer['lr'], cfg.lr_config, 1000,
                                 cfg.runner['max_epochs'])
    optimizer, scheduler = build_optimizer(cfg.optimizer, schedule, model)
    step = make_train_step(model, optimizer, scheduler)
    metrics = step(rank_slice(batch_np, rank, world, device))
    out = dict(metrics={k: float(v) for k, v in metrics.items()})
    if rank == 0:
        out['params'] = {k: p.detach().cpu().numpy().copy()
                         for k, p in model.named_parameters()}
    return out


def train_eval_rank(rank, world, device, cfg_path, work_dir, preempt_after):
    """Training over the ranks on the config file `cfg_path`: a run
    through `tools/train.py --launcher pytorch` in `work_dir`/full, then
    `train_detector` preempted by a SIGTERM to rank 0 after its step
    `preempt_after` in `work_dir`/cut and resumed there; then
    `eval_detector` of the full run's model over `data.val` and
    `tools/test.py --launcher pytorch --eval bbox` on its last checkpoint.
    Returns this rank's img_ids and LR of each step of each run, the steps
    the preempted run took, and the two evaluations' results."""
    import copy
    import signal

    from ld_tpu_torch.apis import eval_detector
    from ld_tpu_torch.apis import train as train_api
    from ld_tpu_torch.data import build_dataset
    from ld_tpu_torch.tools import test as test_tool
    from ld_tpu_torch.tools import train as train_tool
    from ld_tpu_torch.utils.checkpoint import latest_checkpoint
    from ld_tpu_torch.utils.config import Config
    cfg = Config.fromfile(cfg_path)
    full = os.path.join(work_dir, 'full')
    make_step = train_api.make_train_step
    seen = {}

    def wrapped(model, optimizer, *args, **kwargs):
        step = make_step(model, optimizer, *args, **kwargs)
        log = seen.setdefault(run, [])

        def recording(batch):
            log.append((batch['img_ids'].tolist(),
                        optimizer.param_groups[0]['lr']))
            out = step(batch)
            if run == 'cut' and rank == 0 and len(log) == preempt_after:
                signal.raise_signal(signal.SIGTERM)
            return out
        return recording
    train_api.make_train_step = wrapped
    try:
        run = 'full'
        ret = train_tool.main([cfg_path, '--work-dir', full, '--launcher',
                               'pytorch', '--device', str(device)])
        run = 'cut'
        cut = train_api.train_detector(cfg, os.path.join(work_dir, 'cut'),
                                       device=device)
        cfg = copy.deepcopy(cfg)
        cfg['resume_from'] = os.path.join(work_dir, 'cut')
        train_api.train_detector(cfg, os.path.join(work_dir, 'cut'),
                                 device=device)
    finally:
        train_api.make_train_step = make_step
    results = eval_detector(ret['model'], build_dataset(cfg.data['val']),
                            samples_per_gpu=2, pad_hw=cfg.pad_to)
    tool = test_tool.main([cfg_path, latest_checkpoint(full), '--eval',
                           'bbox', '--launcher', 'pytorch', '--device',
                           str(device)])
    return dict(steps=seen, preempted=cut['preempted'], cut_step=cut['step'],
                eval=results, tool=tool['results'])
