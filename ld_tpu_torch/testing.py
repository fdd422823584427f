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
`data_root`; it needs cv2 to write the JPEGs.
"""
import os

import numpy as np
import torch

from ld_tpu_torch.data.voc import VOC_CLASSES

NMS_SETS = ('identical', 'disjoint', 'invalid', 'chain_invalid',
            'boundary_chain', 'sparse_kept', 'dense_kept')
# (K, B) checked on the card: each side of the 64-box blocks, K = 512 (the GI
# path) and 1024 (multiclass_nms), runs longer than the sweep's staging
# window (K > 2048), and K = 16800, the anchor count of stride 8 at 800x1344
# (exact GI mode, gi_candidates >= the level's anchors)
NMS_CHECK_KB = (*[(k, b) for k in (1, 8, 63, 64, 65, 127, 128, 512, 1000,
                                   1024, 2048, 4100, 8192)
                  for b in (1, 3, 8)], (16800, 1))


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
