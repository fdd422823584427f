"""Evaluation API: batched inference over a dataset (port of
`ld_tpu/apis/test.py:20-89`), on one device or over the ranks of a
process group."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ld_tpu_torch.data import DevicePrefetcher, build_dataloader
from ld_tpu_torch.parallel.dist import (all_gather_object, all_reduce_host,
                                        get_dist_info)


def eval_detector(model: torch.nn.Module, dataset, samples_per_gpu: int = 4,
                  pad_hw=(800, 1344), rescale: bool = True,
                  max_images: Optional[int] = None) -> List[Dict]:
    """Run `model.forward_test` over `dataset` on the model's device;
    returns per-image dicts (boxes (n, 5) xyxy + score in original image
    coordinates, labels, and for a model with a mask head masks (n, 28,
    28) float32 roi-space sigmoid masks, what `SegmEvaluator` pastes),
    numpy, in dataset order. (The JAX `eval_detector` unpacks three
    outputs and so cannot run a mask model: ROADMAP.md caveat 21.)

    The batches reach the card through a DevicePrefetcher and run under
    `inference_mode`. The pipeline is one deep: batch N+1 is dispatched
    before batch N's results are read back. A result goes to the slot of its
    image's dataset index (the batch's `img_idx`), so any dataset or wrapper
    works, whatever its image ids are (the JAX package looks results up by
    `int(img_id)`, and so finds none for VOC's string ids). A tail batch
    repeats images to fill its slots; only an image's first result is kept.
    The model is left in the mode (train or eval) it was found in.

    Over R ranks (a process group up), each global batch holds R x
    `samples_per_gpu` images, as the JAX package shards one over its mesh:
    rank r runs slots [r*b, (r+1)*b) of each, and every rank returns the
    whole list, gathered, with each image's first result in the order of
    the one-process run. `max_images` counts the images of every rank.
    """
    device = next(model.parameters()).device
    rank, world = get_dist_info()
    loader = build_dataloader(dataset, samples_per_gpu, world, pad_hw,
                              max_gts=1, shuffle=False, rank=rank)
    # (position in the one-process order, dataset index, result) of each
    # image this rank ran; the position is (global batch, slot)
    found = []
    seen = 0

    def drain(n, img_idx, outs):
        """Device outputs -> per-image host results (waits for the card)."""
        nonlocal seen
        dets, labels, valid, *masks = (o.cpu().numpy() for o in outs)
        for i, idx in enumerate(img_idx):
            m = valid[i]
            res = dict(boxes=dets[i][m], labels=labels[i][m])
            if masks:
                res['masks'] = masks[0][i][m]
            found.append(((n, rank * samples_per_gpu + i), int(idx), res))
        if max_images:
            # the images this batch adds, over the ranks
            fresh = set(map(int, img_idx)) - done
            done.update(fresh)
            seen += int(all_reduce_host([len(fresh)])[0])

    done = set()
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            pending = None
            for n, batch in enumerate(DevicePrefetcher(loader, device)):
                outs = model.forward_test(batch, rescale=rescale)
                if pending is not None:
                    drain(*pending)
                pending = (n, batch['img_idx'], outs)
                if max_images and seen >= max_images:
                    break
            if pending is not None:
                drain(*pending)
    finally:
        model.train(was_training)
    results = [None] * len(dataset)
    for _, idx, r in sorted((f for part in all_gather_object(found)
                             for f in part), key=lambda f: f[0]):
        if results[idx] is None:
            results[idx] = r
    empty = dict(boxes=np.zeros((0, 5), np.float32),
                 labels=np.zeros((0, ), np.int64))
    if getattr(getattr(model, 'roi_head', None), 'with_test_masks', False):
        size = 2 * model.roi_head.mask_roi_size
        empty['masks'] = np.zeros((0, size, size), np.float32)
    for i, r in enumerate(results):
        if r is None:
            results[i] = dict(empty)
    return results
