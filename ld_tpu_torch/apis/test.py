"""Evaluation API: batched inference over a dataset (port of
`ld_tpu/apis/test.py:20-89`, one device)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ld_tpu_torch.data import DevicePrefetcher, build_dataloader


def eval_detector(model: torch.nn.Module, dataset, samples_per_gpu: int = 4,
                  pad_hw=(800, 1344), rescale: bool = True,
                  max_images: Optional[int] = None) -> List[Dict]:
    """Run `model.forward_test` over `dataset` on the model's device;
    returns per-image dicts (boxes (n, 5) xyxy + score in original image
    coordinates, labels), numpy, in dataset order.

    The batches reach the card through a DevicePrefetcher and run under
    `inference_mode`. The pipeline is one deep: batch N+1 is dispatched
    before batch N's results are read back. A result goes to the slot of its
    image's dataset index (the batch's `img_idx`), so any dataset or wrapper
    works, whatever its image ids are (the JAX package looks results up by
    `int(img_id)`, and so finds none for VOC's string ids). A tail batch
    repeats images to fill its slots; only an image's first result is kept.
    The model is left in the mode (train or eval) it was found in.
    """
    device = next(model.parameters()).device
    loader = build_dataloader(dataset, samples_per_gpu, 1, pad_hw,
                              max_gts=1, shuffle=False)
    results = [None] * len(dataset)
    seen = 0

    def drain(img_idx, outs):
        """Device outputs -> per-image host results (waits for the card)."""
        nonlocal seen
        dets, labels, valid = (o.cpu().numpy() for o in outs)
        for i, idx in enumerate(img_idx):
            if results[idx] is not None:
                continue
            m = valid[i]
            results[idx] = dict(boxes=dets[i][m], labels=labels[i][m])
            seen += 1

    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            pending = None
            for batch in DevicePrefetcher(loader, device):
                outs = model.forward_test(batch, rescale=rescale)
                if pending is not None:
                    drain(*pending)
                pending = (batch['img_idx'], outs)
                if max_images and seen >= max_images:
                    break
            if pending is not None:
                drain(*pending)
    finally:
        model.train(was_training)
    for i, r in enumerate(results):
        if r is None:
            results[i] = dict(boxes=np.zeros((0, 5), np.float32),
                              labels=np.zeros((0, ), np.int64))
    return results
