"""Batched data loading with aspect-ratio grouping, thread prefetch and the
copy to the card (port of `ld_tpu/data/loader.py:26-380`).

  * GroupBatchSampler: aspect-ratio-homogeneous batches, shuffled
    deterministically from seed + epoch. Group tails merge only within one
    aspect flag, so no batch mixes orientations, and `len(loader)` is the
    sum over flags of ceil(n_flag / batch) (floor with drop_last): exactly
    the batches an epoch yields. (The JAX package merges the tails of all
    groups; a mixed-orientation tail then finds no pad bucket.)
  * DataLoader: a producer thread fetches and collates static-shape batches
    ahead of the consumer, optionally fanning the samples of a batch out
    over a thread pool (`num_workers`; the C++ preprocess releases the
    interpreter lock). The five `scale_sampling` modes and the pad-bucket
    grouping of fixed-scale configs are the JAX package's; both reach the
    pipelines and image sizes through any nesting of dataset wrappers (the
    JAX package's scale override misses a Concat inside a Repeat). An
    exception in the producer is raised to the consumer, after the batches
    made before it (the JAX package ends the epoch early without an
    error). Each batch carries the dataset index of each of its images
    (`img_idx`).
  * Data parallelism (`num_replicas` R, `rank` r): the sampler cuts global
    batches of R x b images, in the same order on every rank, and rank r
    fetches, decodes and collates only slots [r*b, (r+1)*b) of each, so
    `len(loader)` is the same on every rank and the ranks' slices
    concatenate to the one-replica loader's batches. Every rank pads to
    the one bucket of its global batch (JAX pads the global batch to one
    shape): predicted from the images' sizes and drawn scales where the
    dataset carries them, else agreed by an all-reduce MAX over the
    ranks' padded shapes.
  * DevicePrefetcher: collates into pinned host buffers that it owns and
    reuses, and copies batch N+1 to the card on a side stream while step N
    runs. The producer thread touches no CUDA state: the buffers are
    allocated, and every copy is issued, on the consumer's thread.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ld_tpu_torch.parallel.dist import all_reduce_host, get_dist_info
from .transforms import (BATCH_LAYOUT, FusedPreprocess, Pad, Resize,
                         batch_shape, collate_batch, collects_masks,
                         rescale_size, select_pad_bucket)

_DONE = object()


class _Failure:
    """An exception raised in the producer, carried to the consumer."""

    def __init__(self, exc: Exception):
        self.exc = exc


def _leaf_datasets(dataset) -> Iterator:
    """The datasets under any nesting of the Concat (`datasets`) and
    Repeat / ClassBalanced (`dataset`) wrappers."""
    if hasattr(dataset, 'datasets'):
        for d in dataset.datasets:
            yield from _leaf_datasets(d)
    elif hasattr(dataset, 'dataset'):
        yield from _leaf_datasets(dataset.dataset)
    else:
        yield dataset


def _scale_carriers(dataset) -> List:
    """The Resize / FusedPreprocess scale samplers of the pipelines of a
    dataset or of the datasets it wraps, which take the loader's per-image
    or per-batch scale override."""
    out = []
    for ds in _leaf_datasets(dataset):
        for t in getattr(getattr(ds, 'pipeline', None), 'transforms', []):
            if isinstance(t, FusedPreprocess):
                out.append(t._scale_sampler)
            elif isinstance(t, Resize):
                out.append(t)
    return out


def _collects_masks(dataset) -> bool:
    """Whether a pipeline of the dataset (or of one it wraps) collects
    gt_masks."""
    return any(collects_masks(getattr(ds, 'pipeline', None))
               for ds in _leaf_datasets(dataset))


def _pad_divisor(dataset) -> Optional[int]:
    """The size divisor every pipeline pads its images to (1 where none
    pads); None where the pipelines differ or one pads to a fixed size."""
    seen = set()
    for ds in _leaf_datasets(dataset):
        d = 1
        for t in getattr(getattr(ds, 'pipeline', None), 'transforms', []):
            if isinstance(t, FusedPreprocess):
                d = t.size_divisor
            elif isinstance(t, Pad):
                if t.size is not None:
                    return None
                d = t.size_divisor
        seen.add(d)
    return seen.pop() if len(seen) == 1 else None


def _image_dims(dataset) -> Optional[np.ndarray]:
    """(N, 2) original (height, width) per index of a dataset or wrapper,
    or None where a dataset does not carry image sizes."""
    if hasattr(dataset, 'datasets'):                          # Concat
        parts = [_image_dims(d) for d in dataset.datasets]
        if any(p is None for p in parts):
            return None
        return np.concatenate(parts, axis=0)
    if hasattr(dataset, 'dataset'):
        base = _image_dims(dataset.dataset)
        if base is None:
            return None
        if hasattr(dataset, 'indices'):                       # ClassBalanced
            return base[np.asarray(dataset.indices, np.int64)]
        return np.tile(base, (dataset.times, 1))              # Repeat
    infos = getattr(dataset, 'img_infos', None)
    if infos is None:
        return None
    try:
        return np.asarray([[i['height'], i['width']] for i in infos],
                          np.float64)
    except (KeyError, TypeError):
        return None


class GroupBatchSampler:
    """Aspect-ratio-grouped batch indices, deterministically shuffled."""

    def __init__(self, flags: np.ndarray, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = False):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last

    def num_batches(self) -> int:
        """The batches of every epoch: per aspect flag, ceil(n / batch)
        (floor with drop_last)."""
        b = self.batch_size
        counts = np.unique(self.flags, return_counts=True)[1]
        return int(sum(n // b if self.drop_last else -(-n // b)
                       for n in counts))

    def epoch_batches(self, epoch: int,
                      keys: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """Index batches of one epoch. `keys` overrides the grouping key
        (default: the aspect flags); the loader passes flag x pad-bucket
        keys, so that each batch pads to its own bucket. Each key group is
        shuffled and cut into full batches; its tail joins the tails of
        the other groups of the same aspect flag, padded to a full batch by
        repeats (or dropped with drop_last); then the batches are
        shuffled."""
        groups = self.flags if keys is None else np.asarray(keys)
        rng = np.random.RandomState(self.seed + epoch)
        batches, tails = [], {}
        b = self.batch_size
        for g in np.unique(groups):
            idx = np.nonzero(groups == g)[0]
            if self.shuffle:
                idx = idx[rng.permutation(len(idx))]
            rem = len(idx) % b
            full = idx[:len(idx) - rem]
            if len(full):
                batches.extend(np.split(full, len(full) // b))
            tail = idx[len(idx) - rem:]
            for f in np.unique(self.flags[tail]):
                tails.setdefault(int(f), []).append(
                    tail[self.flags[tail] == f])
        for f in sorted(tails):
            left = np.concatenate(tails[f])
            if self.drop_last:
                left = left[:len(left) - len(left) % b]
            else:
                pad = (-len(left)) % b
                if pad:
                    left = np.concatenate(
                        [left, left[rng.randint(0, len(left), pad)]])
            if len(left):
                batches.extend(np.split(left, len(left) // b))
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put `item` unless the consumer has stopped; returns whether it was
    put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


def _get(q: queue.Queue, stop: threading.Event):
    """The next item of `q`, or None once the consumer has stopped."""
    while not stop.is_set():
        try:
            return q.get(timeout=0.1)
        except queue.Empty:
            pass
    return None


class DataLoader:
    """Iterates collated static-shape batches, made ahead by a thread."""

    def __init__(self, dataset, batch_size: int, pad_hw, max_gts: int = 100,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = False, num_workers: int = 0,
                 batch_scales=None, scale_sampling: str = 'image_range',
                 group_pad_buckets: bool = True, num_replicas: int = 1,
                 rank: int = 0):
        # pad_hw: one (H, W) static shape, or a list of pad buckets; each
        # batch pads to the smallest bucket that fits it.
        #
        # batch_size is the global batch; rank `rank` of `num_replicas`
        # takes its batch_size / num_replicas slots of each.
        #
        # batch_scales + scale_sampling: multi-scale (mstrain) training.
        #   'image_range': each image draws its own scale, long and short
        #       edges each by randint over the bounds of the given scales
        #       (mmdet's range mode);
        #   'image_value': each image picks one of the given scales;
        #   'image_range_grouped' / 'image_value_grouped': the same draws,
        #       with the batches grouped by the pad bucket each image's
        #       drawn scale predicts;
        #   'batch': one scale per batch, for all its images.
        # Every mode hands the drawn scale to the pipeline's Resize /
        # FusedPreprocess through a thread-local override.
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_hw = tuple(map(tuple, pad_hw)) \
            if isinstance(pad_hw[0], (tuple, list)) else tuple(pad_hw)
        self.batch_scales = [tuple(s) for s in batch_scales] \
            if batch_scales else None
        if scale_sampling not in ('image_range', 'image_value', 'batch',
                                  'image_range_grouped',
                                  'image_value_grouped'):
            raise ValueError(f'scale_sampling {scale_sampling!r}')
        self.scale_sampling = scale_sampling
        self.group_pad_buckets = group_pad_buckets
        self._scale_carriers = _scale_carriers(dataset)
        self.max_gts = max_gts
        # batches carry gt_masks (B, G, H/4, W/4) uint8 only then
        self.with_masks = _collects_masks(dataset)
        self.sampler = GroupBatchSampler(
            getattr(dataset, 'flag', np.zeros(len(dataset), np.uint8)),
            batch_size, seed=seed, shuffle=shuffle, drop_last=drop_last)
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.epoch = 0
        if batch_size % num_replicas or not 0 <= rank < num_replicas:
            raise ValueError(f'rank {rank} of {num_replicas} replicas, '
                             f'global batch {batch_size}')
        self.num_replicas, self.rank = num_replicas, rank
        self.rank_batch = batch_size // num_replicas
        # where the ranks' images differ in pad bucket, each rank pads to
        # the global batch's: predicted from sizes and scales, or agreed
        self._predict_pad = self._agree_pad = False
        if num_replicas > 1 and isinstance(self.pad_hw[0], tuple) and \
                len(self.pad_hw) > 1:
            fixed = self._keep_ratio_scale()
            self._pad_divisor = _pad_divisor(dataset)
            self._predict_pad = (_image_dims(dataset) is not None and
                                 self._pad_divisor is not None and
                                 bool(self._scale_carriers) and
                                 fixed is not False and
                                 (fixed is not None or
                                  bool(self.batch_scales)))
            self._agree_pad = not self._predict_pad
            if self._agree_pad and get_dist_info()[1] != num_replicas:
                raise ValueError(
                    'the pad bucket of a global batch cannot be predicted '
                    'here (no image sizes, or a resize that does not keep '
                    'the ratio): the ranks agree on it over a process '
                    f'group of {num_replicas} ranks, which is not up')

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        # exact: the LR schedule's steps per epoch and the resume
        # arithmetic of train_detector depend on it
        return self.sampler.num_batches()

    def _epoch_scales(self) -> Optional[List]:
        """The per-image multi-scale draw of this epoch, deterministic in
        seed + epoch."""
        if not self.batch_scales or self.scale_sampling == 'batch':
            return None
        rng = np.random.RandomState(self.sampler.seed + self.epoch + 1)
        n = len(self.dataset)
        if self.scale_sampling.startswith('image_value'):
            picks = rng.randint(len(self.batch_scales), size=n)
            return [self.batch_scales[j] for j in picks]
        longs = [max(s) for s in self.batch_scales]
        shorts = [min(s) for s in self.batch_scales]
        ls = rng.randint(min(longs), max(longs) + 1, size=n)
        ss = rng.randint(min(shorts), max(shorts) + 1, size=n)
        return list(zip(ls.tolist(), ss.tolist()))

    def _keep_ratio_scale(self):
        """The pipelines' one fixed keep-ratio scale; None where they draw
        their scales from several; False where a resize does not keep the
        ratio (or scales by a random ratio), so that no resized shape can
        be predicted."""
        seen = set()
        for t in self._scale_carriers:
            sc = getattr(t, 'img_scale', None)
            if (sc is None or not getattr(t, 'keep_ratio', False)
                    or getattr(t, 'ratio_range', None) is not None):
                return False
            if isinstance(sc[0], (tuple, list)):
                seen.add(None)
            else:
                seen.add(tuple(sc))
        return seen.pop() if len(seen) == 1 else None

    def _fixed_scales(self) -> Optional[List]:
        """Per-image scales for pad-bucket grouping at one fixed keep-ratio
        scale with several pad buckets: each image's resized shape follows
        from its size, so same-bucket images batch together (a 4:3 image
        resizes to 800x1067 and pads to (800, 1088), not the (800, 1344)
        maximum). None where the resized shape cannot be predicted, or with
        `group_pad_buckets=False`."""
        if not self.group_pad_buckets or self.batch_scales \
                or not isinstance(self.pad_hw[0], tuple) \
                or len(self.pad_hw) <= 1:
            return None
        sc = self._keep_ratio_scale()
        return [sc] * len(self.dataset) if sc else None

    def _predicted_hw(self, i: int, sc, dims) -> Tuple[int, int]:
        """Image i's resized (h, w) at scale `sc`, from its size in `dims`;
        without a size, the scale filled in its flag's orientation (an
        upper bound)."""
        if dims is not None and i < len(dims):
            h0, w0 = int(dims[i][0]), int(dims[i][1])
            f = rescale_size(h0, w0, sc)
            return int(h0 * f + 0.5), int(w0 * f + 0.5)
        flags = self.sampler.flags
        long_s, short_s = max(sc), min(sc)
        landscape = i < len(flags) and flags[i] == 1
        return (short_s, long_s) if landscape else (long_s, short_s)

    def _pad_floor(self, idx, scales, batch_scale, dims):
        """The largest padded (h, w) predicted for the images of the global
        batch `idx`: every rank pads to the bucket that fits them all."""
        one = batch_scale or self._keep_ratio_scale()
        d = self._pad_divisor
        hws = [self._predicted_hw(int(i), one if scales is None
                                  else scales[int(i)], dims) for i in idx]
        return (-(-max(h for h, _ in hws) // d) * d,
                -(-max(w for _, w in hws) // d) * d)

    def _agreed(self, batch, slot):
        """The batch padded to the smallest bucket that fits every rank's
        padded shape (an all-reduce MAX), re-padded where that is larger
        than its own."""
        img = batch['image']
        hw = select_pad_bucket(self.pad_hw, tuple(
            int(v) for v in all_reduce_host(list(img.shape[-2:]), 'max')))
        if tuple(img.shape[-2:]) == hw:
            return batch
        shape = img.shape[:2] + hw
        src = img.copy()
        out = np.zeros(shape, img.dtype) if slot is None else \
            slot.arrays['image'][:int(np.prod(shape))].reshape(shape)
        out[...] = 0
        out[:, :, :src.shape[2], :src.shape[3]] = src
        batch['image'] = out
        return batch

    def _bucket_keys(self, scales: List) -> np.ndarray:
        """flag x pad-bucket grouping key per image: each image's resized,
        /32-padded shape predicted from its size and drawn scale, mapped to
        the smallest fitting bucket. collate_batch selects each batch's
        bucket from the actual shapes, so a wrong prediction costs padding,
        never correctness."""
        buckets = list(self.pad_hw) if isinstance(self.pad_hw[0], tuple) \
            else [self.pad_hw]
        bucket_ids = {tuple(b): i for i, b in enumerate(buckets)}
        dims = _image_dims(self.dataset)
        flags = self.sampler.flags
        keys = np.zeros(len(scales), np.int64)
        for i, sc in enumerate(scales):
            hw = self._predicted_hw(i, sc, dims)
            b = select_pad_bucket(buckets if len(buckets) > 1
                                  else buckets[0], hw)
            flag = flags[i] if i < len(flags) else 0
            keys[i] = int(flag) * len(buckets) + bucket_ids[tuple(b)]
        return keys

    def _index_batches(self, scales) -> List[np.ndarray]:
        """The index batches of the current epoch, in order."""
        if scales is not None and 'grouped' in self.scale_sampling:
            keys = self._bucket_keys(scales)
        else:
            fixed = self._fixed_scales()
            keys = self._bucket_keys(fixed) if fixed is not None else None
        return self.sampler.epoch_batches(self.epoch, keys=keys)

    def _produce(self, batches, scales, out_q, stop, skip, slots):
        pool = None
        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
        scale_rng = np.random.RandomState(self.sampler.seed + self.epoch + 1)
        batch_scale = [None]   # 'batch' mode: the current batch's scale
        dims = _image_dims(self.dataset) if self._predict_pad else None
        lo = self.rank * self.rank_batch

        def fetch(i):
            # a pipeline may drop a sample (returns None): draw another, as
            # mmdet's CustomDataset._rand_another does
            i = int(i)
            tries = 0
            while True:
                if self._scale_carriers:
                    sc = batch_scale[0] if scales is None else scales[i]
                    for t in self._scale_carriers:
                        t.set_scale_override(sc)
                try:
                    s = self.dataset[i]
                finally:
                    for t in self._scale_carriers:
                        t.set_scale_override(None)
                if s is not None:
                    s['img_idx'] = i
                    return s
                tries += 1
                if tries > 100:
                    raise RuntimeError('the pipeline returned None for 100 '
                                       'consecutive redraws: is every '
                                       'sample being filtered?')
                i = int(np.random.randint(len(self.dataset)))

        try:
            for n, idx in enumerate(batches):
                if self.batch_scales and scales is None:
                    batch_scale[0] = self.batch_scales[
                        scale_rng.randint(len(self.batch_scales))]
                mine = idx[lo:lo + self.rank_batch]
                samples = list(pool.map(fetch, mine)) if pool is not None \
                    else [fetch(i) for i in mine]
                # skipped batches are fetched all the same: their random
                # draws keep the later batches those of a run from the start
                if n < skip or stop.is_set():
                    continue
                floor = self._pad_floor(idx, scales, batch_scale[0], dims) \
                    if self._predict_pad else None
                if slots is None:
                    item = collate_batch(samples, self.pad_hw, self.max_gts,
                                         min_hw=floor)
                    hw = item['image'].shape[-2:]
                else:
                    slot = _get(slots, stop)
                    if slot is None:
                        return
                    item = (collate_batch(samples, self.pad_hw, self.max_gts,
                                          out=slot.arrays, min_hw=floor),
                            slot)
                    hw = item[0]['image'].shape[-2:]
                if floor is not None and \
                        tuple(hw) != select_pad_bucket(self.pad_hw, floor):
                    raise RuntimeError(
                        f'rank {self.rank}: its images need the pad bucket '
                        f'{tuple(hw)}, larger than the {floor} predicted '
                        'for the global batch from the image sizes')
                if not _put(out_q, item, stop):
                    return
            _put(out_q, _DONE, stop)
        except Exception as e:   # handed to the consumer, which raises it
            _put(out_q, _Failure(e), stop)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    def iterate(self, skip: int = 0, slots: Optional[queue.Queue] = None
                ) -> Iterator:
        """The batches of the current epoch after the first `skip`: numpy
        dicts, or with `slots` (a queue of free buffer slots, see
        DevicePrefetcher) (batch, slot) pairs, the batch written into the
        slot's buffers."""
        scales = self._epoch_scales()
        batches = self._index_batches(scales)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        producer = threading.Thread(
            target=self._produce, daemon=True,
            args=(batches, scales, out_q, stop, skip, slots))
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                if self._agree_pad:
                    # on the consumer's thread, in step with the other
                    # ranks' consumers
                    if slots is None:
                        item = self._agreed(item, None)
                    else:
                        item = (self._agreed(*item), item[1])
                yield item
        finally:
            stop.set()
            producer.join(timeout=60)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate()


def build_dataloader(dataset, samples_per_gpu: int, num_replicas: int = 1,
                     pad_hw=(800, 1344), max_gts: int = 100,
                     shuffle: bool = True, seed: int = 0,
                     drop_last: bool = False,
                     num_workers: Optional[int] = None,
                     batch_scales=None,
                     scale_sampling: str = 'image_range',
                     group_pad_buckets: bool = True,
                     rank: int = 0) -> DataLoader:
    """Rank `rank`'s loader of global batches of samples_per_gpu *
    num_replicas images: samples_per_gpu images a batch, its slots of each.
    num_workers=None sizes the fetch thread pool to the host: cpu_count - 1,
    at most the rank's batch."""
    if num_workers is None:
        num_workers = min(max((os.cpu_count() or 1) - 1, 0), samples_per_gpu)
    return DataLoader(dataset, samples_per_gpu * num_replicas, pad_hw,
                      max_gts, shuffle=shuffle, seed=seed,
                      drop_last=drop_last, num_workers=num_workers,
                      batch_scales=batch_scales,
                      scale_sampling=scale_sampling,
                      group_pad_buckets=group_pad_buckets,
                      num_replicas=num_replicas, rank=rank)


class _Slot:
    """One batch's pinned host buffers (flat, sized for the largest pad
    bucket), as torch tensors and as numpy views of the same memory."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.tensors = tensors
        self.arrays = {k: t.numpy() for k, t in tensors.items()}


class DevicePrefetcher:
    """A DataLoader's batches as tensors on `device`.

    On the card: the loader's producer collates each batch into one of
    `prefetch + 2` slots of pinned host memory; this iterator copies batch
    N+1 to the card on a side stream while the caller's step N runs, makes
    the caller's stream wait for a batch's copy before handing it over
    (`wait_stream`), marks the batch's tensors as used on that stream
    (`record_stream`), and returns the slot once its copy has finished.
    On the CPU it wraps the loader's fresh arrays without a copy.
    `img_ids` and `img_idx` stay numpy arrays on the host. A slot holds a
    `gt_masks` buffer only where the dataset's pipeline collects masks;
    they cross as uint8 (13.4 MB for 2 x 100 gts at 800x1344) and the mask
    head reads them as such.
    """
    HOST_KEYS = ('img_ids', 'img_idx')

    def __init__(self, loader: DataLoader, device):
        self.loader = loader
        self.device = torch.device(device)
        self._slots = None
        self._stream = None

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        return self.iterate()

    def iterate(self, skip: int = 0) -> Iterator[Dict]:
        """The current epoch's batches after the first `skip`."""
        if self.device.type != 'cuda':
            for batch in self.loader.iterate(skip):
                yield {k: v if k in self.HOST_KEYS else torch.from_numpy(v)
                       for k, v in batch.items()}
            return
        if self._slots is None:
            self._slots = self._alloc_slots()
            self._stream = torch.cuda.Stream(self.device)
        free: queue.Queue = queue.Queue()
        for slot in self._slots:
            free.put(slot)
        current = torch.cuda.current_stream(self.device)
        pending = None
        for batch, slot in self.loader.iterate(skip, slots=free):
            if pending is not None:
                ready = self._hand_over(pending, current, free)
            issued = self._copy(batch, slot)
            if pending is not None:
                yield ready
            pending = issued
        if pending is not None:
            yield self._hand_over(pending, current, free)

    def _alloc_slots(self) -> List[_Slot]:
        loader = self.loader
        buckets = loader.pad_hw if isinstance(loader.pad_hw[0], tuple) \
            else (loader.pad_hw, )
        biggest = max(buckets, key=lambda hw: hw[0] * hw[1])
        slots = []
        for _ in range(loader.prefetch + 2):
            tensors = {}
            for key, (dtype, _) in BATCH_LAYOUT.items():
                if key == 'gt_masks' and not loader.with_masks:
                    continue
                n = int(np.prod(batch_shape(key, loader.rank_batch, biggest,
                                            loader.max_gts)))
                tensors[key] = torch.empty(
                    n, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                    pin_memory=True)
            slots.append(_Slot(tensors))
        return slots

    def _copy(self, batch: Dict[str, np.ndarray], slot: _Slot):
        """Issue the copies of a batch in `slot` on the side stream."""
        host = {k: batch[k].copy() for k in self.HOST_KEYS}
        with torch.cuda.stream(self._stream):
            dev = {k: slot.tensors[k][:a.size].view(a.shape).to(
                self.device, non_blocking=True)
                for k, a in batch.items() if k not in self.HOST_KEYS}
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, host, done, slot

    def _hand_over(self, pending, current, free: queue.Queue) -> Dict:
        dev, host, done, slot = pending
        current.wait_stream(self._stream)
        for t in dev.values():
            t.record_stream(current)
        done.synchronize()      # the slot's memory may be written again
        free.put(slot)
        dev.update(host)
        return dev
