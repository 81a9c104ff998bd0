"""Host input pipeline: threaded decode+augment workers feeding a bounded
queue, with batch-level mixup/cutmix and repeat-augmentation scheduling.
Port of imagenet_models_tpu/data/loader.py.

It yields the same NHWC float32 numpy batches as the JAX package's loader,
bit for bit, for the same dataset, seed and epoch; the engine moves them to
the device (`train.engine.to_device`). Repeat-aug reproduces timm's
RepeatAugSampler: each selected sample appears `repeats` times per epoch
(with independent augmentations), the epoch length preserved.
"""

from __future__ import annotations

import math
import queue
import random
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


def epoch_indices(n: int, epoch: int, seed: int, shuffle: bool, repeats: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + epoch) if shuffle else None
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    if repeats and repeats > 1:
        unique = idx[: math.ceil(n / repeats)]
        idx = np.repeat(unique, repeats)[:n]
    return idx


class DataLoader:
    """Iterable over (images NHWC f32, targets) numpy batches."""

    def __init__(self, dataset, batch_size: int, transform: Callable,
                 is_training: bool = False, mixup_fn=None, num_workers: int = 4,
                 seed: int = 42, repeats: int = 0, drop_last: Optional[bool] = None,
                 use_native: Optional[bool] = None, aug_splits: int = 0,
                 resplit: bool = False, num_shards: int = 1, shard_id: int = 0):
        # Data-parallel sharding (the reference's DistributedSampler analog,
        # GA/train.py:657-658): batch_size is the GLOBAL batch; every process
        # walks the identical epoch index stream and takes its contiguous
        # block of each batch, yielding batch_size//num_shards rows.
        # num_shards=1 is the single-process path: same indices, same
        # per-sample aug seeds, same mixup stream. The train entry passes
        # num_shards=world, shard_id=rank.
        num_shards = max(int(num_shards), 1)
        if batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"num_shards {num_shards}")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} out of range [0,{num_shards})")
        self.num_shards, self.shard_id = num_shards, shard_id
        self.global_batch_size = batch_size
        batch_size = batch_size // num_shards  # local rows yielded per batch
        self.dataset, self.batch_size, self.transform = dataset, batch_size, transform
        self.is_training, self.mixup_fn = is_training, mixup_fn
        self.num_workers = max(1, num_workers)
        self.seed, self.repeats = seed, repeats
        # timm AugMixDataset semantics (GA/train.py:560-561): each sample
        # yields 1 clean + (aug_splits-1) secondary-augmented copies of ONE
        # shared primary crop; batches carry batch_size*aug_splits images,
        # interleaved sample-major (see _stack_splits) so contiguous DP
        # shards hold whole samples. Targets are repeated per split (timm
        # fast_collate). resplit = skip random erasing on the clean split.
        self.aug_splits = aug_splits if aug_splits and aug_splits > 1 else 0
        self.resplit = resplit
        if self.aug_splits and mixup_fn is not None:
            # collate conflict, as in the reference (GA/train.py:554)
            raise ValueError("--aug-splits is not compatible with mixup/cutmix")
        self.drop_last = is_training if drop_last is None else drop_last
        self.epoch = 0
        self.mixup_enabled = mixup_fn is not None
        # native C++ decode path: training over an all-JPEG ImageFolder; only
        # auto-enabled when it can honor every recipe knob (interpolation
        # choice is the one thing it may not support)
        self.native = False
        if use_native is not False and is_training and hasattr(dataset, "samples") \
                and hasattr(transform, "post_decode"):
            from imagenet_models_tpu_torch.data.native import INTERP_CODES

            if getattr(transform, "interpolation", None) in INTERP_CODES and \
                    all(p.lower().endswith((".jpg", ".jpeg")) for p, _ in dataset.samples):
                from imagenet_models_tpu_torch.data.native import get_native_lib

                self.native = get_native_lib() is not None

    @property
    def decoder(self) -> str:
        """Which host decoder makes the batches: "native" (libjpeg, C++) or "PIL"."""
        return "native" if self.native else "PIL"

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        g = self.global_batch_size
        return n // g if self.drop_last else math.ceil(n / g)

    def _load_one(self, index: int, aug_seed: int) -> Tuple[np.ndarray, int]:
        img, label = self.dataset.load(int(index))
        rng = random.Random(aug_seed)
        if self.aug_splits:
            return self._split_variants(img, rng), label
        return self.transform(img, rng), label

    def _split_variants(self, img, rng, cropped: bool = False) -> np.ndarray:
        """(aug_splits, H, W, C): clean + independently-augmented copies of
        one shared primary crop (cropped=True when the caller already applied
        the primary transform, e.g. the native decode path)."""
        tf = self.transform
        base = img if cropped else tf.primary(img, rng)
        outs = [tf.finalize_clean(base, rng, erase=not self.resplit)]
        for _ in range(self.aug_splits - 1):
            outs.append(tf.post_decode_pil(base, rng))
        return np.stack(outs)

    def _load_batch_native(self, binds, seeds) -> Tuple[np.ndarray, np.ndarray]:
        from imagenet_models_tpu_torch.data.native import decode_batch

        tf = self.transform
        paths = [self.dataset.samples[int(i)][0] for i in binds]
        labels = np.asarray([self.dataset.samples[int(i)][1] for i in binds], np.int64)
        arr = decode_batch(paths, seeds, tf.size, "train",
                           interpolation=tf.interpolation,
                           hflip=tf.hflip, vflip=getattr(tf, "vflip", 0.0),
                           scale=tf.scale, ratio=tf.ratio)
        if self.aug_splits:
            from PIL import Image

            imgs = [self._split_variants(Image.fromarray(arr[k]),
                                         random.Random(seeds[k]), cropped=True)
                    for k in range(len(binds))]
            return self._stack_splits(imgs, labels)
        imgs = [tf.post_decode(arr[k], random.Random(seeds[k]))
                for k in range(len(binds))]
        return np.stack(imgs), labels

    def _stack_splits(self, imgs, labels) -> Tuple[np.ndarray, np.ndarray]:
        """Interleave sample-major: row k*s+j is split j of sample k, so any
        contiguous shard of (local_batch*s) rows holds whole samples (unlike
        timm's block-major collate, which would scatter a sample's splits
        across DP shards)."""
        stacked = np.stack(imgs)  # (B, s, H, W, C)
        flat = stacked.reshape(-1, *stacked.shape[2:])
        return flat, np.repeat(np.asarray(labels, np.int64), self.aug_splits)

    def _make_batch(self, bi: int, binds) -> Tuple[np.ndarray, np.ndarray]:
        if len(binds) == 0:
            # a tail batch too short to reach this shard's slice:
            # yield an empty batch (the eval engine pads + masks it) instead
            # of letting np.stack([]) kill the worker thread
            size = int(getattr(self.transform, "size", 0))
            shape = (0, size, size, 3) if size else (0,)
            return np.zeros(shape, np.float32), np.zeros((0,), np.int64)
        # per-sample aug seeds keyed by GLOBAL batch position so shards draw
        # disjoint aug streams (pos0=0 on a single host: unchanged)
        pos0 = self.shard_id * self.batch_size
        seeds = [(self.seed, self.epoch, bi, pos0 + pos).__hash__() & 0x7FFFFFFF
                 for pos in range(len(binds))]
        if self.native:
            return self._load_batch_native(binds, seeds)
        imgs, labels = [], []
        for pos, i in enumerate(binds):
            a, lb = self._load_one(i, seeds[pos])
            imgs.append(a)
            labels.append(lb)
        if self.aug_splits:
            return self._stack_splits(imgs, labels)
        return np.stack(imgs), np.asarray(labels, np.int64)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = epoch_indices(len(self.dataset), self.epoch, self.seed,
                            shuffle=self.is_training, repeats=self.repeats if self.is_training else 0)
        nb = len(self)
        g, lb, s0 = self.global_batch_size, self.batch_size, self.shard_id
        batches = [idx[i * g:(i + 1) * g][s0 * lb:(s0 + 1) * lb] for i in range(nb)]
        # mixup pairs within the process-local batch (== timm's per-process
        # prefetcher mixup under DDP); disjoint stream per shard
        mix_rng = np.random.default_rng(self.seed * 1000003 + self.epoch
                                        + 1000003651 * s0)

        def finish(images, targets):
            if self.is_training and self.mixup_fn is not None and self.mixup_enabled:
                images, targets = self.mixup_fn(images, targets, mix_rng)
            return images, targets

        # the native decoder has its own internal thread pool; one producer
        # thread is enough there. Each worker w makes batches w, w+workers, ...
        # into its own queue. A worker's error is handed to the consumer and
        # raised there; when the consumer stops early (a truncated epoch),
        # `stop` ends the workers instead of leaving them blocked on a full
        # queue with batches in it.
        workers = min(1 if self.native else self.num_workers, max(nb, 1))
        qs = [queue.Queue(maxsize=2 if workers > 1 else 4) for _ in range(workers)]
        stop = threading.Event()

        def put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(w):
            try:
                for bi in range(w, nb, workers):
                    if not put(qs[w], (bi, *self._make_batch(bi, batches[bi]))):
                        return
            except Exception as e:  # noqa: BLE001  (raised again by the consumer)
                put(qs[w], e)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(nb):
                item = qs[bi % workers].get()
                if isinstance(item, Exception):
                    raise item
                if item[0] != bi:
                    raise RuntimeError(f"loader worker out of order: batch {item[0]}, not {bi}")
                yield finish(item[1], item[2])
        finally:
            # the workers see `stop` within one put timeout (or one batch);
            # joining them here leaves no thread of this epoch behind
            stop.set()
            for t in threads:
                t.join()


def create_loader(dataset, input_size: int, batch_size: int, is_training: bool,
                  interpolation: str = "bicubic", crop_pct: float = 0.875,
                  crop_mode: str = "center",
                  mean=None, std=None, auto_augment: Optional[str] = None,
                  hflip: float = 0.5, vflip: float = 0.0, color_jitter: float = 0.0,
                  reprob: float = 0.0, remode: str = "pixel",
                  recount: int = 1, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                  mixup_fn=None, num_workers: int = 4, seed: int = 42,
                  repeats: int = 0, aug_splits: int = 0,
                  resplit: bool = False, no_aug: bool = False,
                  num_shards: int = 1, shard_id: int = 0) -> DataLoader:
    from imagenet_models_tpu_torch.data.transforms import (
        EvalTransform,
        IMAGENET_DEFAULT_MEAN,
        IMAGENET_DEFAULT_STD,
        TrainTransform,
    )

    mean = mean or IMAGENET_DEFAULT_MEAN
    std = std or IMAGENET_DEFAULT_STD
    if is_training and no_aug:
        # timm --no-aug train path (transforms_factory.py): plain
        # resize+center-crop+normalize, no flips/jitter/RandAugment/erasing
        # (GA/train.py:565-573 passes no_aug into timm's create_loader)
        tf = EvalTransform(input_size, crop_pct=1.0,
                           interpolation=interpolation, mean=mean, std=std)
    elif is_training:
        tf = TrainTransform(input_size, interpolation=interpolation, hflip=hflip,
                            vflip=vflip, color_jitter=color_jitter,
                            auto_augment=auto_augment, mean=mean, std=std,
                            reprob=reprob, remode=remode, recount=recount,
                            scale=scale, ratio=ratio)
    else:
        tf = EvalTransform(input_size, crop_pct=crop_pct,
                           interpolation=interpolation, mean=mean, std=std,
                           crop_mode=crop_mode)
    return DataLoader(dataset, batch_size, tf, is_training=is_training,
                      mixup_fn=mixup_fn, num_workers=num_workers, seed=seed,
                      repeats=repeats, aug_splits=aug_splits, resplit=resplit,
                      num_shards=num_shards, shard_id=shard_id)
