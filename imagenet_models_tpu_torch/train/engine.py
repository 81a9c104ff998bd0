"""Training and eval engine: the host loop around the train and eval steps.
Port of imagenet_models_tpu/train/engine.py: one process per device, every
rank running the same loop over its shard of each batch.

Phase meters (data, step), the NaN watchdog, recovery checkpoints, SIGTERM
preemption and throughput logging, as the JAX engine has them. CUDA runs
asynchronously, so the loop never waits for the card between steps: the
losses stay on the device and are fetched, and checked for NaN/inf, only at
log intervals and at the last batch. Batches come from the host loader as
NHWC float32 numpy arrays and reach the device through pinned memory
(`to_device`), in the NHWC layout the port's models take. Across processes
the ranks agree on preemption at the deterministic sync points, and
`validate` reduces its meters over the ranks.
"""

from __future__ import annotations

import logging
import math
import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from imagenet_models_tpu_torch.parallel import mesh
from imagenet_models_tpu_torch.utils.meters import AverageMeter

_logger = logging.getLogger("imagenet_models_tpu_torch")


class NaNWatchdog(Exception):
    pass


class Preempted(Exception):
    """Raised at a step boundary after SIGTERM (maintenance or preemption)."""


_PREEMPT = {"signaled": False}


@dataclass
class LoopStats:
    """What one pass of a loop took, on the host's clock: `images` over
    `seconds` is the loop's rate; `data_seconds` is the time spent waiting
    for the loader (summed over its `steps`). A train loop's clock stops
    after its last drain, which waits for the device."""
    steps: int = 0
    images: int = 0
    seconds: float = 0.0
    data_seconds: float = 0.0

    @property
    def img_s(self) -> float:
        return self.images / self.seconds if self.seconds else 0.0

    @property
    def data_per_step(self) -> float:
        return self.data_seconds / self.steps if self.steps else 0.0


def install_preemption_handler():
    """Turn SIGTERM into a recovery checkpoint and a clean exit at the next
    step boundary, so `--resume` restarts without skipping data (the
    snapshot carries epoch-1 semantics: the interrupted epoch re-runs from
    its start, see CheckpointSaver.save_recovery)."""
    import signal

    def _handler(signum, frame):
        _PREEMPT["signaled"] = True
        _logger.warning("SIGTERM: saving recovery checkpoint at the next step boundary")

    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread (e.g. under pytest plugins)
        pass


def _preempt_agreed(sync_point: bool) -> bool:
    """Whether to act on a SIGTERM now. One process: the local flag, checked
    every step. Several: the signal can land on the ranks at different steps,
    and a rank that saved and left alone would leave the others waiting in
    the next step's collectives; so every rank agrees (an all_reduce MAX of
    the flag: any rank's signal wins), and only at the deterministic sync
    points (log intervals and the last batch), where every rank calls this
    (engine.py:64-83)."""
    if mesh.world() == 1:
        return _PREEMPT["signaled"]
    if not sync_point:
        return False
    return mesh.any_rank(_PREEMPT["signaled"])


def save_image_grid(images: np.ndarray, path: str, cols: int = 8):
    """Debug dump of an input batch as one tiled image (torchvision
    save_image with normalize=True): NHWC float batches in any
    normalization, min-max rescaled."""
    from PIL import Image

    arr = np.asarray(images, np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    arr = (arr - lo) / max(hi - lo, 1e-8)
    n, h, w, c = arr.shape
    cols = min(cols, n)
    rows = math.ceil(n / cols)
    grid = np.zeros((rows * h, cols * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = arr[i]
    Image.fromarray((grid * 255).astype(np.uint8).squeeze()).save(path)


def to_device(images: np.ndarray, targets: np.ndarray,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A host batch on `device`: through pinned memory and a copy that does
    not wait, for a CUDA device."""
    x = torch.from_numpy(np.ascontiguousarray(images))
    t = torch.from_numpy(np.ascontiguousarray(targets))
    if device.type == "cuda":
        x, t = x.pin_memory(), t.pin_memory()
    return x.to(device, non_blocking=True), t.to(device, non_blocking=True)


def train_one_epoch(epoch: int, state, step_fn, loader, generator: Optional[torch.Generator],
                    device: torch.device, log_interval: int = 50, saver=None,
                    recovery_interval: int = 0, lr_fn: Optional[Callable] = None,
                    mixup_off: bool = False, steps_per_epoch: Optional[int] = None,
                    profile_steps: int = 0, profile_dir: str = "",
                    save_images_dir: str = ""):
    """One epoch of `step_fn(state, images, targets, generator)`. Returns
    (state, OrderedDict(loss=mean), LoopStats)."""
    if mixup_off and getattr(loader, "mixup_enabled", False):
        loader.mixup_enabled = False
    profiler = None

    batch_time = AverageMeter()
    data_time = AverageMeter()
    losses = AverageMeter()
    stats = LoopStats()
    pending = []  # (batch_idx, loss on the device, batch size) awaiting the drain

    spe = steps_per_epoch or len(loader)
    start = end = time.time()
    last_idx = len(loader) - 1
    for batch_idx, (images, targets) in enumerate(loader):
        data_time.update(time.time() - end)
        stats.data_seconds += data_time.val
        n = images.shape[0]
        host_images = images
        images, targets = to_device(images, targets, device)
        if profile_steps and epoch == 0:
            if batch_idx == 2 and profiler is None:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])])
                profiler.start()
            elif profiler is not None and batch_idx == 2 + profile_steps:
                profiler.stop()
                os.makedirs(profile_dir or "./profile", exist_ok=True)
                trace = os.path.join(profile_dir or "./profile", "trace.json")
                profiler.export_chrome_trace(trace)
                profiler = None
                _logger.info("profiler trace written to %s", trace)
        state, metrics = step_fn(state, images, targets, generator)
        pending.append((batch_idx, metrics["loss"], n))
        stats.steps += 1
        stats.images += n

        do_log = batch_idx % log_interval == 0 or batch_idx == last_idx
        if do_log:
            # the one wait for the device: fetch the pending losses together
            values = torch.stack([loss.detach().float() for _, loss, _ in pending]).tolist()
            for (bi, _, bn), loss in zip(pending, values):
                if math.isnan(loss) or math.isinf(loss):
                    _logger.error("nan/inf loss at epoch %d batch %d", epoch, bi)
                    raise NaNWatchdog(f"epoch {epoch} batch {bi}")
                losses.update(loss, bn)
            pending.clear()
        # timed after the drain, so the waits for the device are charged to
        # the iteration: the per-interval average is the loop's wall rate
        batch_time.update(time.time() - end)
        if do_log:
            rate = n / max(batch_time.avg, 1e-9)
            lr_now = float(lr_fn(epoch + batch_idx / spe)) if lr_fn else float("nan")
            _logger.info(
                "Train: %d [%4d/%d (%3.0f%%)]  Loss: %.4g (%.3g)  "
                "Time: %.3fs, %7.2f/s  LR: %.3e  Data: %.3f (%.3f)",
                epoch, batch_idx, len(loader), 100.0 * batch_idx / max(last_idx, 1),
                losses.val, losses.avg, batch_time.val, rate, lr_now,
                data_time.val, data_time.avg)
        if save_images_dir and batch_idx % log_interval == 0:
            save_image_grid(host_images, os.path.join(
                save_images_dir, f"train-batch-{batch_idx}.jpg"))

        if saver is not None and recovery_interval and (
                batch_idx == last_idx or (batch_idx + 1) % recovery_interval == 0):
            saver.save_recovery(state, epoch, batch_idx,
                                epoch_complete=batch_idx == last_idx)

        if _preempt_agreed(do_log or batch_idx == last_idx):
            if saver is not None:
                saver.save_recovery(state, epoch, batch_idx,
                                    epoch_complete=batch_idx == last_idx)
                _logger.warning("preemption recovery checkpoint saved "
                                "(epoch %d batch %d)", epoch, batch_idx)
            raise Preempted(f"epoch {epoch} batch {batch_idx}")

        end = time.time()

    if profiler is not None:
        profiler.stop()
    stats.seconds = time.time() - start
    return state, OrderedDict([("loss", losses.avg)]), stats


def validate(eval_step, loader, device: torch.device, log_interval: int = 50,
             log_suffix: str = "", tta: int = 0):
    """Top-1/top-5 over the loader; `eval_step(images, targets)` returns
    (logits, top-1 flags, top-5 flags) with the heads' logits averaged
    (train.state.make_eval_step). The tail batch is padded to the loader's
    batch size with target -1, which no prediction matches, and only its real
    samples are metered. tta > 1: the step returns one flag per group of tta
    samples. Across processes each rank meters its shard of every batch
    (an empty shard is all padding), then [top-1 sum, top-5 sum, count] are
    all-reduced and divided, so that an uneven tail gives the one-pass
    metric (engine.py:237-243). Returns (OrderedDict(top1, top5), LoopStats),
    the stats this rank's."""
    tta = max(int(tta), 1)
    batch_time = AverageMeter()
    top1 = AverageMeter()
    top5 = AverageMeter()
    stats = LoopStats()

    start = end = time.time()
    last_idx = len(loader) - 1
    for batch_idx, (images, targets) in enumerate(loader):
        stats.data_seconds += time.time() - end
        n = images.shape[0]
        want = getattr(loader, "batch_size", n)
        if n < want:
            pad = want - n
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            targets = np.concatenate([targets, np.full((pad,), -1, targets.dtype)])
        images, targets = to_device(images, targets, device)
        _, c1, c5 = eval_step(images, targets)
        c1, c5 = c1.cpu().numpy(), c5.cpu().numpy()
        stats.steps += 1
        stats.images += n
        n_eff = n // tta  # groups fully inside the real samples (pad is at the end)
        if n_eff == 0:
            continue  # tail smaller than one tta group; reference unfold drops it
        if len(c1) > n_eff:
            c1, c5 = c1[:n_eff], c5[:n_eff]
        top1.update(float(c1.mean()) * 100.0, n_eff)
        top5.update(float(c5.mean()) * 100.0, n_eff)
        batch_time.update(time.time() - end)
        end = time.time()
        if batch_idx % log_interval == 0 or batch_idx == last_idx:
            _logger.info("Test%s: [%4d/%d]  Time: %.3f (%.3f)  Acc@1: %.3f (%.3f)  Acc@5: %.3f (%.3f)",
                         log_suffix, batch_idx, len(loader), batch_time.val,
                         batch_time.avg, top1.val, top1.avg, top5.val, top5.avg)
    stats.seconds = time.time() - start
    if mesh.world() > 1:
        s1, s5, count = mesh.all_reduce_sum([top1.sum, top5.sum, top1.count])
        return OrderedDict([("top1", s1 / max(count, 1.0)),
                            ("top5", s5 / max(count, 1.0))]), stats
    return OrderedDict([("top1", top1.avg), ("top5", top5.avg)]), stats
