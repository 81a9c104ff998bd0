"""Checkpoint saver and resume with timm's CheckpointSaver behaviour, on
`torch.save`. Port of imagenet_models_tpu/ckpt/saver.py.

A checkpoint is a directory (`checkpoint-N`, `last`, `model_best`,
`recovery`) holding `state.pt` and `meta.json` ({"epoch", "metric"}).
`state.pt` holds the whole train state on the host: the model's state_dict,
the optimizer state, the EMA shadow (with the state_dict keys that
name one tensor twice), the step, the step's `torch.Generator`
state (the stochastic-depth masks) and the device's default generator state
(the MAP head's dropouts draw from it), so that a resumed run draws what an
uninterrupted one would. `export_pth_tar` writes the reference's
`{"state_dict": ...}` format, whose keys are the port's own names (the
weights bridge of `ckpt/convert.py`).

Across processes (ckpt/saver.py:57-75, :117-129) saves are collective: under
ZeRO-1 each owner's optimizer and EMA leaves reach rank 0 by broadcast, every
rank's generator states too, rank 0 writes, and every rank waits at a
barrier. The file is one full state whatever the world size, so a checkpoint
resumes at any other: each rank takes its own leaves and its own generators
(a rank the writer did not have keeps its fresh ones).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from imagenet_models_tpu_torch.ckpt.convert import (load_reference_weights,
                                                    state_dict_from_checkpoint)
from imagenet_models_tpu_torch.parallel import mesh

_logger = logging.getLogger("imagenet_models_tpu_torch")

STATE_FILE = "state.pt"
META_FILE = "meta.json"
_REFERENCE_SUFFIXES = (".pth", ".pth.tar", ".pt")


def _host(tree):
    """A copy of `tree` with every tensor detached and copied to the host:
    later steps cannot change what a write-behind thread serializes."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _on(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree


def _device_of(state) -> torch.device:
    return next(state.model.parameters()).device


def device_rng_state(device: torch.device) -> torch.Tensor:
    """The state of `device`'s default generator."""
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def set_device_rng_state(device: torch.device, rng_state: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(rng_state, device)
    else:
        torch.set_rng_state(rng_state)


_PER_LEAF = ("mu", "nu", "trace")  # optimizer state entries keyed by parameter


def _gathered(state):
    """(optimizer state, EMA shadow of the parameters) with every leaf: under
    ZeRO-1 broadcast from the owners (collective), else the state's own."""
    if getattr(state, "owners", None) is None:
        return state.opt_state, state.ema_params
    params = state.params()
    full = lambda part: mesh.gather_owned(part, params, state.owners, state.group)
    opt = {k: full(v) if k in _PER_LEAF else v for k, v in state.opt_state.items()}
    return opt, None if state.ema_params is None else full(state.ema_params)


def aliases(model: torch.nn.Module) -> Dict[str, str]:
    """{second key: first key} of every state_dict entry that `model`
    registers under two names (FasterViT's TokenInitializer conv, also
    `to_global_feature.pos`). The EMA shadow, keyed as `named_parameters()`,
    holds the first key alone; `_weights` copies it to the second."""
    first: Dict[int, str] = {}
    out = {}
    for key, t in model.state_dict(keep_vars=True).items():
        if first.setdefault(id(t), key) != key:
            out[key] = first[id(t)]
    return out


def snapshot(state, generator: Optional[torch.Generator] = None) -> Optional[Dict[str, Any]]:
    """The train state as one dict of host tensors (what `state.pt` holds).
    Across processes every rank calls it (collective) and rank 0 gets the
    dict, with every rank's generator states; the others get None."""
    device = _device_of(state)
    opt_state, ema_params = _gathered(state)
    rngs = (None if generator is None else generator.get_state(), device_rng_state(device))
    ranks = [mesh.broadcast_object(rngs, src=r) for r in range(mesh.world())] \
        if mesh.world() > 1 else None
    if not mesh.is_primary():
        return None
    out = {
        "model": state.model.state_dict(),
        "opt_state": opt_state,
        "ema_params": ema_params,
        "ema_batch_stats": state.ema_batch_stats,
        "aliases": aliases(state.model),
        "step": int(state.step),
        "generator": rngs[0],
        "device_rng": rngs[1],
    }
    if ranks:
        out["rank_generators"] = [g for g, _ in ranks]
        out["rank_device_rngs"] = [d for _, d in ranks]
    return _host(out)


class CheckpointSaver:
    """timm CheckpointSaver semantics: `checkpoint-N` every epoch, `last` a
    copy of the newest, `model_best` a copy of the best by the metric's
    direction, at most `max_history` checkpoints kept, `recovery` snapshots,
    and the run's `args.yaml`.

    With `async_save`, the snapshot to the host stays on the caller (it must
    capture this step's state) while serialization, the copies and the
    pruning run on one write-behind thread, overlapped with the next steps.
    At most one save is in flight: the next save waits for the previous
    write, which bounds host memory to two state copies. `generator` is the
    train step's generator, whose state each checkpoint carries. Across
    processes every rank makes the saver and calls every save (module
    docstring): rank 0 writes, synchronously, and the others wait for it."""

    def __init__(self, checkpoint_dir: str, max_history: int = 10,
                 decreasing: bool = False, args_text: str = "",
                 async_save: bool = False, generator: Optional[torch.Generator] = None):
        self.dir = os.path.abspath(checkpoint_dir)
        self.writer = mesh.is_primary()
        if async_save and mesh.world() > 1:
            raise ValueError("async_save is for one process: saves across processes are "
                             "collective and run on the callers")
        if self.writer:
            os.makedirs(self.dir, exist_ok=True)
        self.max_history = max_history
        self.decreasing = decreasing
        self.generator = generator
        self.best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None
        self._executor = None
        self._inflight = None
        if async_save:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="imtpu-ckpt")
        if args_text and self.writer:
            with open(os.path.join(self.dir, "args.yaml"), "w") as f:
                f.write(args_text)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _submit(self, fn):
        """Run fn now (sync mode) or queue it on the single writer thread
        (submission order is execution order); across processes, on rank 0
        alone, and then every rank waits until it is done."""
        if self._executor is None:
            if self.writer:
                fn()
            if mesh.world() > 1:
                mesh.barrier()
            return

        def logged():
            try:
                fn()
            except BaseException:
                _logger.exception("async checkpoint write failed")
                raise

        self._inflight = self._executor.submit(logged)

    def wait_until_finished(self):
        """Block until every queued write has landed; re-raise a failed
        write's exception, so a run never ends believing in a checkpoint that
        was lost."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def close(self):
        """Wait for the queued writes, then stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            if self._executor is not None:
                self._executor.shutdown()
                self._executor = None

    def _save(self, state, epoch: int, name: str, metric: Optional[float] = None):
        self.wait_until_finished()  # back-pressure: one save in flight
        host = snapshot(state, self.generator)

        def write():
            path = self._path(name)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.makedirs(path)
            torch.save(host, os.path.join(path, STATE_FILE))
            with open(os.path.join(path, META_FILE), "w") as f:
                json.dump({"epoch": epoch, "metric": None if metric is None else float(metric)}, f)

        self._submit(write)

    def save_checkpoint(self, state, epoch: int, metric: Optional[float] = None
                        ) -> Tuple[Optional[float], Optional[int]]:
        self._save(state, epoch, f"checkpoint-{epoch}", metric)
        # the best is decided now; only the file copies wait behind the write
        better = metric is not None and (
            self.best_metric is None or
            (metric < self.best_metric if self.decreasing else metric > self.best_metric))
        if better:
            self.best_metric, self.best_epoch = metric, epoch

        def post():
            last = self._path("last")
            if os.path.exists(last):
                shutil.rmtree(last)
            shutil.copytree(self._path(f"checkpoint-{epoch}"), last)
            ckpts = sorted(glob.glob(self._path("checkpoint-*")),
                           key=lambda p: int(p.rsplit("-", 1)[1]))
            while len(ckpts) > self.max_history:
                shutil.rmtree(ckpts.pop(0))
            if better:
                best = self._path("model_best")
                if os.path.exists(best):
                    shutil.rmtree(best)
                shutil.copytree(self._path(f"checkpoint-{epoch}"), best)

        self._submit(post)
        return self.best_metric, self.best_epoch

    def save_recovery(self, state, epoch: int, batch_idx: int,
                      epoch_complete: bool = False):
        """Mid-epoch snapshots record `epoch - 1`, so that a `--resume`
        restart (start_epoch = saved + 1) re-runs the interrupted epoch from
        its start and skips no batch. Only a snapshot taken at the epoch's
        last batch records the epoch itself."""
        self._save(state, epoch if epoch_complete else epoch - 1, "recovery", None)

    def restore(self, name: str, state) -> Tuple[Any, int]:
        self.wait_until_finished()
        return resume_checkpoint(self._path(name), state, generator=self.generator)


def _read(path: str) -> Tuple[Dict[str, Any], int]:
    """(state.pt's dict, the epoch of meta.json or -1) of a checkpoint
    directory or of a state.pt file."""
    path = os.path.abspath(path)
    folder = path if os.path.isdir(path) else os.path.dirname(path)
    file = os.path.join(path, STATE_FILE) if os.path.isdir(path) else path
    ckpt = torch.load(file, map_location="cpu", weights_only=True)
    epoch = -1
    meta = os.path.join(folder, META_FILE)
    if os.path.exists(meta):
        with open(meta) as f:
            epoch = int(json.load(f).get("epoch", -1))
    return ckpt, epoch


def _weights(ckpt: Dict[str, Any], use_ema: bool, path: str) -> Dict[str, torch.Tensor]:
    """The model's state_dict from a saved train state; with use_ema its
    parameters and BN statistics replaced by the EMA shadow's, under every
    key that names them (`ckpt["aliases"]`)."""
    sd = dict(ckpt["model"])
    if use_ema:
        if not ckpt.get("ema_params"):
            raise ValueError(f"--use-ema: checkpoint {path} has no EMA weights")
        sd.update(ckpt["ema_params"])
        sd.update(ckpt.get("ema_batch_stats") or {})
        for alias, key in (ckpt.get("aliases") or {}).items():
            sd[alias] = sd[key]
    return sd


def resume_checkpoint(path: str, target, use_ema: bool = False,
                      generator: Optional[torch.Generator] = None) -> Tuple[Any, int]:
    """Resume from a saved checkpoint (a directory such as `last`,
    `recovery`, `checkpoint-N`, or its `state.pt`). Returns (target, epoch).

    A `TrainState` target gets everything back, in place: weights, optimizer
    state, EMA shadow and step, the device's default generator state and,
    where `generator` is given, the step generator's. An `nn.Module` target
    (validate's --checkpoint, --initial-checkpoint) gets the weights only,
    the EMA shadow's with `use_ema` (timm load_checkpoint(use_ema=...)), and
    a reference `.pth`/`.pth.tar`/`.pt` file loads into it as it is, its
    rel-pos tables re-resolved to the model's input size; epoch is then -1.
    Every load is strict."""
    if isinstance(target, torch.nn.Module):
        if path.endswith(_REFERENCE_SUFFIXES) and not path.endswith(STATE_FILE):
            load_reference_weights(target, state_dict_from_checkpoint(path, use_ema=use_ema))
            return target, -1
        ckpt, epoch = _read(path)
        target.load_state_dict(_weights(ckpt, use_ema, path), strict=True)
        return target, epoch
    if use_ema:
        raise ValueError("use_ema applies to a module target, not to a train state")
    ckpt, epoch = _read(path)
    state = target
    device = _device_of(state)
    state.model.load_state_dict(ckpt["model"], strict=True)
    saved = ckpt["opt_state"]
    if set(saved) != set(state.opt_state):
        raise ValueError(f"checkpoint {path}: its optimizer state does not match this "
                         "optimizer's (another --opt)")
    # under ZeRO-1 this rank keeps its own leaves of the full saved state
    state.opt_state = _on({k: state.owned(v) if k in _PER_LEAF else v
                           for k, v in saved.items()}, device)
    if (ckpt.get("ema_params") is None) != (state.ema_params is None):
        raise ValueError(f"checkpoint {path}: EMA shadow {'absent' if state.ema_params else 'present'}"
                         ", unlike this run's (--model-ema)")
    ema = ckpt.get("ema_params")
    state.ema_params = None if ema is None else _on(state.owned(ema), device)
    state.ema_batch_stats = _on(ckpt.get("ema_batch_stats"), device)
    state.step = int(ckpt["step"])
    # this rank's generators: the writer's rank r, or rank 0's in a
    # one-process file; a rank the writer did not have keeps its own
    r = mesh.rank()
    gens = ckpt.get("rank_generators") or [ckpt.get("generator")]
    rngs = ckpt.get("rank_device_rngs") or [ckpt["device_rng"]]
    if r < len(rngs):
        set_device_rng_state(device, rngs[r])
        if generator is not None and gens[r] is not None:
            generator.set_state(gens[r])
    else:
        _logger.info("rank %d: %s holds the generators of %d ranks; this rank keeps its own",
                     r, path, len(rngs))
    return state, epoch


def export_pth_tar(source, out_path: str, use_ema: bool = False) -> None:
    """Write a reference-format `.pth.tar` ({"state_dict": ...}) of a
    `TrainState`, an `nn.Module`, or a saved checkpoint's path; with use_ema
    the EMA weights (timm's --use-ema). Its keys and layouts are the
    reference's, so the reference, the port (`state_dict_from_checkpoint`)
    and the JAX package (`load_variables_from_torch`) all load it."""
    if isinstance(source, str):
        ckpt, _ = _read(source)
        sd = _weights(ckpt, use_ema, source)
    elif isinstance(source, torch.nn.Module):
        if use_ema:
            raise ValueError("use_ema needs a train state or a saved checkpoint")
        sd = source.state_dict()
    else:
        sd = _weights({"model": source.model.state_dict(), "ema_params": _gathered(source)[1],
                       "ema_batch_stats": source.ema_batch_stats,
                       "aliases": aliases(source.model)}, use_ema, "the train state")
    sd = _host(sd)
    torch.save({"state_dict": sd}, out_path)
    _logger.info("exported %d tensors to %s", len(sd), out_path)
