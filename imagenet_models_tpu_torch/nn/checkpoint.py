"""Gradient checkpointing that keeps a train step's draws and statistics.

The counterpart of the JAX package's `nn.remat` / `jax.checkpoint` of a
block (MaxViT's `grad_checkpointing`, models/maxvit.py:257-258; GA-CSWin's
`use_chk`, models/ga_cswin.py:125-130; ConvNeXt's `IMTPU_BLOCK_REMAT`,
ops/convnext_block.py:629-634): the block's activations are dropped after
the forward and recomputed in the backward. `checkpoint_call` wraps
`torch.utils.checkpoint.checkpoint` (non-reentrant) so that the recompute
gives the forward's values and leaves the step as a plain one would:

- the explicit `torch.Generator` the block draws its DropPath masks from is
  set, for the recompute, to its state before the forward, and afterwards
  back to the state it had when the backward reached the block, so the
  masks are the forward's and later draws are not shifted (the default
  generators are restored by the checkpoint's own `preserve_rng_state`);
- BatchNorm's running statistics are updated once, in the forward, as
  JAX's remat does: the port's `BatchNorm` reads `recomputing()` and skips
  its update in the recompute (the kernels 7/8 route updates them in the
  same place).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

_RECOMPUTING = 0


def recomputing() -> bool:
    """Whether a checkpointed block is being recomputed in the backward."""
    return _RECOMPUTING > 0


@contextlib.contextmanager
def _recompute(generator: Optional[torch.Generator], before_forward):
    global _RECOMPUTING
    at_backward = None if generator is None else generator.get_state()
    if generator is not None:
        generator.set_state(before_forward)
    _RECOMPUTING += 1
    try:
        yield
    finally:
        _RECOMPUTING -= 1
        if generator is not None:
            generator.set_state(at_backward)


def checkpoint_call(fn: Callable, *args, rng: Optional[torch.Generator] = None, **kwargs):
    """`fn(*args, **kwargs)` with its activations recomputed in the backward
    instead of kept. `rng` is the explicit generator `fn` draws from (None:
    it draws from the default generators only)."""
    from torch.utils.checkpoint import checkpoint

    before = None if rng is None else rng.get_state()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute(rng, before)),
                      **kwargs)
