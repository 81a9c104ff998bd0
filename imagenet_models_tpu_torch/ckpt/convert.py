"""Weights into the port: JAX variables or reference `.pth.tar` files.

There is one converter, the JAX package's own (jax-free) torch exporter:
`ckpt/torch_convert.py:export_torch_state_dict` with the model family's
`ckpt/reverse_rules.py:reverse_translator`. Port modules use the reference's
torch names and layouts, so its output loads into them with `strict=True`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from imagenet_models_tpu.ckpt.reverse_rules import reverse_translator
from imagenet_models_tpu.ckpt.torch_convert import (
    export_torch_state_dict,
    load_torch_checkpoint,
)

# Reference keys with no counterpart in the port's state_dict: torch BN's
# step counter, and the triu-index buffer the port keeps non-persistent.
_NOT_LOADED = ("num_batches_tracked", "bp_index")


def _tensors(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()
            if not k.endswith(_NOT_LOADED)}


def state_dict_from_jax(variables: Dict[str, Any], model_name: str) -> Dict[str, torch.Tensor]:
    """JAX variables ({'params': ..., 'batch_stats': ...} of numpy arrays) ->
    a state_dict for the port's `model_name`."""
    return _tensors(export_torch_state_dict(variables, reverse_translator(model_name)))


def state_dict_from_checkpoint(path: str, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """A reference `.pth.tar` / `.pth` file -> a state_dict for the port."""
    return _tensors(load_torch_checkpoint(path, use_ema=use_ema))
