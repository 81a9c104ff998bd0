"""Released weights from local files. Port of imagenet_models_tpu/ckpt/pretrained.py.

The reference downloads release `.pth.tar` files; the port resolves
`--pretrained` against local directories only, and loads a reference file as
it is (the port's modules carry the reference's names), with strict=True;
relative-position tables are re-resolved to the model's input size first.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from imagenet_models_tpu_torch.ckpt.convert import (load_reference_weights,
                                                    state_dict_from_checkpoint)


def pretrained_dirs() -> List[str]:
    """Where released weights are looked for, in order: $IMTPU_PRETRAINED_DIR
    (when set), ./pretrained and ~/.cache/imtpu/checkpoints."""
    dirs = [os.environ.get("IMTPU_PRETRAINED_DIR", ""), "pretrained",
            os.path.expanduser("~/.cache/imtpu/checkpoints")]
    return [d for d in dirs if d]


def find_local_pretrained(model_name: str) -> Optional[str]:
    """Search `pretrained_dirs()` for <model_name>.pth.tar / .pth / .pt;
    None when absent."""
    for d in pretrained_dirs():
        for ext in (".pth.tar", ".pth", ".pt"):
            p = os.path.join(d, model_name + ext)
            if os.path.isfile(p):
                return p
    return None


def require_local_pretrained(model_name: str) -> str:
    p = find_local_pretrained(model_name)
    if p is None:
        raise FileNotFoundError(
            f"--pretrained: no local weights for {model_name}. The reference "
            "downloads release .pth.tar files; this package has no network "
            "access. Place the released checkpoint at "
            f"$IMTPU_PRETRAINED_DIR/{model_name}.pth.tar (or ./pretrained/, "
            "~/.cache/imtpu/checkpoints/), or pass --checkpoint/"
            "--initial-checkpoint explicitly.")
    return p


def load_pretrained(model: torch.nn.Module, model_name: str, checkpoint_path: str = "",
                    use_ema: bool = False) -> torch.nn.Module:
    """Load a reference checkpoint into `model` with strict=True:
    `checkpoint_path`, or the local released file of `model_name`; its
    rel-pos tables re-resolved to the model's input size."""
    path = checkpoint_path or require_local_pretrained(model_name)
    load_reference_weights(model, state_dict_from_checkpoint(path, use_ema=use_ema))
    return model
