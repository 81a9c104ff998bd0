"""Fine-tune checkpoint surgery. Port of imagenet_models_tpu/ckpt/finetune.py
(the reference's MAP/train.py:459-481).

Loading a reference `.pth.tar` for fine-tuning either (a) remaps a 21k-class
classifier fc to the 1k label space through a class-map JSON
(`{"in1k_idx": [...], "in21k_idx": [...]}`, --in21k-1k-map), with the one
class the map lacks (850) set to the 21k mean row, or (b) drops the
classifier fc keys, so the model's freshly initialised fc is trained from
scratch. The rest loads with `strict=False`, as the reference's
`load_state_dict` and the JAX package's conversion do: keys the model lacks
are ignored and its keys the file lacks keep their initial values.
Relative-position tables are re-resolved to the model's input size
(`convert.load_reference_weights`), so a 224 px checkpoint fine-tunes a 384
px model.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from imagenet_models_tpu_torch.ckpt.convert import (load_reference_weights,
                                                    state_dict_from_checkpoint)

# classifier-fc layouts across the zoo: FB-style `head` Linear, timm
# `head.fc`, NormMlp-style `head.fc2` (ckpt/finetune.py:19-24)
_FC_SUFFIXES = ("head.weight", "head.bias",
                "head.fc.weight", "head.fc.bias",
                "head.fc2.weight", "head.fc2.bias")


def apply_finetune_checkpoint(model: torch.nn.Module, path: str, *, in21k_to_in1k: bool = False,
                              map_path: str = "in21k_1k_map.json") -> Tuple[torch.nn.Module, int]:
    """Load the checkpoint at `path` into `model` for fine-tuning
    (ckpt/finetune.py:27-52). Returns (model, the number of fc keys
    remapped or dropped)."""
    sd = state_dict_from_checkpoint(path)
    fc_keys = [k for k in sd if k.endswith(_FC_SUFFIXES)]
    if in21k_to_in1k:
        with open(map_path) as f:
            class_map = json.load(f)
        for k in fc_keys:
            old = sd[k].numpy()
            new = np.zeros((1000,) + old.shape[1:], old.dtype)
            new[class_map["in1k_idx"]] = old[class_map["in21k_idx"]]
            new[850] = old.mean(0)  # class 850 is missing in the map
            sd[k] = torch.from_numpy(new)
    else:
        for k in fc_keys:
            sd.pop(k)
    load_reference_weights(model, sd, strict=False)
    return model, len(fc_keys)
