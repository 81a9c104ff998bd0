"""Weights into the port: JAX variables or reference `.pth.tar` files.

The port keeps its own copy of the JAX package's torch exporter
(`ckpt/torch_convert.py`: the pytree flatten, the Flax -> torch tensor
transform, `export_torch_state_dict`, `load_torch_checkpoint`) and of the
reverse name rules of the ported families (`ckpt/reverse_rules.py`:
`convnext_*`, `map_convnext_*`, `ga_convnext_*`, `*resnet50`, `*mobilenet_v1`;
`models/maxvit.py`: `*maxvit_*`;
`models/ga_cswin.py`: `ga_cswin*`, `ga_CSWin*`). It imports
nothing of the JAX package. Port modules use the reference's torch names and
layouts, so the exported state_dict loads into them with `strict=True`. The
rules of families not yet ported come with their slices.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def flatten_dict(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {'a/b/c': leaf}."""
    out = {}
    for k, v in d.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_dict(v, p))
        else:
            out[p] = v
    return out


def unflatten_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a/b/c': leaf} -> nested dict."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


class ReverseTranslator:
    """Ordered regex rewrites from a Flax module path to a torch dotted key."""

    def __init__(self, rules: Sequence[Tuple[str, str]]):
        self.rules = [(re.compile(p), r) for p, r in rules]

    def __call__(self, path: str) -> str:
        path = path.replace("/", ".")
        for pat, rep in self.rules:
            path = pat.sub(rep, path)
        return path


# the MAP head library's Flax names -> torch names (inverse of the JAX
# package's MAP_HEAD_RULES)
MAP_HEAD_REVERSE: List[Tuple[str, str]] = [
    (r"mmcap\.mmcap_(\d+)", r"mmcap.mmcap.\1"),
    (r"attention_(\d+)\.", r"attention.\1."),
    (r"self_dt_heads_(\d+)", r"self_dt_heads.\1"),
    (r"\bheads_(\d+)", r"heads.\1"),
    (r"(ch_reduction|concat_conv|channel_convertor|gram_contraction|gram_embedding)\.conv\b", r"\1.0"),
    (r"(ch_reduction|concat_conv|channel_convertor|gram_contraction|gram_embedding)\.bn\b", r"\1.1"),
    (r"bp_reduction\b(?!\.)", "bp_reduction.0"),
    (r"bp_bn\b", "bp_reduction.1"),
    (r"norm_(\d+)$", r"norm.\1"),
    (r"head_(\d+)$", r"head.\1"),
]

CONVNEXT_REVERSE: List[Tuple[str, str]] = [
    (r"downsample_layers_0_conv", "downsample_layers.0.0"),
    (r"downsample_layers_0_norm", "downsample_layers.0.1"),
    (r"downsample_layers_(\d+)_norm", r"downsample_layers.\1.0"),
    (r"downsample_layers_(\d+)_conv", r"downsample_layers.\1.1"),
    (r"stages_(\d+)_blocks_(\d+)\.", r"stages.\1.\2."),
] + MAP_HEAD_REVERSE

# models/maxvit.py:306-317. The TF rel-pos table (heads, 2H-1, 2W-1) passes
# through as it is; re-resolving it for another input size on load
# (ckpt/torch_convert.py:106-134) is not ported yet.
MAXVIT_REVERSE: List[Tuple[str, str]] = [
    (r"^stem_conv(\d)", r"stem.conv\1"),
    (r"^stem_norm1\.bn", "stem.norm1"),
    (r"^stages_(\d+)_blocks_(\d+)\.", r"stages.\1.blocks.\2."),
    (r"\bconv\.shortcut_expand", "conv.shortcut.expand"),
    (r"\bconv\.shortcut_conv", "conv.shortcut.0"),
    (r"\bconv\.shortcut_bn", "conv.shortcut.1"),
    (r"\bconv\.(pre_norm|norm1|norm2)\.bn", r"conv.\1"),
    (r"^head_norm", "head.norm"),
    (r"^head_pre_logits", "head.pre_logits.fc"),
    (r"^head_fc", "head.fc"),
] + MAP_HEAD_REVERSE

# models/ga_cswin.py:244-267; the `_bn` suffixes rewrite before their prefixes
GA_CSWIN_REVERSE: List[Tuple[str, str]] = [
    (r"^stem_conv0", "stage1_conv_embed.0"),
    (r"^stem_norm0", "stage1_conv_embed.2"),
    (r"^stem_conv1", "stage1_conv_embed.5"),
    (r"^stem_norm1", "stage1_conv_embed.7"),
    (r"^stem_conv2", "stage1_conv_embed.10"),
    (r"^stem_norm2", "stage1_conv_embed.12"),
    (r"^stage5_merge\.", "stage5.1."),
    (r"^stage5_block\.", "stage5.2."),
    (r"^stage(\d)_(\d+)\.", r"stage\1.\2."),
    (r"attns_(\d)\.", r"attns.\1."),
    (r"^gram_contraction_(\d+)_bn", r"gram_contraction.\1.1"),
    (r"^gram_contraction_(\d+)", r"gram_contraction.\1.0"),
    (r"^gram_layer_(\d+)\.", r"gram_layer.\1.1."),
    (r"^gram_embedding_(\d+)_bn", r"gram_embedding.\1.1"),
    (r"^gram_embedding_(\d+)", r"gram_embedding.\1.0"),
    (r"^ga_(\d+)\.", r"ga.\1."),
    (r"^fc_(\d+)$", r"fc.\1"),
]

# ckpt/reverse_rules.py:60-76
GA_CONVNEXT_REVERSE: List[Tuple[str, str]] = [
    (r"^stem_conv", "stem.0"),
    (r"^stem_norm", "stem.1"),
    (r"^stage4\.downsample_conv", "stages.4.downsample.0"),
    (r"^stage4\.downsample_bn", "stages.4.downsample.1"),
    (r"^stage4\.", "stages.4."),
    (r"^stages_(\d)\.downsample_norm", r"stages.\1.downsample.0"),
    (r"^stages_(\d)\.downsample_conv", r"stages.\1.downsample.1"),
    (r"^stages_(\d)\.blocks_(\d+)\.", r"stages.\1.blocks.\2."),
    (r"^gram_contraction_(\d+)_conv", r"gram_contraction.\1.0"),
    (r"^gram_contraction_(\d+)_bn", r"gram_contraction.\1.1"),
    (r"^gram_layer_(\d+)\.blocks_(\d+)\.", r"gram_layer.\1.blocks.\2."),
    (r"^gram_embedding_(\d+)_bn", r"gram_embedding.\1.1"),
    (r"^gram_embedding_(\d+)", r"gram_embedding.\1.0"),
    (r"^ga_(\d+)\.", r"ga.\1."),
    (r"^fc_(\d+)$", r"fc.\1"),
]

# GA-CSWin with stage5="bottleneck": the Bottleneck's shortcut is
# `stage5_block.downsample_{conv,bn}` in JAX and `downsample.{0,1}` in torch
# (as GA-ConvNeXt's stage 4). GA_CSWIN_REVERSE, the JAX package's list, maps
# only the `stage5_block.` prefix, so these two rules run before it.
GA_CSWIN_BOTTLENECK_REVERSE: List[Tuple[str, str]] = [
    (r"^stage5_block\.downsample_conv", "stage5_block.downsample.0"),
    (r"^stage5_block\.downsample_bn", "stage5_block.downsample.1"),
]

# ckpt/reverse_rules.py:78-97
RESNET_REVERSE: List[Tuple[str, str]] = [
    (r"^stem_(\d+)\.conv", r"stem.\1.0"),
    (r"^stem_(\d+)\.bn", r"stem.\1.1"),
    (r"^layer(\d+)_(\d+)\.", r"layer\1.\2."),
    (r"\bconv(\d)\.conv", r"conv\1.0"),
    (r"\bconv(\d)\.bn", r"conv\1.1"),
    (r"\bdownsample\.conv", "downsample.0"),
    (r"\bdownsample\.bn", "downsample.1"),
    (r"\bse\.fc1\.conv", "se.1.0"),
    (r"\bse\.fc1\.bn", "se.1.1"),
    (r"\bse\.fc2", "se.2"),
] + MAP_HEAD_REVERSE

# ckpt/reverse_rules.py:91-96, and the plain head's classifier: the
# reference's Sequential(avgpool, flatten, linear) keys it `fc.2`
# (models/mobilenet.py:106), a rule the JAX package's reverse list lacks
MOBILENET_REVERSE: List[Tuple[str, str]] = [
    (r"^layers_(\d+)_(\d+)\.conv0", r"layers.\1.\2.0"),
    (r"^layers_(\d+)_(\d+)\.bn0", r"layers.\1.\2.1"),
    (r"^layers_(\d+)_(\d+)\.conv1", r"layers.\1.\2.3"),
    (r"^layers_(\d+)_(\d+)\.bn1", r"layers.\1.\2.4"),
    (r"^fc$", "fc.2"),
] + MAP_HEAD_REVERSE

_REVERSE: Dict[str, List[Tuple[str, str]]] = {
    "convnext_*": CONVNEXT_REVERSE,
    "map_convnext_*": CONVNEXT_REVERSE,
    "ga_convnext_*": GA_CONVNEXT_REVERSE,
    "*resnet50": RESNET_REVERSE,
    "*mobilenet_v1": MOBILENET_REVERSE,
    "*maxvit_*": MAXVIT_REVERSE,
    "ga_cswin*": GA_CSWIN_BOTTLENECK_REVERSE + GA_CSWIN_REVERSE,
    "ga_CSWin*": GA_CSWIN_BOTTLENECK_REVERSE + GA_CSWIN_REVERSE,
}


def reverse_translator(model_name: str) -> ReverseTranslator:
    for pattern, rules in _REVERSE.items():
        if fnmatch.fnmatch(model_name, pattern):
            return ReverseTranslator(rules)
    raise KeyError(f"no reverse conversion rules for {model_name}")


def _to_torch(fval: np.ndarray, path: str) -> np.ndarray:
    """A Flax leaf in the torch layout: conv HWIO -> OIHW, Dense (I, O) -> (O, I),
    GroupedDense (g, I/g, O/g) -> grouped 1x1 conv (O, I/g, 1, 1)."""
    if path.endswith("kernel"):
        if fval.ndim == 4:
            return np.transpose(fval, (3, 2, 0, 1))
        if fval.ndim == 3:
            g, i, o = fval.shape
            return np.transpose(fval, (0, 2, 1)).reshape(g * o, i)[:, :, None, None]
        if fval.ndim == 2:
            return np.transpose(fval, (1, 0))
    # NHWC spatial parameter (PiT pos_embed) back to torch NCHW
    if path.endswith("pos_embed") and fval.ndim == 4:
        return np.transpose(fval, (0, 3, 1, 2))
    return fval


_LEAF_TO_SUFFIX = {"kernel": "weight", "scale": "weight", "bias": "bias",
                   "mean": "running_mean", "var": "running_var"}


def export_torch_state_dict(variables: Dict[str, Any],
                            translate_back: Callable[[str], str]) -> Dict[str, np.ndarray]:
    """Flax variables ({'params': ..., 'batch_stats': ...}) -> torch-layout
    state_dict with numpy values."""
    out: Dict[str, np.ndarray] = {}
    for col in ("params", "batch_stats"):
        for path, val in flatten_dict(variables.get(col, {})).items():
            parts = path.split("/")
            suffix = _LEAF_TO_SUFFIX.get(parts[-1])
            tbase = translate_back("/".join(parts[:-1]) if suffix else path)
            out[f"{tbase}.{suffix}" if suffix else tbase] = _to_torch(np.asarray(val), path)
    return out


def load_torch_checkpoint(path: str, use_ema: bool = False) -> Dict[str, np.ndarray]:
    """Read a reference .pth.tar / .pth checkpoint into numpy arrays (the
    'state_dict' / 'state_dict_ema' / 'model' wrappers and the DDP `module.`
    prefix are unwrapped)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        if use_ema and "state_dict_ema" in ckpt:
            ckpt = ckpt["state_dict_ema"]
        elif "state_dict" in ckpt:
            ckpt = ckpt["state_dict"]
        elif "model" in ckpt and isinstance(ckpt["model"], dict):
            ckpt = ckpt["model"]
    out = {}
    for k, v in ckpt.items():
        k = k[7:] if k.startswith("module.") else k
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


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
