"""Weights into the port: JAX variables or reference `.pth.tar` files.

The port keeps its own copy of the JAX package's torch exporter
(`ckpt/torch_convert.py`: the pytree flatten, the Flax -> torch tensor
transform, `export_torch_state_dict`, `load_torch_checkpoint`) and of the
reverse name rules of the ported families (`ckpt/reverse_rules.py`:
`convnext_*`, `map_convnext_*`, `ga_convnext_*`, `*resnet50`, `*mobilenet_v1`,
`*pit_s`; `models/maxvit.py`: `*maxvit_*`; `models/ga_cswin.py`: `ga_cswin*`,
`ga_CSWin*`; `models/fastervit.py`: `*faster_vit*`, with its alias). It
imports nothing of the JAX package. Port modules use the reference's torch
names and layouts, so the exported state_dict loads into them with
`strict=True`.

Every load of a reference-format file goes through `load_reference_weights`,
which re-resolves each relative-position bias table whose shape differs from
the model's (a 224 px MaxViT checkpoint into `maxvit_tiny_tf_384`), as the
JAX converter does on every torch-format load (`_to_flax`,
ckpt/torch_convert.py:106-141); every other key keeps its strict check.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from imagenet_models_tpu_torch.nn.layers import resize_bilinear


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
    """Ordered regex rewrites from a Flax module path to a torch dotted key.

    `aliases` rewrite a torch key to the second key of a module that the
    reference registers under two parents (FasterViT's
    `global_tokenizer.pos_embed`, also `global_tokenizer.to_global_feature.
    pos`): a reference state_dict carries both, so the export writes both
    (ckpt/reverse_rules.py:13-35)."""

    def __init__(self, rules: Sequence[Tuple[str, str]],
                 aliases: Sequence[Tuple[str, str]] = ()):
        self.rules = [(re.compile(p), r) for p, r in rules]
        self.aliases = [(re.compile(p), r) for p, r in aliases]

    def __call__(self, path: str) -> str:
        path = path.replace("/", ".")
        for pat, rep in self.rules:
            path = pat.sub(rep, path)
        return path

    def alias_keys(self, tkey: str) -> List[str]:
        """The other torch keys that `tkey` must also be written under."""
        return [pat.sub(rep, tkey) for pat, rep in self.aliases if pat.search(tkey)]


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

# models/maxvit.py:306-317
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

# models/ga_cswin.py:244-267; the `_bn` suffixes rewrite before their prefixes.
# The 7x7 stem of `deep_stem=False` (`stem_conv0` with its bias, `stem_norm0`)
# is the reference's `stage1_conv_embed.0` and `.2`: the deep stem's first rules.
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

# ckpt/reverse_rules.py:98-102
PIT_REVERSE: List[Tuple[str, str]] = [
    (r"^transformers_(\d+)_blocks_(\d+)\.", r"transformers.\1.blocks.\2."),
    (r"^pools_(\d+)", r"pools.\1.conv"),
    (r"^patch_embed$", "patch_embed.conv"),
] + MAP_HEAD_REVERSE

# models/fastervit.py:428-445
FASTERVIT_REVERSE: List[Tuple[str, str]] = [
    (r"^patch_embed_conv0", "patch_embed.conv_down.0"),
    (r"^patch_embed_bn0", "patch_embed.conv_down.1"),
    (r"^patch_embed_conv1", "patch_embed.conv_down.3"),
    (r"^patch_embed_bn1", "patch_embed.conv_down.4"),
    (r"^levels_(\d)_blocks_(\d+)\.", r"levels.\1.blocks.\2."),
    (r"^levels_(\d)_downsample_norm", r"levels.\1.downsample.norm"),
    (r"^levels_(\d)_downsample_conv", r"levels.\1.downsample.reduction.0"),
    (r"^levels_(\d)_global_tokenizer\.pos_embed", r"levels.\1.global_tokenizer.pos_embed"),
    (r"cpb_mlp\.fc1", "cpb_mlp.0"),
    (r"cpb_mlp\.fc2", "cpb_mlp.2"),
] + MAP_HEAD_REVERSE
FASTERVIT_ALIASES: List[Tuple[str, str]] = [
    (r"(global_tokenizer)\.pos_embed\.", r"\1.to_global_feature.pos."),
]

_REVERSE: Dict[str, List[Tuple[str, str]]] = {
    "convnext_*": CONVNEXT_REVERSE,
    "map_convnext_*": CONVNEXT_REVERSE,
    "ga_convnext_*": GA_CONVNEXT_REVERSE,
    "*resnet50": RESNET_REVERSE,
    "*mobilenet_v1": MOBILENET_REVERSE,
    "*maxvit_*": MAXVIT_REVERSE,
    "ga_cswin*": GA_CSWIN_BOTTLENECK_REVERSE + GA_CSWIN_REVERSE,
    "ga_CSWin*": GA_CSWIN_BOTTLENECK_REVERSE + GA_CSWIN_REVERSE,
    "*pit_s": PIT_REVERSE,
    "*faster_vit*": FASTERVIT_REVERSE,
}
_ALIASES: Dict[str, List[Tuple[str, str]]] = {"*faster_vit*": FASTERVIT_ALIASES}


def reverse_translator(model_name: str) -> ReverseTranslator:
    for pattern, rules in _REVERSE.items():
        if fnmatch.fnmatch(model_name, pattern):
            return ReverseTranslator(rules, _ALIASES.get(pattern, ()))
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
                            translate_back: ReverseTranslator) -> Dict[str, np.ndarray]:
    """Flax variables ({'params': ..., 'batch_stats': ...}) -> torch-layout
    state_dict with numpy values."""
    out: Dict[str, np.ndarray] = {}
    for col in ("params", "batch_stats"):
        for path, val in flatten_dict(variables.get(col, {})).items():
            parts = path.split("/")
            suffix = _LEAF_TO_SUFFIX.get(parts[-1])
            tbase = translate_back("/".join(parts[:-1]) if suffix else path)
            tkey = f"{tbase}.{suffix}" if suffix else tbase
            out[tkey] = _to_torch(np.asarray(val), path)
            for dup in translate_back.alias_keys(tkey):
                out[dup] = out[tkey]
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
# step counter, the triu-index buffer the port keeps non-persistent, and
# FasterViT's coordinate tables, bias index and bias cache, which the port
# keeps as constants (the JAX package drops them on import too,
# models/fastervit.py:423-426).
_NOT_LOADED = ("num_batches_tracked", "bp_index", "relative_coords_table",
               "relative_position_index", "relative_bias")


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


def resize_rel_pos_table(table: torch.Tensor, shape: Sequence[int], key: str) -> torch.Tensor:
    """A relative-position bias table re-resolved to another window size
    (ckpt/torch_convert.py:106-134): the (2H-1, 2W-1) lattice bilinearly
    interpolated, half-pixel centers, no antialias (timm
    resize_rel_pos_bias_table semantics), in fp32, cast back. Layouts: TF
    (heads, 2H-1, 2W-1) and ((2H-1)*(2W-1), heads), the latter square only."""
    shape = tuple(shape)
    t = table.detach().cpu()
    if t.dim() == 3 and len(shape) == 3:  # (heads, h, w)
        x = t.permute(1, 2, 0).float()[None]
        return resize_bilinear(x, shape[1:3])[0].permute(2, 0, 1).to(t.dtype).contiguous()
    if t.dim() == 2 and len(shape) == 2:  # (L, heads), L = (2H-1)^2
        sl, tl = int(round(float(np.sqrt(t.shape[0])))), int(round(float(np.sqrt(shape[0]))))
        if sl * sl != t.shape[0] or tl * tl != shape[0]:
            raise ValueError(f"non-square rel-pos table at {key}: {tuple(t.shape)} -> {shape}")
        x = t.reshape(sl, sl, -1).float()[None]
        return resize_bilinear(x, (tl, tl))[0].reshape(tl * tl, -1).to(t.dtype).contiguous()
    raise ValueError(f"cannot re-resolve rel-pos table at {key}: {tuple(t.shape)} -> {shape}")


def load_reference_weights(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                           strict: bool = True):
    """Load a reference-format state_dict into `model` (`strict` as
    `load_state_dict`), each `relative_position_bias_table` whose shape
    differs from the model's re-resolved to it first. Returns
    `load_state_dict`'s result."""
    own = model.state_dict()
    sd = {k: resize_rel_pos_table(v, own[k].shape, k)
          if "relative_position_bias_table" in k and k in own and v.shape != own[k].shape else v
          for k, v in sd.items()}
    return model.load_state_dict(sd, strict=strict)
