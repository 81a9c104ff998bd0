"""The reference's weight init for from-scratch training. Port of
imagenet_models_tpu/core/reinit.py.

The factories initialise every conv and dense weight with trunc_normal(0.02),
which is what the ConvNeXt families do, but the reference's other families
initialise differently (the JAX file's docstring cites each):

- resnet: convs kaiming_normal(mode='fan_out', relu gain); Linear keeps
  trunc_normal(0.02); `zero_init_last` zeroes the last BN's gamma
  (`conv3.1.weight`) of every bottleneck;
- cswin and fastervit: convs keep torch's default, U(+-1/sqrt(fan_in)) for
  the weight and for its bias;
- pit and mobilenet: convs and Linear both keep torch's default (PiT's
  pos_embed, a parameter of its own, keeps its init);
- ConvNeXt, MaxViT and unknown names: unchanged.

"Conv" is a weight of rank 4 in the torch layout: a Conv2d, or a grouped
pointwise projection (`GroupedDense`, whose JAX leaf is (g, I/g, O/g)), as
the JAX rules take every kernel of rank >= 3; "dense" is a Linear weight of
rank 2. The draws come from one `torch.Generator` on the CPU, seeded from
`seed`, in parameter order, and are copied to the parameters' device; they
cannot match `jax.random`'s bits, but the distributions and the set of
rewritten tensors are the JAX package's.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch

from imagenet_models_tpu_torch.nn.layers import grouped_weights

_ZERO_INIT_LAST = re.compile(r"(^|\.)conv3[^.]*\.1\.weight$")


def _family(model_name: str) -> Optional[str]:
    n = model_name.lower()
    if "resnet" in n:
        return "resnet"
    if "cswin" in n:
        return "torch_conv"          # Linear trunc-normal'd by the model
    if "faster_vit" in n or "fastervit" in n:
        return "torch_conv"
    if "pit" in n:
        return "torch_all"           # Linear + conv both torch default
    if "mobilenet" in n:
        return "torch_all"
    return None                       # convnext/maxvit/unknown: leave as-is


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


@torch.no_grad()
def reference_init(model_name: str, model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Rewrite `model`'s parameters in place to the reference init scheme of
    its family (module docstring); returns `model`."""
    fam = _family(model_name)
    if fam is None:
        return model
    gen = torch.Generator().manual_seed(seed ^ 0x5EED1217)
    groups = grouped_weights(model)
    torch_dense = fam == "torch_all"

    def put(p: torch.Tensor, value: torch.Tensor):
        p.copy_(value.to(device=p.device, dtype=p.dtype))

    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        weight = module._parameters.get("weight")
        bias = module._parameters.get("bias")
        if weight is None or weight.dim() < 2:
            continue
        conv_like = weight.dim() == 4
        fan_in = weight[0].numel()  # I/g * kh * kw; I for a dense (O, I) weight
        if conv_like and fam == "resnet":
            g = groups.get(prefix + "weight")
            fan_out = weight.shape[0] // g if g else weight.shape[0] * weight[0, 0].numel()
            put(weight, torch.randn(weight.shape, generator=gen) * math.sqrt(2.0 / fan_out))
        elif conv_like or torch_dense:
            b = 1.0 / math.sqrt(fan_in)
            put(weight, _uniform(weight.shape, b, gen))
            if bias is not None:
                put(bias, _uniform(bias.shape, b, gen))
    if fam == "resnet":
        for name, p in model.named_parameters():
            if _ZERO_INIT_LAST.search(name):
                p.zero_()
    return model
