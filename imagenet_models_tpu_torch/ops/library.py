"""The port's custom ops: the forward kernels an eval forward can reach, as
`torch.library` ops in the namespace `imtpu`.

Each op is defined beside its wrapper, with `mutates_args=()` and a fake
function that gives the output's shape, dtype and strides from the inputs'
alone; the op's real function holds the wrapper's checks, workspace,
`data_ptr` reads, launch and launch count. The wrappers call their op, so the
eager path and a program that `torch.export` traced run the same code:

| op | kernel | wrapper |
|---|---|---|
| `imtpu::ln_mlp_fwd` | 1 | `ops/convnext_block.fused_ln_mlp` |
| `imtpu::partition_attn_fwd` | 3 | `ops/partition_attention.fused_partition_attention` |
| `imtpu::stripe_attn_fwd` | 5 | `ops/stripe_attention.fused_stripe_attention` |
| `imtpu::window_attn_fwd` | 12 | `ops/flash_attention.fused_window_attention` |
| `imtpu::window_attn_heads_fwd` | 13 | `ops/flash_attention.fused_window_attention_heads` |

There is no CPU registration: a CPU tensor takes the kernel's twin, chosen
before the op is called, and an op called on CPU tensors raises. The backward
kernels and kernels 7-11 stay `ctypes` calls inside autograd functions.

Importing this module registers every op, and imports nothing of the model
code: it is what a serving host needs to load an exported program
(`serving.load_artifact`).
"""

from __future__ import annotations

from typing import List

import torch

from imagenet_models_tpu_torch.ops import convnext_block  # noqa: F401  (imtpu::ln_mlp_fwd)
from imagenet_models_tpu_torch.ops import flash_attention  # noqa: F401  (window_attn_*)
from imagenet_models_tpu_torch.ops import partition_attention  # noqa: F401
from imagenet_models_tpu_torch.ops import stripe_attention  # noqa: F401

NAMESPACE = "imtpu"


def program_ops(exported: "torch.export.ExportedProgram") -> List[str]:
    """The `imtpu::` ops that an exported program's graph calls, sorted."""
    return sorted({node.target.name() for node in exported.graph.nodes
                   if node.op == "call_function"
                   and isinstance(node.target, torch._ops.OpOverload)
                   and node.target.namespace == NAMESPACE})
