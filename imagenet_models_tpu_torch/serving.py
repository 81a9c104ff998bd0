"""Serving forward and its export: uint8 NHWC images -> fp32 head-averaged
logits.

Port of imagenet_models_tpu/serving.py. `make_serving_fn` is the live
function (:32-45). `export_serving` freezes the same function with
`torch.export` at a fixed batch, the weights inside the program, as JAX's
`jax.export` freezes its StableHLO; `write_artifact` saves the program
(`torch.export.save`) with a JSON sidecar of the host-side preprocessing
contract, and `load_artifact` reloads both.

The traced function is `ServingModule`: normalisation with mean and std as
buffers, the model, the head average. `model.eval()` and the grad mode are
set outside it: `make_serving_fn` calls it under `inference_mode`, and
`export_serving` traces it under `no_grad`.

How hermetic an artifact is, against JAX's:
- An export traced on the card calls the forward kernels through their
  custom ops (`imtpu::ln_mlp_fwd` and the others of `ops/library.py`): the
  program holds the graph and the weights, not the kernels. The serving host
  needs this package's op library, which `load_artifact` imports (no model
  code), and the kernels' build (nvcc for sm_90a at their first call, as
  everywhere in the port).
- An export traced on the CPU takes the kernels' twins, so it holds only
  aten ops and reloads with torch alone.
- JAX lowers one artifact for several platforms at once (`platforms=[...]`);
  here an artifact is traced for one `device`, and runs there.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence, Tuple

import torch

from imagenet_models_tpu_torch.core.registry import IMAGENET_MEAN, IMAGENET_STD

SIDECAR_SUFFIX = ".json"


class ServingModule(torch.nn.Module):
    """The serving function as a module: uint8 (B, H, W, 3) images ->
    `(x/255 - mean)/std` -> the model -> fp32 (B, num_classes), the mean of
    its heads' logits. Mean and std are fp32 buffers on the model's device."""

    def __init__(self, model: torch.nn.Module, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD, use_kernel: Optional[bool] = None):
        super().__init__()
        self.model = model
        self.use_kernel = use_kernel
        device = next(model.parameters()).device
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32, device=device))
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32, device=device))

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        # imported here: a host that only loads programs imports no layers
        from imagenet_models_tpu_torch.nn.heads import average_head_logits

        x = (images_u8.float() / 255.0 - self.mean) / self.std
        return average_head_logits(self.model(x, use_kernel=self.use_kernel))


def _check_images(images_u8: torch.Tensor) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
        raise ValueError(f"expected uint8 NHWC images, got {images_u8.dtype} "
                         f"{tuple(images_u8.shape)}")


def make_serving_fn(model: torch.nn.Module, mean: Sequence[float] = IMAGENET_MEAN,
                    std: Sequence[float] = IMAGENET_STD,
                    use_kernel: Optional[bool] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval forward over a uint8 (B, H, W, 3) batch -> fp32 (B, num_classes).

    Input contract: images already resized and center-cropped to the model's
    eval geometry on the host; `(x/255 - mean)/std` happens here.
    """
    serving = ServingModule(model, mean, std, use_kernel)

    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        _check_images(images_u8)
        model.eval()  # a train step in between leaves the model in train mode
        with torch.inference_mode():
            return serving(images_u8)

    return fn


def export_serving(model: torch.nn.Module, batch_size: int, img_size: int,
                   mean: Sequence[float], std: Sequence[float],
                   device: Optional[torch.device | str] = None,
                   use_kernel: Optional[bool] = None) -> "torch.export.ExportedProgram":
    """`torch.export` of the serving function at a fixed (batch_size,
    img_size, img_size, 3) uint8 input, traced on `device` (the model's when
    None; the model is moved there). The model's weights and the
    normalisation buffers are held in the program. `use_kernel` is the
    dispatch of `make_serving_fn`: None takes the kernels on the card and the
    twins on the CPU; True on the CPU traces the ops through their fake
    functions, into a program that only the card can run."""
    if device is not None:
        model.to(device)
    model.eval()
    serving = ServingModule(model, mean, std, use_kernel)
    dev = serving.mean.device
    example = torch.zeros(batch_size, img_size, img_size, 3, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        return torch.export.export(serving, (example,))


def write_artifact(exported: "torch.export.ExportedProgram", path: str, sidecar: dict) -> None:
    """The program at `path` (`torch.export.save`), the sidecar beside it at
    `path + ".json"`."""
    torch.export.save(exported, path)
    with open(path + SIDECAR_SUFFIX, "w") as f:
        json.dump(sidecar, f, indent=2, sort_keys=True)


def load_artifact(path: str) -> Tuple["torch.export.ExportedProgram", dict]:
    """Reload a saved program and its sidecar (an empty dict where there is
    none). Imports the port's op library first, so that a program traced on
    the card finds its `imtpu::` ops, and nothing of the model code. Call the
    program as `program.module()(images_u8)`."""
    from imagenet_models_tpu_torch.ops import library  # noqa: F401  (registers imtpu::)

    program = torch.export.load(path)
    sidecar = {}
    try:
        with open(path + SIDECAR_SUFFIX) as f:
            sidecar = json.load(f)
    except FileNotFoundError:
        pass
    return program, sidecar
