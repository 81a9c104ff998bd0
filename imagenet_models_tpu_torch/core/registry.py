"""Model registry: string name -> factory producing a `torch.nn.Module`.

Port of imagenet_models_tpu/core/registry.py with the same model names and
data configs. Factories build the module and initialise its parameters with
the JAX package's init scheme, from an optional `torch.Generator`.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Callable, Dict, List, Optional

import torch

_REGISTRY: Dict[str, Callable[..., Any]] = {}
_DEFAULT_CFGS: Dict[str, Dict[str, Any]] = {}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def register_model(fn: Callable) -> Callable:
    """Decorator registering a model factory under its function name."""
    if fn.__name__ in _REGISTRY:
        raise ValueError(f"duplicate model registration: {fn.__name__}")
    _REGISTRY[fn.__name__] = fn
    return fn


def register_default_cfg(name: str, cfg: Dict[str, Any]) -> None:
    _DEFAULT_CFGS[name] = dict(cfg)


def default_cfg(name: str) -> Dict[str, Any]:
    """Data config for a model: input_size, crop_pct, interpolation, mean/std."""
    base = {
        "input_size": (224, 224, 3),
        "crop_pct": 0.875,
        "crop_mode": "center",
        "interpolation": "bicubic",
        "mean": IMAGENET_MEAN,
        "std": IMAGENET_STD,
        "num_classes": 1000,
    }
    base.update(_DEFAULT_CFGS.get(name, {}))
    return base


def resolve_device(device: Optional[torch.device | str] = None) -> torch.device:
    """The device an entry point builds on: `device` when given, else the
    current CUDA device. Raises when CUDA is asked for (or defaulted to) and
    absent: nothing is quietly built on the CPU; pass device="cpu" for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the GPU by default; "
                           "pass device='cpu' to build on the CPU")
    return dev


def create_model(model_name: str, device: Optional[torch.device | str] = None, **kwargs):
    """Build `model_name` on `device` (the GPU when None).

    kwargs go to the factory (num_classes, dtype, drop_path_rate, generator,
    ...); Nones are stripped, as timm does. The module is built and
    initialised on the CPU, so a seeded `generator` gives the same weights on
    every machine, and then moved to `device`.
    """
    if model_name not in _REGISTRY:
        raise KeyError(
            f"Unknown model {model_name!r}. Known: {', '.join(sorted(_REGISTRY))}")
    dev = resolve_device(device)
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    return _REGISTRY[model_name](**kwargs).to(dev)


def list_models(filter: str = "") -> List[str]:
    names = sorted(_REGISTRY)
    if filter:
        names = [n for n in names if fnmatch.fnmatch(n, filter)]
    return names
