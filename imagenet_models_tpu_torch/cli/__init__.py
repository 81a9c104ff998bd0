"""The port's command-line entries, each run as `python -m
imagenet_models_tpu_torch.cli.<entry>`: `train`, `validate`,
`train_with_script` (the recipe presets), `export_serving` and
`golden_eval`; and what they share."""

from __future__ import annotations

import os


def entry_device():
    """The device an entry runs on: the current GPU, or the CPU where
    IMTPU_PLATFORM=cpu (the variable the JAX CLIs read for the same
    purpose). Raises where there is no GPU and the CPU was not asked for."""
    from imagenet_models_tpu_torch.core.registry import resolve_device

    return resolve_device("cpu" if os.environ.get("IMTPU_PLATFORM", "") == "cpu" else None)


class Truncate:
    """Wrap a loader to cap steps per epoch (smoke runs, --max-steps-per-epoch,
    --max-batches).

    Reads AND writes of loader attributes (batch_size, mixup_enabled, ...)
    go to the wrapped loader, so engine-side toggles such as
    `--mixup-off-epoch` reach the real DataLoader."""

    _own = ("loader", "max_steps")

    def __init__(self, loader, max_steps):
        object.__setattr__(self, "loader", loader)
        object.__setattr__(self, "max_steps", max_steps)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __setattr__(self, name, value):
        if name in self._own:
            object.__setattr__(self, name, value)
        else:
            setattr(self.loader, name, value)

    def __len__(self):
        n = len(self.loader)
        return min(n, self.max_steps) if self.max_steps else n

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if self.max_steps and i >= self.max_steps:
                return
            yield b
