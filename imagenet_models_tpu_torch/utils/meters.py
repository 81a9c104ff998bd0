"""Meters and logging. Port of imagenet_models_tpu/utils/meters.py.

timm's AverageMeter, the engine's logging setup, the per-epoch summary.csv
(timm update_summary) and the optional wandb mirror, which is imported only
when a run asks for it.
"""

from __future__ import annotations

import csv
import logging
import os
from collections import OrderedDict
from typing import Dict, Optional

_logger = logging.getLogger("imagenet_models_tpu_torch")


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def setup_default_logging(level=logging.INFO):
    # force=True: an earlier basicConfig (a library's, or a test runner's)
    # would otherwise keep the root logger and swallow the engine's INFO logs
    logging.basicConfig(level=level, force=True,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def init_wandb(project: str, run_name: str, config: Dict, resume_id: Optional[str] = None) -> bool:
    """Start a wandb run; False (with a warning) where wandb is not installed."""
    try:
        import wandb
    except ImportError:
        _logger.warning("You've requested to log metrics to wandb but package not found. "
                        "Metrics not being logged to wandb, try `pip install wandb`")
        return False
    if resume_id:
        wandb.init(project=project, name=run_name, config=config, resume="must", id=resume_id)
    else:
        wandb.init(project=project, name=run_name, config=config)
    return True


def update_summary(epoch: int, train_metrics: Dict, eval_metrics: Dict,
                   filename: str, write_header: bool = False, lr: Optional[float] = None,
                   log_wandb: bool = False):
    """Append one row of per-epoch metrics to summary.csv (timm update_summary):
    epoch, train_*, eval_*, lr; the header only with `write_header`."""
    rowd = OrderedDict(epoch=epoch)
    rowd.update([("train_" + k, v) for k, v in train_metrics.items()])
    rowd.update([("eval_" + k, v) for k, v in eval_metrics.items()])
    if lr is not None:
        rowd["lr"] = lr
    if log_wandb:
        import wandb

        wandb.log(dict(rowd))
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rowd.keys()))
        if write_header:
            writer.writeheader()
        writer.writerow(rowd)
