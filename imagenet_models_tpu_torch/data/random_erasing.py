"""Random Erasing with timm's semantics: applied after normalization; 'pixel'
mode fills with unit-normal noise (the recipes' `--remode pixel --reprob
0.25`). Port of imagenet_models_tpu/data/random_erasing.py."""

from __future__ import annotations

import math
import random

import numpy as np


class RandomErasing:
    def __init__(self, probability: float = 0.5, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 mode: str = "pixel", count: int = 1):
        self.probability = probability
        self.min_area, self.max_area = min_area, max_area
        self.log_aspect = (math.log(min_aspect), math.log(1 / min_aspect))
        self.mode, self.count = mode, count

    def __call__(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        """img: HWC float (already normalized)."""
        if rng.random() > self.probability:
            return img
        h, w, c = img.shape
        area = h * w
        img = img.copy()
        for _ in range(self.count):
            for _ in range(10):
                target = area * rng.uniform(self.min_area, self.max_area) / self.count
                aspect = math.exp(rng.uniform(*self.log_aspect))
                eh = int(round(math.sqrt(target * aspect)))
                ew = int(round(math.sqrt(target / aspect)))
                if eh < h and ew < w:
                    top = rng.randint(0, h - eh)
                    left = rng.randint(0, w - ew)
                    if self.mode == "pixel":
                        noise = np.random.default_rng(rng.getrandbits(32)).standard_normal(
                            (eh, ew, c)).astype(img.dtype)
                        img[top:top + eh, left:left + ew] = noise
                    elif self.mode == "const":
                        img[top:top + eh, left:left + ew] = 0
                    else:  # rand: same noise all channels
                        noise = np.random.default_rng(rng.getrandbits(32)).standard_normal(
                            (eh, ew, 1)).astype(img.dtype)
                        img[top:top + eh, left:left + ew] = noise
                    break
        return img
