"""Mixup/CutMix with timm's `Mixup` semantics, on numpy with an explicit
`np.random.Generator`. Port of imagenet_models_tpu/data/mixup.py.

- modes 'batch' (one lambda per batch), 'pair' (i mixed with n-1-i, a shared
  lambda per pair) and 'elem' (a lambda per sample), by --mixup-mode
- cutmix boxes from the lambda (sqrt(1-lam) ratio) or from --cutmix-minmax
  per-dimension uniform ratios (timm forces cutmix_alpha=1.0 with minmax)
- the lambda corrected to the clipped box's area (timm correct_lam=True)
- targets become smoothed soft labels mixed against the reversed batch
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def one_hot_np(targets: np.ndarray, num_classes: int, on: float, off: float) -> np.ndarray:
    out = np.full((targets.shape[0], num_classes), off, dtype=np.float32)
    out[np.arange(targets.shape[0]), targets] = on
    return out


def rand_bbox(h: int, w: int, lam: float, rng: np.random.Generator):
    """timm cutmix bbox: cut ratio sqrt(1-lam), center anywhere, clipped at
    borders."""
    ratio = np.sqrt(1.0 - lam)
    cut_h, cut_w = int(h * ratio), int(w * ratio)
    cy = int(rng.integers(0, h))
    cx = int(rng.integers(0, w))
    y1, y2 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
    x1, x2 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
    return y1, y2, x1, x2


def rand_bbox_minmax(h: int, w: int, minmax: Sequence[float],
                     rng: np.random.Generator):
    """timm rand_bbox_minmax: bbox side lengths uniform in
    [minmax[0]*dim, minmax[1]*dim), placed fully inside the image."""
    cut_h = int(rng.integers(int(h * minmax[0]), int(h * minmax[1])))
    cut_w = int(rng.integers(int(w * minmax[0]), int(w * minmax[1])))
    y1 = int(rng.integers(0, h - cut_h))
    x1 = int(rng.integers(0, w - cut_w))
    return y1, y1 + cut_h, x1, x1 + cut_w


class Mixup:
    def __init__(self, mixup_alpha: float = 1.0, cutmix_alpha: float = 0.0,
                 cutmix_minmax: Optional[Sequence[float]] = None,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 label_smoothing: float = 0.1, num_classes: int = 1000,
                 mode: str = "batch"):
        self.mixup_alpha, self.cutmix_alpha = mixup_alpha, cutmix_alpha
        self.cutmix_minmax = tuple(cutmix_minmax) if cutmix_minmax else None
        if self.cutmix_minmax is not None:
            assert len(self.cutmix_minmax) == 2
            # timm: force cutmix_alpha=1.0 when minmax active (mixup.py logic)
            self.cutmix_alpha = 1.0
        self.prob, self.switch_prob = prob, switch_prob
        self.label_smoothing, self.num_classes = label_smoothing, num_classes
        if mode not in ("batch", "pair", "elem"):
            raise ValueError(f"--mixup-mode {mode}: expected batch/pair/elem")
        self.mode = mode
        self.mixup_enabled = True

    # -- lambda / cutmix draws ------------------------------------------------
    def _params_per_batch(self, rng: np.random.Generator) -> Tuple[float, bool]:
        lam, use_cutmix = 1.0, False
        if not self.mixup_enabled or rng.random() >= self.prob:
            return 1.0, False
        if self.mixup_alpha > 0 and self.cutmix_alpha > 0:
            use_cutmix = rng.random() < self.switch_prob
            alpha = self.cutmix_alpha if use_cutmix else self.mixup_alpha
            lam = float(rng.beta(alpha, alpha))
        elif self.mixup_alpha > 0:
            lam = float(rng.beta(self.mixup_alpha, self.mixup_alpha))
        elif self.cutmix_alpha > 0:
            use_cutmix = True
            lam = float(rng.beta(self.cutmix_alpha, self.cutmix_alpha))
        return lam, use_cutmix

    def _params_per_elem(self, n: int, rng: np.random.Generator):
        lam = np.ones(n, np.float32)
        use_cutmix = np.zeros(n, bool)
        if not self.mixup_enabled:
            return lam, use_cutmix
        if self.mixup_alpha > 0 and self.cutmix_alpha > 0:
            use_cutmix = rng.random(n) < self.switch_prob
            lam_mix = np.where(
                use_cutmix,
                rng.beta(self.cutmix_alpha, self.cutmix_alpha, n),
                rng.beta(self.mixup_alpha, self.mixup_alpha, n))
        elif self.mixup_alpha > 0:
            lam_mix = rng.beta(self.mixup_alpha, self.mixup_alpha, n)
        elif self.cutmix_alpha > 0:
            use_cutmix = np.ones(n, bool)
            lam_mix = rng.beta(self.cutmix_alpha, self.cutmix_alpha, n)
        else:
            return lam, use_cutmix
        enabled = rng.random(n) < self.prob
        lam = np.where(enabled, lam_mix.astype(np.float32), lam)
        return lam, use_cutmix

    def _bbox_and_lam(self, h: int, w: int, lam: float,
                      rng: np.random.Generator):
        """timm cutmix_bbox_and_lam with correct_lam=True: lambda becomes the
        actual kept-area fraction after clipping."""
        if self.cutmix_minmax is not None:
            y1, y2, x1, x2 = rand_bbox_minmax(h, w, self.cutmix_minmax, rng)
        else:
            y1, y2, x1, x2 = rand_bbox(h, w, lam, rng)
        lam = 1.0 - (y2 - y1) * (x2 - x1) / float(h * w)
        return (y1, y2, x1, x2), lam

    # -- mixing ---------------------------------------------------------------
    def _mix_batch(self, images: np.ndarray, rng: np.random.Generator):
        lam, use_cutmix = self._params_per_batch(rng)
        if lam == 1.0:
            return images, 1.0
        h, w = images.shape[1:3]
        if use_cutmix:
            (y1, y2, x1, x2), lam = self._bbox_and_lam(h, w, lam, rng)
            images = images.copy()
            images[:, y1:y2, x1:x2] = images[::-1, y1:y2, x1:x2]
        else:
            images = images * lam + images[::-1] * (1.0 - lam)
        return images, lam

    def _mix_elem(self, images: np.ndarray, rng: np.random.Generator):
        n = images.shape[0]
        h, w = images.shape[1:3]
        lam, use_cutmix = self._params_per_elem(n, rng)
        orig = images
        images = images.copy()
        for i in range(n):
            j = n - i - 1
            if lam[i] == 1.0:
                continue
            if use_cutmix[i]:
                (y1, y2, x1, x2), lam[i] = self._bbox_and_lam(h, w, lam[i], rng)
                images[i, y1:y2, x1:x2] = orig[j, y1:y2, x1:x2]
            else:
                images[i] = orig[i] * lam[i] + orig[j] * (1.0 - lam[i])
        return images, lam

    def _mix_pair(self, images: np.ndarray, rng: np.random.Generator):
        n = images.shape[0]
        h, w = images.shape[1:3]
        lam_half, use_cutmix = self._params_per_elem(n // 2, rng)
        orig = images
        images = images.copy()
        for i in range(n // 2):
            j = n - i - 1
            if lam_half[i] == 1.0:
                continue
            if use_cutmix[i]:
                (y1, y2, x1, x2), lam_half[i] = self._bbox_and_lam(
                    h, w, lam_half[i], rng)
                images[i, y1:y2, x1:x2] = orig[j, y1:y2, x1:x2]
                images[j, y1:y2, x1:x2] = orig[i, y1:y2, x1:x2]
            else:
                images[i] = orig[i] * lam_half[i] + orig[j] * (1.0 - lam_half[i])
                images[j] = orig[j] * lam_half[i] + orig[i] * (1.0 - lam_half[i])
        # timm: second half mirrors the first half's lambdas
        lam = np.concatenate([lam_half, np.ones(n - 2 * (n // 2), np.float32),
                              lam_half[::-1]])
        return images, lam

    def __call__(self, images: np.ndarray, targets: np.ndarray,
                 rng: np.random.Generator):
        """images: NHWC float; targets: int class ids. Returns mixed images +
        soft targets (always dense, smoothing baked in)."""
        off = self.label_smoothing / self.num_classes
        on = 1.0 - self.label_smoothing + off
        y = one_hot_np(targets, self.num_classes, on, off)

        if self.mode == "batch":
            images, lam = self._mix_batch(images, rng)
        elif self.mode == "elem":
            images, lam = self._mix_elem(images, rng)
        else:
            images, lam = self._mix_pair(images, rng)
        lam_col = lam if np.isscalar(lam) else np.asarray(lam, np.float32)[:, None]
        y = y * lam_col + y[::-1] * (1.0 - lam_col)
        return images.astype(np.float32), y
