"""RandAugment with timm's semantics for config strings like
`rand-m9-mstd0.5-inc1`. Port of imagenet_models_tpu/data/auto_augment.py.

2 layers by default, each op applied with probability 0.5, gaussian
magnitude jitter (mstd), magnitudes clipped to [0, 10], the "increasing
severity" op set of -inc1, grey (128) fill, a random bilinear/bicubic
resample for the geometric ops. PIL is imported when an op runs.
"""

from __future__ import annotations

import random
from typing import Callable, List

_LEVEL_DENOM = 10.0
_FILL = (128, 128, 128)


def _interp(rng: random.Random):
    from PIL import Image

    return rng.choice([Image.BILINEAR, Image.BICUBIC])


def _randomly_negate(v, rng):
    return -v if rng.random() > 0.5 else v


# --- op implementations -----------------------------------------------------

def auto_contrast(img, level, rng):
    from PIL import ImageOps

    return ImageOps.autocontrast(img)


def equalize(img, level, rng):
    from PIL import ImageOps

    return ImageOps.equalize(img)


def invert(img, level, rng):
    from PIL import ImageOps

    return ImageOps.invert(img)


def rotate(img, level, rng):
    deg = _randomly_negate(level / _LEVEL_DENOM * 30.0, rng)
    return img.rotate(deg, resample=_interp(rng), fillcolor=_FILL)


def posterize_inc(img, level, rng):
    from PIL import ImageOps

    bits = 4 - int(level / _LEVEL_DENOM * 4)
    if bits >= 8:
        return img
    return ImageOps.posterize(img, max(1, bits)) if bits > 0 else img


def solarize_inc(img, level, rng):
    from PIL import ImageOps

    thresh = 256 - int(level / _LEVEL_DENOM * 256)
    return ImageOps.solarize(img, min(256, max(0, thresh)))


def solarize_add(img, level, rng):
    add = int(level / _LEVEL_DENOM * 110)
    lut = [min(255, i + add) if i < 128 else i for i in range(256)]
    if img.mode in ("L", "RGB"):
        if img.mode == "RGB":
            lut = lut + lut + lut
        return img.point(lut)
    return img


def _enhance_inc(name: str):
    def fn(img, level, rng):
        from PIL import ImageEnhance

        f = 1.0 + _randomly_negate(level / _LEVEL_DENOM * 0.9, rng)
        return getattr(ImageEnhance, name)(img).enhance(max(0.1, f))

    return fn


def _affine(img, coeffs, rng):
    from PIL import Image

    return img.transform(img.size, Image.AFFINE, coeffs, resample=_interp(rng), fillcolor=_FILL)


def shear_x(img, level, rng):
    v = _randomly_negate(level / _LEVEL_DENOM * 0.3, rng)
    return _affine(img, (1, v, 0, 0, 1, 0), rng)


def shear_y(img, level, rng):
    v = _randomly_negate(level / _LEVEL_DENOM * 0.3, rng)
    return _affine(img, (1, 0, 0, v, 1, 0), rng)


def translate_x_rel(img, level, rng):
    v = _randomly_negate(level / _LEVEL_DENOM * 0.45, rng) * img.size[0]
    return _affine(img, (1, 0, v, 0, 1, 0), rng)


def translate_y_rel(img, level, rng):
    v = _randomly_negate(level / _LEVEL_DENOM * 0.45, rng) * img.size[1]
    return _affine(img, (1, 0, 0, 0, 1, v), rng)


_RAND_INCREASING: List[Callable] = [
    auto_contrast, equalize, invert, rotate, posterize_inc, solarize_inc,
    solarize_add,
    _enhance_inc("Color"), _enhance_inc("Contrast"),
    _enhance_inc("Brightness"), _enhance_inc("Sharpness"),
    shear_x, shear_y, translate_x_rel, translate_y_rel,
]


class RandAugment:
    def __init__(self, magnitude: float = 9, num_layers: int = 2,
                 mstd: float = 0.5, prob: float = 0.5):
        self.magnitude, self.num_layers = magnitude, num_layers
        self.mstd, self.prob = mstd, prob

    def __call__(self, img, rng: random.Random):
        for _ in range(self.num_layers):
            if rng.random() > self.prob:
                continue
            op = rng.choice(_RAND_INCREASING)
            m = self.magnitude
            if self.mstd > 0:
                if self.mstd > 100:
                    m = rng.uniform(0, self.magnitude)
                else:
                    m = rng.gauss(self.magnitude, self.mstd)
            m = min(_LEVEL_DENOM, max(0.0, m))
            img = op(img, m, rng)
        return img


def rand_augment_transform(config_str: str) -> RandAugment:
    """Parse a timm-style config string: rand-m9-mstd0.5-inc1[-n2][-p0.5]."""
    parts = config_str.split("-")
    if parts[0] != "rand":
        raise ValueError(f"RandAugment config {config_str!r} must start with 'rand'")
    magnitude, mstd, num_layers, prob = 9.0, 0.0, 2, 0.5
    inc = False
    for p in parts[1:]:
        if p.startswith("mstd"):
            mstd = float(p[4:])
        elif p.startswith("m"):
            magnitude = float(p[1:])
        elif p.startswith("inc"):
            # timm reads any digit-carrying value (`-inc0` too) as a non-empty
            # string, so every `-inc<digit>` selects the increasing set
            inc = p[3:3 + 1].isdigit()
        elif p.startswith("n"):
            num_layers = int(p[1:])
        elif p.startswith("p"):
            prob = float(p[1:])
        elif p.startswith("w"):
            pass  # weighted choice unused by the recipes
    if not inc:
        # only timm's "increasing" op set is implemented (every recipe passes
        # inc1); the other set's magnitude math differs, so refuse it
        raise NotImplementedError(
            f"RandAugment config {config_str!r} lacks '-inc1': only the "
            "timm 'increasing' op set is implemented (all reference recipes "
            "use inc1). Append -inc1 or use a recipe config.")
    return RandAugment(magnitude=magnitude, num_layers=num_layers, mstd=mstd, prob=prob)
