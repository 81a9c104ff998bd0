"""Host-side image transforms with timm's train and eval semantics. Port of
imagenet_models_tpu/data/transforms.py.

train = RandomResizedCrop + flips + RandAugment (or color jitter) +
normalize + RandomErasing; eval = resize (shorter side / crop_pct) + center
crop + normalize. PIL on the host, producing HWC float32. PIL is imported
when a transform runs, so the package imports on a host without Pillow.
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def _pil_interp(name: str):
    from PIL import Image

    return {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
            "nearest": Image.NEAREST, "lanczos": Image.LANCZOS}[name]


def random_resized_crop(img, size: int, rng: random.Random,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                        interpolation="bicubic"):
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch)
            j = rng.randint(0, w - cw)
            img = img.crop((j, i, j + cw, i + ch))
            return img.resize((size, size), _pil_interp(interpolation))
    # fallback: center crop
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    i, j = (h - ch) // 2, (w - cw) // 2
    return img.crop((j, i, j + cw, i + ch)).resize((size, size), _pil_interp(interpolation))


def resize_center_crop(img, size: int, crop_pct: float = 0.875,
                       interpolation="bicubic", crop_mode: str = "center",
                       fill=(0.0, 0.0, 0.0)):
    """timm's eval modes. 'center': resize the shorter side to
    floor(size/crop_pct) keeping the aspect, center crop. 'squash': resize
    both sides to floor(size/crop_pct), center crop. 'border': resize so the
    longest side fits floor(size/crop_pct), pad to a square with the mean
    fill, center crop."""
    from PIL import Image

    scale_size = int(math.floor(size / crop_pct))
    w, h = img.size
    if crop_mode == "squash":
        img = img.resize((scale_size, scale_size), _pil_interp(interpolation))
    elif crop_mode == "border":
        ratio = scale_size / max(w, h)
        ow, oh = max(1, round(w * ratio)), max(1, round(h * ratio))
        img = img.resize((ow, oh), _pil_interp(interpolation))
        side = max(ow, oh, size)
        canvas = Image.new("RGB", (side, side),
                           tuple(int(round(255 * m)) for m in fill))
        canvas.paste(img, ((side - ow) // 2, (side - oh) // 2))
        img = canvas
    else:
        if w < h:
            ow, oh = scale_size, int(scale_size * h / w)
        else:
            ow, oh = int(scale_size * w / h), scale_size
        img = img.resize((ow, oh), _pil_interp(interpolation))
    ow, oh = img.size
    left, top = (ow - size) // 2, (oh - size) // 2
    return img.crop((left, top, left + size, top + size))


def to_float_chw_last(img, mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD) -> np.ndarray:
    a = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    a = (a - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return a  # HWC


def color_jitter(img, rng: random.Random, brightness: float,
                 contrast: float, saturation: float):
    """torchvision ColorJitter: each enabled op picks a factor uniformly from
    [max(0, 1-v), 1+v], and the ops run in random order."""
    from PIL import ImageEnhance

    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        fc = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(fc))
    if saturation > 0:
        fs = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(fs))
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


class TrainTransform:
    def __init__(self, size: int = 224, interpolation: str = "bicubic",
                 hflip: float = 0.5, vflip: float = 0.0,
                 color_jitter: float = 0.0, auto_augment: Optional[str] = None,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 reprob: float = 0.0, remode: str = "pixel", recount: int = 1,
                 scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size, self.interpolation = size, interpolation
        self.hflip, self.vflip, self.mean, self.std = hflip, vflip, mean, std
        self.scale, self.ratio = scale, ratio
        self.aa = None
        if auto_augment:
            from imagenet_models_tpu_torch.data.auto_augment import rand_augment_transform

            self.aa = rand_augment_transform(auto_augment)
        # timm disables color jitter when auto-augment is active
        self.color_jitter = 0.0 if auto_augment else color_jitter
        self.erase = None
        if reprob > 0:
            from imagenet_models_tpu_torch.data.random_erasing import RandomErasing

            self.erase = RandomErasing(reprob, mode=remode, count=recount)

    def __call__(self, img, rng: random.Random) -> np.ndarray:
        return self.post_decode_pil(self.primary(img, rng), rng)

    def primary(self, img, rng: random.Random):
        """The geometric part (RRC + flips), shared across aug-splits as timm's
        AugMixDataset applies the dataset transform once per sample."""
        from PIL import Image

        interp = self.interpolation
        if interp == "random":
            interp = rng.choice(["bilinear", "bicubic"])
        img = random_resized_crop(img, self.size, rng, self.scale, self.ratio, interp)
        if self.hflip and rng.random() < self.hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.vflip and rng.random() < self.vflip:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
        return img

    def finalize_clean(self, img, rng: random.Random, erase: bool = True) -> np.ndarray:
        """The clean aug-split: normalize only (no AA or color jitter); random
        erasing unless --resplit skips it."""
        a = to_float_chw_last(img, self.mean, self.std)
        if erase and self.erase is not None:
            a = self.erase(a, rng)
        return a

    def post_decode_pil(self, img, rng: random.Random) -> np.ndarray:
        if self.aa is not None:
            img = self.aa(img, rng)
        elif self.color_jitter > 0:
            cj = self.color_jitter
            img = color_jitter(img, rng, cj, cj, cj)
        a = to_float_chw_last(img, self.mean, self.std)
        if self.erase is not None:
            a = self.erase(a, rng)
        return a

    def post_decode(self, arr_uint8: np.ndarray, rng: random.Random) -> np.ndarray:
        """Finish a natively decoded (already cropped and flipped) uint8 HWC
        image: RandAugment + normalize + random erasing."""
        from PIL import Image

        return self.post_decode_pil(Image.fromarray(arr_uint8), rng)


class EvalTransform:
    def __init__(self, size: int = 224, crop_pct: float = 0.875,
                 interpolation: str = "bicubic",
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 crop_mode: str = "center"):
        self.size, self.crop_pct = size, crop_pct
        self.interpolation, self.mean, self.std = interpolation, mean, std
        self.crop_mode = crop_mode

    def __call__(self, img, rng=None) -> np.ndarray:
        img = resize_center_crop(img, self.size, self.crop_pct,
                                 self.interpolation, crop_mode=self.crop_mode,
                                 fill=self.mean)
        return to_float_chw_last(img, self.mean, self.std)
