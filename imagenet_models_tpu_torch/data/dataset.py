"""Datasets: ImageFolder (ImageNet layout) and synthetic generators. Port of
imagenet_models_tpu/data/dataset.py.

`load(index)` returns a PIL image and its label; the loader's worker threads
decode and augment on the host. PIL is imported where an image is made, so
the package imports on a host without Pillow.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolder:
    """ImageNet-style directory: root/<class>/<image>."""

    def __init__(self, root: str, class_map: Optional[dict] = None):
        self.root = root
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = class_map or {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def load(self, index: int):
        from PIL import Image

        path, label = self.samples[index]
        with Image.open(path) as img:
            return img.convert("RGB"), label

    @property
    def filenames(self):
        return [p for p, _ in self.samples]


class SyntheticDataset:
    """Deterministic random images: smoke training and timing without
    ImageNet on disk."""

    def __init__(self, length: int = 10000, num_classes: int = 1000,
                 image_size: int = 224):
        self.length, self.num_classes, self.image_size = length, num_classes, image_size

    def __len__(self):
        return self.length

    def load(self, index: int):
        from PIL import Image

        rng = np.random.default_rng(index)
        arr = rng.integers(0, 256, (self.image_size, self.image_size, 3), dtype=np.uint8)
        return Image.fromarray(arr, "RGB"), int(index % self.num_classes)


class SyntheticClassDataset(SyntheticDataset):
    """Learnable synthetic data: each class is a fixed low-frequency pattern
    (8x8 color grid upsampled) blended with per-sample noise, so the class
    survives RandomResizedCrop, flips and RandAugment. The validation split
    draws its noise from a disjoint seed range; the train split folds the
    loader epoch into the noise seed (`set_epoch`), so only the class template
    generalizes across epochs. Deterministic for a fixed (seed, epoch)."""

    def __init__(self, length: int = 10000, num_classes: int = 1000,
                 image_size: int = 224, seed_offset: int = 0,
                 epoch_varying: bool = False):
        super().__init__(length, num_classes, image_size)
        self.seed_offset = seed_offset
        self.epoch_varying = epoch_varying
        self._epoch = 0
        self._templates: dict = {}  # label -> fp32 image (idempotent fill)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _template(self, label: int) -> np.ndarray:
        from PIL import Image

        t = self._templates.get(label)
        if t is None:
            t8 = np.random.default_rng(1_000_003 + label).integers(
                0, 256, (8, 8, 3), dtype=np.uint8)
            t = np.asarray(Image.fromarray(t8, "RGB").resize(
                (self.image_size, self.image_size), Image.BILINEAR), np.float32)
            self._templates[label] = t
        return t

    def load(self, index: int):
        from PIL import Image

        label = int(index % self.num_classes)
        tmpl = self._template(label)
        seed = self.seed_offset + index
        if self.epoch_varying:
            seed += 1_000_033 * self._epoch
        noise = np.random.default_rng(seed).normal(0.0, 24.0, tmpl.shape)
        arr = np.clip(tmpl + noise, 0, 255).astype(np.uint8)
        return Image.fromarray(arr, "RGB"), label


def load_class_map(path: str) -> dict:
    """timm load_class_map: .txt = one class name per line (index = line
    number); .json = an explicit {name: idx} mapping."""
    if path.endswith(".json"):
        import json

        with open(path) as f:
            return {str(k): int(v) for k, v in json.load(f).items()}
    with open(path) as f:
        return {line.strip(): i for i, line in enumerate(f) if line.strip()}


#: timm dataset-factory names that resolve to plain folder datasets. Anything
#: else (tfds/, wds/, hfds/ ...) needs network egress and is refused.
FOLDER_DATASET_NAMES = ("imagefolder", "folder", "imagenet",
                        "torch/image_folder", "torch/folder", "torch/imagenet")


def check_dataset_name(name: str, flag: str = "--dataset") -> None:
    """Raise for dataset-factory names that cannot be served offline."""
    if name and name.lower() not in FOLDER_DATASET_NAMES:
        raise ValueError(
            f"{flag} {name!r}: only folder-style datasets are supported "
            "(tfds/wds/hfds factories need network egress); pass "
            f"{flag} '' and a directory data path")


def create_dataset(name_or_root: str, split: str = "train",
                   num_classes: int = 1000, image_size: int = 224,
                   class_map: Optional[str] = None):
    """`synthetic[-cls][:train_len[:val_len]]` (also `fake...`), or a folder:
    <root>/<split>, <root>/val for split "validation", then <root> itself."""
    if name_or_root.startswith(("synthetic", "fake")):
        length, lengths = 10000, name_or_root.split(":")[1:]
        if lengths:
            length = int(lengths[0])
            if split != "train" and len(lengths) > 1:
                length = int(lengths[1])
        if name_or_root.startswith("synthetic-cls"):
            train = split == "train"
            return SyntheticClassDataset(
                length=length, num_classes=num_classes, image_size=image_size,
                seed_offset=0 if train else 777_000_017, epoch_varying=train)
        return SyntheticDataset(length=length, num_classes=num_classes,
                                image_size=image_size)
    cmap = load_class_map(class_map) if class_map else None
    candidates = [os.path.join(name_or_root, split)]
    if split == "validation":
        candidates.append(os.path.join(name_or_root, "val"))
    candidates.append(name_or_root)
    for c in candidates:
        if os.path.isdir(c):
            try:
                return ImageFolder(c, class_map=cmap)
            except FileNotFoundError:
                continue
    raise FileNotFoundError(f"no dataset at {name_or_root} (split {split})")
