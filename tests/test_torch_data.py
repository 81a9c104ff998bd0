"""The port's data pipeline against the JAX package's: for the same dataset,
seed and epoch, `imagenet_models_tpu_torch.data.loader.create_loader` yields
the batches of `imagenet_models_tpu.data.loader.create_loader` bit for bit:
images, targets (soft targets under mixup) and their order. Small images and
batches keep it cheap; every augmentation of the recipes runs."""

import numpy as np
import pytest
from PIL import Image

from imagenet_models_tpu.data import dataset as jdataset
from imagenet_models_tpu.data import loader as jloader
from imagenet_models_tpu.data import mixup as jmixup
from imagenet_models_tpu.data import native as jnative
from imagenet_models_tpu_torch.data import dataset as tdataset
from imagenet_models_tpu_torch.data import loader as tloader
from imagenet_models_tpu_torch.data import mixup as tmixup
from imagenet_models_tpu_torch.data import native as tnative

# the recipes' augmentations (train_with_script.py): RandAugment, random
# erasing, mixup 0.8 / cutmix 1.0 with label smoothing
AA = "rand-m9-mstd0.5-inc1"
TRAIN_KW = dict(interpolation="random", color_jitter=0.4, reprob=0.25, num_workers=2, seed=7)


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """A 12-image JPEG ImageFolder: 3 classes of 4 images of mixed sizes."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    for c in ("a", "b", "c"):
        (root / c).mkdir()
        for i in range(4):
            arr = rng.integers(0, 256, (40 + 8 * i, 48, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / c / f"{i}.jpg", quality=90)
    return str(root)


def _mixups(num_classes):
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, num_classes=num_classes)
    return jmixup.Mixup(**kw), tmixup.Mixup(**kw)


def _case(name, jpeg_root):
    """(JAX loader, port loader) of one case, on the same dataset and seed."""
    if name.startswith("synthetic"):
        split = "train" if name.endswith("train") else "validation"
        make = lambda pkg: pkg.create_dataset("synthetic:16", split, num_classes=5, image_size=40)
        jds, tds = make(jdataset), make(tdataset)
        if split == "train":
            kw = dict(TRAIN_KW, is_training=True)
        else:
            kw = dict(is_training=False, crop_pct=0.875, num_workers=2)
        return (jloader.create_loader(jds, 32, 4, **kw),
                tloader.create_loader(tds, 32, 4, **kw))
    jds, tds = jdataset.create_dataset(jpeg_root), tdataset.create_dataset(jpeg_root)
    jmix, tmix = _mixups(3)
    kw = dict(TRAIN_KW, is_training=True, auto_augment=AA)
    jl = jloader.create_loader(jds, 32, 4, mixup_fn=jmix, **kw)
    tl = tloader.create_loader(tds, 32, 4, mixup_fn=tmix, **kw)
    if name == "folder-pil":
        jl.native = tl.native = False
    else:
        if jnative.get_native_lib() is None or tnative.get_native_lib() is None:
            pytest.skip("the native loader did not build on this host (no g++ or libjpeg)")
        assert jl.native and tl.native and tl.decoder == "native"
    return jl, tl


@pytest.mark.parametrize("name", ["synthetic-train", "synthetic-eval", "folder-pil",
                                  "folder-native"])
def test_loader_batches_bit_equal_to_jax(name, jpeg_root):
    jl, tl = _case(name, jpeg_root)
    assert len(jl) == len(tl) > 1
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        got, ref = list(tl), list(jl)
        assert len(got) == len(ref) == len(tl)
        for (gx, gy), (rx, ry) in zip(got, ref):
            assert gx.dtype == rx.dtype == np.float32 and gx.shape == rx.shape
            np.testing.assert_array_equal(gx, rx)
            np.testing.assert_array_equal(gy, ry)
    if name.startswith("folder"):  # the soft targets of mixup, smoothing inside
        assert gy.ndim == 2 and np.allclose(gy.sum(axis=1), 1.0, atol=1e-5)


def test_loader_stops_its_workers_when_the_consumer_stops(jpeg_root):
    """A truncated epoch (the CLI's --max-steps-per-epoch) closes the loader's
    generator; its workers end instead of blocking on a full queue, and a
    worker's error reaches the consumer."""
    import threading

    ds = tdataset.create_dataset("synthetic:64", "validation", num_classes=5, image_size=16)
    before = set(threading.enumerate())
    loader = tloader.create_loader(ds, 16, 2, is_training=False, num_workers=3)
    it = iter(loader)
    next(it)
    started = [t for t in threading.enumerate() if t not in before]
    assert started  # the loader's workers
    it.close()
    # the loader joins its workers when the consumer stops: none of the
    # threads that were not there before is alive now (a global count would
    # also see threads of earlier tests ending meanwhile)
    assert [t for t in threading.enumerate() if t not in before] == []
    assert not any(t.is_alive() for t in started)

    class Broken(tdataset.SyntheticDataset):
        def load(self, index):
            raise OSError("unreadable image")

    bad = tloader.create_loader(Broken(8, 5, 16), 16, 2, is_training=False, num_workers=2)
    with pytest.raises(OSError, match="unreadable"):
        list(bad)
