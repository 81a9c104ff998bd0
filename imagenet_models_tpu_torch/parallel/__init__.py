"""Data parallelism over processes, one device each. Port of
imagenet_models_tpu/parallel/."""
