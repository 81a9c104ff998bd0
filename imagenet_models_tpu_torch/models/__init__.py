from imagenet_models_tpu_torch.models import convnext, maxvit  # noqa: F401  (registers the factories)
