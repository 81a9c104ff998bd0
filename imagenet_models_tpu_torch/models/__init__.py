from imagenet_models_tpu_torch.models import convnext  # noqa: F401  (registers the factories)
