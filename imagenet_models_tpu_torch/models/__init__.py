from imagenet_models_tpu_torch.models import convnext, ga_cswin, maxvit  # noqa: F401  (registers the factories)
