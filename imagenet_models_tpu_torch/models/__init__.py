from imagenet_models_tpu_torch.models import convnext, ga_cswin, maxvit, mobilenet, resnet  # noqa: F401  (registers the factories)
