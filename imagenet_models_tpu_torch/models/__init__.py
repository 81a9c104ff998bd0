from imagenet_models_tpu_torch.models import (  # noqa: F401  (registers the factories)
    convnext,
    fastervit,
    ga_convnext,
    ga_cswin,
    maxvit,
    mobilenet,
    pit,
    resnet,
)
