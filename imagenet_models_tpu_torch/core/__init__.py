from imagenet_models_tpu_torch.core.registry import (  # noqa: F401
    create_model,
    default_cfg,
    list_models,
    register_model,
)
