from imagenet_models_tpu_torch.ckpt.convert import (  # noqa: F401
    state_dict_from_checkpoint,
    state_dict_from_jax,
)
