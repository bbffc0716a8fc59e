from repro_torch.configs.base import (
    INPUT_SHAPES, EncDecSpec, InputShape, ModelConfig, MoESpec, SSMSpec, ServingSpec,
    get_config, get_input_shape, list_archs, register,
)

__all__ = [
    "INPUT_SHAPES", "EncDecSpec", "InputShape", "ModelConfig", "MoESpec",
    "SSMSpec", "ServingSpec", "get_config", "get_input_shape", "list_archs", "register",
]
