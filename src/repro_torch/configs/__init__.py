from repro_torch.configs.base import ARCHS, SHAPES, InputShape, ModelConfig, cell_is_runnable, get_config

__all__ = ["ARCHS", "SHAPES", "InputShape", "ModelConfig", "cell_is_runnable", "get_config"]
