from repro_torch.config.base import ModelConfig, ShapeConfig

__all__ = ["ModelConfig", "ShapeConfig"]
