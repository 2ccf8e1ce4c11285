from repro_torch.config.base import (DDLConfig, LMSConfig, MeshSpec,
                                     ModelConfig, ShapeConfig, TrainConfig)

__all__ = ["DDLConfig", "LMSConfig", "MeshSpec", "ModelConfig", "ShapeConfig",
           "TrainConfig"]
