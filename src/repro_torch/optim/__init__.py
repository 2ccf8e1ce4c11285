from repro_torch.optim.adamw import (OPTIMIZERS, AdamState, SGDState,
                                     adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     sgdm_init, sgdm_update)
from repro_torch.optim.schedule import SCHEDULES, constant, warmup_cosine

__all__ = ["OPTIMIZERS", "SCHEDULES", "AdamState", "SGDState", "adamw_init",
           "adamw_update", "clip_by_global_norm", "constant", "global_norm",
           "sgdm_init", "sgdm_update", "warmup_cosine"]
