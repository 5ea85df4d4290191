from repro_torch.optim.optimizer import (
    OptState, adamw_update, global_norm, init_opt_state, make_schedule,
)

__all__ = ["OptState", "adamw_update", "global_norm", "init_opt_state",
           "make_schedule"]
