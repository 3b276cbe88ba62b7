from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import SCHEDULES, make_schedule, wsd_schedule

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "SCHEDULES",
    "make_schedule",
    "wsd_schedule",
]
