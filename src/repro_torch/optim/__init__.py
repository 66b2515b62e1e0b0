from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState, adamw, apply_updates, clip_by_global_norm,
)
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule  # noqa: F401
