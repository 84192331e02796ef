"""repro_torch.optim -- AdamW with float32 master weights and the LR schedule.
The port of ``repro.optim``."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm  # noqa: F401
from .schedules import warmup_cosine  # noqa: F401
