"""repro_torch.train -- the training step, the serving steps the dry-run shares,
and the trainer loop. The port of ``repro.train``."""
from .step import (TrainConfig, build_decode_step, build_prefill_step,  # noqa: F401
                   build_train_step)
from .trainer import StragglerWatchdog, Trainer  # noqa: F401
