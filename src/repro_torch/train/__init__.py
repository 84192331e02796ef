"""repro_torch.train -- the training step and the trainer loop. The port of
``repro.train`` (``build_prefill_step`` / ``build_decode_step`` wait for the
dry-run tooling, ROADMAP queue 1 item 8)."""
from .step import TrainConfig, build_train_step  # noqa: F401
from .trainer import StragglerWatchdog, Trainer  # noqa: F401
