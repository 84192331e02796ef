"""repro_torch.ckpt -- checkpoints (atomic, checksummed, FZ-compressible) and
elastic resharding. The port of ``repro.ckpt``."""
from . import checkpoint, elastic  # noqa: F401
from .checkpoint import latest_step, restore, save  # noqa: F401
