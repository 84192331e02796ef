"""Model substrate of the port: parameter declarations, layer math, attention, the
decoder families and the model API (``zoo.build``)."""
from . import attention, mamba2, moe, nn, rwkv6, transformer, whisper, zamba2, zoo  # noqa: F401
from .zoo import Model, build  # noqa: F401
