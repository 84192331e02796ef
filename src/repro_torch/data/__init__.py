"""Synthetic data (numpy): scientific fields (``fields``) and the token stream
(``tokens``), shared by the tests, the trainer and chip_smoke.py."""
from .fields import FIELD_KINDS, make_field  # noqa: F401
from .tokens import TokenStream  # noqa: F401
