"""Synthetic data (numpy): scientific fields (``fields``) and the token stream
(``tokens``), shared by the tests, the trainer and chip_smoke.py."""
