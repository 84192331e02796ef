"""Synthetic scientific fields (numpy), shared by the tests and chip_smoke.py."""
