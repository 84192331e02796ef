"""The tiny shape of the ``orbital`` kind, which ``qmcpack-288`` uses, for the
CPU tests' copy of the benchmark (``tests/conftest.py:tiny_copy`` cuts every
configuration to its kind's entry in ``TINY_SHAPES``). Pytest loads this file
before ``tests/conftest.py``'s fixtures run. Two orbitals of 115 planes, so the
copy keeps an orbital boundary."""
from fzbench.tests.conftest import TINY_SHAPES

TINY_SHAPES.setdefault("orbital", [230, 6, 5])
