"""Ms a decompress call of Python's collections: the program's ``gc_pause_ms``
(every generation) summed over the window, over its ``fz_dispatches{op=decompress}``."""
from fzbench import inside


def read(record):
    return inside.gc_ms(record, "decompress")
