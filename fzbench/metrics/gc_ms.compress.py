"""Ms a compress call of Python's collections: the program's ``gc_pause_ms``
(every generation) summed over the window, over its ``fz_dispatches{op=compress}``."""
from fzbench import inside


def read(record):
    return inside.gc_ms(record, "compress")
