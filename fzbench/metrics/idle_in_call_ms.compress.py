"""Ms a call of the program's ``fz.compress`` host ranges in the profiled window
in which no device op ran (the gaps of the union of device ops inside each
range), over the ranges."""
from fzbench import inside


def read(record):
    return inside.idle_in_call_ms(record, "fz.compress")
