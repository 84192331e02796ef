"""Device ops (kernels, memsets, copies) a call launches inside the program's
``fz.decompress`` profiler range, over the profiled calls."""
from fzbench import yardstick


def read(record):
    return yardstick.launches_per_call(record, "fz.decompress")
