"""Device ms a call (the union of the op intervals) of K6's column passes, the
``scan_columns`` ops launched inside the program's ``fz.stage.fused_decompress``
ranges, over the profiled calls."""
from fzbench import columns


def read(record):
    return columns.device_ms(record)
