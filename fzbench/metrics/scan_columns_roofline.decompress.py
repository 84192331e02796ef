"""K6's column passes' least time over their device time, in %: 8 bytes an
element a pass (a 4-byte read and a 4-byte write) at the card's HBM bandwidth,
the passes a call being the ``scan_columns`` ops inside
``fz.stage.fused_decompress`` over the profiled calls, against those ops'
device time."""
from fzbench import columns


def read(record):
    return columns.roofline_pct(record)
