"""Raw GB (1e9 bytes) reconstructed in the window, over the window's wall time."""
from fzbench import yardstick


def read(record):
    return yardstick.window_gbps(record, "decompress")
