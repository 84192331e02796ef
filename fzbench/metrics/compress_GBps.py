"""Raw GB (1e9 bytes) of every compress call completed in the window, over its wall time."""
from fzbench import yardstick


def read(record):
    return yardstick.window_gbps(record, "compress")
