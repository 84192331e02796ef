"""The profiled calls' least time at the card's HBM bandwidth (the raw field
and the stored container, each moved once), over the device time inside
``fz.compress`` ranges (the union of the device ops' intervals), in %."""
from fzbench import yardstick


def read(record):
    return yardstick.roofline_pct(record, "fz.compress")
