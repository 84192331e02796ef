"""Share of the profiled window's wall time in which no device op ran, in %."""
from fzbench import yardstick


def read(record):
    return yardstick.idle_pct(record, "decompress")
