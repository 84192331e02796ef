"""95th percentile (nearest rank) over every call of the window, from entry to
the size read or to the field being ready, on the card's clock."""
from fzbench import yardstick


def read(record):
    return yardstick.p95(c["ms"] for c in record["calls"]) if record["calls"] else None
