"""Raw bytes over stored bytes, summed over the window's calls (in decompress
cells, over the containers decompressed)."""


def read(record):
    calls = record["calls"]
    return sum(c["raw"] for c in calls) / sum(c["stored"] for c in calls) if calls else None
