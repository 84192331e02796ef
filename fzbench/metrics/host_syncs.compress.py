"""Host reads of device values a compress call, size read included: the
program's ``fz_host_syncs`` (every site) over its ``fz_dispatches{op=compress}``,
over the window's calls."""
from fzbench import inside


def read(record):
    return inside.host_syncs(record, "compress")
