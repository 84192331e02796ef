"""Device ms a call (the union of the op intervals) of the ops launched inside
the program's ``fz.stage.resolve_eb`` ranges: the bound's ``amax`` and
``amin`` and their scalar ops, over the profiled calls."""
from fzbench import inside


def read(record):
    return inside.stage_device_ms(record, "fz.stage.resolve_eb")
