"""Device ms a call (the union of the op intervals) of the ops launched inside
the program's ``fz.stage.dual_quantize`` ranges: strict mode's torch-op
quantize and outlier channel, over the profiled calls."""
from fzbench import inside


def read(record):
    return inside.stage_device_ms(record, "fz.stage.dual_quantize")
