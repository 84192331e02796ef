"""Mean host ms a call of the program's own ``fz.decompress`` span (``obs``:
``span_ms`` sum over ``span_calls``), over the window's calls."""
from fzbench import yardstick


def read(record):
    return yardstick.span_mean_ms(record, "fz.decompress")
