"""Mean host ms a call of the program's ``fz.used_bytes`` span (``obs``:
``span_ms`` sum over ``span_calls``), the size read that ends each compress
call and waits for the card, over the window's calls."""
from fzbench import yardstick


def read(record):
    return yardstick.span_mean_ms(record, "fz.used_bytes")
