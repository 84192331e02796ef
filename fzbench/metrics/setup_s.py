"""Seconds from process start to the first timed call: imports, the kernels'
build or load, the fields, the set-up containers and the warm-up."""


def read(record):
    return record["setup_s"]
