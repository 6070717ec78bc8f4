"""Seconds from the process's start to the first timed call: imports, the
kernels' build or load, weights, state and inputs, the first steps."""


def read(rec):
    return rec["setup_s"]
