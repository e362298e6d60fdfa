"""setup_s: process start to the first timed operation, in seconds:
imports, the kernel library (built on the first run in a checkout), weights,
inputs, capture and warm-up."""


def read(run):
    return run.setup_s
