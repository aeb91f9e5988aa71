"""Seconds of set-up: inputs made from the seed, the problem built, the
kernels loaded (built on a checkout's first run), every shape warmed."""


def read(run):
    return run.setup_s
