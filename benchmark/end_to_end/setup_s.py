"""Seconds from process start to the end of set-up: imports, the build,
the inputs, the warm steps and the host copy of the compared fields."""


def read(run):
    return run.setup_s
