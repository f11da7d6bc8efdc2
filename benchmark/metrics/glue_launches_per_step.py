"""Device operations a step outside the port's own kernel families."""


def read(trace):
    ops = trace.family_ops("glue")
    if not ops or not trace.steps:
        return None
    return len(ops) / trace.steps
