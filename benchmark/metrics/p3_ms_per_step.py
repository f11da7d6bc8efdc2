"""Device ms a step of the P3 kernels: lookups, per-cell phases and
sedimentation (``csrc/p3_lookup.cu``, ``p3_cellwise.cu``, ``p3_sed.cu``)."""

from ._layer import ms_per_step


def read(trace):
    return ms_per_step(trace, "p3")
