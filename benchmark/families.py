"""Kernel families by name: which layer of the port a device operation
belongs to.

Frozen from ``scripts/torch_port_measure.py::_family`` at commit b9c5862,
with its "microphysics" family split into Kessler, P3 and the surrogate by
the kernel names of ``miniweatherml_tpu_torch/csrc``.  Frozen: later edits
of that script do not reach it.  A kernel that matches no family of the
port's own sources is PyTorch's, the plain-PyTorch glue.
"""

from __future__ import annotations

# (family, name fragments), first match wins
FAMILIES = (
    ("flux", ("fluxes",)),
    ("fct", ("fct",)),
    ("kessler", ("kessler",)),
    ("p3", ("cellwise", "cell_kernel", "rates_pre", "ice_kernel",
            "collect_kernel", "rain_kernel", "sed_step", "sed_columns",
            "sed_vmax")),
    ("surrogate", ("surrogate",)),
)
GLUE = "glue"


def family(name: str) -> str:
    """The family of a device operation named ``name``."""
    n = name.lower()
    for fam, frags in FAMILIES:
        if any(f in n for f in frags):
            return fam
    return GLUE
