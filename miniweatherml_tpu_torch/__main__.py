"""Top-level CLI: dispatch to the experiment drivers.

Port of ``miniweatherml_tpu/__main__.py``.  Usage:
  python -m miniweatherml_tpu_torch <experiment> <input.yaml> [--device cpu|cuda]
  python -m miniweatherml_tpu_torch --list

The reference builds one executable per experiment
(experiments/*/CMakeLists.txt); here they are subcommands.  Every
experiment runs on the GPU unless given ``--device cpu``.
"""

from __future__ import annotations

import importlib
import sys

__all__ = ["main"]

_EXPERIMENTS = {
    "supercell_example": "canonical supercell: WENO dycore + Kessler + "
                         "sponge + nudging (reference supercell_example)",
    "community_benchmark": "timed benchmark loop, output off "
                           "(reference community_benchmark)",
    "simple_city": "flow over immersed buildings + horizontal sponge + "
                   "time averager (reference simple_city)",
    "supercell_p3": "supercell with P3 ice microphysics (p3_backend: "
                    "torch, jax or native)",
    "gather_statistics": "measure the active-microphysics cell ratio",
    "generate_micro_data": "harvest stratified Kessler training pairs",
    "inference_surrogate": "run with the MLP surrogate micro inline",
}


def main(argv=None):
    """Run the named experiment's ``main`` on the rest of the command line
    and return what it returns."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("--list", "-l", "--help", "-h"):
        print("usage: python -m miniweatherml_tpu_torch <experiment> "
              "<input.yaml> [--device cpu|cuda]")
        print("\nexperiments:")
        for name, desc in _EXPERIMENTS.items():
            print(f"  {name:<22s} {desc}")
        print("\noffline training: python -m miniweatherml_tpu_torch.ml.train "
              "<dataset> [prefix] [--device cpu|cuda]")
        raise SystemExit(0 if argv else 2)
    name = argv[0]
    if name not in _EXPERIMENTS:
        raise SystemExit(f"unknown experiment {name!r}; see --list")
    mod = importlib.import_module(f"{__package__}.experiments.{name}")
    return mod.main(argv[1:])


if __name__ == "__main__":
    main()
