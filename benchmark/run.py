"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, which also end standard error.  Exits
with a code other than 0, printing no result, when no CUDA device is
there, when the program cannot be imported, or when JAX or the JAX
package was loaded.  See ``harness.py`` for what a run does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of compilers the program may use live in the checkout, at fixed
# paths (the port's own nvcc builds go to miniweatherml_tpu_torch/_build)
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "miniweatherml_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's, jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness
    manifest = harness.load_manifest(ROOT)
    cell = {w["name"]: w for w in manifest["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        import miniweatherml_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program cannot be imported: {e}", file=sys.stderr)
        return 4
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
