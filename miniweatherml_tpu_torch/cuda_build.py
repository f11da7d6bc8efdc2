"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, for ``sm_90a`` (Hopper), into ``_build/`` beside this file.
The library's file name carries a hash of the sources and flags, so an edit
or a flag change rebuilds and an unchanged tree reuses the library.  Nothing
here runs at import time: a wrapper calls ``load_library`` on its first
launch.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .utils.profiling import count, span

__all__ = ["load_library", "NVCC_FLAGS", "nvcc_flags", "on_cuda"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD = os.path.join(_PKG_DIR, "_build")

# --fmad=false: every multiply and add rounds on its own, as in the plain
# PyTorch versions, so a kernel and its plain version agree to the last
# bits except inside pow/exp.  A source listed in FMAD_SOURCES writes its
# arithmetic with round-to-nearest intrinsics instead and builds with
# contraction on, so that its pow and exp also round as PyTorch's (built
# that way) do.  --split-compile=0 optimizes a file's kernels in parallel on
# every core (the flux kernel has 192 instantiations in its reference
# algebra, 288 in its reduced-operation ones, 96 in the reference algebra
# with approximate reciprocals).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
FMAD_SOURCES = ("direction_fluxes", "direction_fluxes_opt",
                "direction_fluxes_ref_fast", "dycore_state", "kessler",
                "p3_lookup")


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    fmad = "true" if name in FMAD_SOURCES else "false"
    return NVCC_FLAGS + (f"--fmad={fmad}",)

_lock = threading.Lock()           # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit's "
                       "bin directory on PATH)")


def _sources(name: str) -> list[str]:
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    return [os.path.join(_CSRC, name + ".cu")] + [
        os.path.join(_CSRC, h) for h in headers]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    Different names may build concurrently (one nvcc each, from threads)."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        flags = nvcc_flags(name)
        h = hashlib.sha256(" ".join(flags).encode())
        for path in _sources(name):
            with open(path, "rb") as f:
                h.update(f.read())
        so = os.path.join(_BUILD, f"lib{name}_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *flags, "-o", tmp, _sources(name)[0]]
            count("cuda_build.builds")
            with span(f"build.{name}"):
                res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (rc {res.returncode}):\n"
                    f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
            with open(os.path.join(_BUILD, f"{name}.ptxas.txt"), "w") as f:
                f.write(res.stderr)
            os.replace(tmp, so)
        _libs[name] = ctypes.CDLL(so)
        return _libs[name]


def on_cuda(t) -> bool:
    """Whether a wrapper handed ``t`` launches its kernel (a CUDA tensor)
    or runs its plain version (a CPU tensor); other devices raise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True

