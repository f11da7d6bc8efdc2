"""Build the package's CUDA sources with ``nvcc``, and bind, check and
launch their kernels: the one seam between the wrappers and the libraries.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, for ``sm_90a`` (Hopper), into ``_build/`` beside this file.
The library's file name carries a hash of the sources and flags, so an edit
or a flag change rebuilds and an unchanged tree reuses the library
(``cached_build``, which the P3 native twin's g++ build shares).  A failed
build raises.

A wrapper declares its library once, as a ``KernelLibrary``: per kernel
stem the C parameter types without the trailing stream (the library
exports ``<stem>_f32`` and ``<stem>_f64``), and per query entry its
parameter and result types.  Nothing is built or loaded at import time: the
library loads on its first use.  A wrapper checks its operands with
``check_operand`` (a run of like operands with ``check_operands``) and
calls ``KernelLibrary.launch``, which picks the entry by dtype, passes the
current stream, raises on a refused launch and counts a successful one.
``KernelLibrary.use`` runs the wrappers on another build of the same entry
points (a variant, a parent tree's, a stand-in).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .utils.profiling import count, span

__all__ = ["KernelLibrary", "cached_build", "check_operand",
           "check_operands", "data_ptr", "load_library", "NVCC_FLAGS",
           "nvcc_flags", "on_cuda", "pointers"]

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

# the floating types every kernel takes, and their entry suffixes
_SUFFIXES = {torch.float32: "f32", torch.float64: "f64"}
# the C types of the signature tables: a pointer, an array of pointers,
# int, long long, a 64-bit mask, double
PTR, PTRS = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
INT, LONG, U64, DOUBLE = (ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64,
                          ctypes.c_double)


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


def cached_build(name: str, sources, flags, compiler, build_dir: str,
                 failure: str, log: str | None = None) -> str:
    """The path of ``build_dir/lib<name>_<hash>.so``, built from
    ``sources[0]`` first if it is not there.  The hash covers ``flags`` and
    every file of ``sources``.  ``compiler()`` names the compiler; it is
    called only for a build, which counts ``cuda_build.builds``, records
    the span ``build.<name>``, writes to a temporary file and renames it
    (a concurrent process sees all or nothing), and keeps the compiler's
    standard error in ``build_dir/<log>`` when ``log`` is given.  A build
    that fails raises RuntimeError starting with ``failure``, with the
    command and the compiler's output."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [compiler(), *flags, "-o", tmp, sources[0]]
    count("cuda_build.builds")
    try:
        with span(f"build.{name}"):
            res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{failure}: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{failure} (rc {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    if log is not None:
        with open(os.path.join(build_dir, log), "w") as f:
            f.write(res.stderr)
    os.replace(tmp, so)
    return so


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    Different names may build concurrently (one nvcc each, from threads).
    ``_build/<name>.ptxas.txt`` keeps the last build's register report."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _libs:
            so = cached_build(name, _sources(name), nvcc_flags(name), _nvcc,
                              _BUILD, f"nvcc failed for {name}.cu",
                              log=f"{name}.ptxas.txt")
            _libs[name] = ctypes.CDLL(so)
        return _libs[name]


class _Binding:
    """One loaded build's entry points, typed: every entry by its symbol,
    the kernels also by (stem, dtype)."""

    def __init__(self, lib, name, signatures, kernels):
        self.path = getattr(lib, "_name", None)
        self.entries = {}
        for symbol, (params, restype) in signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes = list(params)
            fn.restype = restype
            self.entries[symbol] = fn
        self.kernels = {key: self.entries[symbol]
                        for symbol, key in kernels.items()}
        self.error_string = self.entries[f"{name}_error_string"]

    def fail(self, what: str, rc: int):
        raise RuntimeError(f"{what} failed: "
                           + self.error_string(rc).decode())


class KernelLibrary:
    """The entry points of the library ``csrc/<name>.cu``, declared once.

    Args:
      name: the library (``load_library``'s name).
      kernels: kernel stem -> its C parameter types (ctypes), without the
        trailing stream.  The library exports ``<stem>_f32`` and
        ``<stem>_f64`` (only ``<stem>_f32`` for a stem in ``f32_only``),
        each taking the stream last and returning an error code.
      queries: entry -> (parameter types, result type) of the library's
        other entry points.
      f32_only: the stems with no float64 entry.

    ``<name>_error_string`` (an error code to its message) is declared
    here.  ``signatures`` holds every symbol's (parameter types, result
    type).  The library is built and loaded on first use; its functions
    are typed once per loaded build.
    """

    def __init__(self, name: str, kernels, queries=None, f32_only=()):
        self.name = name
        self.signatures: dict[str, tuple[tuple, type]] = {}
        self._kernels: dict[str, tuple[str, torch.dtype]] = {}
        for stem, params in kernels.items():
            for dtype, suffix in _SUFFIXES.items():
                if dtype == torch.float64 and stem in f32_only:
                    continue
                symbol = f"{stem}_{suffix}"
                self.signatures[symbol] = ((*params, PTR), INT)
                self._kernels[symbol] = (stem, dtype)
        for entry, (params, restype) in (queries or {}).items():
            self.signatures[entry] = (tuple(params), restype)
        self.signatures[f"{name}_error_string"] = ((INT,), ctypes.c_char_p)
        self._bound: _Binding | None = None
        self._lock = threading.Lock()

    def bind(self, lib) -> _Binding:
        """``lib`` (a loaded build, or any object with the entry points as
        attributes) with every declared entry typed."""
        return _Binding(lib, self.name, self.signatures, self._kernels)

    def _binding(self) -> _Binding:
        b = self._bound
        if b is None:
            with self._lock:
                if self._bound is None:
                    self._bound = self.bind(load_library(self.name))
                b = self._bound
        return b

    @property
    def path(self) -> str | None:
        """The file of the build in use (the library loads on first use)."""
        return self._binding().path

    @contextlib.contextmanager
    def use(self, lib):
        """Inside the block the wrappers run on ``lib``: a path to another
        build of the same entry points, or a loaded one."""
        if isinstance(lib, (str, os.PathLike)):
            lib = ctypes.CDLL(os.fspath(lib))
        prev, self._bound = self._bound, self.bind(lib)
        try:
            yield
        finally:
            self._bound = prev

    def launch(self, stem: str, like: torch.Tensor, *args,
               counter: str | None = None) -> None:
        """Launch kernel ``stem`` of ``like``'s dtype with ``args`` and the
        current stream of ``like``'s device.  A launch the library refuses
        raises RuntimeError with the kernel's name and the library's
        message, and counts nothing; a launch that goes counts
        ``counter``."""
        b = self._bound or self._binding()
        fn = b.kernels.get((stem, like.dtype))
        if fn is None:
            raise TypeError(f"{self.name} has no {like.dtype} {stem} kernel")
        # the current stream's handle, as Triton's launcher reads it: no
        # torch.cuda.Stream is built, which would cost more than the rest
        # of the launch path
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(like.get_device()))
        if rc != 0:
            b.fail(f"{stem} kernel launch", rc)
        if counter is not None:
            count(counter)

    def call(self, entry: str, *args) -> None:
        """Call ``entry``, which returns an error code; a nonzero one
        raises RuntimeError with the entry's name and the library's
        message."""
        b = self._binding()
        rc = b.entries[entry](*args)
        if rc != 0:
            b.fail(entry, rc)

    def query(self, entry: str, *args):
        """``entry``'s result: a value the caller reads, not an error
        code."""
        return self._binding().entries[entry](*args)


def data_ptr(t) -> int | None:
    """The tensor's data pointer; a null pointer for None."""
    return None if t is None else t.data_ptr()


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' data pointers (one null pointer when
    there are none)."""
    return (PTR * max(len(tensors), 1))(
        *(t.data_ptr() for t in tensors))


def _operand_dtype(name, like, dtype):
    """``dtype``, or ``like``'s when None, which must be float32 or
    float64."""
    if dtype is None:
        dtype = like.dtype
        if dtype not in _SUFFIXES:
            raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    return dtype


def _fits(t, device, shape, dtype) -> bool:
    # a torch.Size equals a tuple of its sizes; other sequences are compared
    # as tuples
    return (t.dtype == dtype and t.device == device and t.is_contiguous()
            and (shape is None or t.shape == shape
                 or tuple(t.shape) == tuple(shape)))


def _reject(name, t, like, shape, dtype):
    want = "" if shape is None else f" of shape {tuple(shape)}"
    contiguous = t.is_contiguous()
    raise (TypeError if t.dtype != dtype else ValueError)(
        f"{name} must be a contiguous {dtype} tensor{want} on device "
        f"{like.device}, got a {'' if contiguous else 'non-contiguous '}"
        f"{t.dtype} tensor of shape {tuple(t.shape)} on device {t.device}")


def check_operand(name: str, t, like, shape=None, dtype=None) -> None:
    """Raise unless ``t``, a kernel's operand ``name``, is a contiguous
    tensor on ``like``'s device, of ``dtype`` and, when given, of
    ``shape``.  ``dtype`` defaults to ``like``'s, which must then be
    float32 or float64.  A wrong dtype raises TypeError, anything else
    ValueError; the message names the operand, what it must be and what it
    is."""
    dtype = _operand_dtype(name, like, dtype)
    if not _fits(t, like.device, shape, dtype):
        _reject(name, t, like, shape, dtype)


def check_operands(name: str, tensors, like, shape=None,
                   dtype=None) -> None:
    """``check_operand`` of each of ``tensors``, the i-th named
    ``<name> <i>``."""
    dtype = _operand_dtype(name, like, dtype)
    device = like.device
    for i, t in enumerate(tensors):
        if not _fits(t, device, shape, dtype):
            _reject(f"{name} {i}", t, like, shape, dtype)


def on_cuda(t) -> bool:
    """Whether a wrapper handed ``t`` launches its kernel (a CUDA tensor)
    or runs its plain version (a CPU tensor); other devices raise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True
