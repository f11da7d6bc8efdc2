"""The seam between the port's wrappers and its kernel libraries
(``miniweatherml_tpu_torch/cuda_build.py``), on the CPU: no card, no nvcc.

* Every library's signature table: each declared entry is typed on a
  stand-in library, and the table agrees with the ``extern "C"`` entry
  points of ``csrc/<name>.cu`` (every symbol, every parameter's C type).
* ``KernelLibrary.launch`` / ``call`` / ``query`` / ``use`` on a stand-in
  library: the entry by dtype, the stream last, a refused launch raises with
  the library's message and counts nothing, a launch counts once; the
  library loads on its first use, once.
* ``check_operand``: one case per rejection; ``check_operands`` names the
  operand at fault.
* ``cached_build`` with g++: built once, reused, rebuilt for other flags,
  and a failed build raises with the compiler's output.
* ``exact_div``: one correctly rounded division, a number on either side.
"""

import ctypes
import os
import re

import pytest
import torch

from miniweatherml_tpu_torch import cuda_build as CB
from miniweatherml_tpu_torch.ops import dycore_state, fct
from miniweatherml_tpu_torch.ops import direction_fluxes as DF
from miniweatherml_tpu_torch.ops.exact_div import exact_div
from miniweatherml_tpu_torch.physics import (kessler_cuda,
                                             kessler_surrogate_cuda,
                                             p3_cellwise_cuda,
                                             p3_lookup_cuda, p3_sed_cuda)
from miniweatherml_tpu_torch.utils import profiling

CSRC = os.path.join(os.path.dirname(CB.__file__), "csrc")
# every kernel library of the package, by name
LIBRARIES = {lib.name: lib for lib in (
    *DF.LIBRARIES.values(), fct.LIBRARY, dycore_state.LIBRARY,
    kessler_cuda.LIBRARY, kessler_surrogate_cuda.LIBRARY,
    p3_cellwise_cuda.LIBRARY, p3_lookup_cuda.LIBRARY, p3_sed_cuda.LIBRARY)}


def test_every_library_is_declared():
    """The ten libraries, one per ``csrc/*.cu`` but the P3 native twin's
    C++ (which has no ``.cu``)."""
    sources = {f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu")}
    assert set(LIBRARIES) == sources and len(LIBRARIES) == 10


class _Entry:
    """An entry point of a stand-in library: records its calls and returns
    ``rc``; takes argument and result types like a ctypes function."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _StandIn:
    """A stand-in library: an ``_Entry`` for every symbol asked for."""

    def __init__(self, **entries):
        self.__dict__.update(entries)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        entry = self.__dict__[name] = _Entry()
        return entry


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_binding_types_every_declared_entry(name):
    """Binding a stand-in declares each entry's parameter and result types
    as the table says: the kernels of both float types (the f32-only stems
    of f32 alone) with the stream last and an int result, the queries, and
    ``<name>_error_string``."""
    lib = LIBRARIES[name]
    stand_in = _StandIn()
    binding = lib.bind(stand_in)
    assert set(binding.entries) == set(lib.signatures)
    assert f"{name}_error_string" in lib.signatures
    for symbol, (params, restype) in lib.signatures.items():
        fn = getattr(stand_in, symbol)
        assert binding.entries[symbol] is fn
        assert fn.argtypes == list(params) and fn.restype is restype, symbol
    for (stem, dtype), fn in binding.kernels.items():
        symbol = f"{stem}_{'f32' if dtype == torch.float32 else 'f64'}"
        assert fn is getattr(stand_in, symbol)
        assert fn.argtypes[-1] is ctypes.c_void_p and fn.restype is CB.INT
    if name.startswith("direction_fluxes"):
        # the 35 parameters of csrc/direction_fluxes.cuh's entry points
        assert {len(fn.argtypes) for fn in binding.kernels.values()} == {35}


# -- the tables against the C sources ---------------------------------------

# C scalar type -> its ctypes type
_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "double": ctypes.c_double, "uint64_t": ctypes.c_uint64,
            "unsigned": ctypes.c_uint, "const char*": ctypes.c_char_p}


def _macros(text):
    """{name: (parameters, body)} of the function-like macros in ``text``."""
    text = text.replace("\\\n", " ")
    return {m.group(1): ([p.strip() for p in m.group(2).split(",")],
                         m.group(3))
            for m in re.finditer(r"#define (\w+)\(([^)]*)\)(.*)", text)}


def _exports(name):
    """{symbol: (return type, [parameter types])} of the ``extern "C"``
    functions of ``csrc/<name>.cu``, its macros expanded."""
    with open(os.path.join(CSRC, name + ".cu")) as f:
        text = f.read()
    macros = {}
    for header in sorted(os.listdir(CSRC)):
        if header.endswith(".cuh"):
            with open(os.path.join(CSRC, header)) as f:
                macros.update(_macros(f.read()))
    macros.update(_macros(text))
    blocks = re.findall(r'extern "C" \{(.*?)\}  // extern "C"', text,
                        re.S)
    assert blocks, name
    body = re.sub(r"#define .*?(?<!\\)\n", "\n", "".join(blocks),
                  flags=re.S)
    body = re.sub(r"//[^\n]*", "", body)
    for macro, (params, expansion) in macros.items():
        def expand(m, params=params, expansion=expansion):
            out = expansion
            for p, a in zip(params, m.group(1).split(",")):
                out = out.replace(f"##{p}", a.strip())
                out = re.sub(rf"\b{p}\b", a.strip(), out)
            return out
        body = re.sub(rf"\b{macro}\(([^)]*)\)", expand, body)
    found = {}
    for m in re.finditer(r"([A-Za-z_][\w ]*?\**)\s*\b(\w+)\s*\(([^()]*)\)"
                         r"\s*\{", body):
        ret, fn, params = m.group(1).strip(), m.group(2), m.group(3)
        if ret in ("return", "else", "if"):
            continue
        types = [re.sub(r"\s*\b\w+$", "", p.strip())
                 for p in params.split(",") if p.strip()]
        found[fn] = (ret, types)
    return found


def _matches(ctype, c):
    """Whether the ctypes type declared for a parameter passes what the C
    parameter of type ``c`` takes."""
    c = re.sub(r"\s+", " ", c.replace("const ", "")).strip()
    stars = c.count("*")
    base = c.replace("*", "").strip()
    if stars == 2:
        return ctype is CB.PTRS
    if stars == 1:
        return ctype is ctypes.c_void_p or (
            getattr(ctype, "_type_", None) is _SCALARS.get(base))
    return ctype is _SCALARS[c]


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_signatures_match_the_sources(name):
    """Every declared symbol is an ``extern "C"`` function of the source
    and every exported function is declared, with as many parameters, each
    of the C type's ctypes kind (any single pointer may be declared
    ``c_void_p``), and the result type."""
    lib, exports = LIBRARIES[name], _exports(name)
    assert set(lib.signatures) == set(exports), name
    for symbol, (params, restype) in lib.signatures.items():
        ret, types = exports[symbol]
        assert len(params) == len(types), symbol
        for i, (ctype, c) in enumerate(zip(params, types)):
            assert _matches(ctype, c), (symbol, i, c, ctype)
        assert restype is _SCALARS[ret.replace(" *", "*")], (symbol, ret)


# -- launch, call, query and use on a stand-in ------------------------------

_LIB = CB.KernelLibrary("stand_in", {"kern": [CB.PTR, CB.INT],
                                     "only32": [CB.PTR]},
                        {"stand_in_query": ([CB.INT], CB.LONG),
                         "stand_in_config": ([CB.INT, CB.PTR], CB.INT)},
                        f32_only=["only32"])


class _Message(_Entry):
    """A stand-in's ``<name>_error_string``: "bad launch <rc>"."""

    def __call__(self, rc):
        self.calls.append((rc,))
        return f"bad launch {rc}".encode()


@pytest.fixture
def stand_in(monkeypatch):
    """``_LIB`` on a stand-in inside the test, with a current stream of
    handle 1234 on any device."""
    lib = _StandIn(stand_in_error_string=_Message())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234, raising=False)
    with _LIB.use(lib):
        yield lib


@pytest.mark.parametrize("dtype, symbol", [(torch.float32, "kern_f32"),
                                           (torch.float64, "kern_f64")])
def test_launch_picks_the_entry_by_dtype_and_counts_once(stand_in, dtype,
                                                         symbol):
    """rc 0: the entry of ``like``'s dtype gets the arguments and then the
    stream, and the counter counts one launch."""
    n0 = profiling.counter("stand_in.launches")
    _LIB.launch("kern", torch.zeros(2, dtype=dtype), 7, 3,
                counter="stand_in.launches")
    assert getattr(stand_in, symbol).calls == [(7, 3, 1234)]
    other = "kern_f64" if symbol == "kern_f32" else "kern_f32"
    assert getattr(stand_in, other).calls == []
    assert profiling.counter("stand_in.launches") == n0 + 1


def test_a_refused_launch_raises_and_counts_nothing(stand_in):
    stand_in.kern_f32 = _Entry(rc=9)
    with _LIB.use(stand_in):
        n0 = profiling.counter("stand_in.launches")
        with pytest.raises(RuntimeError,
                           match="kern kernel launch failed: bad launch 9"):
            _LIB.launch("kern", torch.zeros(2), 7, 3,
                        counter="stand_in.launches")
        assert profiling.counter("stand_in.launches") == n0
    # a dtype the library has no kernel of
    with pytest.raises(TypeError, match="only32"):
        _LIB.launch("only32", torch.zeros(2, dtype=torch.float64), 7)


def test_call_raises_like_a_launch_and_query_returns_the_value(stand_in):
    _LIB.call("stand_in_config", 1, None)
    assert stand_in.stand_in_config.calls == [(1, None)]
    stand_in.stand_in_config = _Entry(rc=2)
    stand_in.stand_in_query = _Entry(rc=-5)
    with _LIB.use(stand_in):
        with pytest.raises(RuntimeError,
                           match="stand_in_config failed: bad launch 2"):
            _LIB.call("stand_in_config", 1, None)
        assert _LIB.query("stand_in_query", 4) == -5


def test_use_restores_the_build_before_it(stand_in):
    """Nested ``use`` blocks run on the innermost build and give back the
    outer one, also when the block raises."""
    inner = _StandIn(stand_in_error_string=_Message())
    with pytest.raises(KeyError):
        with _LIB.use(inner):
            _LIB.launch("kern", torch.zeros(1), 1, 2)
            raise KeyError("out")
    _LIB.launch("kern", torch.zeros(1), 3, 4)
    assert inner.kern_f32.calls == [(1, 2, 1234)]
    assert stand_in.kern_f32.calls == [(3, 4, 1234)]


def test_the_library_loads_on_first_use_once(monkeypatch):
    """Declaring a library loads nothing; its first use loads it through
    ``load_library`` once, and ``path`` names the loaded file."""
    loads = []

    def load(name):
        loads.append(name)
        return _StandIn(_name="/builds/libstand_in.so",
                        stand_in_error_string=_Message())
    monkeypatch.setattr(CB, "load_library", load)
    lib = CB.KernelLibrary("stand_in", {"kern": [CB.PTR, CB.INT]})
    assert loads == []
    assert lib.query("stand_in_error_string", 3) == b"bad launch 3"
    assert lib.path == "/builds/libstand_in.so" and loads == ["stand_in"]


def test_pointers_and_data_ptr():
    ts = [torch.zeros(3), torch.ones(2)]
    arr = CB.pointers(ts)
    assert [arr[i] for i in range(2)] == [t.data_ptr() for t in ts]
    assert len(CB.pointers([])) == 1 and CB.pointers([])[0] is None
    assert CB.data_ptr(None) is None and CB.data_ptr(ts[0]) == ts[0].data_ptr()


# -- check_operand ------------------------------------------------------------

_LIKE = torch.zeros((2, 3))


@pytest.mark.parametrize("t, kw, error, words", [
    (torch.zeros((2, 3), dtype=torch.float16), {"like_self": True},
     TypeError, "is not float32/float64"),
    (torch.zeros((2, 3), dtype=torch.float64), {}, TypeError,
     "contiguous torch.float32 tensor"),
    (torch.zeros((2, 3)), {"dtype": torch.int32}, TypeError,
     "torch.int32"),
    (torch.zeros((2, 3), device="meta"), {}, ValueError,
     "on device cpu, got a torch.float32 tensor of shape (2, 3) on device "
     "meta"),
    (torch.zeros((3, 2)), {"shape": (2, 3)}, ValueError,
     "of shape (2, 3) on device cpu, got a torch.float32 tensor of shape "
     "(3, 2)"),
    (torch.zeros((3, 2)).t(), {}, ValueError, "got a non-contiguous"),
], ids=["not_float", "dtype", "explicit_dtype", "device", "shape",
        "contiguity"])
def test_check_operand_rejects(t, kw, error, words):
    kw = dict(kw)
    like = t if kw.pop("like_self", False) else _LIKE
    with pytest.raises(error) as e:
        CB.check_operand("x", t, like, **kw)
    assert str(e.value).startswith("x") and words in str(e.value)


def test_check_operand_accepts():
    CB.check_operand("x", torch.ones((2, 3)), _LIKE, (2, 3))
    CB.check_operand("x", torch.ones((2, 3)), _LIKE, [2, 3])
    CB.check_operand("i", torch.ones((4,), dtype=torch.int32), _LIKE,
                     dtype=torch.int32)
    CB.check_operand("x", torch.ones(5, dtype=torch.float64),
                     torch.ones(1, dtype=torch.float64))


@pytest.mark.parametrize("bad, error", [
    (torch.zeros((2, 3), dtype=torch.float64), TypeError),
    (torch.zeros((3, 2)), ValueError),
], ids=["dtype", "shape"])
def test_check_operands_names_the_operand_at_fault(bad, error):
    """A run of operands is checked as ``check_operand`` checks each, the
    i-th named ``<name> <i>``; a good run passes."""
    good = [torch.ones((2, 3)) for _ in range(3)]
    CB.check_operands("field", good, _LIKE, (2, 3))
    with pytest.raises(error) as e:
        CB.check_operands("field", [good[0], bad, good[2]], _LIKE, (2, 3))
    assert str(e.value).startswith("field 1 must be a contiguous")


# -- cached_build ---------------------------------------------------------------

def test_cached_build_builds_once_per_source_and_flags(tmp_path):
    src = tmp_path / "seven.c"
    src.write_text("int seven(void) { return 7; }\n")
    flags = ("-O1", "-shared", "-fPIC")
    n0 = profiling.counter("cuda_build.builds")
    so = CB.cached_build("seven", [str(src)], flags, lambda: "gcc",
                         str(tmp_path / "b"), "seven failed", log="seven.txt")
    assert re.fullmatch(r"libseven_[0-9a-f]{16}\.so", os.path.basename(so))
    assert ctypes.CDLL(so).seven() == 7
    assert (tmp_path / "b" / "seven.txt").exists()
    # reused: the compiler is not even looked up
    assert CB.cached_build("seven", [str(src)], flags, None,
                           str(tmp_path / "b"), "seven failed") == so
    assert profiling.counter("cuda_build.builds") == n0 + 1
    other = CB.cached_build("seven", [str(src)], flags + ("-g",),
                            lambda: "gcc", str(tmp_path / "b"), "x")
    assert other != so and profiling.counter("cuda_build.builds") == n0 + 2
    assert os.listdir(tmp_path / "b").count(os.path.basename(so)) == 1


def test_cached_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "bad.c"
    src.write_text("this is not C;\n")
    with pytest.raises(RuntimeError, match="bad build failed") as e:
        CB.cached_build("bad", [str(src)], ("-shared",), lambda: "gcc",
                        str(tmp_path), "bad build failed")
    assert "bad.c" in str(e.value) and "error" in str(e.value)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


# -- exact_div ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exact_div_is_one_rounded_division(dtype):
    """Either side a number: the quotient in dtype, rounded once (f32 from
    the exact f64 quotient, f64 equal to numpy's division)."""
    g = torch.Generator().manual_seed(5)
    x = torch.rand(4096, generator=g, dtype=torch.float64) * 10 + 0.1
    x = x.to(dtype)
    want = {torch.float32: lambda a, b: (a.double() / b.double()).float(),
            torch.float64: lambda a, b: torch.from_numpy(
                a.numpy() / b.numpy())}[dtype]
    three = torch.full_like(x, 3.0)
    got = exact_div(x, 3.0)
    assert got.dtype == dtype and torch.equal(got, want(x, three))
    got = exact_div(7.0, x)
    assert got.dtype == dtype and torch.equal(
        got, want(torch.full_like(x, 7.0), x))
    assert torch.equal(exact_div(x, x + 1), torch.div(x, x + 1))
