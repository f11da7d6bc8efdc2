"""The Kessler MLP surrogate's forward pass: CUDA kernels, and their plain
version.

``surrogate_forward`` reads the five input fields [T, rho_d, rho_v, rho_c,
rho_r] where they lie, normalises them with the input scaling, runs every
dense layer (x W + b, LeakyReLU(0.1) between layers), denormalises with the
output scaling and clamps rho_v, rho_c and rho_r at 0.  On a CUDA tensor it
launches ``csrc/surrogate.cu``, the port of the XLA fusion of the JAX
package's ``MicrophysicsKesslerSurrogate._nn_forward``
(``miniweatherml_tpu/physics/kessler_surrogate.py:60-76``; no Pallas
kernel); on a CPU tensor ``surrogate_forward_plain``, which writes each dot
product as an ordered sum, k ascending from x_0 W_0j and then + b_j, one
rounding per multiply and per add, as the kernels do.

The model and its scaling tables travel as one parameter tensor in the
fields' dtype (``pack_mlp``): a header (the layer count, then the layer
widths), scl_in (5, 2), scl_out (4, 2), then each layer's W (n_in, n_out)
and b (n_out,), flattened.  Any model of 5 inputs and 4 outputs is taken,
at any depth, widths and parameter size.  The kernel has two forms,
chosen by ``kernel_form`` from the widths: "fixed", widths known at compile
time, for the models in ``FIXED_WIDTHS`` (5 -> 10 -> 4: the shipped model
and ``ml.train.train_mlp``'s default), and "general", a tiled form that
streams the weights from device memory, for every other model.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import (INT, LONG, PTR, PTRS, KernelLibrary, check_operand,
                          check_operands, data_ptr, on_cuda, pointers)
from ..utils.profiling import count_traced
from ..ml.mlp import leaky_relu

__all__ = ["surrogate_forward", "surrogate_forward_plain", "pack_mlp",
           "kernel_form", "FIXED_WIDTHS"]

NIN, NOUT = 5, 4
# the widths the fixed form is built for (csrc/surrogate.cu, form 0)
FIXED_WIDTHS = ((NIN, 10, NOUT),)
_FORMS = {"fixed": 0, "general": 1}

_INTS = ctypes.POINTER(INT)
LIBRARY = KernelLibrary("surrogate", {
    "surrogate_forward": [PTRS, PTRS, PTR, INT, INT, _INTS, LONG, INT, PTR,
                          LONG],
}, {"surrogate_scratch": ([INT, _INTS, INT], LONG),
    "surrogate_general_tile": ([INT, _INTS, INT, ctypes.POINTER(LONG)], INT)})


def kernel_form(widths) -> str:
    """The kernel form a CUDA launch takes for a model of these layer
    widths: "fixed" for one in FIXED_WIDTHS, else "general"."""
    return "fixed" if tuple(widths) in FIXED_WIDTHS else "general"


def _c_widths(widths):
    return (ctypes.c_int * len(widths))(*widths)


def _general_tile(widths, dtype) -> tuple[int, int, bool]:
    """(cells per tile, dynamic shared memory per block in bytes, whether
    the activations live in global scratch) of the general form for a model
    of these widths in ``dtype``.  Builds the kernel's library."""
    item = torch.empty((), dtype=dtype).element_size()
    smem = ctypes.c_longlong()
    tile = LIBRARY.query("surrogate_general_tile", len(widths) - 1,
                         _c_widths(widths), item, ctypes.byref(smem))
    return abs(tile), smem.value, tile < 0


def pack_mlp(weights, scl_in, scl_out):
    """(params, widths): the surrogate's parameters as one contiguous 1-D
    tensor on scl_in's device and in its dtype, and the layer widths.
    ``weights``: [(W (n_in, n_out), b (n_out,)), ...] of the MLP.  Raises
    ValueError for a model of other than 5 inputs and 4 outputs."""
    widths = [int(weights[0][0].shape[0])] + [int(W.shape[1])
                                              for W, _ in weights]
    if widths[0] != NIN or widths[-1] != NOUT:
        raise ValueError(f"the surrogate maps {NIN} inputs to {NOUT} "
                         f"outputs; the model has widths {widths}")
    kw = dict(device=scl_in.device, dtype=scl_in.dtype)
    parts = [torch.tensor([len(weights), *widths], **kw),
             scl_in.reshape(-1), scl_out.to(**kw).reshape(-1)]
    for W, b in weights:
        parts += [W.to(**kw).reshape(-1), b.to(**kw).reshape(-1)]
    return torch.cat(parts).contiguous(), tuple(widths)


def _unpack(params, widths):
    """(scl_in, scl_out, [(W, b), ...]): views of a packed ``params``."""
    i = len(widths) + 1  # the header
    scl_in = params[i:i + 2 * NIN].view(NIN, 2)
    scl_out = params[i + 2 * NIN:i + 2 * (NIN + NOUT)].view(NOUT, 2)
    layers, i = [], i + 2 * (NIN + NOUT)
    for n_in, n_out in zip(widths[:-1], widths[1:]):
        W = params[i:i + n_in * n_out].view(n_in, n_out)
        i += n_in * n_out
        layers.append((W, params[i:i + n_out]))
        i += n_out
    return scl_in, scl_out, layers


def surrogate_forward_plain(temp, rho_d, rho_v, rho_c, rho_r, params, widths):
    """Plain version of ``surrogate_forward``: the same normalisation, the
    layers as ordered sums of products, LeakyReLU(0.1) between layers, the
    denormalisation and the clamps, one field per unit."""
    scl_in, scl_out, layers = _unpack(params, widths)
    rng_in = scl_in[:, 1] - scl_in[:, 0]
    x = [(f - scl_in[i, 0]) / rng_in[i]
         for i, f in enumerate((temp, rho_d, rho_v, rho_c, rho_r))]
    for li, (W, b) in enumerate(layers):
        y = []
        for j in range(W.shape[1]):
            acc = x[0] * W[0, j]
            for k in range(1, W.shape[0]):
                acc = acc + x[k] * W[k, j]
            acc = acc + b[j]
            y.append(leaky_relu(acc) if li + 1 < len(layers) else acc)
        x = y
    rng_out = scl_out[:, 1] - scl_out[:, 0]
    out = [x[j] * rng_out[j] + scl_out[j, 0] for j in range(NOUT)]
    return (out[0], *(torch.clamp_min(a, 0.0) for a in out[1:]))


def surrogate_forward(temp, rho_d, rho_v, rho_c, rho_r, params, widths):
    """The surrogate's prediction of (temp, rho_v, rho_c, rho_r) from the
    coupler's fields, rho_v, rho_c and rho_r clamped at 0.

    Args:
      temp, rho_d, rho_v, rho_c, rho_r: same-shape fields.
      params, widths: the model and scaling tables from ``pack_mlp``, in
        the fields' dtype on their device.

    CPU tensors take ``surrogate_forward_plain``; CUDA tensors launch
    ``csrc/surrogate.cu`` in the form ``kernel_form(widths)`` picks.
    """
    fields = (temp, rho_d, rho_v, rho_c, rho_r)
    if not on_cuda(temp):
        return surrogate_forward_plain(*fields, params, widths)
    return _launch(kernel_form(widths), *fields, params, widths)


def _launch(form, temp, rho_d, rho_v, rho_c, rho_r, params, widths):
    """``surrogate_forward`` on CUDA tensors, in kernel form ``form``
    ("fixed" or "general"); tests and measurements name the form.  Counts
    ``surrogate_forward.launches``, and under a profiler session
    ``surrogate_forward.fixed_launches`` or ``.general_launches``."""
    fields = (temp, rho_d, rho_v, rho_c, rho_r)
    check_operands("surrogate field", fields, temp, temp.shape)
    check_operand("surrogate params", params, temp)
    if form not in _FORMS or (form == "fixed"
                              and tuple(widths) not in FIXED_WIDTHS):
        raise ValueError(f"surrogate: no {form!r} kernel form for widths "
                         f"{tuple(widths)} (the fixed form takes "
                         f"{FIXED_WIDTHS})")
    outs = [torch.empty_like(temp) for _ in range(NOUT)]
    wid = _c_widths(widths)
    scratch, nscratch = None, 0
    if form == "general":
        nscratch = LIBRARY.query("surrogate_scratch", len(widths) - 1, wid,
                                 temp.element_size())
        if nscratch < 0:
            raise RuntimeError("surrogate: the scratch query failed")
        if nscratch:
            scratch = torch.empty(nscratch, dtype=temp.dtype,
                                  device=temp.device)
    LIBRARY.launch("surrogate_forward", temp, pointers(fields),
                   pointers(outs), params.data_ptr(), params.numel(),
                   len(widths) - 1, wid, temp.numel(), _FORMS[form],
                   data_ptr(scratch), nscratch,
                   counter="surrogate_forward.launches")
    count_traced(f"surrogate_forward.{form}_launches")
    return tuple(outs)
