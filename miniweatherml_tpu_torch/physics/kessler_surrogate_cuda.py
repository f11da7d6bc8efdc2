"""The Kessler MLP surrogate's forward pass: one CUDA kernel, and its plain
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
rounding per multiply and per add, as the kernel does.

The model and its scaling tables travel as one parameter tensor in the
fields' dtype (``pack_mlp``): a header (the layer count, then the layer
widths), scl_in (5, 2), scl_out (4, 2), then each layer's W (n_in, n_out)
and b (n_out,), flattened.  The kernel keeps a cell's activations in
registers and stages the parameters in shared memory, so it takes a model
of any depth whose layers are at most ``MAX_WIDTH`` units wide and whose
parameters fit in ``MAX_PARAM_BYTES``; ``pack_mlp`` refuses any other.
The shipped model is 5 -> 10 -> 4 and ``ml.train.train_mlp`` trains 5 ->
hidden -> 4 (hidden 10 by default).
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import count_launch, load_library, on_cuda
from ..ml.mlp import leaky_relu

__all__ = ["surrogate_forward", "surrogate_forward_plain", "pack_mlp",
           "MAX_WIDTH", "MAX_PARAM_BYTES"]

MAX_WIDTH = 16  # units of any layer, inputs and outputs included (MAXW)
# the shared memory a block of an sm_90 card may opt in to
MAX_PARAM_BYTES = 227 * 1024
NIN, NOUT = 5, 4

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("surrogate")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        PP = ctypes.POINTER(ctypes.c_void_p)
        for name in ("surrogate_forward_f32", "surrogate_forward_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [PP, PP, P, I, I, ctypes.POINTER(I), L, P]
            fn.restype = I
        lib.surrogate_error_string.argtypes = [I]
        lib.surrogate_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def pack_mlp(weights, scl_in, scl_out):
    """(params, widths): the surrogate's parameters as one contiguous 1-D
    tensor on scl_in's device and in its dtype, and the layer widths.
    ``weights``: [(W (n_in, n_out), b (n_out,)), ...] of the MLP.  Raises
    ValueError for a model the kernel does not take: a layer wider than
    MAX_WIDTH units, parameters over MAX_PARAM_BYTES, or other than 5
    inputs and 4 outputs."""
    widths = [int(weights[0][0].shape[0])] + [int(W.shape[1])
                                              for W, _ in weights]
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"the surrogate kernel takes layers of at most "
                         f"{MAX_WIDTH} units; the model has widths {widths}")
    if widths[0] != NIN or widths[-1] != NOUT:
        raise ValueError(f"the surrogate maps {NIN} inputs to {NOUT} "
                         f"outputs; the model has widths {widths}")
    kw = dict(device=scl_in.device, dtype=scl_in.dtype)
    parts = [torch.tensor([len(weights), *widths], **kw),
             scl_in.reshape(-1), scl_out.to(**kw).reshape(-1)]
    for W, b in weights:
        parts += [W.to(**kw).reshape(-1), b.to(**kw).reshape(-1)]
    params = torch.cat(parts).contiguous()
    nbytes = params.numel() * params.element_size()
    if nbytes > MAX_PARAM_BYTES:
        raise ValueError(f"the surrogate kernel stages at most "
                         f"{MAX_PARAM_BYTES} bytes of parameters in shared "
                         f"memory; the model (widths {widths}) has {nbytes}")
    return params, tuple(widths)


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
    ``csrc/surrogate.cu``.
    """
    fields = (temp, rho_d, rho_v, rho_c, rho_r)
    if not on_cuda(temp):
        return surrogate_forward_plain(*fields, params, widths)
    if temp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype {temp.dtype} is not float32/float64")
    for i, a in enumerate((*fields, params)):
        if (a.device != temp.device or a.dtype != temp.dtype
                or not a.is_contiguous()
                or (i < NIN and a.shape != temp.shape)):
            raise ValueError(f"surrogate: argument {i} must be a contiguous "
                             f"{temp.dtype} tensor on {temp.device}"
                             + (f" of shape {tuple(temp.shape)}"
                                if i < NIN else ""))
    outs = [torch.empty_like(temp) for _ in range(NOUT)]
    lib = _library()
    fn = (lib.surrogate_forward_f32 if temp.dtype == torch.float32
          else lib.surrogate_forward_f64)
    ptrs = (ctypes.c_void_p * NIN)(*(a.data_ptr() for a in fields))
    optrs = (ctypes.c_void_p * NOUT)(*(a.data_ptr() for a in outs))
    wid = (ctypes.c_int * len(widths))(*widths)
    rc = fn(ptrs, optrs, params.data_ptr(), params.numel(), len(widths) - 1,
            wid, temp.numel(),
            torch.cuda.current_stream(temp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("surrogate kernel launch failed: "
                           + lib.surrogate_error_string(rc).decode())
    count_launch(surrogate_forward)
    return tuple(outs)


surrogate_forward.launches = 0
