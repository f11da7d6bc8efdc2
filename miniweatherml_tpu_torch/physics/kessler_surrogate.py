"""Kessler microphysics MLP surrogate: inline NN inference in the step.

Port of ``miniweatherml_tpu/physics/kessler_surrogate.py`` (after the
reference's ponni-based drop-in micro, experiments/supercell_kessler_surrogate/
custom_modules/microphysics_kessler_ponni.h): per cell, the 5 inputs
[T, rho_d, rho_v, rho_c, rho_p] are min-max normalized (:177-187), pushed
through the MLP (5 -> 10 LeakyReLU(0.1) -> 4, :103-111), denormalized and
clamped >= 0 (:196-202).  The reference also runs the real Kessler scheme
every step and prints the mean NN-truth differences (:244-269), with the
actual online override left commented out (:271-276); here both behaviors
are options.

The forward pass is ``kessler_surrogate_cuda.surrogate_forward``: a
kernel on the card (a fixed-width form for the shipped 5 -> 10 -> 4 shape, a
general one for any other model), its plain version (ordered sums) on the
CPU.  The mean
diffs are stored in the coupler field ``surrogate_diffs`` (4,) [temp, rho_v,
rho_c, rho_p] on the device, so a driver reads all four in one transfer.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..core.coupler import CouplerState
from ..ml.mlp import MLP
from ..parallel.collectives import pmean
from ..utils.profiling import span
from .kessler import MicrophysicsKessler
from .kessler_surrogate_cuda import pack_mlp, surrogate_forward

__all__ = ["MicrophysicsKesslerSurrogate"]

_INPUTS = ("temp", "density_dry", "water_vapor", "cloud_liquid",
           "precip_liquid")
_OUTPUTS = ("temp", "water_vapor", "cloud_liquid", "precip_liquid")


def _tensor(a) -> torch.Tensor:
    """``a`` as a tensor; an array (which may be read-only) is copied."""
    return a if torch.is_tensor(a) else torch.tensor(np.asarray(a))


class MicrophysicsKesslerSurrogate(MicrophysicsKessler):
    """Drop-in replacement for MicrophysicsKessler (same tracer registry and
    constants, reference microphysics_kessler_ponni.h:16,75-95).

    Args:
      model: the MLP (``ml.mlp.MLP``), on any device and dtype.
      scl_in:  (5, 2) [min, max] input scaling [T, rho_d, rho_v, rho_c, rho_p].
      scl_out: (4, 2) [min, max] output scaling [T, rho_v, rho_c, rho_p].
      online: if True the NN output becomes the new state (the deploy mode
        the reference leaves commented out, :271-276); if False the real
        Kessler result is kept (the reference's comparison mode).
      compare: also run the reference Kessler and store mean NN-truth diffs
        in the ``surrogate_diffs`` field (always True when online=False,
        since the Kessler result is needed anyway).

    The weights and tables are cast to the state's device and dtype and
    packed for the forward kernel once, at ``init`` (again only if a state
    of another device or dtype comes): weights loaded as f32 then computed
    in f64 give what the JAX package computes, where ``jnp`` promotes
    ``f64 @ f32`` to f64.  Any MLP of 5 inputs and 4 outputs is taken, at
    any depth and width; one of other widths raises ValueError there.
    """

    def __init__(self, model: MLP, scl_in, scl_out,
                 online: bool = True, compare: bool = False):
        self.model = model
        self.scl_in = _tensor(scl_in)
        self.scl_out = _tensor(scl_out)
        self.online = online
        self.compare = compare or not online
        # ((device, dtype), net, scl_in, scl_out, (packed params, widths))
        self._cast = None

    def _params(self, state: CouplerState):
        """(net, scl_in, scl_out) on the state's device in its dtype."""
        return self._cast_for(state)[1:4]

    def _cast_for(self, state: CouplerState):
        key = (state.device, state.meta.tdtype)
        if self._cast is None or self._cast[0] != key:
            kw = dict(device=key[0], dtype=key[1])
            net = copy.deepcopy(self.model).requires_grad_(False).to(**kw)
            scl_in, scl_out = self.scl_in.to(**kw), self.scl_out.to(**kw)
            self._cast = (key, net, scl_in, scl_out,
                          pack_mlp(net.weights, scl_in, scl_out))
        return self._cast

    def init(self, state: CouplerState) -> CouplerState:
        state = super().init(state)
        state = state.set_options(micro="kessler_surrogate")
        self._params(state)
        return state.register_field("surrogate_diffs", value=torch.zeros(4))

    def _nn_forward(self, state: CouplerState):
        """Normalized-MLP-denormalized prediction of (temp, rho_v, rho_c,
        rho_r), clamped non-negative except temp
        (microphysics_kessler_ponni.h:177-202)."""
        params, widths = self._cast_for(state)[4]
        return surrogate_forward(*(state[n] for n in _INPUTS), params, widths)

    def time_step(self, state: CouplerState, dt: float,
                  spmd_axes: tuple = ()) -> CouplerState:
        """``spmd_axes``: in a shard of a mesh run, the mesh axes to reduce
        Kessler's sub-cycle count and to ``pmean`` the compare-mode diffs
        over.  The step runs in the span ``surrogate.step`` (compare
        mode's Kessler step inside it, in ``kessler.step``)."""
        with span("surrogate.step"):
            nn_out = self._nn_forward(state)
            if self.compare:
                truth = super().time_step(state, dt, spmd_axes=spmd_axes)
                sums = torch.stack([torch.sum(a - truth[n]) for a, n in
                                    zip(nn_out, _OUTPUTS)])
                diffs = pmean(torch.div(sums, sums.new_full(
                    (), nn_out[0].numel())), spmd_axes)
            else:
                truth = None
                diffs = state["surrogate_diffs"]
            out = (state.replace_fields(**dict(zip(_OUTPUTS, nn_out)))
                   if self.online else truth)
            return out.replace_fields(surrogate_diffs=diffs)
