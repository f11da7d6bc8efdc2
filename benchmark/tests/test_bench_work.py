"""The frozen work counts reproduce chip_smoke.py's."""

import pytest
import torch

from benchmark import work


def test_flux_x_opt_at_512():
    """chip_smoke.py's opt x call at 8 variables, 512x512x64 f32: 19.38
    GFLOP and 1.074 GB."""
    assert work.limiter_ops_opt(5) == 138
    nb, ops = work.flux_work(8, (1, 64, 512, 512), -1, 5, "float32")
    assert (nb, ops) == (1074135552, 19384139776)


@pytest.mark.parametrize("nvar", [6, 8, 14])
@pytest.mark.parametrize("axis", [-1, -2, -3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_flux_work_matches_chip_smoke(nvar, axis, dtype):
    import chip_smoke as cs
    t = getattr(torch, dtype)
    prim = torch.empty((nvar, 1, 64, 512, 512), dtype=t, device="meta")
    assert work.flux_work(nvar, (1, 64, 512, 512), axis, 5, dtype) == \
        cs._flux_work(prim, axis, 5, "opt")


@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_limiter_ops_match_chip_smoke(ord_):
    import chip_smoke as cs
    assert work.limiter_ops_opt(ord_) == cs._limiter_ops_opt(ord_)


def test_bound_is_the_larger_of_bytes_and_operations():
    import chip_smoke as cs
    for nb, ops in ((1.0e9, 1.0e9), (1.0e6, 1.0e13)):
        ms, _ = cs._bound(nb, ops, torch.float32)
        assert work.bound_s(nb, ops, "float32") == pytest.approx(ms / 1e3)


def test_kessler_ops_match_chip_smoke():
    import chip_smoke as cs
    f = torch.empty((1, 64, 512, 512), device="meta")
    assert work.kessler_step_ops((1, 64, 512, 512), 2) == \
        cs._kessler_work((f,), 2)[1]
