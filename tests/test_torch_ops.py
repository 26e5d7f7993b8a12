"""The port's plain torch ops against the JAX package's reference ops.

Same float32 inputs (numpy, from a seed) through both packages, on the CPU,
at the tolerance of tests/test_pallas_ops.py (rtol = atol = 1e-6): both sides
evaluate the same expressions in the same order, so what differs is XLA's
FMA contraction, at the ulp level.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fluidsimulationcuda_torch import ops as tops  # noqa: E402
from fluidsimulationcuda_torch.ops import chebyshev as tcheby  # noqa: E402
from fluidsimulationcuda_tpu import ops as jops  # noqa: E402
from fluidsimulationcuda_tpu.ops import chebyshev as jcheby  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _fields(seed, side, *scales):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, (side, side)).astype(np.float32) * s
            for s in scales]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("side", [32, 64])
def test_set_bnd(b, side):
    (x,) = _fields(b, side, 1.0)
    _close(tops.set_bnd(b, _t(x)), jops.set_bnd(b, x), rtol=0, atol=0)


@pytest.mark.parametrize("b", [0, 1, 2])
def test_embed_interior(b):
    (x,) = _fields(10 + b, 40, 1.0)
    inner = x[1:-1, 1:-1]
    _close(tops.embed_interior(b, _t(inner)), jops.embed_interior(b, inner),
           rtol=0, atol=0)


def test_add_source():
    x, s = _fields(20, 32, 1.0, 0.5)
    _close(tops.add_source(_t(x), _t(s), 0.016),
           jops.add_source(x, s, 0.016), rtol=0, atol=0)


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("iters", [1, 20])
def test_diffuse(b, iters):
    x, x0 = _fields(30 + b, 48, 1.0, 1.0)
    _close(tops.diffuse(b, _t(x), _t(x0), 0.42, 2.68, iters),
           jops.diffuse(b, x, x0, 0.42, 2.68, iters))


@pytest.mark.parametrize("b", [0, 1, 2])
def test_jacobi_sweep(b):
    x, x0 = _fields(40 + b, 32, 1.0, 1.0)
    _close(tops.jacobi_sweep(b, _t(x), _t(x0)[1:-1, 1:-1], 0.3, 2.2),
           jops.jacobi_sweep(b, x, x0[1:-1, 1:-1], 0.3, 2.2))


@pytest.mark.parametrize("rho,iters", [(0.9, 10), (0.99, 8), (0.96, 12)])
def test_cheby_omegas(rho, iters):
    assert tcheby.cheby_omegas(rho, iters) == jcheby.cheby_omegas(rho, iters)


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("iters", [2, 10])
def test_cheby_diffuse(b, iters):
    x, x0 = _fields(50 + b, 48, 1.0, 1.0)
    _close(tcheby.cheby_diffuse(b, _t(x), _t(x0), 0.42, 2.68, iters, 0.9),
           jcheby.cheby_diffuse(b, x, x0, 0.42, 2.68, iters, 0.9))


def test_cheby_pressure_solve():
    (div,) = _fields(60, 64, 0.01)
    _close(tcheby.cheby_pressure_solve(_t(div), 14, 0.9),
           jcheby.cheby_pressure_solve(div, 14, 0.9))


def test_backtrace():
    u, v = _fields(70, 64, 2.0, 2.0)
    for got, want in zip(tops.backtrace(_t(u), _t(v), 0.016, 62),
                         jops.backtrace(u, v, 0.016, 62)):
        _close(got, want)


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("scale", [2.0, 40.0])
def test_advect_exact(b, scale):
    """Exact gather at displacements inside and far outside any window."""
    d0, u, v = _fields(80 + b, 64, 1.0, scale, scale)
    _close(tops.advect(b, _t(d0), _t(u), _t(v), 0.016, 62),
           jops.advect(b, d0, u, v, 0.016, 62))


def test_divergence():
    u, v = _fields(90, 64, 1.0, 1.0)
    _close(tops.divergence(_t(u), _t(v), 62), jops.divergence(u, v, 62))


@pytest.mark.parametrize("iters", [1, 20])
def test_pressure_solve(iters):
    (div,) = _fields(91, 48, 0.01)
    _close(tops.pressure_solve(_t(div), iters), jops.pressure_solve(div, iters))


def test_apply_pressure_gradient():
    u, v, p = _fields(92, 64, 1.0, 1.0, 1.0)
    for got, want in zip(tops.apply_pressure_gradient(_t(u), _t(v), _t(p), 62),
                         jops.apply_pressure_gradient(u, v, p, 62)):
        _close(got, want)


@pytest.mark.parametrize("side", [32, 64])
def test_project(side):
    u, v = _fields(93, side, 1.0, 1.0)
    for got, want in zip(tops.project(_t(u), _t(v), side - 2, 20),
                         jops.project(u, v, side - 2, 20)):
        _close(got, want)
