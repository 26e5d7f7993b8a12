"""The port's 3-D ops and the plain forms of its 3-D kernels against the JAX
package.

Same float32 volumes (numpy, from a seed) through both packages on the CPU,
at n=22 as tests/test_pallas_3d.py runs them.  Tolerances are those of
tests/test_pallas_3d.py: atol 1e-6 for the ghost-layer functions and the
divergence, 1e-5 for the rest, 3e-6 for the plain gather against the Pallas
one (XLA may contract the backtrace to an FMA, torch does not).  The Pallas
functions run in interpret mode, as the JAX package's own tests run them,
and only in the cases that suite runs outside ``slow``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fluidsimulationcuda_torch.kernels import cuda_ops, cuda_ops_3d  # noqa: E402
from fluidsimulationcuda_torch.ops import chebyshev as tcheby  # noqa: E402
from fluidsimulationcuda_torch.ops import three_d as to3  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops_3d as k3  # noqa: E402
from fluidsimulationcuda_tpu.ops import chebyshev as jcheby  # noqa: E402
from fluidsimulationcuda_tpu.ops import source as jsource  # noqa: E402
from fluidsimulationcuda_tpu.ops import three_d as jo3  # noqa: E402

N = 22
SIDE = N + 2
DT = 0.016
GHOST = dict(rtol=0, atol=1e-6)
TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_ops, "INTERPRET", True)


def _vols(seed, *scales, lo=-1.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, 1.0, (SIDE,) * 3).astype(np.float32) * np.float32(s)
            for s in scales]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# ops/three_d.py against the JAX ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_set_bnd3(b):
    (x,) = _vols(b, 1.0)
    _close(to3.set_bnd3(b, _t(x)), jo3.set_bnd3(b, jnp.asarray(x)), GHOST)


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_fix_faces3(b):
    (x,) = _vols(10 + b, 1.0)
    _close(to3.fix_faces3(b, _t(x)), jo3.fix_faces3(b, jnp.asarray(x)), GHOST)


def test_fix_edges3():
    (x,) = _vols(14, 1.0)
    _close(to3.fix_edges3(_t(x)), jo3.fix_edges3(jnp.asarray(x)), GHOST)


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_embed_interior3(b):
    (x,) = _vols(20 + b, 1.0)
    inner = x[1:-1, 1:-1, 1:-1]
    _close(to3.embed_interior3(b, _t(inner)), jo3.embed_interior3(b, inner),
           GHOST)


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_embed_faces3(b):
    (x,) = _vols(30 + b, 1.0)
    inner = x[1:-1, 1:-1, 1:-1]
    _close(to3.embed_faces3(b, _t(inner)), jo3.embed_faces3(b, inner), GHOST)


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("iters", [1, 7])
def test_diffuse3(b, iters):
    x, x0 = _vols(40 + b, 1.0, 1.0)
    _close(to3.diffuse3(b, _t(x), _t(x0), 0.3, 2.8, iters),
           jo3.diffuse3(b, x, x0, 0.3, 2.8, iters), TOL)


# Displacements (cells, per axis) of the three advection regimes: inside the
# TPU gather window (cmax=2), random velocities beyond it, and clamped at
# the walls.
ADVECT_REGIMES = {"window": 1.7, "random": 6.0, "clamped": 9.0}


def _advect_inputs(regime, seed):
    dt0 = DT * N
    disp = ADVECT_REGIMES[regime]
    (d0,) = _vols(seed, 1.0, lo=0.0)
    if regime == "random":
        u, v, w = _vols(seed + 1, *(3 * [disp / dt0]))
    else:
        u, v, w = (np.full((SIDE,) * 3, np.float32(-s * disp / dt0))
                   for s in (1.0, 1.0, -1.0))
    return d0, u, v, w


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("regime", list(ADVECT_REGIMES))
def test_advect3(regime, b):
    d0, u, v, w = _advect_inputs(regime, 50 + b)
    _close(to3.advect3(b, _t(d0), _t(u), _t(v), _t(w), DT, N),
           jo3.advect3(b, d0, u, v, w, DT, N), TOL)


def test_divergence3():
    u, v, w = _vols(60, 1.0, 1.0, 1.0)
    _close(to3.divergence3(_t(u), _t(v), _t(w), N),
           jo3.divergence3(u, v, w, N), GHOST)


@pytest.mark.parametrize("iters", [1, 6])
def test_pressure_solve3(iters):
    (div,) = _vols(61, 0.01)
    _close(to3.pressure_solve3(_t(div), iters),
           jo3.pressure_solve3(div, iters), TOL)


def test_apply_pressure_gradient3():
    u, v, w, p = _vols(62, 1.0, 1.0, 1.0, 1.0)
    _close(to3.apply_pressure_gradient3(_t(u), _t(v), _t(w), _t(p), N),
           jo3.apply_pressure_gradient3(u, v, w, p, N), TOL)


def test_project3():
    u, v, w = _vols(63, 1.0, 1.0, 1.0)
    _close(to3.project3(_t(u), _t(v), _t(w), N, 8),
           jo3.project3(u, v, w, N, 8), TOL)


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("iters", [2, 10])
def test_cheby_diffuse3(b, iters):
    x, x0 = _vols(70 + b, 1.0, 1.0)
    _close(tcheby.cheby_diffuse3(b, _t(x), _t(x0), 0.3, 2.8, iters, 0.85),
           jcheby.cheby_diffuse3(b, x, x0, 0.3, 2.8, iters, 0.85), TOL)


@pytest.mark.parametrize("iters", [2, 12])
def test_cheby_pressure_solve3(iters):
    (div,) = _vols(75, 0.01)
    _close(tcheby.cheby_pressure_solve3(_t(div), iters, 0.85),
           jcheby.cheby_pressure_solve3(div, iters, 0.85), TOL)


# ---------------------------------------------------------------------------
# The plain versions of the CUDA wrappers (their CPU path) against the
# Pallas kernels and the JAX spec
# ---------------------------------------------------------------------------


def test_fused_jacobi3_zero_init_matches_pallas():
    (div,) = _vols(80, 1.0)
    want = jo3.set_bnd3(0, k3.fused_jacobi3(0, div, div, 1.0, 6.0, 6,
                                            zero_init=True))
    _close(cuda_ops_3d.fused_jacobi3(0, _t(div), _t(div), 1.0, 6.0, 6,
                                     zero_init=True), want, TOL)


def test_divergence3_p_matches_pallas():
    u, v, w = _vols(81, 1.0, 1.0, 1.0)
    want = jo3.set_bnd3(0, k3.divergence3_p(u, v, w, N))
    _close(cuda_ops_3d.divergence3_p(_t(u), _t(v), _t(w), N), want, GHOST)


def test_gradient3_p_matches_pallas():
    u, v, w, p = _vols(82, 1.0, 1.0, 1.0, 1.0)
    want = tuple(jo3.set_bnd3(b, g)
                 for b, g in zip((1, 2, 3), k3.gradient3_p(u, v, w, p, N)))
    _close(cuda_ops_3d.gradient3_p(_t(u), _t(v), _t(w), _t(p), N), want, TOL)


def test_advect3_shift_matches_pallas():
    """Random velocities (displacement <= 0.35 cells), inside cmax=2."""
    (d0,) = _vols(83, 1.0, lo=0.0)
    d0 = np.asarray(jo3.set_bnd3(0, jnp.asarray(d0)))
    u, v, w = _vols(84, 1.0, 1.0, 1.0)
    want = jo3.set_bnd3(0, k3.advect3_shift(0, d0, u, v, w, DT, N, cmax=2))
    _close(cuda_ops_3d.advect3_shift(0, _t(d0), _t(u), _t(v), _t(w), DT, N),
           want, dict(rtol=0, atol=3e-6))


JACOBI3_MODES = {
    "jacobi": dict(),
    "src-fold": dict(src_dt=DT),
    "chebyshev": dict(src_dt=DT, cheby_rho=0.85),
}


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", list(JACOBI3_MODES))
def test_fused_jacobi3_matches_spec(b, mode):
    """The wrapper's modes against the JAX spec the 3-D step composes: the
    source added to the rhs (``add_source``) with the raw source as guess."""
    kw = JACOBI3_MODES[mode]
    x, x0 = _vols(90 + b, 0.5, 1.0)
    rhs = x0 if "src_dt" not in kw else jsource.add_source(x0, x, DT)
    if "cheby_rho" in kw:
        want = jcheby.cheby_diffuse3(b, x, rhs, 0.3, 2.8, 10, 0.85)
    else:
        want = jo3.diffuse3(b, x, rhs, 0.3, 2.8, 10)
    _close(cuda_ops_3d.fused_jacobi3(b, _t(x), _t(x0), 0.3, 2.8, 10, **kw),
           want, TOL)


@pytest.mark.parametrize("cheby_rho", [None, 0.85])
def test_fused_jacobi3_fast_is_the_reciprocal_form(cheby_rho):
    """Fast mode solves the same system: it stays within float32 rounding
    of the exact form."""
    x, x0 = _vols(95, 0.5, 1.0)
    kw = dict(src_dt=DT, cheby_rho=cheby_rho)
    fast = cuda_ops_3d.fused_jacobi3(1, _t(x), _t(x0), 0.3, 2.8, 10,
                                     fast=True, **kw)
    exact = cuda_ops_3d.fused_jacobi3(1, _t(x), _t(x0), 0.3, 2.8, 10, **kw)
    np.testing.assert_allclose(fast.numpy(), exact.numpy(), rtol=0,
                               atol=1e-6)


def test_advect3_shift_fused_triple():
    """The self-advection triple: each field advected by the pre-advection
    velocity, inputs untouched, one backtrace for all three."""
    u, v, w = _vols(96, 10.0, 10.0, 10.0)
    tu, tv, tw = _t(u), _t(v), _t(w)
    got = cuda_ops_3d.advect3_shift_fused((1, 2, 3), (tu, tv, tw), tu, tv, tw,
                                          DT, N)
    want = tuple(jo3.advect3(b, f, u, v, w, DT, N)
                 for b, f in ((1, u), (2, v), (3, w)))
    _close(got, want, TOL)
    np.testing.assert_array_equal(tu.numpy(), u)
    with pytest.raises(ValueError):
        cuda_ops_3d.advect3_shift_fused((1, 2, 3, 0), (tu, tv, tw, tu), tu,
                                        tv, tw, DT, N)


def test_cpu_wrappers_launch_nothing():
    """A wrapper given CPU tensors runs its plain version: no launch counts."""
    cuda_ops.reset_launch_counts()
    x, u, v, w = map(_t, _vols(97, 1.0, 1.0, 1.0, 1.0))
    cuda_ops_3d.fused_jacobi3(1, x, x, 0.4, 3.4, 3, src_dt=DT, cheby_rho=0.85)
    cuda_ops_3d.divergence3_p(u, v, w, N)
    cuda_ops_3d.gradient3_p(u, v, w, x, N)
    cuda_ops_3d.advect3_shift_fused((1, 2, 3), (u, v, w), u, v, w, DT, N)
    assert cuda_ops.launch_counts() == dict.fromkeys(cuda_ops.KERNELS, 0)


@pytest.mark.parametrize("bad", ["dtype", "grid", "shape", "contiguity",
                                 "devices", "side"])
def test_wrapper_rejects(bad):
    x = torch.zeros((SIDE,) * 3)
    y = {
        "dtype": torch.zeros((SIDE,) * 3, dtype=torch.float64),
        "grid": torch.zeros(SIDE, SIDE),
        "shape": torch.zeros(SIDE, SIDE, SIDE + 2),
        "contiguity": torch.zeros(SIDE, SIDE, 2 * SIDE)[..., ::2],
        "devices": torch.zeros((SIDE,) * 3, device="meta"),
        # side**3 >= 2**31 does not fit the kernels' 32-bit indices
        "side": torch.zeros(1, 1, 1291, device="meta"),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        cuda_ops_3d.fused_jacobi3(0, x, y, 0.4, 3.4, 1)
