"""The CPU path of each ``cuda_ops`` wrapper against the Pallas kernel it
ports, run in interpret mode as tests/test_pallas_ops.py runs it.

On CPU tensors a wrapper returns its plain version, so these pin the plain
versions (which the GPU tests and chip_smoke.py hold the CUDA kernels
against) to the TPU kernels' semantics, mode by mode.  Tolerances: 1e-6 as
in tests/test_pallas_ops.py; rtol 1e-5 / atol 2e-5 where a bilinear gather
amplifies a one-ulp difference in the backtrace (XLA contracts it to an FMA,
torch does not).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fluidsimulationcuda_torch.kernels import cuda_ops  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
GATHER_TOL = dict(rtol=1e-5, atol=2e-5)
DT = 0.016


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_ops, "INTERPRET", True)


@pytest.fixture
def strip_mode(monkeypatch):
    """Multi-strip tiling on small grids, as tests/test_pallas_ops.py
    forces it: the fused density kernel only runs on strips."""

    def pick(side):
        for tm in (16, 8):
            if side % tm == 0 and side > tm:
                return tm
        return side

    monkeypatch.setattr(pallas_ops, "_pick_tm", pick)


def _fields(seed, side, *scales):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, (side, side)).astype(np.float32) * s
            for s in scales]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


JACOBI_MODES = {
    "jacobi": dict(),
    "src_dt": dict(src_dt=DT),
    "zero_init": dict(zero_init=True),
    "fast": dict(src_dt=DT, fast=True),
    "chebyshev": dict(cheby_rho=0.9),
    "chebyshev_src_fast": dict(src_dt=DT, cheby_rho=0.9, fast=True),
}


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("mode", list(JACOBI_MODES))
def test_fused_jacobi(b, mode):
    kw = JACOBI_MODES[mode]
    iters = 10 if "cheby_rho" in kw else 20
    x, x0 = _fields(b, 64, 0.5, 1.0)
    want = pallas_ops.fused_jacobi(b, jnp.asarray(x), jnp.asarray(x0), 0.42,
                                   2.68, iters, **kw)
    got = cuda_ops.fused_jacobi(b, _t(x), _t(x0), 0.42, 2.68, iters, **kw)
    _close(got, want)


@pytest.mark.parametrize("iters", [1, 2, 5])
def test_fused_jacobi_strips(strip_mode, iters):
    x, x0 = _fields(7, 64, 0.5, 1.0)
    want = pallas_ops.fused_jacobi(1, jnp.asarray(x), jnp.asarray(x0), 0.3,
                                   2.2, iters, src_dt=DT)
    got = cuda_ops.fused_jacobi(1, _t(x), _t(x0), 0.3, 2.2, iters, src_dt=DT)
    _close(got, want)


@pytest.mark.parametrize("cheby_rho,iters", [(None, 20), (0.9, 14)])
def test_fused_project(cheby_rho, iters):
    u, v = _fields(11, 64, 1.0, 1.0)
    want = pallas_ops.fused_project(jnp.asarray(u), jnp.asarray(v), 62, iters,
                                    cheby_rho=cheby_rho)
    got = cuda_ops.fused_project(_t(u), _t(v), 62, iters, cheby_rho=cheby_rho)
    _close(got, want)


def test_divergence_p(strip_mode):
    u, v = _fields(12, 64, 1.0, 1.0)
    _close(cuda_ops.divergence_p(_t(u), _t(v), 62),
           pallas_ops.divergence_p(jnp.asarray(u), jnp.asarray(v), 62))


def test_gradient_p(strip_mode):
    u, v, p = _fields(13, 64, 1.0, 1.0, 1.0)
    _close(cuda_ops.gradient_p(_t(u), _t(v), _t(p), 62),
           pallas_ops.gradient_p(jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(p), 62))


@pytest.mark.parametrize("b", [0, 1, 2])
def test_advect_shift(strip_mode, b):
    # |dt*n*u| <= 0.016*62*2 ~ 2 cells: inside the Pallas window (cmax=4).
    d0, u, v = _fields(20 + b, 64, 1.0, 2.0, 2.0)
    want = pallas_ops.advect_shift(b, jnp.asarray(d0), jnp.asarray(u),
                                   jnp.asarray(v), DT, 62, cmax=4)
    got = cuda_ops.advect_shift(b, _t(d0), _t(u), _t(v), DT, 62)
    _close(got, want, GATHER_TOL)


def test_advect_shift_fused_self_advection(strip_mode):
    """The u/v pair of the step: both advected by the pre-advection velocity."""
    u, v = _fields(24, 64, 2.0, 2.0)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    want = pallas_ops.advect_shift_fused((1, 2), (ju, jv), ju, jv, DT, 62,
                                         cmax=4, self_advect=True)
    tu, tv = _t(u), _t(v)
    got = cuda_ops.advect_shift_fused((1, 2), (tu, tv), tu, tv, DT, 62)
    _close(got, want, GATHER_TOL)
    np.testing.assert_array_equal(tu.numpy(), u)  # inputs untouched


@pytest.mark.parametrize("kw", [dict(), dict(cheby_rho=0.9, fast=True)],
                         ids=["jacobi", "chebyshev_fast"])
def test_fused_dens_advect(strip_mode, kw):
    # 6 strips of 16; |dt*n*u| <= 0.016*94 ~ 1.5 cells, inside cmax=2.
    side, iters, cmax = 96, 5, 2
    n = side - 2
    src, base, u, v = _fields(30, side, 0.5, 1.0, 1.0, 1.0)
    a = 0.37
    want = pallas_ops.fused_dens_advect(
        0, jnp.asarray(src), jnp.asarray(base), jnp.asarray(u),
        jnp.asarray(v), a, 1 + 4 * a, iters, DT, n, cmax=cmax, **kw)
    got = cuda_ops.fused_dens_advect(0, _t(src), _t(base), _t(u), _t(v), a,
                                     1 + 4 * a, iters, DT, n, **kw)
    _close(got, want, GATHER_TOL)


def test_cpu_wrappers_launch_nothing():
    """A wrapper given CPU tensors runs its plain version: no launch counts."""
    cuda_ops.reset_launch_counts()
    x, x0, u, v = map(_t, _fields(40, 34, 1.0, 1.0, 1.0, 1.0))
    cuda_ops.fused_jacobi(1, x, x0, 0.4, 2.6, 3, src_dt=DT, cheby_rho=0.9)
    cuda_ops.fused_project(u, v, 32, 3)
    cuda_ops.advect_shift_fused((1, 2), (u, v), u, v, DT, 32)
    cuda_ops.fused_dens_advect(0, x, x0, u, v, 0.4, 2.6, 3, DT, 32)
    assert cuda_ops.launch_counts() == dict.fromkeys(cuda_ops.KERNELS, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "devices"])
def test_wrapper_rejects(bad):
    x = torch.zeros(34, 34)
    y = {
        "dtype": torch.zeros(34, 34, dtype=torch.float64),
        "shape": torch.zeros(34, 36),
        "contiguity": torch.zeros(34, 68)[:, ::2],
        "devices": torch.zeros(34, 34, device="meta"),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        cuda_ops.fused_jacobi(0, x, y, 0.4, 2.6, 1)


@pytest.mark.parametrize("iters", [1, 2, 7])
def test_dens_plain_is_diffuse_then_advect(iters):
    """The plain form of K4 is the composition it replaces."""
    src, base, u, v = map(_t, _fields(50, 34, 0.5, 1.0, 1.0, 1.0))
    d = cuda_ops.fused_jacobi(0, src, base, 0.4, 2.6, iters, src_dt=DT)
    want = cuda_ops.advect_shift(0, d, u, v, DT, 32)
    got = cuda_ops.fused_dens_advect(0, src, base, u, v, 0.4, 2.6, iters, DT,
                                     32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
