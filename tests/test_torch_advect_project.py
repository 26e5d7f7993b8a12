"""The port's fused velocity tail (``kernels/cuda_step.py``, K17) against
the JAX package's fused advect+project kernel (``kernels/pallas_step.py``,
B11) in interpret mode, as tests/test_pallas_step.py runs it.

On CPU tensors ``fused_advect_project`` returns its plain version
(``advect_windowed`` on the u/v pair, then ``fused_project_plain``), which
the GPU tests and chip_smoke.py hold K17 against.  Velocities come from a
numpy seed, with the ghost ring a projection leaves (modes 1 and 2).

Two references: the JAX package's jnp specification of the same function
(its ``advect_windowed`` on the pair, then its reference projection), held
at atol 1e-6 as tests/test_pallas_step.py holds B11 against its
composition (the port equals it bit for bit in the Jacobi cases); and B11
itself in interpret mode, whose gather rounds the backtrace ``j - dt0*u``
differently from JAX's own jnp spec (8.1e-6 apart on the gather of these
inputs: the FMA-contraction class tests/test_pallas_step.py:53-60 names),
held at the gather tolerance of tests/test_torch_cuda_ops.py (rtol 1e-5,
atol 2e-5).  Where displacements of many cells put departure points on the
window's edges, rtol = atol = 1e-4, as tests/test_pallas_step.py:53-68.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fluidsimulationcuda_torch.kernels import cuda_ops, cuda_step  # noqa: E402
from fluidsimulationcuda_torch.ops.boundary import embed_interior  # noqa: E402
from fluidsimulationcuda_tpu.kernels import (  # noqa: E402
    pallas_ops, pallas_step)
from fluidsimulationcuda_tpu.kernels.dispatch import (  # noqa: E402
    _project_ref_op as jax_project)
from fluidsimulationcuda_tpu.ops.advect import (  # noqa: E402
    advect_windowed as jax_advect_windowed)

N, DT = 126, 0.016
GATHER_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_ops, "INTERPRET", True)


def _vel_pair(seed, scale=1.0, n=N):
    """Velocities in [-scale, scale] with the ghost ring of modes 1 and 2."""
    rng = np.random.default_rng(seed)
    side = n + 2
    u, v = (torch.from_numpy(rng.uniform(-1.0, 1.0, (side, side))
                             .astype(np.float32) * np.float32(scale))
            for _ in range(2))
    return (embed_interior(1, u[1:-1, 1:-1]).numpy(),
            embed_interior(2, v[1:-1, 1:-1]).numpy())


def _run_both(u, v, iters, cmax, cheby_rho=None):
    got = cuda_step.fused_advect_project(
        torch.from_numpy(u), torch.from_numpy(v), N, iters, DT, cmax=cmax,
        cheby_rho=cheby_rho)
    want = pallas_step.fused_advect_project(
        jnp.asarray(u), jnp.asarray(v), N, iters, DT, cmax=cmax,
        cheby_rho=cheby_rho)
    return got, want


def _close(got, want, **tol):
    for name, g, w in zip("uv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **tol)


CASES = pytest.mark.parametrize("iters,cmax", [(6, 1), (6, 2), (3, 1)])
RHOS = pytest.mark.parametrize("cheby_rho", [None, 0.9],
                               ids=["jacobi", "chebyshev"])


@RHOS
@CASES
def test_advect_project_matches_jax_spec(iters, cmax, cheby_rho):
    u, v = _vel_pair(1)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    want = jax_project(jax_advect_windowed(1, ju, ju, jv, DT, N, cmax),
                       jax_advect_windowed(2, jv, ju, jv, DT, N, cmax), N,
                       iters, cheby_rho=cheby_rho)
    got = cuda_step.fused_advect_project(
        torch.from_numpy(u), torch.from_numpy(v), N, iters, DT, cmax=cmax,
        cheby_rho=cheby_rho)
    _close(got, want, rtol=0, atol=1e-6)


@RHOS
@CASES
def test_advect_project_matches_jax_kernel(iters, cmax, cheby_rho):
    u, v = _vel_pair(1)
    _close(*_run_both(u, v, iters, cmax, cheby_rho), **GATHER_TOL)


def test_large_displacement_clamps_like_jax():
    """Backtraces of up to 80 cells against a 2-cell window: the clamp
    fires nearly everywhere, as in JAX."""
    u, v = _vel_pair(3, scale=40.0)
    _close(*_run_both(u, v, 6, 2), rtol=1e-4, atol=1e-4)


def test_batch_of_two_matches_jax_and_single_grids():
    pairs = [_vel_pair(5), _vel_pair(6, scale=2.0)]
    u = np.stack([p[0] for p in pairs])
    v = np.stack([p[1] for p in pairs])
    got, want = _run_both(u, v, 4, 2)
    _close(got, want, **GATHER_TOL)
    for k, (a, b) in enumerate(pairs):
        single = cuda_step.fused_advect_project(
            torch.from_numpy(a), torch.from_numpy(b), N, 4, DT, cmax=2)
        for g, s in zip(got, single):
            np.testing.assert_array_equal(g[k].numpy(), s.numpy())


@pytest.mark.parametrize("cheby_rho", [None, 0.9], ids=["jacobi", "chebyshev"])
@pytest.mark.parametrize("cmax", [1, 4])
def test_plain_is_the_composition_it_replaces(cmax, cheby_rho):
    """The plain version equals the CUDA backend's composition on CPU
    tensors: the windowed pair (K3's wrapper), then ``fused_project``."""
    u, v = (torch.from_numpy(a) for a in _vel_pair(7, scale=3.0, n=30))
    got = cuda_step.fused_advect_project(u, v, 30, 5, DT, cmax=cmax,
                                         cheby_rho=cheby_rho)
    want = cuda_ops.fused_project(
        *cuda_ops.advect_shift_fused((1, 2), (u, v), u, v, DT, 30, cmax), 30,
        5, cheby_rho=cheby_rho)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert not torch.equal(u, got[0])  # inputs untouched, outputs fresh


def test_advect_project_supported():
    """The port takes what JAX's VMEM plan and Mosaic gates refuse (a
    window over 3 cells, a side with no 4 strips), and refuses what K17
    cannot run."""
    assert not pallas_step.advect_project_supported(2048, 20, 4)
    assert cuda_step.advect_project_supported(2048, 20, 4)
    assert not pallas_step.advect_project_supported(66, 6, 1)
    assert cuda_step.advect_project_supported(66, 6, 1)
    assert pallas_step.advect_project_supported(128, 6, 2)
    assert cuda_step.advect_project_supported(128, 6, 2)
    for side, iters, cmax in ((128, 6, 0), (128, 0, 1),
                              (128, cuda_step.MAX_SWEEPS + 1, 1), (2, 6, 1),
                              (46341, 6, 1)):
        assert not cuda_step.advect_project_supported(side, iters, cmax)


@pytest.mark.parametrize("bad", ["cmax", "iters", "shape", "dtype", "batch"])
def test_rejects(bad):
    u = torch.zeros(34, 34)
    args = {"cmax": (u, u, 32, 3, DT, 0), "iters": (u, u, 32, 0, DT, 1),
            "shape": (u, torch.zeros(34, 36), 32, 3, DT, 1),
            "dtype": (u, u.double(), 32, 3, DT, 1),
            "batch": (u[None].expand(2, 34, 34).contiguous(), u, 32, 3, DT,
                      1)}[bad]
    *pos, cmax = args
    with pytest.raises((TypeError, ValueError)):
        cuda_step.fused_advect_project(*pos, cmax=cmax)


def test_cpu_tensors_launch_nothing():
    u, v = (torch.from_numpy(a) for a in _vel_pair(8, n=30))
    cuda_ops.reset_launch_counts()
    cuda_step.fused_advect_project(u, v, 30, 3, DT, cmax=2, cheby_rho=0.9)
    assert cuda_ops.launch_counts() == dict.fromkeys(cuda_ops.KERNELS, 0)
