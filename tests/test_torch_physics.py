"""Physics ground truth for the port (mirror of tests/test_physics.py), and
the exactness boundary of the port's windowed 3-D gather (mirror of the 3-D
half of tests/test_exactness_boundary.py, :96-119).

The solvers are pinned to analytic properties of the discretized equations,
which hold whatever the implementation:

1. the converged implicit diffusion scales its boundary-compatible
   eigenmodes by 1 / (1 + 4a(sin²(kx/2) + sin²(ky/2))) (mode 0: cosines;
   modes 1/2: sines on the wall-normal axis), Chebyshev sweeps included;
2. under mode 0 it conserves interior mass;
3. the projection passes a discretely solenoidal field through and scales a
   pure-gradient eigenmode by F = 1 − (sx²cx² + sy²cy²)/(sx² + sy²);
4. advection is exact on constants and the identity at zero velocity.

Each runs on the ``reference`` backend on the CPU (diffusion also on the
NumPy oracle, as the JAX tests run it) and, marked ``gpu``, on the
``cuda`` backend on the card, where it skips without one.  The windowed
3-D gather equals the exact one while the displacement stays at or below
the window and differs above it, on the ``reference`` backend, on the
``cuda`` backend's wrappers on CPU tensors (their plain versions) and on
the card.  Nothing here imports JAX, so the ``gpu`` cases run on a machine
without it (``pytest -m gpu --noconftest``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.kernels.dispatch import get_ops  # noqa: E402
from fluidsimulationcuda_torch.models.stable_fluids_3d import _Ops3  # noqa: E402
from fluidsimulationcuda_torch.ops.three_d import advect3  # noqa: E402

N = 30  # interior cells; side 32
CARD = pytest.param("cuda", marks=pytest.mark.gpu)


def _device(backend):
    """The device a backend's case runs on; the card's cases skip without
    one (decided when the test runs)."""
    if backend != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ops(backend, n=N):
    dev = _device(backend)
    return get_ops(ft.SimConfig(n=n, jacobi_iters=20, backend=backend,
                                device=dev)), dev


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def _mode(fam_y, p, fam_x, q, n=N):
    """Product eigenmode on the padded grid (ghosts included);
    ``fam``: "cos" (mirror family) or "sin" (no-slip family); k = πp/n."""
    idx = np.arange(n + 2, dtype=np.float64)
    ky, kx = np.pi * p / n, np.pi * q / n

    def fam(f, k):
        c = (idx - 0.5) * k
        return np.cos(c) if f == "cos" else np.sin(c)

    m = np.outer(fam(fam_y, ky), fam(fam_x, kx)).astype(np.float32)
    return m, 4.0 * (np.sin(kx / 2) ** 2 + np.sin(ky / 2) ** 2)


def _diffuse(backend, b, x_init, x0, alpha, iters, cheby_rho=None):
    beta = 1.0 + 4.0 * alpha
    if backend == "oracle":
        from fluidsimulationcuda_tpu.oracle import numpy_ref as oracle

        return oracle.diffuse(b, x_init.copy(), x0, alpha, beta, iters)
    ops, dev = _ops(backend)
    kw = {} if cheby_rho is None else {"cheby_rho": cheby_rho}
    return ops.diffuse(b, _t(x_init, dev), _t(x0, dev), alpha, beta, iters,
                       **kw).cpu().numpy()


@pytest.mark.parametrize("backend", ["reference", "oracle", CARD])
@pytest.mark.parametrize("b,fam_y,fam_x,p,q", [
    (0, "cos", "cos", 3, 5),  # density: mirror on both axes
    (1, "cos", "sin", 2, 4),  # u: no-slip on the x walls
    (2, "sin", "cos", 4, 2),  # v: no-slip on the y walls
])
def test_diffusion_eigenmode_factor(backend, b, fam_y, fam_x, p, q):
    alpha = 0.4
    m, denom = _mode(fam_y, p, fam_x, q)
    got = _diffuse(backend, b, m, m, alpha, 150)
    np.testing.assert_allclose(got[1:-1, 1:-1],
                               m[1:-1, 1:-1] / (1.0 + alpha * denom),
                               rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("backend", ["reference", CARD])
def test_diffusion_chebyshev_same_eigenmode_factor(backend):
    """The Chebyshev solve targets the same fixed point."""
    alpha = 0.4
    m, denom = _mode("cos", 3, "cos", 5)
    got = _diffuse(backend, 0, m, m, alpha, 100, cheby_rho=0.9)
    np.testing.assert_allclose(got[1:-1, 1:-1],
                               m[1:-1, 1:-1] / (1.0 + alpha * denom),
                               rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("backend", ["reference", "oracle", CARD])
def test_diffusion_mode0_conserves_mass(backend):
    rng = np.random.default_rng(1234)
    x0 = np.zeros((N + 2, N + 2), np.float32)
    x0[1:-1, 1:-1] = rng.standard_normal((N, N)).astype(np.float32)
    mass0 = float(np.sum(x0[1:-1, 1:-1], dtype=np.float64))
    got = _diffuse(backend, 0, x0, x0, 0.7, 150)
    mass = float(np.sum(got[1:-1, 1:-1], dtype=np.float64))
    assert abs(mass - mass0) <= 1e-4 * max(1.0, abs(mass0)) + 1e-4


def _solenoidal_field():
    """(u, v) whose central divergence cancels term by term, from a
    streamfunction that vanishes near the walls."""
    yy, xx = np.meshgrid(np.arange(N + 2), np.arange(N + 2), indexing="ij")
    c = (N + 2) / 2.0
    psi = np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (2 * (N / 8.0) ** 2))
    psi[:4, :] = psi[-4:, :] = psi[:, :4] = psi[:, -4:] = 0.0
    u = np.zeros_like(psi)
    v = np.zeros_like(psi)
    u[1:-1, 1:-1] = psi[2:, 1:-1] - psi[:-2, 1:-1]
    v[1:-1, 1:-1] = -(psi[1:-1, 2:] - psi[1:-1, :-2])
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("backend", ["reference", CARD])
def test_projection_identity_on_solenoidal_field(backend):
    ops, dev = _ops(backend)
    u, v = _solenoidal_field()
    div = ops.divergence(_t(u, dev), _t(v, dev), N).cpu().numpy()
    assert np.abs(div).max() < 1e-7
    un, vn = (x.cpu().numpy() for x in ops.project(_t(u, dev), _t(v, dev), N,
                                                   20))
    tol = 1e-4 * max(np.abs(u).max(), 1e-3)
    np.testing.assert_allclose(un[1:-1, 1:-1], u[1:-1, 1:-1], atol=tol)
    np.testing.assert_allclose(vn[1:-1, 1:-1], v[1:-1, 1:-1], atol=tol)


@pytest.mark.parametrize("backend", ["reference", CARD])
def test_projection_gradient_mode_exact_factor(backend):
    """The converged projection scales a pure-gradient eigenmode field by
    exactly F (the collocated grid's wide-divergence / compact-Laplacian
    mismatch included)."""
    ops, dev = _ops(backend)
    p, q = 6, 8
    ky, kx = np.pi * p / N, np.pi * q / N
    m_u, _ = _mode("cos", p, "sin", q)
    m_v, _ = _mode("sin", p, "cos", q)
    u = (np.sin(kx) * m_u).astype(np.float32)
    v = (np.sin(ky) * m_v).astype(np.float32)
    sx2, cx2 = np.sin(kx / 2) ** 2, np.cos(kx / 2) ** 2
    sy2, cy2 = np.sin(ky / 2) ** 2, np.cos(ky / 2) ** 2
    f = 1.0 - (sx2 * cx2 + sy2 * cy2) / (sx2 + sy2)
    un, vn = (x.cpu().numpy() for x in ops.project(_t(u, dev), _t(v, dev), N,
                                                   150))
    np.testing.assert_allclose(un[1:-1, 1:-1], f * u[1:-1, 1:-1], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(vn[1:-1, 1:-1], f * v[1:-1, 1:-1], rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["reference", CARD])
@pytest.mark.parametrize("field", ["constant", "zero_velocity"])
def test_advection_identities(backend, field):
    """A constant advects to itself at any velocity (the bilinear weights
    sum to 1); at zero velocity every cell backtraces to itself."""
    ops, dev = _ops(backend)
    rng = np.random.default_rng(1234)
    if field == "constant":
        d0 = np.full((N + 2, N + 2), 0.7321, np.float32)
        u, v = ((0.5 * rng.standard_normal((N + 2, N + 2))).astype(np.float32)
                for _ in range(2))
    else:
        d0 = np.zeros((N + 2, N + 2), np.float32)
        d0[1:-1, 1:-1] = rng.standard_normal((N, N)).astype(np.float32)
        u = v = np.zeros_like(d0)
    got = ops.advect(0, _t(d0, dev), _t(u, dev), _t(v, dev), 0.016,
                     N).cpu().numpy()
    if field == "constant":
        np.testing.assert_allclose(got[1:-1, 1:-1], 0.7321, rtol=0, atol=2e-6)
    else:
        np.testing.assert_array_equal(got[1:-1, 1:-1], d0[1:-1, 1:-1])


# ---------------------------------------------------------------------------
# The windowed 3-D gather at its exactness boundary
# ---------------------------------------------------------------------------


CMAX = 2
N3 = 22


def _windowed3(backend):
    """The advection of the windowed 3-D step (``advect_mode="windowed"``,
    a window of ``CMAX`` cells) on ``backend``, and its device.
    ``cuda_cpu`` is the ``cuda`` backend's wrappers on CPU tensors, where
    they return their plain versions (the config's backend is set after it
    is built: ``SimConfig`` refuses ``cuda`` with a CPU device)."""
    dev = _device(backend)
    cfg = ft.SimConfig(n=N3, ndim=3, dt=1.0 / N3, max_courant=CMAX,
                       advect_mode="windowed",
                       backend="cuda" if backend == "cuda" else "reference",
                       device=dev)
    if backend == "cuda_cpu":
        object.__setattr__(cfg, "backend", "cuda")
    return _Ops3(cfg).advect, dev


def _gather3(backend, disp):
    """(exact, windowed) advection of a random field by a uniform velocity
    whose backtrace moves ``disp`` cells along x (dt*n = 1, so the
    displacement equals the velocity, exactly)."""
    advect, dev = _windowed3(backend)
    rng = np.random.default_rng(1)
    side = N3 + 2
    d0 = _t(rng.standard_normal((side,) * 3), dev)
    u, v, w = (torch.full((side,) * 3, float(np.float32(disp * s)),
                          device=dev) for s in (1.0, 0.4, -0.7))
    dt = 1.0 / N3
    exact = advect3(0, d0, u, v, w, dt, N3)
    return exact.cpu().numpy(), advect(0, d0, u, v, w).cpu().numpy()


@pytest.mark.parametrize("backend", ["reference", "cuda_cpu", CARD])
@pytest.mark.parametrize("disp", [CMAX - 0.25, CMAX - 0.001, float(CMAX)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_3d_windowed_exact_below_and_at_cmax(backend, disp, sign):
    """Bit for bit on the CPU; on the card K6 against the plain exact
    gather at JAX's kernel tolerance (atol 1e-6,
    tests/test_exactness_boundary.py:84-86)."""
    exact, win = _gather3(backend, sign * disp)
    atol = 1e-6 if backend == "cuda" else 0.0
    np.testing.assert_allclose(win, exact, rtol=0, atol=atol)


@pytest.mark.parametrize("backend", ["reference", "cuda_cpu", CARD])
def test_3d_windowed_clamps_above_cmax(backend):
    exact, win = _gather3(backend, CMAX + 0.5)
    assert float(np.abs(exact - win).max()) > 0.0
