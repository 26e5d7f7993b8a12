"""The 2-D step in windowed mode (``advect_mode="windowed"``) on both of the
port's backends against the JAX package's windowed ``reference`` step, and
the exactness boundary of the port's windowed gather, mirroring
tests/test_exactness_boundary.py:47-71 on both backends.

Sources come from numpy (a seed) and go to both packages; JAX runs its
``reference`` backend on the CPU, which takes ``advect_windowed`` in
windowed mode.  The ``cuda`` backend's wrappers return their plain versions
on CPU tensors; ``SimConfig`` refuses ``backend="cuda"`` with a CPU device,
so the tests set it after the config is built, as
dev/rehearse_kernels_cpu.py does.  The step tolerance is that of
tests/test_pallas_step.py:71-90 (rtol = atol = 1e-5, n=126, 6 iterations,
a 2-cell window).  The compensated mode runs without fast math: the JAX
reference backend ignores ``fast_math``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.kernels.dispatch import get_ops  # noqa: E402
from fluidsimulationcuda_torch.ops.advect import advect  # noqa: E402

N, ITERS, CMAX = 126, 6, 2
MODES = {
    "parity": dict(),
    "compensated": dict(pressure_solver="chebyshev",
                        diffusion_solver="chebyshev", cheby_rho=0.9,
                        cheby_iters=10, cheby_press_iters=14),
}
# Source velocity scales: the reference impulse moves the backtrace 0.22
# cells (under the window); 20 times it, 4.5 cells (the window clamps).
IMPULSES = {"under_window": 1.0, "over_window": 20.0}


def _sources(seed, n, scale):
    """reference_init's distributions, drawn with numpy; velocities scaled."""
    rng = np.random.default_rng(seed)
    side = n + 2
    dens = rng.uniform(0.0, 0.099, (side, side)).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None] & band[None, :])] = 0.0
    u, v = (rng.uniform(0.0, 0.99, (side, side)).astype(np.float32)
            * np.float32(scale) for _ in range(2))
    return dens, u, v


def _kw(mode):
    return dict(n=N, jacobi_iters=ITERS, max_courant=CMAX,
                advect_mode="windowed", backend="reference", **MODES[mode])


def _port_cfg(which, **kw):
    """A CPU config of the ``reference`` or (``which="cuda"``) the ``cuda``
    backend."""
    cfg = ft.SimConfig(device="cpu", **{**kw, "backend": "reference"})
    if which == "cuda":
        object.__setattr__(cfg, "backend", "cuda")
    return cfg


@functools.lru_cache(maxsize=None)
def _jax(mode, impulse, audited=False):
    """JAX's windowed reference step from the zero state: (dens, u, v) as
    numpy arrays, and with ``audited`` the audited displacement."""
    cfg = fj.SimConfig(**_kw(mode))
    src = fj.Sources(*map(jnp.asarray, _sources(0, N, IMPULSES[impulse])))
    if audited:
        state, disp = fj.step_audited(cfg, fj.zero_state(cfg), src)
        return tuple(np.asarray(x) for x in state[:3]), float(disp)
    state = fj.step(cfg, fj.zero_state(cfg), src)
    return tuple(np.asarray(x) for x in state[:3])


def _torch_sources(impulse):
    return ft.Sources(*(torch.from_numpy(a)
                        for a in _sources(0, N, IMPULSES[impulse])))


@pytest.mark.parametrize("impulse", list(IMPULSES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_windowed_step_matches_jax(backend, mode, impulse):
    cfg = _port_cfg(backend, **_kw(mode))
    got = ft.step(cfg, ft.zero_state(cfg), _torch_sources(impulse))
    for name, g, w in zip(("dens", "u", "v"), got, _jax(mode, impulse)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_window_clamps_over_it_and_not_under_it():
    """The test has teeth: over the window the windowed step differs from
    the exact one, under it they are equal bit for bit."""
    for impulse, clamps in (("under_window", False), ("over_window", True)):
        src = _torch_sources(impulse)
        cfg = _port_cfg("reference", **_kw("parity"))
        win = ft.step(cfg, ft.zero_state(cfg), src)
        exact = ft.step(cfg.replace(advect_mode="exact"), ft.zero_state(cfg),
                        src)
        differs = any(not torch.equal(a, b) for a, b in zip(win[:3], exact[:3]))
        assert differs == clamps, impulse


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_windowed_step_audited_matches_step_and_jax(backend):
    cfg = _port_cfg(backend, **_kw("parity"))
    src = _torch_sources("over_window")
    state, disp = ft.step_audited(cfg, ft.zero_state(cfg), src)
    plain = ft.step(cfg, ft.zero_state(cfg), src)
    for a, b in zip(state[:3], plain[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jstate, jdisp = _jax("parity", "over_window", audited=True)
    assert float(disp) > CMAX  # the gathers clamped
    np.testing.assert_allclose(float(disp), jdisp, rtol=1e-5)
    for a, w in zip(state[:3], jstate):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-5)


def test_cuda_opset_passes_the_window_to_the_gathers(monkeypatch):
    """The cuda backend's OpSet calls K3 (the pair) and K4 with the window
    in windowed mode and without it in the exact modes."""
    calls = []

    def spy(name):
        orig = getattr(cuda_ops, name)

        def call(*args, **kw):
            calls.append((name, kw["cmax"] if "cmax" in kw else args[6]))
            return orig(*args, **kw)

        monkeypatch.setattr(cuda_ops, name, call)

    spy("advect_shift_fused")
    spy("fused_dens_advect")
    u = torch.zeros(N + 2, N + 2)
    for mode in ("windowed", "exact"):
        ops = cuda_ops.make_opset(
            _port_cfg("cuda", **{**_kw("parity"), "advect_mode": mode}))
        ops.advect_pair(1, 2, u, u, u, u, 0.016, N)
        ops.diffuse_advect(0, u, u, u, u, 0.5, 3.0, 2, 0.016, N)
    assert calls == [("advect_shift_fused", CMAX), ("fused_dens_advect", CMAX),
                     ("advect_shift_fused", None), ("fused_dens_advect", None)]


# ---------------------------------------------------------------------------
# The exactness boundary (tests/test_exactness_boundary.py:47-71)
# ---------------------------------------------------------------------------

B_N = 62


def _field2(n, seed=0):
    rng = np.random.default_rng(seed)
    side = n + 2
    return torch.from_numpy(rng.standard_normal((side, side))
                            .astype(np.float32))


def _const_vel2(n, disp, angle=0.3):
    """Uniform velocity whose backtrace displacement is exactly ``disp``
    cells along the dominant axis (dt*n = 1 below)."""
    side = n + 2
    return (torch.full((side, side), float(np.float32(disp))),
            torch.full((side, side), float(np.float32(disp * angle))))


def _dt(n):
    """dt*n == 1 makes the displacement equal the velocity, exactly."""
    return 1.0 / n


def _windowed_advect(backend):
    """The ``advect`` op of a backend's OpSet in windowed mode."""
    cfg = _port_cfg(backend, n=B_N, max_courant=CMAX, advect_mode="windowed")
    return (get_ops(cfg) if backend == "reference"
            else cuda_ops.make_opset(cfg)).advect


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("disp", [CMAX - 1.0, CMAX - 0.25, CMAX - 0.001,
                                  float(CMAX)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_2d_windowed_exact_below_and_at_cmax(sign, disp, backend):
    d0 = _field2(B_N)
    u, v = _const_vel2(B_N, sign * disp)
    exact = advect(0, d0, u, v, _dt(B_N), B_N)
    win = _windowed_advect(backend)(0, d0, u, v, _dt(B_N), B_N)
    np.testing.assert_array_equal(exact.numpy(), win.numpy())


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("disp", [CMAX + 0.25, CMAX + 1.0])
def test_2d_windowed_clamps_above_cmax(disp, backend):
    """Above the boundary the clamp must fire: the paths really differ."""
    d0 = _field2(B_N)
    u, v = _const_vel2(B_N, disp)
    exact = advect(0, d0, u, v, _dt(B_N), B_N)
    win = _windowed_advect(backend)(0, d0, u, v, _dt(B_N), B_N)
    assert float((exact - win).abs().max()) > 0.0


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("mode", ["auto", "exact"])
def test_exact_modes_stay_exact_above_cmax(mode, backend):
    """``"auto"`` and ``"exact"`` gather exactly in the port, whatever the
    window."""
    cfg = _port_cfg(backend, n=B_N, max_courant=CMAX, advect_mode=mode)
    ops = get_ops(cfg) if backend == "reference" else cuda_ops.make_opset(cfg)
    d0 = _field2(B_N)
    u, v = _const_vel2(B_N, CMAX + 1.0)
    np.testing.assert_array_equal(
        ops.advect(0, d0, u, v, _dt(B_N), B_N).numpy(),
        advect(0, d0, u, v, _dt(B_N), B_N).numpy())
