"""The 3-D step in windowed mode (``advect_mode="windowed"``) on both of the
port's backends against the JAX package's windowed jnp 3-D step, and the
window's exactness boundary.

JAX takes its windowed jnp gather (``ops.three_d.advect3_windowed``) only
when ``jax.default_backend() == "tpu"`` (``models/stable_fluids_3d.py:92``
there), so each JAX run here patches ``jax.default_backend`` to answer
``"tpu"`` around a ``backend="reference"`` ``step3``; nothing in the JAX
package changes.  Sources are drawn with numpy from a seed, their
velocities scaled up until the backtrace crosses the window, and go to both
packages.  The ``cuda`` backend's wrappers return their plain versions on
CPU tensors (the config's backend is set after it is built, as
tests/test_torch_step_windowed.py does).  Tolerance: atol 2e-5, that of
JAX's own windowed 3-D step tests (tests/test_pallas_3d.py:241-245), times
the field's scale where it exceeds 1: the sources that make the window
clamp leave velocities of ~34, where an ulp is 3.8e-6 and the port's exact
3-D step already differs from JAX's by more than 2e-5 (printed by
``test_the_window_clamps_and_the_audit_says_so``).
The compensated mode runs without fast math, which the reference backends
ignore.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.models import stable_fluids_3d as t3  # noqa: E402
from fluidsimulationcuda_tpu.models import stable_fluids_3d as j3  # noqa: E402

ATOL = 2e-5
STEPS = 2
MODES = {
    "parity": dict(),
    "compensated": dict(pressure_solver="chebyshev",
                        diffusion_solver="chebyshev", cheby_rho=0.85,
                        cheby_iters=10, cheby_press_iters=12),
}
# Velocity source scale: 2000 moves the backtrace tens of cells at n=14
# and n=22, far over windows of 1 and 2 cells.
SCALE = 2000.0


def _sources(seed, n, scale):
    """reference_init's 3-D distributions, drawn with numpy, velocities
    scaled by ``scale``."""
    rng = np.random.default_rng(seed)
    side = n + 2
    shape = (side,) * 3
    dens = rng.uniform(0.0, 0.099, shape).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None, None] & band[None, :, None] & band[None, None, :])] = 0
    vel = [rng.uniform(0.0, 0.99, shape).astype(np.float32) * np.float32(scale)
           for _ in range(3)]
    return (dens, *vel)


def _kw(n, cmax, mode):
    return dict(n=n, ndim=3, jacobi_iters=10, max_courant=cmax,
                advect_mode="windowed", backend="reference", **MODES[mode])


@contextlib.contextmanager
def _jax_on_a_tpu():
    """Make JAX's 3-D step take the branch it takes on a TPU."""
    real = jax.default_backend
    jax.default_backend = lambda: "tpu"
    try:
        yield
    finally:
        jax.default_backend = real


@functools.lru_cache(maxsize=None)
def _jax_windowed(n, cmax, mode, scale=SCALE):
    """JAX's windowed jnp 3-D step from the zero state, sources on step 1:
    the states after each of ``STEPS`` steps as numpy arrays."""
    cfg = fj.SimConfig(**_kw(n, cmax, mode))
    src = fj.Sources(*map(jnp.asarray, _sources(n, n, scale)))
    zeros, state, out = fj.zero_sources(cfg), fj.zero_state(cfg), []
    with _jax_on_a_tpu():
        for k in range(STEPS):
            state = j3.step3(cfg, state, src if k == 0 else zeros)
            out.append(tuple(np.asarray(x) for x in state))
    return out


def _port(n, cmax, mode, backend="reference", scale=SCALE, **kw):
    """The port's step3 trajectory, as ``_jax_windowed``."""
    cfg = ft.SimConfig(device="cpu", **{**_kw(n, cmax, mode), **kw})
    object.__setattr__(cfg, "backend", backend)
    src = ft.Sources(*map(torch.from_numpy, _sources(n, n, scale)))
    state, zeros, out = ft.zero_state(cfg), ft.zero_sources(cfg), []
    for k in range(STEPS):
        state = ft.step3(cfg, state, src if k == 0 else zeros)
        out.append(state)
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cmax", [1, 2])
@pytest.mark.parametrize("n", [14, 22])
def test_windowed_step3_matches_jax(n, cmax, mode):
    want = _jax_windowed(n, cmax, mode)
    for k, state in enumerate(_port(n, cmax, mode)):
        gap = max(float(np.abs(g.numpy() - w).max())
                  for g, w in zip(state, want[k]))
        print(f"step {k + 1}: max|d| {gap:.3e}, max|field| "
              f"{max(float(np.abs(w).max()) for w in want[k]):.4g}")
        for name, g, w in zip(("dens", "u", "v", "w"), state, want[k]):
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=ATOL * scale,
                                       err_msg=f"{name} step {k + 1}")


@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_backend_equals_reference_on_cpu(mode):
    """The ``cuda`` OpSet's windowed K6 wrappers on CPU tensors return
    their plain versions: the step equals the ``reference`` one bit for
    bit."""
    for a, b in zip(_port(14, 1, mode, "cuda"), _port(14, 1, mode)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_the_window_clamps_and_the_audit_says_so():
    """With these sources the audited displacement exceeds the window, and
    the windowed step differs from the exact one; JAX's exact step (its
    CPU branch) differs from its windowed one by as much."""
    n, cmax = 14, 1
    cfg = ft.SimConfig(device="cpu", **_kw(n, cmax, "parity"))
    src = ft.Sources(*map(torch.from_numpy, _sources(n, n, SCALE)))
    windowed, disp = t3.step_audited3(cfg, ft.zero_state(cfg), src)
    assert float(disp) > cmax
    exact = _port(n, cmax, "parity", advect_mode="exact")[0]
    gap = max(float((a - b).abs().max()) for a, b in zip(windowed, exact))
    jcfg = fj.SimConfig(**{**_kw(n, cmax, "parity"), "advect_mode": "exact"})
    jexact = j3.step3(jcfg, fj.zero_state(jcfg),
                      fj.Sources(*map(jnp.asarray, _sources(n, n, SCALE))))
    jgap = max(float(np.abs(np.asarray(a) - b).max())
               for a, b in zip(jexact, _jax_windowed(n, cmax, "parity")[0]))
    egap = max(float(np.abs(a.numpy() - np.asarray(b)).max())
               for a, b in zip(exact, jexact))
    print(f"n={n}, cmax={cmax}: windowed - exact, port {gap:.4g}, JAX "
          f"{jgap:.4g}; exact step, port - JAX {egap:.3e}")
    assert gap > 1.0 and jgap > 1.0, (gap, jgap)
    np.testing.assert_allclose(gap, jgap, rtol=1e-3)


def test_windowed_equals_exact_under_the_window():
    """Unscaled sources move the backtrace less than one cell: a window of
    2 cells never clamps, and the windowed step equals the exact one bit
    for bit."""
    n, cmax = 14, 2
    cfg = ft.SimConfig(device="cpu", **_kw(n, cmax, "parity"))
    src = ft.Sources(*map(torch.from_numpy, _sources(n, n, 1.0)))
    windowed, disp = t3.step_audited3(cfg, ft.zero_state(cfg), src)
    assert float(disp) < cmax
    exact = ft.step3(cfg.replace(advect_mode="exact"), ft.zero_state(cfg),
                     src)
    for a, b in zip(windowed, exact):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_windowed_k6_wrappers_take_cmax_on_cpu():
    """``advect3_shift(_fused)`` with ``cmax`` return
    ``ops.three_d.advect3_windowed`` on CPU tensors, and refuse a window
    under one cell."""
    from fluidsimulationcuda_torch.kernels import cuda_ops_3d as co3
    from fluidsimulationcuda_torch.ops.three_d import advect3_windowed

    rng = np.random.default_rng(0)
    d, u, v, w = (torch.from_numpy(rng.uniform(-1, 1, (10,) * 3).astype(
        np.float32) * s) for s in (1.0, 100.0, 100.0, 100.0))
    got = co3.advect3_shift_fused((1, 2, 3), (u, v, w), u, v, w, 0.016, 8,
                                  cmax=2)
    for b, f, g in zip((1, 2, 3), (u, v, w), got):
        np.testing.assert_array_equal(
            g.numpy(), advect3_windowed(b, f, u, v, w, 0.016, 8, 2).numpy())
    np.testing.assert_array_equal(
        co3.advect3_shift(0, d, u, v, w, 0.016, 8, cmax=1).numpy(),
        advect3_windowed(0, d, u, v, w, 0.016, 8, 1).numpy())
    with pytest.raises(ValueError, match="window"):
        co3.advect3_shift(0, d, u, v, w, 0.016, 8, cmax=0)
    assert "advect3_windowed" in cuda_ops.KERNELS
