"""The port's conjugate-gradient pressure solver (``ops/cg.py``) and the 2-D
step with ``pressure_solver="cg"``, against the JAX package's.

Inputs are numpy arrays given to both packages: the solver's rhs is that of
tests/test_cg.py (JAX's ``reference_init`` through JAX's divergence), the
step's sources are drawn with numpy from a seed; JAX runs its
``reference`` backend on the CPU.  Tolerances: a CG solve is held to
1e-5 of max|p| (the two frameworks sum the dot products in other orders,
and CG carries those roundings from iteration to iteration); the step to
the repo's gate, rtol 1e-5 / atol 2e-5 (tests/test_pallas_ops.py:174).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.ops import cg as tcg  # noqa: E402
from fluidsimulationcuda_torch.ops.project import (  # noqa: E402
    divergence, pressure_solve)
from fluidsimulationcuda_tpu.ops import cg as jcg  # noqa: E402
from fluidsimulationcuda_tpu.ops.project import (  # noqa: E402
    divergence as j_divergence, pressure_solve as j_pressure_solve)

STEP_TOL = dict(rtol=1e-5, atol=2e-5)


def _div(n, seed=0):
    """The rhs of tests/test_cg.py:12-18, as numpy: JAX's reference_init
    sources added to the zero state over one ``dt``, and JAX's divergence
    of them (the port does not reproduce ``jax.random``)."""
    cfg = fj.SimConfig(n=n, jacobi_iters=4, backend="reference")
    state, sources = fj.reference_init(jax.random.key(seed), cfg)
    dt = jnp.asarray(cfg.dt, jnp.float32)
    u, v = state.u + dt * sources.u, state.v + dt * sources.v
    return np.array(j_divergence(u, v, n))


@pytest.mark.parametrize("iters", [5, 20])
@pytest.mark.parametrize("n", [30, 126])
def test_cg_matches_jax(n, iters):
    """CG-20 (and CG-5) at n=30 and n=126: within 1e-5 of max|p|, and the
    same residual to 1e-3 of it."""
    div = _div(n)
    want = np.asarray(jcg.cg_pressure_solve(jnp.asarray(div), iters=iters))
    d_t = torch.from_numpy(div.copy())
    got = tcg.cg_pressure_solve(d_t, iters=iters)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    r_t = float(tcg.cg_residual_norm(got, d_t))
    r_j = float(jcg.cg_residual_norm(jnp.asarray(want), jnp.asarray(div)))
    print(f"max|d| {np.abs(got.numpy() - want).max():.3e}, max|p| "
          f"{scale:.4g}; residual port {r_t:.4e}, JAX {r_j:.4e}")
    assert abs(r_t - r_j) <= 1e-3 * r_j + 1e-12, (r_t, r_j)


def test_cg_residual_norm_matches_jax():
    div = _div(30, 1)
    p = np.random.default_rng(2).standard_normal((32, 32)).astype(np.float32)
    got = float(tcg.cg_residual_norm(torch.from_numpy(p),
                                     torch.from_numpy(div)))
    want = float(jcg.cg_residual_norm(jnp.asarray(p), jnp.asarray(div)))
    assert got == pytest.approx(want, rel=1e-6)


def test_cg_beats_jacobi40_residual_in_20_iters():
    """tests/test_cg.py:21-30: CG-20 leaves no more residual than 40
    Jacobi sweeps."""
    div = torch.from_numpy(_div(62))
    rj = float(tcg.cg_residual_norm(pressure_solve(div, 40), div))
    rc = float(tcg.cg_residual_norm(tcg.cg_pressure_solve(div, 20), div))
    print(f"n=62, JAX's rhs: CG-20 residual {rc:.4e}, Jacobi-40 {rj:.4e}")
    assert rc <= rj, (rc, rj)


def test_cg_and_jacobi40_residuals_match_jax_on_a_drawn_rhs():
    """On a numpy-drawn divergence (velocities uniform in [0, 0.99] times
    dt, n=62) CG-20's residual is not below 40 Jacobi sweeps' in either
    package: the property above depends on its rhs, not on the port.
    Each residual matches JAX's to 1e-3 of it."""
    n, dt = 62, np.float32(0.016)
    rng = np.random.default_rng(0)
    u, v = (dt * rng.uniform(0, 0.99, (n + 2, n + 2)).astype(np.float32)
            for _ in range(2))
    div = np.asarray(j_divergence(jnp.asarray(u), jnp.asarray(v), n))
    d_j, d_t = jnp.asarray(div), torch.from_numpy(div.copy())
    got = (float(tcg.cg_residual_norm(tcg.cg_pressure_solve(d_t, 20), d_t)),
           float(tcg.cg_residual_norm(pressure_solve(d_t, 40), d_t)))
    want = (float(jcg.cg_residual_norm(jcg.cg_pressure_solve(d_j, iters=20),
                                       d_j)),
            float(jcg.cg_residual_norm(j_pressure_solve(d_j, 40), d_j)))
    print(f"n={n}, drawn rhs: CG-20 / Jacobi-40 residual, port "
          f"{got[0]:.4e} / {got[1]:.4e}, JAX {want[0]:.4e} / {want[1]:.4e}")
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 * w, (got, want)


def test_cg_converges_with_iterations():
    """tests/test_cg.py:33-40: the residual halves at least between 5 and
    40 iterations."""
    div = torch.from_numpy(_div(30))
    r5 = float(tcg.cg_residual_norm(tcg.cg_pressure_solve(div, 5), div))
    r40 = float(tcg.cg_residual_norm(tcg.cg_pressure_solve(div, 40), div))
    assert r40 < 0.5 * r5, (r5, r40)


def test_cg_keeps_its_scalars_on_the_device():
    """No host sync inside the loop: the recurrence's scalars never become
    Python numbers (``Tensor.item`` and ``float`` are not called), so a
    step that runs it can be captured as a CUDA graph."""
    div = torch.from_numpy(_div(30))
    calls = []
    item, to_float = torch.Tensor.item, torch.Tensor.__float__

    def spy(name, fn):
        def wrapped(self, *a, **k):
            calls.append(name)
            return fn(self, *a, **k)
        return wrapped

    try:
        torch.Tensor.item = spy("item", item)
        torch.Tensor.__float__ = spy("float", to_float)
        tcg.cg_pressure_solve(div, 20)
    finally:
        torch.Tensor.item, torch.Tensor.__float__ = item, to_float
    assert calls == []


# ---------------------------------------------------------------------------
# The 2-D step with the CG projection
# ---------------------------------------------------------------------------

N = 126


def _sources(seed, n=N):
    """reference_init's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    side = n + 2
    dens = rng.uniform(0.0, 0.099, (side, side)).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None] & band[None, :])] = 0.0
    u, v = (rng.uniform(0.0, 0.99, (side, side)).astype(np.float32)
            for _ in range(2))
    return dens, u, v


KW = dict(n=N, jacobi_iters=20, pressure_solver="cg", cg_iters=20,
          backend="reference")


@functools.lru_cache(maxsize=None)
def _jax_states(steps=5):
    """JAX's reference step from the zero state, sources on step 1: the
    states after each step as numpy arrays."""
    cfg = fj.SimConfig(**KW)
    step = fj.make_step_fn(cfg)
    src = fj.Sources(*map(jnp.asarray, _sources(0)))
    zeros, state, out = fj.zero_sources(cfg), fj.zero_state(cfg), []
    for k in range(steps):
        state = step(state, src if k == 0 else zeros)
        out.append(tuple(np.asarray(x) for x in state[:3]))
    return out


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_step_matches_jax(backend):
    """After step 1 and step 5, on both backends (``cuda`` on CPU tensors:
    the wrappers' plain forms; CG itself is the same code on both)."""
    cfg = ft.SimConfig(device="cpu", **KW)
    object.__setattr__(cfg, "backend", backend)
    src = ft.Sources(*map(torch.from_numpy, _sources(0)))
    state, zeros = ft.zero_state(cfg), ft.zero_sources(cfg)
    want = _jax_states()
    for k in range(5):
        state = ft.step(cfg, state, src if k == 0 else zeros)
        if k in (0, 4):
            for name, g, w in zip(("dens", "u", "v"), state[:3], want[k]):
                np.testing.assert_allclose(g.numpy(), w, **STEP_TOL,
                                           err_msg=f"{name} step {k + 1}")


def test_step_reduces_divergence_below_jacobi4():
    """tests/test_cg.py:43-55 in the port: at n=30 with 4 Jacobi
    diffusion sweeps, the CG-20 projection leaves less divergence than the
    4-sweep Jacobi one."""
    src = ft.Sources(*map(torch.from_numpy, _sources(1, 30)))
    out = {}
    for solver in ("cg", "jacobi"):
        cfg = ft.SimConfig(n=30, jacobi_iters=4, pressure_solver=solver,
                           cg_iters=20, device="cpu")
        s = ft.step(cfg, ft.zero_state(cfg), src)
        assert all(bool(torch.isfinite(x).all()) for x in s[:3])
        out[solver] = float(divergence(s.u, s.v, 30)[1:-1, 1:-1].abs().max())
    assert out["cg"] < out["jacobi"], out
