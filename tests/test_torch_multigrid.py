"""The port's multigrid pressure solver (``ops/multigrid.py``), its damped
smoother (K1's ``damp`` on the card, ``fused_jacobi_plain(damp=...)`` here)
and the 2-D step with ``pressure_solver="multigrid"``, against the JAX
package's.

Inputs come from numpy (a seed) and go to both packages; JAX runs its jnp
multigrid (``pallas_smoother=False``) and, for the smoother, its Pallas
``fused_jacobi`` with ``damp`` in interpret mode, as
tests/test_multigrid_fast.py:92-108 runs it.  Tolerances: the transfer
matrices are the same NumPy code (equal array for array); a transfer, a
smoothing and a solve differ only by the summation order of the matrix
products (rtol 1e-6 for one transfer, rtol = atol = 1e-5 for a solve, the
atol relative to max|p|); the
step is held to the repo's gate, rtol 1e-5 / atol 2e-5
(tests/test_pallas_ops.py:174).
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
from fluidsimulationcuda_torch.ops import multigrid as tmg  # noqa: E402
from fluidsimulationcuda_torch.ops.diffuse import diffuse  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.ops import multigrid as jmg  # noqa: E402
from fluidsimulationcuda_tpu.ops.boundary import (  # noqa: E402
    embed_interior as j_embed_interior)

STEP_TOL = dict(rtol=1e-5, atol=2e-5)


def _div(n, seed):
    """A rough rhs with the copy border: standard normal interior."""
    rng = np.random.default_rng(seed)
    return np.asarray(j_embed_interior(0, jnp.asarray(
        rng.standard_normal((n, n)).astype(np.float32))))


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Transfers
# ---------------------------------------------------------------------------

# (nf, nc): the 2048² fine level, the 128² fine level, and a graded pair
# (n=128: padded side 130 halves to 65, rounded down to 64).
PAIRS = [(2046, 1022), (126, 62), (128, 62)]


@pytest.mark.parametrize("nf,nc", PAIRS)
def test_transfer_1d_equals_jax(nf, nc):
    for got, want in zip(tmg._transfer_1d(nf, nc), jmg._transfer_1d(nf, nc)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nf,nc", PAIRS[1:])
def test_restrict_and_prolong_mat_match_jax(nf, nc):
    r_j, r_t = _both(_div(nf, nf))
    np.testing.assert_allclose(tmg._restrict_mat(r_t, nc).numpy(),
                               np.asarray(jmg._restrict_mat(r_j, nc)),
                               rtol=1e-6, atol=1e-6)
    e_j, e_t = _both(_div(nc, nc))
    np.testing.assert_allclose(tmg._prolong_mat(e_t, nf).numpy(),
                               np.asarray(jmg._prolong_mat(e_j, nf)),
                               rtol=1e-6, atol=1e-6)


def test_coarse_sides_match_jax():
    for side in (16, 18, 32, 130, 132, 258, 2048, 8192):
        assert tmg._coarse_side(side) == jmg._coarse_side(side)
    for n in (6, 14, 30, 64, 126, 130, 2046):
        assert tmg.mg_levels(n) == jmg.mg_levels(n)


def _prolong_reference(ec: np.ndarray) -> np.ndarray:
    """Literal 9/3/3/1 cell-centred prolongation in scalar loops, the copy
    border derived after (tests/test_multigrid_fast.py:18-40)."""
    nc = ec.shape[0] - 2
    nf = 2 * nc
    out = np.zeros((nf + 2, nf + 2), np.float32)
    for i in range(nf):
        for j in range(nf):
            a, b = i // 2 + 1, j // 2 + 1
            vi = a - 1 if i % 2 == 0 else a + 1
            vj = b - 1 if j % 2 == 0 else b + 1
            out[i + 1, j + 1] = (9 * ec[a, b] + 3 * ec[vi, b]
                                 + 3 * ec[a, vj] + ec[vi, vj]) / 16.0
    out[0, 1:-1], out[-1, 1:-1] = out[1, 1:-1], out[-2, 1:-1]
    out[1:-1, 0], out[1:-1, -1] = out[1:-1, 1], out[1:-1, -2]
    out[0, 0] = 0.5 * (out[0, 1] + out[1, 0])
    out[0, -1] = 0.5 * (out[0, -2] + out[1, -1])
    out[-1, 0] = 0.5 * (out[-1, 1] + out[-2, 0])
    out[-1, -1] = 0.5 * (out[-1, -2] + out[-2, -1])
    return out


def test_prolong_matches_scalar_reference_and_jax():
    ec = _div(8, 0)
    got = tmg._prolong(torch.from_numpy(ec.copy())).numpy()
    np.testing.assert_allclose(got, _prolong_reference(ec), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jmg._prolong(jnp.asarray(ec))),
                               rtol=1e-6, atol=1e-6)


def test_restrict_and_residual_match_jax():
    div_j, div_t = _both(_div(30, 1))
    p_j, p_t = _both(_div(30, 2))
    np.testing.assert_allclose(tmg._restrict(div_t).numpy(),
                               np.asarray(jmg._restrict(div_j)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tmg.residual(p_t, div_t).numpy(),
                                  np.asarray(jmg.residual(p_j, div_j)))


# ---------------------------------------------------------------------------
# The damped smoother (B1's damp; K1's plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zero_init", [False, True])
def test_smoother_matches_jax(zero_init, monkeypatch):
    """``_smooth`` and ``fused_jacobi_plain(damp=0.8)`` (what K1's damped
    mode computes; equal to the bit) against JAX's ``_smooth`` and JAX's
    ``fused_jacobi(..., damp=0.8)`` in interpret mode, at n=126 as
    tests/test_multigrid_fast.py:92-108 runs it.  Against JAX at 1e-6:
    XLA's CPU compiler may contract the damped combine into fused
    multiply-adds, an ulp a sweep away from the unfused expression."""
    monkeypatch.setattr(pallas_ops, "INTERPRET", True)
    p_j, p_t = _both(_div(126, 3))
    d_j, d_t = _both(_div(126, 4))
    sweeps = 4
    plain = tmg._smooth(p_t, d_t, sweeps, zero_init)
    wrapper = cuda_ops.fused_jacobi(0, p_t, d_t, 1.0, 4.0, sweeps,
                                    zero_init=zero_init, damp=tmg.OMEGA)
    np.testing.assert_array_equal(wrapper.numpy(), plain.numpy())
    j_init = jnp.zeros_like(d_j) if zero_init else p_j
    jnp_smooth = np.asarray(jmg._smooth(j_init, d_j, sweeps))
    kernel = pallas_ops.fused_jacobi(0, p_j, d_j, 1.0, 4.0, sweeps,
                                     zero_init=zero_init, damp=jmg._OMEGA)
    print(f"damped smoother, {sweeps} sweeps, n=126: max|d| against JAX's "
          f"jnp _smooth {np.abs(plain.numpy() - jnp_smooth).max():.3e}, "
          f"against its kernel "
          f"{np.abs(plain.numpy() - np.asarray(kernel)).max():.3e}")
    np.testing.assert_allclose(plain.numpy(), jnp_smooth, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(plain.numpy(), np.asarray(kernel), rtol=1e-6,
                               atol=1e-6)


def test_damped_sweeps_take_jax_one_minus_omega():
    """1-w rounds once from float64 (0x3E4CCCCD), as JAX takes it; the
    device's 1.0f - 0.8f is one ulp below."""
    from fluidsimulationcuda_torch.ops.diffuse import as_scalar

    omw = as_scalar(1.0 - tmg.OMEGA, torch.zeros(()))
    assert omw.numpy().view(np.uint32) == 0x3E4CCCCD
    assert (np.float32(1.0) - np.float32(0.8)).view(np.uint32) == 0x3E4CCCCC


@pytest.mark.parametrize("kw", [dict(cheby_rho=0.9), dict(src_dt=0.1),
                                dict(fast=True)],
                         ids=["cheby_rho", "src_dt", "fast"])
@pytest.mark.parametrize("fn", [cuda_ops.fused_jacobi,
                                cuda_ops.fused_jacobi_plain],
                         ids=["wrapper", "plain"])
def test_damp_is_the_smoothers_alone(fn, kw):
    """``damp`` takes no Chebyshev weights (JAX asserts so), no source fold
    and no reciprocal form: the multigrid smoother uses none of them."""
    x = torch.zeros(18, 18)
    with pytest.raises(ValueError, match="damp takes no"):
        fn(0, x, x, 1.0, 4.0, 2, damp=0.8, **kw)


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def _projection_rhs(n, seed):
    """What the projection hands the solver: the divergence (copy border)
    of random velocities in [-1, 1]."""
    from fluidsimulationcuda_tpu.ops.project import divergence

    rng = np.random.default_rng(seed)
    u, v = (jnp.asarray(rng.uniform(-1, 1, (n + 2, n + 2)).astype(np.float32))
            for _ in range(2))
    return np.asarray(divergence(u, v, n))


def _assert_solve_close(got, want):
    """rtol = atol = 1e-5, the atol taken relative to max|p|: a rough rhs
    (standard normal) drives p to ~47, where an ulp is 3.8e-6 and the
    products' summation order moves p by a few tens of ulps (printed)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    print(f"max|d| {np.abs(got.numpy() - want).max():.3e}, max|p| "
          f"{np.abs(want).max():.4g}")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("rhs", ["projection", "rough"])
@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("n", [126, 130])
def test_fast_solve_matches_jax(n, cycles, rhs):
    make = _projection_rhs if rhs == "projection" else _div
    div_j, div_t = _both(make(n, 5))
    want = jmg.mg_pressure_solve_fast(div_j, cycles=cycles,
                                      pallas_smoother=False)
    _assert_solve_close(tmg.mg_pressure_solve_fast(div_t, cycles=cycles),
                        want)


@pytest.mark.parametrize("rhs", ["projection", "rough"])
def test_plain_solve_and_v_cycle_match_jax(rhs):
    make = _projection_rhs if rhs == "projection" else _div
    div_j, div_t = _both(make(128, 6))
    _assert_solve_close(tmg.mg_pressure_solve(div_t, cycles=2),
                        jmg.mg_pressure_solve(div_j, 2))
    p_j, p_t = _both(make(128, 7))
    _assert_solve_close(tmg.v_cycle(p_t, div_t, 2),
                        jmg.v_cycle(p_j, div_j, 2))


def _max_residual(p, div):
    return float(tmg.residual(p, div)[1:-1, 1:-1].abs().max())


@pytest.mark.parametrize("n", [126, 130])
def test_fast_cycle_beats_jacobi20_residual(n):
    """The perf-mode bar (tests/test_multigrid_fast.py:56-73): two fast
    cycles leave a residual no larger than 20 Jacobi sweeps on a rough
    rhs."""
    div = torch.from_numpy(_div(n, 3).copy())
    p20 = diffuse(0, torch.zeros_like(div), div, 1.0, 4.0, 20)
    pmg = tmg.mg_pressure_solve_fast(div, cycles=2)
    assert _max_residual(pmg, div) <= _max_residual(p20, div)


def test_fast_residual_tracks_plain():
    """tests/test_multigrid_fast.py:76-89: one fast cycle contracts the
    residual within 2x of one plain cycle."""
    div = torch.from_numpy(_div(128, 5).copy())
    ra = _max_residual(tmg.mg_pressure_solve(div, cycles=1), div)
    rb = _max_residual(tmg.mg_pressure_solve_fast(div, cycles=1), div)
    assert rb <= 2.0 * ra, (rb, ra)


def test_solve_reuses_its_transfer_matrices():
    div = torch.from_numpy(_div(62, 8).copy())
    tmg.mg_pressure_solve_fast(div, cycles=1)
    before = tmg._transfer_mats.cache_info()
    tmg.mg_pressure_solve_fast(div, cycles=2)
    after = tmg._transfer_mats.cache_info()
    assert after.misses == before.misses
    assert after.hits > before.hits


def test_smoother_is_the_opsets():
    """The OpSet carries the smoother: plain on ``reference``, the K1
    wrapper (damped) on ``cuda``, which on CPU tensors returns the plain
    form."""
    from fluidsimulationcuda_torch.kernels.dispatch import get_ops

    ref = ft.SimConfig(n=30, device="cpu", backend="reference")
    assert get_ops(ref).smooth is tmg._smooth
    cuda = ft.SimConfig(n=30, device="cpu", backend="reference")
    object.__setattr__(cuda, "backend", "cuda")
    p, d = (torch.from_numpy(_div(30, s).copy()) for s in (9, 10))
    got = get_ops(cuda).smooth(p, d, 3)
    np.testing.assert_array_equal(got.numpy(), tmg._smooth(p, d, 3).numpy())


# ---------------------------------------------------------------------------
# The 2-D step with the multigrid projection
# ---------------------------------------------------------------------------

N = 126
# The two settings of the JAX package: the config default (two cycles,
# Jacobi-20 diffusion) and the bench's line (bench.py:140-143: one cycle,
# fast math, which the reference backends ignore).
STEP_CONFIGS = {"mg_cycles=2": dict(mg_cycles=2),
                "mg_cycles=1 fast_math": dict(mg_cycles=1, fast_math=True)}


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


def _kw(config):
    return dict(n=N, jacobi_iters=20, pressure_solver="multigrid",
                backend="reference", **STEP_CONFIGS[config])


@functools.lru_cache(maxsize=None)
def _jax_states(config, steps=5):
    """JAX's reference step from the zero state, sources on step 1: the
    states after each step as numpy arrays."""
    cfg = fj.SimConfig(**_kw(config))
    step = fj.make_step_fn(cfg)
    src = fj.Sources(*map(jnp.asarray, _sources(0)))
    zeros, state, out = fj.zero_sources(cfg), fj.zero_state(cfg), []
    for k in range(steps):
        state = step(state, src if k == 0 else zeros)
        out.append(tuple(np.asarray(x) for x in state[:3]))
    return out


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("config", list(STEP_CONFIGS))
def test_step_matches_jax(config, backend):
    """After step 1 and step 5, on both backends (``cuda`` on CPU tensors:
    the wrappers' plain forms)."""
    cfg = ft.SimConfig(device="cpu", **_kw(config))
    object.__setattr__(cfg, "backend", backend)
    src = ft.Sources(*map(torch.from_numpy, _sources(0)))
    state, zeros = ft.zero_state(cfg), ft.zero_sources(cfg)
    want = _jax_states(config)
    for k in range(5):
        state = ft.step(cfg, state, src if k == 0 else zeros)
        if k in (0, 4):
            for name, g, w in zip(("dens", "u", "v"), state[:3], want[k]):
                np.testing.assert_allclose(g.numpy(), w, **STEP_TOL,
                                           err_msg=f"{name} step {k + 1}")


def test_step_reduces_divergence_below_jacobi20():
    """The multigrid projection leaves less divergence than the Jacobi-20
    one on the same step (the reason to run it)."""
    from fluidsimulationcuda_torch.ops.project import divergence

    src = ft.Sources(*map(torch.from_numpy, _sources(1)))
    out = {}
    for solver in ("multigrid", "jacobi"):
        cfg = ft.SimConfig(n=N, jacobi_iters=20, pressure_solver=solver,
                           device="cpu")
        s = ft.step(cfg, ft.zero_state(cfg), src)
        out[solver] = float(divergence(s.u, s.v, N)[1:-1, 1:-1].abs().max())
    assert out["multigrid"] < out["jacobi"], out
