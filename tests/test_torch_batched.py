"""Batched datagen (``models/batched.py``) and the batch axis of the 2-D
kernels' wrappers, against the JAX package.

The same numpy arrays, drawn from ``np.random.default_rng(seed)``, go to
both packages.  JAX's Pallas kernels run in interpret mode, set and
restored as tests/test_batched_and_utils.py:113-128 does; its reference
step runs under ``jax.vmap``.  Tolerance: rtol 1e-5 / atol 2e-5, JAX's own
for its batched Pallas step (``test_batched_and_utils.py:155-159``); the
audited displacement at 1e-6 relative.  A batch must equal the same call on
each of its grids bit for bit, on either backend.  The ``cuda`` backend's
wrappers return their plain versions on CPU tensors; ``SimConfig`` refuses
``backend="cuda"`` with a CPU device, so ``_cfg`` sets it afterwards.
"""
import functools
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.core.state import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from fluidsimulationcuda_torch.kernels import checks, cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.models import batched as tb  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.models import batched as jb  # noqa: E402

B, N = 3, 30
SIDE = N + 2
DT = 0.016
TOL = dict(rtol=1e-5, atol=2e-5)
# The configurations of test_batched_and_utils.py:106-161 (n=30, 6 Jacobi
# iterations, a 2-cell window): parity, and the Chebyshev pressure solve
# with Jacobi or Chebyshev diffusion.
CHEBY = dict(pressure_solver="chebyshev", cheby_iters=5, cheby_rho=0.95)
CONFIGS = {
    "parity": dict(),
    "chebyshev-pressure": dict(CHEBY, diffusion_solver="jacobi"),
    "chebyshev": dict(CHEBY, diffusion_solver="chebyshev"),
}
BASE = dict(n=N, jacobi_iters=6, max_courant=2)


@pytest.fixture
def interpret():
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    try:
        yield
    finally:
        pallas_ops.INTERPRET = prev


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


def _fields(seed, *scales, batch=B, side=SIDE):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, (batch, side, side)).astype(np.float32)
            * np.float32(s) for s in scales]


def _sources(seed, batch=B, n=N):
    """reference_init's distributions for ``batch`` grids, drawn with
    numpy."""
    rng = np.random.default_rng(seed)
    side = n + 2
    dens = rng.uniform(0.0, 0.099, (batch, side, side)).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[:, ~(band[:, None] & band[None, :])] = 0.0
    u = rng.uniform(0.0, 0.99, (batch, side, side)).astype(np.float32)
    v = rng.uniform(0.0, 0.99, (batch, side, side)).astype(np.float32)
    return dens, u, v


def _state(seed, batch=B, n=N):
    """A moving state: density in [0, 1], velocities under half a unit (the
    backtrace moves under dt*n/2 cells, inside the 2-cell window)."""
    rng = np.random.default_rng(seed)
    shape = (batch, n + 2, n + 2)
    return (rng.uniform(0.0, 1.0, shape).astype(np.float32),
            rng.uniform(-0.5, 0.5, shape).astype(np.float32),
            rng.uniform(-0.5, 0.5, shape).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _cfg(which="reference", **kw):
    """A CPU config of the ``reference`` or (``which="cuda"``) the ``cuda``
    backend."""
    cfg = ft.SimConfig(device="cpu", backend="reference", **kw)
    if which == "cuda":
        object.__setattr__(cfg, "backend", "cuda")
    return cfg


# ---------------------------------------------------------------------------
# Each wrapper on a batch against JAX's Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

JACOBI_MODES = {
    "jacobi": dict(),
    "src_dt": dict(src_dt=DT),
    "zero_init": dict(zero_init=True),
    "fast": dict(src_dt=DT, fast=True),
    "chebyshev": dict(src_dt=DT, cheby_rho=0.9),
    "chebyshev_fast": dict(src_dt=DT, cheby_rho=0.9, fast=True),
}


@pytest.mark.parametrize("b,mode", [(i % 3, m)
                                    for i, m in enumerate(JACOBI_MODES)])
def test_fused_jacobi_batch_matches_pallas(interpret, b, mode):
    kw = JACOBI_MODES[mode]
    iters = 10 if "cheby_rho" in kw else 20
    x, x0 = _fields(b, 0.5, 1.0)
    want = pallas_ops.fused_jacobi(b, jnp.asarray(x), jnp.asarray(x0), 0.42,
                                   2.68, iters, **kw)
    got = cuda_ops.fused_jacobi(b, _t(x), _t(x0), 0.42, 2.68, iters, **kw)
    _close(got, want)


@pytest.mark.parametrize("cheby_rho,iters", [(None, 20), (0.9, 14)])
def test_fused_project_batch_matches_pallas(interpret, cheby_rho, iters):
    u, v = _fields(11, 1.0, 1.0)
    want = pallas_ops.fused_project(jnp.asarray(u), jnp.asarray(v), N, iters,
                                    cheby_rho=cheby_rho)
    got = cuda_ops.fused_project(_t(u), _t(v), N, iters, cheby_rho=cheby_rho)
    _close(got, want)


def test_divergence_p_batch_matches_pallas(interpret):
    u, v = _fields(12, 1.0, 1.0)
    _close(cuda_ops.divergence_p(_t(u), _t(v), N),
           pallas_ops.divergence_p(jnp.asarray(u), jnp.asarray(v), N))


def test_gradient_p_batch_matches_pallas(interpret):
    u, v, p = _fields(13, 1.0, 1.0, 1.0)
    _close(cuda_ops.gradient_p(_t(u), _t(v), _t(p), N),
           pallas_ops.gradient_p(jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(p), N))


@pytest.mark.parametrize("cmax", [1, 2])
def test_advect_shift_fused_batch_matches_pallas(interpret, cmax):
    """The u/v self-advection pair, the backtrace inside the window."""
    scale = 0.9 * cmax / (DT * N)
    u, v = _fields(20 + cmax, scale, scale)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    want = pallas_ops.advect_shift_fused((1, 2), (ju, jv), ju, jv, DT, N,
                                         cmax=cmax, self_advect=True)
    tu, tv = _t(u), _t(v)
    got = cuda_ops.advect_shift_fused((1, 2), (tu, tv), tu, tv, DT, N, cmax)
    _close(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(cheby_rho=0.9, fast=True)],
                         ids=["jacobi", "chebyshev_fast"])
def test_fused_dens_advect_batch_matches_pallas(interpret, strip_mode, kw):
    # 4 strips of 8 rows; 5 sweeps and a 2-cell window fit JAX's margin.
    iters, cmax = 5, 2
    src, base = _fields(30, 0.5, 1.0)
    u, v = _fields(31, 1.5 / (DT * N), 1.5 / (DT * N))
    a = 0.37
    want = pallas_ops.fused_dens_advect(
        0, jnp.asarray(src), jnp.asarray(base), jnp.asarray(u),
        jnp.asarray(v), a, 1 + 4 * a, iters, DT, N, cmax=cmax, **kw)
    got = cuda_ops.fused_dens_advect(0, _t(src), _t(base), _t(u), _t(v), a,
                                     1 + 4 * a, iters, DT, N, cmax=cmax, **kw)
    _close(got, want)


@pytest.mark.parametrize("batch", [0, B], ids=["one grid", "batch"])
@pytest.mark.parametrize("kw", [dict(src_dt=DT), dict(src_dt=DT, fast=True)],
                         ids=["src_dt", "fast"])
def test_fused_jacobi_pair_matches_pallas_and_two_singles(interpret, batch,
                                                          kw):
    """B12: u and v stacked on the batch axis, each grid with its own
    boundary mode (``nb1``), against JAX's pair and two singles."""
    s1, s2, b1, b2 = _fields(40 + batch, 0.5, 0.5, 1.0, 1.0,
                             batch=max(batch, 1))
    if not batch:
        s1, s2, b1, b2 = s1[0], s2[0], b1[0], b2[0]
    args = (1, 2, s1, s2, b1, b2)
    want = pallas_ops.fused_jacobi_pair(*args[:2], *map(jnp.asarray,
                                                         args[2:]),
                                        0.42, 2.68, 20, **kw)
    got = cuda_ops.fused_jacobi_pair(*args[:2], *map(_t, args[2:]), 0.42,
                                     2.68, 20, **kw)
    _close(got, want)
    singles = (cuda_ops.fused_jacobi(1, _t(s1), _t(b1), 0.42, 2.68, 20, **kw),
               cuda_ops.fused_jacobi(2, _t(s2), _t(b2), 0.42, 2.68, 20, **kw))
    for g, s in zip(got, singles):
        assert torch.equal(g, s)


# ---------------------------------------------------------------------------
# A batch equals the same call on each of its grids, bit for bit
# ---------------------------------------------------------------------------

_PER_GRID = [c.label for c in checks.batched_against_grids(2, 8, "cpu",
                                                         cmax=2)]


@pytest.mark.parametrize("label", _PER_GRID)
def test_batched_op_equals_per_grid(label):
    """Each wrapper call of ``checks.kernel_checks_batched`` (which holds
    the kernels to these plain versions on the card) on a batch of three
    grids against the same call on each grid alone."""
    check = {c.label: c for c in checks.batched_against_grids(B, SIDE, "cpu",
                                                              seed=7,
                                                              cmax=2)}[label]
    got, want = check.run(), check.plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _one(t, g):
    return type(t)(*(None if f is None else f[g] for f in t))


@pytest.mark.parametrize("mode", ["parity", "chebyshev", "windowed"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_batched_step_equals_per_grid(backend, mode):
    kw = dict(CONFIGS["chebyshev"]) if mode == "chebyshev" else {}
    if mode == "windowed":
        kw["advect_mode"] = "windowed"
    cfg = _cfg(backend, **BASE, **kw)
    state = ft.FluidState(*map(_t, _state(50)))
    src = ft.Sources(*map(_t, _sources(51)))
    got, disp = ft.step_audited(cfg, state, src)
    disps = []
    for g in range(B):
        one, d = ft.step_audited(cfg, _one(state, g), _one(src, g))
        disps.append(d)
        for a, b in zip(got[:3], one[:3]):
            assert torch.equal(a[g], b)
    assert torch.equal(disp, torch.stack(disps).max())


# ---------------------------------------------------------------------------
# The batched step against JAX's batched Pallas step and vmapped reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step(config: str, pallas: bool):
    """JAX's step on the fed batch: its Pallas kernels taking the batch
    directly (interpret mode; the gathers windowed), or its reference step
    under ``jax.vmap`` (exact gathers)."""
    cfg = fj.SimConfig(backend="reference", **BASE, **CONFIGS[config])
    state = fj.FluidState(*map(jnp.asarray, _state(60)))
    src = fj.Sources(*map(jnp.asarray, _sources(61)))
    if not pallas:
        out = jax.vmap(functools.partial(fj.step, cfg))(state, src)
        return tuple(np.asarray(x) for x in out[:3])
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    try:
        out = fj.step(cfg.replace(backend="pallas"), state, src)
        return tuple(np.asarray(x) for x in out[:3])
    finally:
        pallas_ops.INTERPRET = prev


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_batched_step_matches_jax_pallas(config, backend):
    want = _jax_step(config, True)
    cfg = _cfg(backend, advect_mode="windowed", **BASE, **CONFIGS[config])
    got = tb.make_batched_step_fn(cfg)(ft.FluidState(*map(_t, _state(60))),
                                       ft.Sources(*map(_t, _sources(61))))
    for name, g, w in zip(("dens", "u", "v"), got[:3], want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_batched_step_matches_jax_vmapped_reference(config, backend):
    want = _jax_step(config, False)
    cfg = _cfg(backend, **BASE, **CONFIGS[config])
    got = tb.make_batched_step_fn(cfg)(ft.FluidState(*map(_t, _state(60))),
                                       ft.Sources(*map(_t, _sources(61))))
    for name, g, w in zip(("dens", "u", "v"), got[:3], want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("solver", ["multigrid", "cg"])
def test_make_batched_step_fn_refuses_unported_solvers(solver):
    """The name is kept from when the batched step refused these solvers
    (their solves coupled or mixed the grids of a batch).  Both now act per
    grid over the last two axes, as JAX's vmapped step runs them, so the
    check is the other way round: the batched step runs them, keeps the
    batch's shape and stays finite."""
    cfg = _cfg(n=14, pressure_solver=solver)
    got = tb.make_batched_step_fn(cfg)(
        ft.FluidState(*map(_t, _state(70, n=14))),
        ft.Sources(*map(_t, _sources(71, n=14))))
    for g in got[:3]:
        assert g.shape == (B, 16, 16) and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())


# The multigrid and CG steps at n=14 (a 40-sweep solve on the one level)
# and n=30 (one matrix transfer to 16², then 40 sweeps).
SOLVERS = {"multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
           "cg": dict(pressure_solver="cg", cg_iters=20)}


@pytest.mark.parametrize("n", [14, 30])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_batched_solver_step_equals_per_grid(dtype, solver, backend, n):
    """Each grid of a batched multigrid or CG step equals its own step bit
    for bit, and the audited displacement is the grids' largest; in bf16
    storage too, where every field stays bf16 (multigrid's float32
    pressure included: the gradient writes u's dtype)."""
    cfg = _cfg(backend, n=n, jacobi_iters=6, dtype=dtype, **SOLVERS[solver])
    state = ft.FluidState(*(_t(a).to(dtype) for a in _state(72, n=n)))
    src = ft.Sources(*(_t(a).to(dtype) for a in _sources(73, n=n)))
    got, disp = ft.step_audited(cfg, state, src)
    assert all(f.dtype == dtype for f in got[:3])
    disps = []
    for g in range(B):
        one, d = ft.step_audited(cfg, _one(state, g), _one(src, g))
        disps.append(d)
        for a, b in zip(got[:3], one[:3]):
            assert torch.equal(a[g], b)
    assert torch.equal(disp, torch.stack(disps).max())


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_solve_matches_jax_vmapped(solver):
    """The solve alone on a batch of three rough right-hand sides against
    JAX's solve under ``jax.vmap``: rtol 1e-5 and atol 1e-5 of max|p| for
    multigrid, atol 1e-5 of max|p| for CG, the tolerances of
    tests/test_torch_multigrid.py and tests/test_torch_cg.py."""
    from fluidsimulationcuda_torch.ops import cg as tcg
    from fluidsimulationcuda_torch.ops import multigrid as tmg
    from fluidsimulationcuda_tpu.ops import cg as jcg
    from fluidsimulationcuda_tpu.ops import multigrid as jmg

    div = _fields(74, 1.0)[0]
    if solver == "multigrid":
        got = tmg.mg_pressure_solve_fast(_t(div), cycles=2)
        want = jax.vmap(functools.partial(jmg.mg_pressure_solve_fast,
                                          cycles=2))(jnp.asarray(div))
        rtol = 1e-5
    else:
        got = tcg.cg_pressure_solve(_t(div), iters=20)
        want = jax.vmap(functools.partial(jcg.cg_pressure_solve,
                                          iters=20))(jnp.asarray(div))
        rtol = 0.0
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_solver_step(solver: str):
    cfg = fj.SimConfig(backend="reference", n=N, jacobi_iters=6,
                       **SOLVERS[solver])
    state = fj.FluidState(*map(jnp.asarray, _state(75)))
    src = fj.Sources(*map(jnp.asarray, _sources(76)))
    out = jb.make_batched_step_fn(cfg)(state, src)
    return tuple(np.asarray(x) for x in out[:3])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_solver_step_matches_jax_vmapped(solver, backend):
    """The batched multigrid or CG step against JAX's
    ``make_batched_step_fn``, which vmaps its reference step over the
    grids: rtol 1e-5 / atol 2e-5, the step tolerance of
    tests/test_torch_multigrid.py and tests/test_torch_cg.py."""
    want = _jax_solver_step(solver)
    cfg = _cfg(backend, n=N, jacobi_iters=6, **SOLVERS[solver])
    got = tb.make_batched_step_fn(cfg)(ft.FluidState(*map(_t, _state(75))),
                                       ft.Sources(*map(_t, _sources(76))))
    for name, g, w in zip(("dens", "u", "v"), got[:3], want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


# ---------------------------------------------------------------------------
# The trajectory runner and the window probe against JAX's
# ---------------------------------------------------------------------------


def _zero_state(batch=B, n=N):
    return tuple(np.zeros((batch, n + 2, n + 2), np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("every,mode", [(0, "auto"), (3, "auto"),
                                        (4, "windowed")])
def test_trajectory_runner_matches_jax(every, mode):
    """6 steps, sources on step 1 only; snapshots every 3 (dividing the
    run) and every 4 (not: one snapshot, at step 4)."""
    kw = dict(BASE, advect_mode=mode)
    srcs = _sources(70)
    jcfg = fj.SimConfig(backend="reference", **kw)
    jfinal, jsnaps, jdmax = jb._trajectory_runner(jcfg, 6, every)(
        fj.FluidState(*map(jnp.asarray, _zero_state())),
        fj.Sources(*map(jnp.asarray, srcs)))
    final, snaps, dmax = tb._trajectory_runner(_cfg(**kw), 6, every)(
        ft.FluidState(*map(_t, _zero_state())), ft.Sources(*map(_t, srcs)))
    _close(tuple(final[:3]), tuple(jfinal[:3]))
    if every:
        assert tuple(snaps.shape) == (6 // every, B, SIDE, SIDE)
        _close(snaps, jsnaps)
    else:
        assert snaps is None and jsnaps is None
    assert dmax.dim() == 0 and float(dmax) > 0
    np.testing.assert_allclose(float(dmax), float(jdmax), rtol=1e-6)


def _jax_probe(jcfg, state, src, steps=8, margin=0.25):
    """JAX's probe, ``batched.py:86-96``, on fed arrays."""
    exact = jcfg.replace(backend="reference", advect_mode="exact")
    audited = jax.jit(jax.vmap(functools.partial(fj.step_audited, exact)))
    zeros = jax.tree.map(jnp.zeros_like, src)
    dmax = 0.0
    for k in range(steps):
        state, d = audited(state, src if k == 0 else zeros)
        dmax = max(dmax, float(jnp.max(d)))
    return max(1, int(math.floor(dmax + margin)) + 1), dmax


@pytest.mark.parametrize("dt", [0.016, 0.25])
def test_probe_matches_jax(dt):
    """At the default dt the backtrace stays under a cell (cmax 1); at
    dt=0.25 it moves several."""
    kw = dict(BASE, dt=dt)
    srcs = _sources(80)
    want_cmax, want_d = _jax_probe(
        fj.SimConfig(backend="reference", **kw),
        fj.FluidState(*map(jnp.asarray, _zero_state())),
        fj.Sources(*map(jnp.asarray, srcs)))
    cmax, d = tb._probe_cmax(_cfg(**kw),
                             ft.FluidState(*map(_t, _zero_state())),
                             ft.Sources(*map(_t, srcs)))
    assert cmax == want_cmax and (cmax > 1) == (dt > 0.1)
    np.testing.assert_allclose(d, want_d, rtol=1e-6)


def test_select_cmax_batched_probes_a_drawn_batch():
    cfg = _cfg(n=14, jacobi_iters=4)
    got = ft.select_cmax_batched(torch.Generator().manual_seed(3), cfg, 2,
                                 probe_steps=3)
    state, src = ft.batched_init(torch.Generator().manual_seed(3), cfg, 2)
    assert got == tb._probe_cmax(cfg, state, src, probe_steps=3)


def test_auto_cmax_grows_the_window_and_warns():
    """A probe over the configured window grows it, with a warning, and
    the run equals a run at the grown window."""
    cfg = _cfg(n=14, jacobi_iters=4, dt=0.5, max_courant=1,
               advect_mode="windowed")
    state, src = ft.batched_init(torch.Generator().manual_seed(4), cfg, 2)
    cmax, probed = tb._probe_cmax(cfg, state, src)
    assert cmax > 1
    with pytest.warns(UserWarning, match="growing the gather window"):
        got = ft.generate_trajectories(torch.Generator().manual_seed(4), cfg,
                                       2, 3, auto_cmax=True)
    want = tb._trajectory_runner(cfg.replace(max_courant=cmax), 3, 0)(state,
                                                                       src)
    for a, b in zip(got[0][:3], want[0][:3]):
        assert torch.equal(a, b)
    assert float(got[2]) == float(want[2]) and float(got[2]) <= cmax


def test_auto_cmax_within_the_window_is_silent():
    cfg = _cfg(n=14, jacobi_iters=4, advect_mode="windowed")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        final, snaps, dmax = ft.generate_trajectories(
            torch.Generator().manual_seed(5), cfg, 2, 6, snapshot_every=3,
            auto_cmax=True)
    assert tuple(snaps.shape) == (2, 2, 16, 16)
    assert torch.equal(snaps[-1], final.dens)
    assert 0.0 < float(dmax) < 1.0


# ---------------------------------------------------------------------------
# Drawing a batch, state round trips, sources, shape errors
# ---------------------------------------------------------------------------


def test_batched_init_stacks_reference_init_draws():
    cfg = _cfg(n=14)
    state, src = ft.batched_init(torch.Generator().manual_seed(6), cfg, 3)
    gen = torch.Generator().manual_seed(6)
    draws = [ft.reference_init(gen, cfg) for _ in range(3)]
    for name in ("dens", "u", "v"):
        assert tuple(getattr(src, name).shape) == (3, 16, 16)
        for g, (s0, s1) in enumerate(draws):
            assert torch.equal(getattr(src, name)[g], getattr(s1, name))
            assert torch.equal(getattr(state, name)[g], getattr(s0, name))
    assert not torch.equal(src.u[0], src.u[1])  # independent draws
    assert state.w is None and src.w is None


def test_state_numpy_round_trip_keeps_the_batch():
    arrays = dict(zip(("dens", "u", "v"), _state(90)))
    state = state_from_numpy(arrays, device="cpu")
    assert all(tuple(t.shape) == (B, SIDE, SIDE) for t in state[:3])
    back = state_to_numpy(state)
    for name, a in arrays.items():
        np.testing.assert_array_equal(getattr(back, name), a)
    assert back.w is None


def test_simulate_and_model_step_fill_batched_zero_sources():
    """Sources after step 1 are zeros shaped like the batch."""
    cfg = _cfg(**BASE)
    state = ft.FluidState(*map(_t, _state(91)))
    src = ft.Sources(*map(_t, _sources(92)))
    got = ft.simulate(cfg, state, src, 3)
    sim = ft.StableFluids2D(cfg)
    want = sim.step(state, src)
    for _ in range(2):
        want = sim.step(want)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    alone = ft.simulate(cfg, _one(state, 1), _one(src, 1), 3)
    for a, b in zip(got[:3], alone[:3]):
        assert torch.equal(a[1], b)


@pytest.mark.parametrize("bad", ["4-D", "mixed batch", "batch and grid",
                                 "grid and batch", "cells", "grids",
                                 "empty"])
def test_wrappers_reject_bad_batches(bad):
    """A wrapper takes (side, side) grids or (nb, side, side) batches of
    one shape, 1 <= nb <= 65535, under 2**31 cells in all."""
    a, b = {
        "4-D": (torch.zeros(1, 3, 34, 34),) * 2,
        "mixed batch": (torch.zeros(3, 34, 34), torch.zeros(2, 34, 34)),
        "batch and grid": (torch.zeros(3, 34, 34), torch.zeros(34, 34)),
        "grid and batch": (torch.zeros(34, 34), torch.zeros(3, 34, 34)),
        # Shapes only: meta tensors hold no memory, and the size checks
        # come before the device check.
        "cells": (torch.empty(32300, 258, 258, device="meta"),) * 2,
        "grids": (torch.empty(65536, 34, 34, device="meta"),) * 2,
        "empty": (torch.zeros(0, 34, 34),) * 2,
    }[bad]
    n = b.shape[-1] - 2
    with pytest.raises(ValueError):
        cuda_ops.fused_jacobi(0, a, b, 0.4, 2.6, 1)
    with pytest.raises(ValueError):
        cuda_ops.divergence_p(a, b, n)
    with pytest.raises(ValueError):
        cuda_ops.fused_jacobi_pair(1, 2, a, a, b, b, 0.4, 2.6, 1)
