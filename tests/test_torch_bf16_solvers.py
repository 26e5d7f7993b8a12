"""bf16 storage with the multigrid and CG pressure solves (JAX's
``SimConfig(dtype=jnp.bfloat16, pressure_solver="multigrid"|"cg")``), on
one grid and on a batch, against the JAX package.

JAX's dtype flow, which the port follows:

- Multigrid takes a bf16 divergence to a float32 pressure: its matrix
  transfers promote the bf16 residual to float32, so the coarse levels, the
  corrected iterate and every fine smooth after the first are float32; the
  first pre-smooth of the first cycle runs in bf16 from a bf16 zero, with
  w and 1-w in bf16.  Below 16² the solve is one level and stays bf16.
- CG stays bf16, its dot products summed in float32 (XLA fuses
  ``jnp.sum(r * r)`` without rounding the products).
- The gradient writes u's dtype.  JAX's Pallas ``gradient_p`` does; its
  jnp version returns float32 u, v, which this file pins as a recorded
  difference (ROADMAP §C).

The ``cuda`` backend's multigrid smooths on K1-damp's bf16-rhs forms,
whose first pre-smooth keeps its iterate in float32 and rounds once, at
the store (ROADMAP §C: up to 0.23% of max|p| from JAX's per-operation
rounding from n = 30 on, 2.1% at n = 14, pinned below).  On CPU tensors each wrapper runs its plain twin.
The same numpy arrays, drawn from ``np.random.default_rng(seed)``, go to
both packages; each rounds them to bf16.
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
from fluidsimulationcuda_torch.core.state import (  # noqa: E402
    zero_sources_like)
from fluidsimulationcuda_torch.kernels import cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.models import batched as tb  # noqa: E402
from fluidsimulationcuda_torch.ops import cg as tcg  # noqa: E402
from fluidsimulationcuda_torch.ops import multigrid as tmg  # noqa: E402
from fluidsimulationcuda_torch.ops.project import divergence  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.models import batched as jb  # noqa: E402
from fluidsimulationcuda_tpu.ops import cg as jcg  # noqa: E402
from fluidsimulationcuda_tpu.ops import multigrid as jmg  # noqa: E402

BF16 = torch.bfloat16
SOLVERS = {"multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
           "cg": dict(pressure_solver="cg", cg_iters=20)}


def _t(a, dtype=BF16):
    return torch.from_numpy(np.array(a)).to(dtype)


def _j(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _ulp(x: np.ndarray) -> float:
    """One bf16 rounding unit at the magnitude of ``x``'s largest value."""
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _div(n, seed):
    """A bf16 divergence of random bf16 velocities in [-1, 1], as the
    projection hands it to the solver (the port's bf16 divergence, equal
    to JAX's bit for bit: tests/test_torch_bf16.py)."""
    rng = np.random.default_rng(seed)
    u, v = (rng.uniform(-1, 1, (n + 2, n + 2)).astype(np.float32)
            for _ in range(2))
    return divergence(_t(u), _t(v), n)


def _sources(seed, n, batch=()):
    """reference_init's source distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    side = n + 2
    shape = batch + (side, side)
    dens = rng.uniform(0.0, 0.099, shape).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[..., ~(band[:, None] & band[None, :])] = 0.0
    u = rng.uniform(0.0, 0.99, shape).astype(np.float32)
    v = rng.uniform(0.0, 0.99, shape).astype(np.float32)
    return dens, u, v


def _cfg(backend, n, dtype=BF16, **kw):
    cfg = ft.SimConfig(n=n, jacobi_iters=8, backend="reference", dtype=dtype,
                       device="cpu", **kw)
    object.__setattr__(cfg, "backend", backend)
    return cfg


def _run(cfg, src_np, steps, batch=False):
    """The port's states after each of ``steps`` steps from the zero state,
    sources on step 1."""
    src = ft.Sources(*(_t(a, cfg.dtype) for a in src_np))
    state = ft.FluidState(*zero_sources_like(src))
    step = tb.make_batched_step_fn(cfg) if batch else ft.make_step_fn(cfg)
    out = []
    for k in range(steps):
        state = step(state, src if k == 0 else zero_sources_like(src))
        out.append(state)
    return out


# ---------------------------------------------------------------------------
# The solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [14, 30, 62])
def test_mg_solve_bf16_matches_jax(n):
    """The port's solve with the ``reference`` smoother against JAX's
    ``mg_pressure_solve_fast(pallas_smoother=False)``: a float32 pressure
    from n = 30 on (bf16 at n = 14, one level), bit for bit at n = 14 and
    within 1e-5 of max|p| above (measured: at most 8.6e-8, from the
    float32 matrix products' summation order, as in float32:
    tests/test_torch_multigrid.py)."""
    for seed in (0, 1):
        d = _div(n, seed)
        got = tmg.mg_pressure_solve_fast(d, cycles=2)
        want = jmg.mg_pressure_solve_fast(_j(_np(d)), cycles=2,
                                          pallas_smoother=False)
        dtype = BF16 if n < 16 else torch.float32
        assert got.dtype == dtype
        assert want.dtype == (jnp.bfloat16 if n < 16 else jnp.float32)
        want = _np(want)
        print(f"n={n} seed {seed}: max|d| {np.abs(_np(got) - want).max():.3e}"
              f" on max|p| {np.abs(want).max():.4g}")
        if n < 16:
            np.testing.assert_array_equal(_np(got), want)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [14, 30, 62])
def test_mg_solve_bf16_cuda_smoother_single_rounding(n):
    """A recorded difference (ROADMAP §C): K1-damp's bf16 form keeps the
    first pre-smooth's iterate in float32 and rounds it once, where JAX's
    jnp ``_smooth`` rounds each operation to bf16.  The first smooth
    differs by at most 2 bf16 units of its magnitude (measured: 1), and the
    two solves are not equal.  From n = 30 the solve differs by under 1%
    of max|p| (measured: at most 0.23%).  At n = 14 the whole solve is
    bf16 sweeps on one level (80 of them): under 5% (measured: at most
    2.1%), and the port's single rounding lands nearer the float32 solve
    of the same rhs than JAX's rounding of every operation (measured: 1.6-
    2.3% of max|p| against 2.3-4.1%)."""
    d = _div(n, 2)
    first = cuda_ops.mg_smooth(torch.zeros_like(d), d, 2, zero_init=True)
    jfirst = _np(jmg._smooth(jnp.zeros_like(_j(_np(d))), _j(_np(d)), 2))
    assert first.dtype == BF16
    gap = np.abs(_np(first) - jfirst).max()
    assert 0 < gap <= 2 * _ulp(jfirst)
    got = tmg.mg_pressure_solve_fast(d, cycles=2, smooth=cuda_ops.mg_smooth)
    want = _np(jmg.mg_pressure_solve_fast(_j(_np(d)), cycles=2,
                                          pallas_smoother=False))
    rel = np.abs(_np(got) - want).max() / np.abs(want).max()
    print(f"n={n}: first smooth max|d| {gap:.3e} ({gap / _ulp(jfirst):.1f} "
          f"bf16 units), solve max|d| {rel:.3e} of max|p|")
    assert 0 < rel < (5e-2 if n < 16 else 1e-2)
    if n < 16:
        f32 = tmg.mg_pressure_solve_fast(d.float(), cycles=2).numpy()
        assert np.abs(_np(got) - f32).max() < np.abs(want - f32).max()


@pytest.mark.parametrize("iters", [5, 20])
@pytest.mark.parametrize("n", [30, 62, 126])
def test_cg_solve_bf16_matches_jax_bit_for_bit(n, iters):
    """bf16 CG stays bf16 and equals JAX's bit for bit once its dot products
    sum unrounded float32 products (``ops.cg._dot``): with the products
    rounded to bf16 first, one ``rs`` at n = 30 moved a bf16 unit."""
    for seed in range(4):
        d = _div(n, seed)
        got = tcg.cg_pressure_solve(d, iters=iters)
        want = jcg.cg_pressure_solve(_j(_np(d)), iters=iters)
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))


def test_cg_dot_sums_unrounded_products():
    """The op behind the n = 30 gap: ``jnp.sum(r * r)`` under ``jit`` (as
    JAX's CG runs it) keeps the products in float32; eagerly it rounds them
    first.  ``_dot`` matches the first."""
    d = _div(30, 3)
    r = d[1:-1, 1:-1]
    for seed in range(40):
        g = torch.Generator().manual_seed(seed)
        r = (d[1:-1, 1:-1].float()
             * (1 + torch.rand(r.shape, generator=g))).to(BF16)
        want = jax.jit(lambda a: jnp.sum(a * a))(_j(_np(r)))
        assert float(tcg._dot(r, r)) == float(want)


# ---------------------------------------------------------------------------
# The steps against JAX's
# ---------------------------------------------------------------------------

SIDE = 64


@functools.lru_cache(maxsize=None)
def _jax_pallas_states(solver, steps=3):
    """JAX's Pallas bf16 step in interpret mode at side 64."""
    cfg = fj.SimConfig(n=SIDE - 2, jacobi_iters=8, backend="pallas",
                       dtype=jnp.bfloat16, max_courant=2, **SOLVERS[solver])
    src = fj.Sources(*map(_j, _sources(40, SIDE - 2)))
    zeros = fj.Sources(*(jnp.zeros_like(a) for a in src[:3]))
    state = fj.FluidState(*(jnp.zeros_like(a) for a in src[:3]))
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    out = []
    try:
        for k in range(steps):
            state = fj.step(cfg, state, src if k == 0 else zeros)
            assert all(f.dtype == jnp.bfloat16 for f in state[:3])
            out.append(tuple(_np(x) for x in state[:3]))
    finally:
        pallas_ops.INTERPRET = prev
    return out


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_cuda_step_bf16_matches_jax_pallas(solver):
    """The ``cuda`` backend's bf16 step (its plain twins on the CPU: K2's
    bf16 divergence and gradient, K1-damp's bf16-rhs forms) against JAX's
    Pallas bf16 step in interpret mode, both windowed at 2 cells, after
    steps 1 and 3 at n = 62.  Every field stays bf16.  CG: one bf16 unit
    of each field's magnitude (measured: 0 after step 1, 1 unit in the
    density after step 3).  Multigrid: 4 units (measured: at most 2), the
    first pre-smooth's single rounding (above) carried through the
    step."""
    cfg = _cfg("cuda", SIDE - 2, max_courant=2, advect_mode="windowed",
               **SOLVERS[solver])
    got = _run(cfg, _sources(40, SIDE - 2), 3)
    for k in (0, 2):
        for name, g, w in zip(("dens", "u", "v"), got[k][:3],
                              _jax_pallas_states(solver)[k]):
            assert g.dtype == BF16
            gap = np.abs(_np(g) - w).max()
            print(f"{solver} step {k + 1} {name}: max|d| {gap:.3e} on "
                  f"max {np.abs(w).max():.4g} ({gap / _ulp(w):.2f} units)")
            atol = _ulp(w) * (1 if solver == "cg" else 4)
            np.testing.assert_allclose(_np(g), w, rtol=0, atol=atol,
                                       err_msg=f"{name} step {k + 1}")


N = 30


@functools.lru_cache(maxsize=None)
def _jax_reference_step(solver, batch=(), n=N):
    """JAX's bf16 ``reference`` step (vmapped over a batch) from the zero
    state with sources, once: its u, v and dens, and their dtypes."""
    cfg = fj.SimConfig(n=n, jacobi_iters=8, backend="reference",
                       dtype=jnp.bfloat16, **SOLVERS[solver])
    src = fj.Sources(*map(_j, _sources(41, n, batch)))
    state = fj.FluidState(*(jnp.zeros_like(a) for a in src[:3]))
    step = jb.make_batched_step_fn(cfg) if batch else fj.make_step_fn(cfg)
    out = step(state, src)
    return tuple(_np(x) for x in out[:3]), tuple(x.dtype for x in out[:3])


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_reference_step_bf16_matches_jax(solver):
    """The port's ``reference`` bf16 step against JAX's after step 1.  CG
    keeps bf16 in both: bit for bit.  Multigrid: JAX's jnp gradient
    returns float32 u, v (the leak pinned below), which its density step
    then advects with; the port writes them in bf16.  So JAX's u and v
    rounded to bf16 are held to the port's within one bf16 unit of each
    field's magnitude (measured: 1 in u and v, 0.01 in the density)."""
    cfg = _cfg("reference", N, **SOLVERS[solver])
    got = _run(cfg, _sources(41, N), 1)[0]
    want, dtypes = _jax_reference_step(solver)
    for name, g, w in zip(("dens", "u", "v"), got[:3], want):
        assert g.dtype == BF16
        w16 = _np(_t(w))  # JAX's field rounded to bf16
        gap = np.abs(_np(g) - w16).max()
        print(f"{solver} {name}: max|d| {gap:.3e} on max "
              f"{np.abs(w16).max():.4g} ({gap / _ulp(w16):.2f} units)")
        if solver == "cg":
            np.testing.assert_array_equal(_np(g), w)
        else:
            np.testing.assert_allclose(_np(g), w16, rtol=0, atol=_ulp(w16),
                                       err_msg=name)


def test_jax_reference_leaks_float32_and_its_simulate_raises():
    """A recorded difference (ROADMAP §C): JAX's ``reference`` bf16
    multigrid step returns float32 u and v (its jnp gradient promotes them
    against the float32 pressure), so its ``simulate`` cannot carry the
    state through ``lax.scan``; the port's gradient writes u's dtype and its
    ``simulate`` keeps bf16 on both backends."""
    _, dtypes = _jax_reference_step("multigrid")
    assert dtypes == (jnp.bfloat16, jnp.float32, jnp.float32)
    jcfg = fj.SimConfig(n=N, jacobi_iters=8, backend="reference",
                        dtype=jnp.bfloat16, **SOLVERS["multigrid"])
    src = fj.Sources(*map(_j, _sources(41, N)))
    state = fj.FluidState(*(jnp.zeros_like(a) for a in src[:3]))
    with pytest.raises(TypeError, match="carry"):
        fj.StableFluids2D(jcfg).simulate(state, src, 2)
    for backend in ("reference", "cuda"):
        cfg = _cfg(backend, N, **SOLVERS["multigrid"])
        src_t = ft.Sources(*(_t(a) for a in _sources(41, N)))
        out = ft.StableFluids2D(cfg).simulate(
            ft.FluidState(*zero_sources_like(src_t)), src_t, 3)
        assert all(f.dtype == BF16 for f in out[:3])
        assert all(bool(torch.isfinite(f).all()) for f in out[:3])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_simulate_bf16_keeps_bf16(solver, backend):
    """Several steps through ``StableFluids2D.simulate`` at n = 30 and one
    grid of n = 14 (multigrid's one-level solve, bf16 throughout): every
    field stays bf16 and finite."""
    for n in (14, N):
        cfg = _cfg(backend, n, **SOLVERS[solver])
        src = ft.Sources(*(_t(a) for a in _sources(42, n)))
        out = ft.StableFluids2D(cfg).simulate(
            ft.FluidState(*zero_sources_like(src)), src, 4)
        assert all(f.dtype == BF16 and f.shape == (n + 2, n + 2)
                   for f in out[:3])
        assert all(bool(torch.isfinite(f).all()) for f in out[:3])


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_bf16_step_stays_near_float32(solver):
    """rel-L2 of each bf16 field to the float32 run's after 3 steps at
    n = 62, on both backends: below 0.15 (measured: at most 0.0125 with
    multigrid, 0.0725 with CG-20)."""
    src = _sources(43, SIDE - 2)
    for backend in ("reference", "cuda"):
        f32 = _run(_cfg(backend, SIDE - 2, dtype=torch.float32,
                        **SOLVERS[solver]), src, 3)[-1]
        b16 = _run(_cfg(backend, SIDE - 2, **SOLVERS[solver]), src, 3)[-1]
        for name, b, f in zip(("dens", "u", "v"), b16[:3], f32[:3]):
            rel = float(torch.linalg.vector_norm(b.float() - f)
                        / torch.linalg.vector_norm(f))
            print(f"{solver} {backend} {name}: rel-L2 {rel:.4f}")
            assert b.dtype == BF16 and rel < 0.15


# ---------------------------------------------------------------------------
# The batch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pallas_grids(solver, n, batch):
    """JAX's Pallas bf16 step in interpret mode on each grid of a batch
    alone (JAX's batched step vmaps its ``reference`` step for these
    solvers), stacked."""
    cfg = fj.SimConfig(n=n, jacobi_iters=8, backend="pallas",
                       dtype=jnp.bfloat16, **SOLVERS[solver])
    src = _sources(41, n, (batch,))
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    try:
        outs = []
        for g in range(batch):
            one = fj.Sources(*(_j(a[g]) for a in src))
            state = fj.FluidState(*(jnp.zeros_like(a) for a in one[:3]))
            outs.append(fj.step(cfg, state, one))
    finally:
        pallas_ops.INTERPRET = prev
    return tuple(np.stack([_np(o[i]) for o in outs]) for i in range(3))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_bf16_step_matches_jax_vmapped(solver, backend):
    """The batched bf16 step on three grids at n = 14, where JAX keeps
    bf16 (multigrid's solve is 40 sweeps on one level, no transfer).
    ``reference`` against JAX's vmapped ``reference`` step, bit for bit;
    ``cuda`` (the plain twins) against JAX's Pallas step on each grid in
    interpret mode: CG within one bf16 unit of each field's magnitude
    (measured: 1), multigrid within 8 (measured: 4.9; K1-damp's bf16 form
    rounds each 40-sweep solve once, JAX each operation)."""
    n, batch = 14, 3
    if backend == "reference":
        want, dtypes = _jax_reference_step(solver, (batch,), n)
        assert dtypes == (jnp.bfloat16,) * 3
    else:
        want = _jax_pallas_grids(solver, n, batch)
    cfg = _cfg(backend, n, **SOLVERS[solver])
    got = _run(cfg, _sources(41, n, (batch,)), 1, batch=True)[0]
    for name, g, w in zip(("dens", "u", "v"), got[:3], want):
        assert g.dtype == BF16 and g.shape == (batch, n + 2, n + 2)
        gap = np.abs(_np(g) - w).max()
        print(f"{solver} {backend} {name}: max|d| {gap:.3e} on max "
              f"{np.abs(w).max():.4g} ({gap / _ulp(w):.2f} units)")
        if backend == "reference":
            np.testing.assert_array_equal(_np(g), w, err_msg=name)
        else:
            atol = _ulp(w) * (1 if solver == "cg" else 8)
            np.testing.assert_allclose(_np(g), w, rtol=0, atol=atol,
                                       err_msg=name)
