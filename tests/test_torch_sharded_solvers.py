"""The multigrid and CG pressure solves of the port's row-slab step against
the JAX package's slab route.

The port's ``make_sharded_step_fn`` (``reference`` backend: the slab
functions' plain twins, ``parallel/solvers.py``) runs on a virtual CPU mesh,
one device listed once per slab; JAX's ``make_sharded_step_fn(...,
advect_mode="windowed", shard_backend="pallas")`` runs its slab kernels in
interpret mode and its sharded jnp solvers (``_mg_local``, ``_cg_local``) on
the virtual 8-device CPU mesh of ``tests/conftest.py``.  Both start from
the zero state with the same numpy sources, at n = 62, ``max_courant=2``,
``jacobi_iters=6``, ``mg_cycles=2`` and ``cg_iters=12``, and take two steps
(sources on the first).  Each JAX configuration runs once per module.
Tolerance rtol 2e-5 / atol 2e-5, JAX's own bar for the same sharded
algorithm on another mesh (``tests/test_sharded_solvers.py:77-80``): the
port sums the CG dot products and the coarse grid's 2x2 groups in another
order than XLA.  The states differ by at most 2.6e-8 for both solvers on 4
and on 8 slabs, as in the Jacobi runs of ``tests/test_torch_sharded.py``:
the JAX slab gather's interpret-mode rounding of the backtrace.

The port's own checks: its slab solvers on 1, 4 and 8 slabs against each
other; slab CG against the single-device CG step (the same algorithm);
``mg_slabs`` on 1, 4 and 8 slabs against the classic single-grid solve
``ops.multigrid.mg_pressure_solve``; the slab smoother's plain twin against
``ops.multigrid._smooth`` on the whole grid, bit for bit on the slab's
rows; the odd-slab refusal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.ops import cg as tcg  # noqa: E402
from fluidsimulationcuda_torch.ops import multigrid as tmg  # noqa: E402
from fluidsimulationcuda_torch.ops.boundary import embed_copy  # noqa: E402
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    make_mesh, make_sharded_step_fn, shard_state, unshard)
from fluidsimulationcuda_torch.parallel.mesh import _ext  # noqa: E402
from fluidsimulationcuda_torch.parallel.solvers import (  # noqa: E402
    cg_slabs, mg_slabs)
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.parallel import mesh as jmesh  # noqa: E402
from fluidsimulationcuda_tpu.parallel import sharded as jsharded  # noqa: E402

N = 62
CPU = torch.device("cpu")
SOLVERS = {"multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
           "cg": dict(pressure_solver="cg", cg_iters=12)}
RUNS = [(solver, slabs) for solver in SOLVERS for slabs in (4, 8)]
STEPS = 2
RTOL = ATOL = 2e-5


def _sources():
    """reference_init's distributions, drawn with numpy."""
    rng = np.random.default_rng(62)
    side = N + 2
    dens = rng.uniform(0.0, 0.099, (side, side)).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None] & band[None, :])] = 0.0
    u = rng.uniform(0.0, 0.99, (side, side)).astype(np.float32)
    v = rng.uniform(0.0, 0.99, (side, side)).astype(np.float32)
    return dens, u, v


def _cfg(solver, **kw):
    return ft.SimConfig(n=N, max_courant=2, jacobi_iters=6,
                        backend="reference", device="cpu", **SOLVERS[solver],
                        **kw)


def _jax_run(solver, slabs):
    """The states after each step of the JAX slab route."""
    cfg = fj.SimConfig(n=N, max_courant=2, jacobi_iters=6, backend="pallas",
                       **SOLVERS[solver])
    mesh = jmesh.make_mesh(jax.devices()[:slabs], shape=(slabs, 1))
    dens, u, v = (jnp.asarray(a) for a in _sources())
    sources = jsharded.shard_state(fj.Sources(dens=dens, u=u, v=v), mesh)
    zero = jsharded.shard_state(fj.zero_sources(cfg), mesh)
    state = jsharded.shard_state(fj.zero_state(cfg), mesh)
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    try:
        step = jsharded.make_sharded_step_fn(
            cfg, mesh, advect_mode="windowed", shard_backend="pallas")
        assert step.shard_backend == "pallas"
        states = []
        for k in range(STEPS):
            state = step(state, sources if k == 0 else zero)
            states.append([np.asarray(a) for a in state[:3]])
    finally:
        pallas_ops.INTERPRET = prev
    return states


def _torch_run(solver, slabs, **kw):
    cfg = _cfg(solver, **kw)
    mesh = make_mesh([CPU] * slabs)
    step = make_sharded_step_fn(cfg, mesh, advect_mode="windowed",
                                shard_backend="slab", audited=True)
    sources = shard_state(ft.Sources(*(torch.from_numpy(a)
                                       for a in _sources())), mesh)
    zero = shard_state(ft.zero_sources(cfg), mesh)
    state = shard_state(ft.zero_state(cfg), mesh)
    states, disps = [], []
    for k in range(STEPS):
        state, disp = step(state, sources if k == 0 else zero)
        states.append([t.numpy() for t in unshard(state)[:3]])
        disps.append(float(disp))
    return step, states, disps


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(solver, slabs):
        if (solver, slabs) not in cache:
            cache[solver, slabs] = _jax_run(solver, slabs)
        return cache[solver, slabs]

    return get


def _close(got, want):
    for k, (g_state, w_state) in enumerate(zip(got, want)):
        for name, g, w in zip(("dens", "u", "v"), g_state, w_state):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {k + 1} {name}")


@pytest.mark.parametrize("solver,slabs", RUNS,
                         ids=[f"{s}-{k}slabs" for s, k in RUNS])
def test_slab_solver_step_matches_jax(jax_runs, solver, slabs):
    step, states, _ = _torch_run(solver, slabs)
    assert step.routes["projection"] == "composed"
    _close(states, jax_runs(solver, slabs))


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_slab_solvers_agree_across_meshes(solver):
    """The same step on 1, 4 and 8 slabs: the coarse grid's overlapping
    rows summed (a 1-slab run has none), the dot products over every
    slab."""
    _, one, _ = _torch_run(solver, 1)
    for slabs in (4, 8):
        _, states, _ = _torch_run(solver, slabs)
        _close(states, one)


def test_slab_cg_matches_single_device_cg():
    """Slab CG runs the single-device CG step's algorithm: three steps on
    4 slabs equal the single-device step's within the bar while the
    audited displacement stays under max_courant (the gathers are then
    exact)."""
    cfg = _cfg("cg")
    mesh = make_mesh([CPU] * 4)
    step = make_sharded_step_fn(cfg, mesh, audited=True)
    sources = ft.Sources(*(torch.from_numpy(a) for a in _sources()))
    single, sharded = ft.zero_state(cfg), shard_state(ft.zero_state(cfg),
                                                      mesh)
    for k in range(3):
        src = sources if k == 0 else ft.zero_sources(cfg)
        sharded, disp = step(sharded, shard_state(src, mesh))
        single = ft.step(cfg, single, src)
        assert float(disp) < cfg.max_courant
    for a, b in zip(unshard(sharded)[:3], single[:3]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def _div(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return embed_copy(torch.randn(N, N, generator=gen))


def _slabs(g, slabs):
    m = g.shape[0] // slabs
    return ([g[i * m:(i + 1) * m].clone() for i in range(slabs)],
            [(int(i == 0), int(i == slabs - 1), i * m)
             for i in range(slabs)])


@pytest.mark.parametrize("slabs", [1, 4, 8])
def test_mg_slabs_matches_the_classic_cycle(slabs):
    """``mg_slabs`` is the classic two-level cycle (not the graded
    ``mg_pressure_solve_fast``): within 1e-5 x max|p| of
    ``ops.multigrid.mg_pressure_solve``.  Its fine-level smoother takes
    every slab at once (the SlabOpSet's ``smooth`` contract), so the
    test passes the plain twin of that contract, ``smooth_slabs_plain``
    (before, the one-slab ``smooth_slab_plain``)."""
    div = _div()
    xs, flags = _slabs(div, slabs)
    got = torch.cat(mg_slabs(xs, 2, N, flags, cs.smooth_slabs_plain,
                             tmg._smooth))
    want = tmg.mg_pressure_solve(div, 2)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    fast = tmg.mg_pressure_solve_fast(div, 2)
    assert float((got - fast).abs().max()) > 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("slabs", [1, 4, 8])
def test_cg_slabs_matches_the_single_grid_solve(slabs):
    div = _div(1)
    xs, flags = _slabs(div, slabs)
    got = torch.cat(cg_slabs(xs, 12, N, flags))
    want = tcg.cg_pressure_solve(div, 12)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=ATOL * float(want.abs().max()))


@pytest.mark.parametrize("zero_init", [False, True])
@pytest.mark.parametrize("sweeps", [2, 8])
@pytest.mark.parametrize("position", ["first", "interior", "last"])
def test_smooth_slab_plain_is_the_smoother_on_the_slab_rows(position, sweeps,
                                                            zero_init):
    """The slab smoother's plain twin on an extended slab equals
    ``ops.multigrid._smooth`` on the whole grid in the slab's rows, bit for
    bit: a K-row halo is valid for K sweeps.  On CPU tensors the kernel's
    wrapper is that twin: the wrapper now takes every slab
    (``smooth_slabs``), where the one-slab ``smooth_slab`` it checked
    before is gone with the per-slab kernel."""
    slabs, K = 4, 8
    i = {"first": 0, "interior": 1, "last": slabs - 1}[position]
    gen = torch.Generator().manual_seed(sweeps)
    p = torch.randn(N + 2, N + 2, generator=gen)
    div = torch.randn(N + 2, N + 2, generator=gen)
    ps, flags = _slabs(p, slabs)
    ds, _ = _slabs(div, slabs)
    m = ps[0].shape[0]
    got = cs.smooth_slab_plain(_ext(ps, K)[i], _ext(ds, K)[i], flags[i],
                               m=m, K=K, sweeps=sweeps, zero_init=zero_init)
    want = tmg._smooth(p, div, sweeps, zero_init=zero_init)
    assert torch.equal(got, want[i * m:(i + 1) * m])
    assert torch.equal(cs.smooth_slabs(ps, ds, flags, sweeps=sweeps,
                                       zero_init=zero_init)[i], got)


@pytest.mark.parametrize("n,slabs", [(46, 16), (45, 1), (62, 32)])
def test_multigrid_refuses_odd_slabs(n, slabs):
    """JAX's gate: the coarse grid's 2x2 groups must not straddle two
    slabs, so the slab height must be even (n = 46 on 16 slabs of 3 rows,
    n = 45 on one slab of 47); CG has no such gate.  Slabs of 2 rows are
    even but thinner than the smoother's 8-row halo."""
    cfg = ft.SimConfig(n=n, max_courant=1, jacobi_iters=6,
                       pressure_solver="multigrid", backend="reference",
                       device="cpu", diffusion_solver="chebyshev",
                       cheby_iters=2, cheby_rho=0.9)
    mesh = make_mesh([CPU] * slabs)
    match = "halo" if (n + 2) // slabs % 2 == 0 else "even local block"
    with pytest.raises(ValueError, match=match):
        make_sharded_step_fn(cfg, mesh)
