"""The multigrid and CG projections of the block route, and the slab
route's deep-halo Chebyshev, against the JAX package.

Multigrid (two cycles) and CG (10 iterations) on (2, 2) and (2, 4) blocks
at n = 30 (``solvers.mg_blocks``, ``cg_blocks``, the ``reference``
backend) against JAX's ``_step_local`` on the virtual 8-device CPU mesh
of ``tests/conftest.py``, 2 steps from the zero state with the same numpy
sources, at rtol/atol 2e-5 (the slab solvers' bar,
``tests/test_torch_sharded_solvers.py``): the port sums its dot products
and restriction blocks in mesh order, JAX in XLA's.  Against the slab
route's solvers on the flattened mesh the block route differs by the
partition of those sums alone (on (2, 2); ``-s`` prints each max|Δ|).  JAX's
odd-block ``ValueError`` stands.

The slab route's one-call Chebyshev solves need a ``ceil8(iters+1)``-row
halo; where that is deeper than a slab (10 sweeps on 8 slabs of 8 rows at
n = 62) JAX's ``_step_local_pallas`` falls back to its jnp chunked solve
on the (px, 1) blocks, and so does the port, through the block route's
``_cheby_blocks``: held against JAX's slab route in interpret mode at atol
1e-5 and against the single-device step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    make_mesh, make_sharded_step_fn, shard_blocks, shard_state, unshard)
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.parallel import mesh as jmesh  # noqa: E402
from fluidsimulationcuda_tpu.parallel import sharded as jsharded  # noqa: E402

CPU = torch.device("cpu")
STEPS = 2
SOLVERS = {"multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
           "cg": dict(pressure_solver="cg", cg_iters=10)}
RUNS = [("multigrid", (2, 2)), ("multigrid", (2, 4)), ("cg", (2, 2)),
        ("cg", (2, 4))]


def _sources(side: int):
    """reference_init's distributions, drawn with numpy."""
    rng = np.random.default_rng(side)
    dens = rng.uniform(0.0, 0.099, (side, side)).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None] & band[None, :])] = 0.0
    u, v = (rng.uniform(0.0, 30.0, (side, side)).astype(np.float32)
            for _ in range(2))
    return dens, u, v


def _drive(step, state, src, zero, join):
    out = []
    for k in range(STEPS):
        state = step(state, src if k == 0 else zero)
        out.append([np.asarray(a) for a in join(state)[:3]])
    return out


def _jax(cfg, shape, **kw):
    mesh = jmesh.make_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape)
    step = jsharded.make_sharded_step_fn(cfg, mesh, **kw)
    side = cfg.n + 2
    put = lambda t: jsharded.shard_state(t, mesh)  # noqa: E731
    return step, _drive(step, put(fj.zero_state(cfg)),
                        put(fj.Sources(*map(jnp.asarray, _sources(side)))),
                        put(fj.zero_sources(cfg)), lambda s: s)


def _torch(cfg, shape, **kw):
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step = make_sharded_step_fn(cfg, mesh, **kw)
    cut = shard_blocks if step.layout == "blocks" else shard_state

    def put(t):
        return cut(t, step.mesh)

    src = ft.Sources(*map(torch.from_numpy, _sources(cfg.n + 2)))
    return step, _drive(step, put(ft.zero_state(cfg)), put(src),
                        put(ft.zero_sources(cfg)),
                        lambda s: unshard(s, step.mesh))


def _close(got, want, rtol, atol):
    worst = 0.0
    for k, (g_state, w_state) in enumerate(zip(got, want)):
        for name, g, w in zip(("dens", "u", "v"), g_state, w_state):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"step {k + 1} {name}")
            worst = max(worst, float(np.abs(g - w).max()))
    return worst


@pytest.mark.parametrize("solver,shape", RUNS,
                         ids=[f"{s}-{a}x{b}" for s, (a, b) in RUNS])
def test_block_solvers_match_jax(solver, shape):
    # fuse_sweeps: the slab route's Jacobi chunks (a 4-sweep chunk's 8-row
    # halo fits the 8-row slabs of the flattened (2, 2) mesh); the block
    # route chunks as JAX's, at most 8 sweeps.
    kw = dict(n=30, jacobi_iters=8, max_courant=2, fuse_sweeps=4,
              **SOLVERS[solver])
    jstep, want = _jax(fj.SimConfig(**kw), shape, advect_mode="exact",
                       shard_backend="reference")
    assert jstep.shard_backend == "reference"
    cfg = ft.SimConfig(backend="reference", device="cpu", **kw)
    step, got = _torch(cfg, shape, advect_mode="exact",
                       shard_backend="reference")
    assert step.layout == "blocks" and step.routes["projection"] == "composed"
    err = _close(got, want, 2e-5, 2e-5)
    if shape == (2, 4):  # 8 slabs of 4 rows hold no Jacobi halo
        print(f"{solver} {shape}: max|d| to JAX {err:.2e}")
        return
    # The slab route on the flattened mesh: the same solver over another
    # partition of its sums (ROADMAP §C).
    _, slabs = _torch(cfg, shape, advect_mode="exact", shard_backend="slab")
    gap = _close(got, slabs, 2e-5, 2e-5)
    print(f"{solver} {shape}: max|d| to JAX {err:.2e}, to the slab route "
          f"{gap:.2e}")


def test_odd_block_multigrid_raises():
    """Side 36 on a (4, 2) mesh: blocks of 9 x 18, whose 2x2 restriction
    groups would straddle two blocks (JAX's gate)."""
    cfg = ft.SimConfig(n=34, pressure_solver="multigrid", device="cpu")
    mesh = make_mesh([CPU] * 8, shape=(4, 2))
    with pytest.raises(ValueError, match=r"\(9, 18\)"):
        make_sharded_step_fn(cfg, mesh, shard_backend="reference")
    with pytest.raises(ValueError, match="even local block sizes"):
        jsharded.make_sharded_step_fn(
            fj.SimConfig(n=34, pressure_solver="multigrid"),
            jmesh.make_mesh(jax.devices(), shape=(4, 2)),
            shard_backend="reference")


def test_deep_halo_chebyshev_matches_jax():
    """10-sweep Chebyshev solves on 8 slabs of 8 rows (a 16-row halo): the
    velocity, density and pressure solves take the chunked block solve on
    the (8, 1) blocks in both packages (JAX's ``_step_local_pallas`` with
    its jnp fallback, in interpret mode)."""
    kw = dict(n=62, jacobi_iters=4, max_courant=2,
              pressure_solver="chebyshev", diffusion_solver="chebyshev",
              cheby_rho=0.9, cheby_iters=10)
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    try:
        jstep, want = _jax(fj.SimConfig(backend="pallas", **kw), (8, 1),
                           advect_mode="windowed", shard_backend="pallas")
    finally:
        pallas_ops.INTERPRET = prev
    assert jstep.shard_backend == "pallas"
    cfg = ft.SimConfig(backend="reference", device="cpu", **kw)
    step, got = _torch(cfg, (8, 1), advect_mode="windowed")
    assert step.shard_backend == "slab"
    assert step.routes == {"projection": "composed", "density": "composed"}
    _close(got, want, 0.0, 1e-5)
    # Windowed: the single-device step gathers in the same window.
    single = cfg.replace(advect_mode="windowed")
    state = ft.zero_state(single)
    src = ft.Sources(*map(torch.from_numpy, _sources(64)))
    for k in range(STEPS):
        state = ft.step(single, state, src if k == 0 else
                        ft.zero_sources(single))
        for g, w in zip(got[k], state[:3]):
            np.testing.assert_array_equal(g, w.numpy())
