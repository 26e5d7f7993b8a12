"""The port's multi-device step against the JAX package's slab route.

The port's ``make_sharded_step_fn`` (``reference`` backend: the slab
functions' plain twins) runs on a virtual CPU mesh, one device listed once
per slab; JAX's ``make_sharded_step_fn(..., advect_mode="windowed",
shard_backend="pallas")`` runs its slab kernels in interpret mode on the
virtual 8-device CPU mesh of ``tests/conftest.py``.  Both start from the zero
state with the same numpy sources, at n = 62 and max_courant = 2, and take
two steps (sources on the first).  Each JAX configuration runs once per
module.  Tolerance atol 1e-5.  The states differ by at most 2.3e-8 in the
Jacobi runs, which is the JAX slab gather's interpret-mode rounding of the
backtrace (the port equals JAX's jnp ``advect_windowed`` to the bit,
``tests/test_torch_sharded_ops.py``).  In the Chebyshev run they differ by
1.3e-6, because the JAX fused projection runs its weight recurrence in
float32 and the port in float64.  Against the port's own single-device
step, the sharded step is bit-identical.

At this width (side 64 < 128) the JAX route sends the one-call Chebyshev
diffusion to its jnp twin (``_cheby_diffuse_local``, the same sweeps in the
same order); the port, which has no TPU tiling gate, keeps the slab call.
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

N = 62
CPU = torch.device("cpu")
CONFIGS = {
    "parity": dict(jacobi_iters=6),
    "multi_chunk": dict(jacobi_iters=9, fuse_sweeps=4),
    "chebyshev": dict(jacobi_iters=6, pressure_solver="chebyshev",
                      diffusion_solver="chebyshev"),
}
# (config, mesh) pairs that JAX runs, each once per module.
RUNS = [("parity", (1, 1)), ("parity", (4, 1)), ("parity", (8, 1)),
        ("multi_chunk", (4, 1)), ("chebyshev", (4, 1))]
STEPS = 2
ATOL = 1e-5


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


def _cfg(name, **kw):
    return ft.SimConfig(n=N, max_courant=2, backend="reference", device="cpu",
                        **CONFIGS[name], **kw)


def _jax_run(name, shape):
    """(states after each step, audited displacements) of the JAX slab
    route."""
    cfg = fj.SimConfig(n=N, max_courant=2, backend="pallas", **CONFIGS[name])
    mesh = jmesh.make_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape)
    dens, u, v = (jnp.asarray(a) for a in _sources())
    sources = jsharded.shard_state(fj.Sources(dens=dens, u=u, v=v), mesh)
    zero = jsharded.shard_state(fj.zero_sources(cfg), mesh)
    state = jsharded.shard_state(fj.zero_state(cfg), mesh)
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    try:
        step = jsharded.make_sharded_step_fn(
            cfg, mesh, advect_mode="windowed", shard_backend="pallas",
            audited=True)
        states, disps = [], []
        for k in range(STEPS):
            state, disp = step(state, sources if k == 0 else zero)
            states.append([np.asarray(a) for a in state[:3]])
            disps.append(float(disp))
    finally:
        pallas_ops.INTERPRET = prev
    return states, disps


def _torch_run(name, shape, **kw):
    cfg = _cfg(name, **kw)
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step = make_sharded_step_fn(cfg, mesh, advect_mode="windowed",
                                shard_backend="slab", audited=True)
    sources = ft.Sources(*(torch.from_numpy(a) for a in _sources()))
    sources = shard_state(sources, mesh)
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

    def get(name, shape):
        if (name, shape) not in cache:
            cache[name, shape] = _jax_run(name, shape)
        return cache[name, shape]

    return get


def _close(got, want, atol=ATOL):
    for k, (g_state, w_state) in enumerate(zip(got, want)):
        for name, g, w in zip(("dens", "u", "v"), g_state, w_state):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"step {k + 1} {name}")


@pytest.mark.parametrize("name,shape", RUNS,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in RUNS])
def test_sharded_step_matches_jax(jax_runs, name, shape):
    step, states, _ = _torch_run(name, shape)
    want, _ = jax_runs(name, shape)
    assert step.shard_backend == "slab" and step.advect_mode == "windowed"
    _close(states, want)


@pytest.mark.parametrize("name,shape,routes", [
    ("parity", (1, 1), ("fused", "fused")),
    ("parity", (4, 1), ("fused", "fused")),
    # m = 8: the projection's 16-row halo and the density's exceed a slab.
    ("parity", (8, 1), ("composed", "composed")),
    # 9 sweeps > fuse_sweeps = 4: the density is diffused in chunks.
    ("multi_chunk", (4, 1), ("fused", "composed")),
    ("chebyshev", (4, 1), ("fused", "composed")),
])
def test_routes(name, shape, routes):
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step = make_sharded_step_fn(_cfg(name), mesh)
    assert (step.routes["projection"], step.routes["density"]) == routes


def test_audited_displacement_matches_jax(jax_runs):
    _, _, disps = _torch_run("parity", (4, 1))
    _, want = jax_runs("parity", (4, 1))
    assert all(0 < d < 2 for d in disps)
    np.testing.assert_allclose(disps, want, rtol=1e-6)


def test_2d_mesh_flattens(jax_runs):
    """A (2, 2) mesh takes the slab route as the (4, 1) mesh of its
    devices, bit-identical to the explicit row mesh."""
    step, states, _ = _torch_run("parity", (2, 2))
    assert step.mesh.shape == {"x": 4, "y": 1}
    _, rows, _ = _torch_run("parity", (4, 1))
    for a, b in zip(states, rows):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    _close(states, jax_runs("parity", (4, 1))[0])


@pytest.mark.parametrize("name,shape", [("parity", (1, 1)),
                                        ("parity", (8, 1)),
                                        ("chebyshev", (4, 1))])
def test_sharded_step_matches_single_device(name, shape):
    """Three steps on slabs equal three single-device steps while the
    audited displacement stays under max_courant (the gathers are then
    exact)."""
    cfg = _cfg(name)
    mesh = make_mesh([CPU] * shape[0], shape=shape)
    step = make_sharded_step_fn(cfg, mesh, audited=True)
    sources = ft.Sources(*(torch.from_numpy(a) for a in _sources()))
    state, single = ft.zero_state(cfg), ft.zero_state(cfg)
    sharded = shard_state(state, mesh)
    for k in range(3):
        src = sources if k == 0 else ft.zero_sources(cfg)
        sharded, disp = step(sharded, shard_state(src, mesh))
        single = ft.step(cfg, single, src)
        assert float(disp) < cfg.max_courant
    for a, b in zip(unshard(sharded)[:3], single[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_shard_state_round_trip():
    cfg = _cfg("parity")
    mesh = make_mesh([CPU] * 4)
    src = ft.Sources(*(torch.from_numpy(a) for a in _sources()))
    slabs = shard_state(src, mesh)
    assert len(slabs.u) == 4 and tuple(slabs.u[0].shape) == (16, 64)
    assert slabs.w is None
    back = unshard(slabs)
    for a, b in zip(back[:3], src[:3]):
        assert torch.equal(a, b)
    assert slabs.u[0].data_ptr() != src.u.data_ptr()  # a copy
    with pytest.raises(ValueError, match="divisible"):
        shard_state(ft.zero_state(cfg), make_mesh([CPU] * 3))


def test_make_mesh_shapes():
    assert make_mesh([CPU] * 8).shape == {"x": 8, "y": 1}
    assert make_mesh([CPU] * 6, shape=(3, 2)).shape == {"x": 3, "y": 2}
    assert make_mesh(["cpu"] * 4).device_list == [CPU] * 4
    with pytest.raises(ValueError):
        make_mesh([CPU] * 4, shape=(3, 1))
    with pytest.raises(ValueError):
        make_mesh([])


def test_step_needs_slabs():
    mesh = make_mesh([CPU] * 4)
    step = make_sharded_step_fn(_cfg("parity"), mesh)
    cfg = _cfg("parity")
    with pytest.raises(TypeError, match="slabs"):
        step(ft.zero_state(cfg), ft.zero_sources(cfg))


def test_rejects_exact_advection():
    """The exact gather runs on both routes now: on the slab route
    (``tests/test_torch_sharded_exact.py``), on JAX's jnp route
    (``shard_backend="reference"``, the block route) and, where slabs are
    thinner than ``max_courant+1`` rows, under ``"auto"`` and ``"exact"``
    on the block route, as JAX's ``"auto"`` gathers there
    (``tests/test_torch_sharded_blocks.py``).  What stays refused is a
    windowed gather on parts thinner than the window, JAX's
    ``ValueError``."""
    mesh = make_mesh([CPU] * 2)
    assert make_sharded_step_fn(_cfg("parity"), mesh, advect_mode="exact",
                                shard_backend="slab").advect_mode == "exact"
    step = make_sharded_step_fn(_cfg("parity"), mesh, advect_mode="exact",
                                shard_backend="reference")
    assert (step.shard_backend, step.layout) == ("reference", "blocks")
    thin = _cfg("parity").replace(max_courant=8)  # 8-row slabs, 9 needed
    for mode in ("auto", "exact"):
        step = make_sharded_step_fn(thin, make_mesh([CPU] * 8),
                                    advect_mode=mode)
        assert (step.shard_backend, step.advect_mode) == ("reference",
                                                          "exact")
    with pytest.raises(ValueError, match="windowed advection needs"):
        make_sharded_step_fn(thin, make_mesh([CPU] * 8),
                             advect_mode="windowed")


def test_rejects_unflattenable_mesh():
    """Side 36 over 8 devices: 36 % 8 != 0, so the (2, 4) mesh cannot
    row-flatten.  The slab route still refuses it; ``"auto"`` now runs
    the block route on the (2, 4) blocks of 18 x 9, as JAX does."""
    cfg = ft.SimConfig(n=34, jacobi_iters=4, device="cpu")
    mesh = make_mesh([CPU] * 8, shape=(2, 4))
    with pytest.raises(ValueError, match="row slabs"):
        make_sharded_step_fn(cfg, mesh, shard_backend="slab")
    step = make_sharded_step_fn(cfg, mesh)
    assert (step.shard_backend, step.layout) == ("reference", "blocks")
    assert step.mesh.shape == {"x": 2, "y": 4}
    state = shard_blocks(ft.zero_state(cfg), mesh)
    out = step(state, shard_blocks(ft.zero_sources(cfg), mesh))
    assert tuple(out.u[0].shape) == (18, 9)


def test_rejects_a_halo_deeper_than_a_slab():
    """20 sweeps per chunk need a 24-row halo; JAX's x[-K:] would silently
    take the 8 rows a slab has, so the port refuses the Jacobi chunk.  A
    one-call Chebyshev solve whose halo is deeper than a slab now takes
    JAX's jnp fallback, the chunked block solve on the (px, 1) blocks
    (``tests/test_torch_sharded_blocks_solvers.py``)."""
    cfg = ft.SimConfig(n=62, jacobi_iters=20, max_courant=2, device="cpu")
    with pytest.raises(ValueError, match="24-row halo"):
        make_sharded_step_fn(cfg, make_mesh([CPU] * 8))
    cheby = cfg.replace(jacobi_iters=4, diffusion_solver="chebyshev",
                        cheby_iters=10)
    step = make_sharded_step_fn(cheby, make_mesh([CPU] * 8))
    assert step.shard_backend == "slab"
    out = step(shard_state(ft.zero_state(cheby), step.mesh),
               shard_state(ft.zero_sources(cheby), step.mesh))
    assert len(out.u) == 8


@pytest.mark.parametrize("kw", [dict(shard_backend="reference"),
                                dict(advect_mode="sideways"),
                                dict(shard_backend="pallas")])
def test_rejects_unported_or_unknown_backends(kw):
    """Unknown backends and modes raise ``ValueError``; JAX's jnp route,
    ``shard_backend="reference"``, is ported (the block route) and runs."""
    mesh = make_mesh([CPU] * 4)
    if kw.get("shard_backend") == "reference":
        step = make_sharded_step_fn(_cfg("parity"), mesh, **kw)
        assert (step.shard_backend, step.layout) == ("reference", "blocks")
        return
    with pytest.raises(ValueError):
        make_sharded_step_fn(_cfg("parity"), mesh, **kw)


@pytest.mark.parametrize("solver", ["multigrid", "cg"])
def test_rejects_sharded_krylov_and_multigrid(solver):
    """The multigrid and CG projections run on row slabs
    (``tests/test_torch_sharded_solvers.py``) and now on JAX's block route
    too (``shard_backend="reference"``, ``solvers.mg_blocks`` and
    ``cg_blocks``, ``tests/test_torch_sharded_blocks_solvers.py``).  What
    stays refused is bf16 on the slab route and, for multigrid, odd
    blocks.  bf16 storage now runs on the block route, which ``"auto"``
    and ``"reference"`` take for it (ROADMAP §A 5 (b),
    ``tests/test_torch_sharded_blocks_bf16.py``); the slab route is
    float32, as JAX's, so only ``"slab"`` refuses it, with a
    ``ValueError`` that says so."""
    cfg = _cfg("parity", pressure_solver=solver)
    step = make_sharded_step_fn(cfg, make_mesh([CPU] * 4),
                                shard_backend="reference")
    assert step.layout == "blocks" and step.routes["projection"] == "composed"
    assert make_sharded_step_fn(cfg, make_mesh([CPU] * 4)).routes[
        "projection"] == "composed"
    bf16 = cfg.replace(dtype=torch.bfloat16)
    for backend in ("auto", "reference"):
        assert make_sharded_step_fn(bf16, make_mesh([CPU] * 4),
                                    shard_backend=backend).layout == "blocks"
    with pytest.raises(ValueError, match="float32"):
        make_sharded_step_fn(bf16, make_mesh([CPU] * 4),
                             shard_backend="slab")


def test_auto_keeps_slabs_where_jax_takes_blocks():
    """A recorded difference (ROADMAP §C): JAX's ``shard_backend="auto"``
    takes its slab route only when ``cfg.backend`` asks for Pallas, and
    its block route for any other backend (``sharded.py:1022-1027``
    there); the port's ``"auto"`` keeps the slab route wherever it
    qualifies, on either backend (the slab route's plain twins on
    ``reference``)."""
    mesh = make_mesh([CPU] * 4)
    assert make_sharded_step_fn(_cfg("parity"), mesh).shard_backend == "slab"
    jstep = jsharded.make_sharded_step_fn(
        fj.SimConfig(n=N, max_courant=2, backend="reference"),
        jmesh.make_mesh(jax.devices()[:4], shape=(4, 1)))
    assert jstep.shard_backend == "reference"
