"""The block route of the port's multi-device 2-D step against the JAX
package's ``_step_local`` and against the port's own steps.

``make_sharded_step_fn(cfg, mesh, shard_backend="reference")`` runs the
block route (``_BlockStep``) on the (px, py) blocks of a virtual CPU mesh,
one device listed once per block, with the ``reference`` backend (the
block forms' plain twins).  JAX's ``_step_local`` runs on the virtual
8-device CPU mesh of ``tests/conftest.py``.  Both start from the zero
state with the same numpy sources at n = 30 (8 Jacobi iterations, a
2-cell window) and take 3 steps, audited: the states at atol 1e-5 and the
displacements at rtol 1e-6, Jacobi windowed on (2, 4) blocks and exact on
(2, 2), Chebyshev exact on (1, 8) and ``chebyshev-dens`` exact on (2, 4).
Slabs thinner than the window under ``"auto"`` take the block route in
both packages and gather exactly there.

Against the port's single-device step (``ft.step``, which gathers exactly
under ``advect_mode="auto"``) the exact block step is equal bit for bit on
(2, 2), (4, 2), (2, 4), (1, 8) and (8, 1) meshes, and the windowed block
step equals the windowed slab route on the flattened mesh bit for bit.
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
    Blocks, make_mesh, make_sharded_step_fn, shard_blocks, shard_state,
    unshard)
from fluidsimulationcuda_torch.parallel import mesh as tmesh  # noqa: E402
from fluidsimulationcuda_tpu.parallel import mesh as jmesh  # noqa: E402
from fluidsimulationcuda_tpu.parallel import sharded as jsharded  # noqa: E402

N = 30
SIDE = N + 2
CPU = torch.device("cpu")
STEPS = 3
ATOL = 1e-5
CONFIGS = {
    "jacobi": dict(jacobi_iters=8, max_courant=2),
    "chebyshev": dict(jacobi_iters=8, max_courant=2,
                      pressure_solver="chebyshev",
                      diffusion_solver="chebyshev", cheby_rho=0.9,
                      cheby_iters=10),
    "chebyshev-dens": dict(jacobi_iters=8, max_courant=2,
                           diffusion_solver="chebyshev-dens", cheby_rho=0.9,
                           cheby_dens_iters=6),
}
# (config, mesh, advect_mode) that JAX runs, each once per module.
RUNS = [("jacobi", (2, 4), "windowed"), ("jacobi", (2, 2), "exact"),
        ("chebyshev", (1, 8), "exact"), ("chebyshev-dens", (2, 4), "exact")]


# The velocity sources' upper bound: each moves the backtrace past the
# window (2-D, n = 30: 3.14 cells on Jacobi, 3.61 on Chebyshev, whose 10
# under-converged sweeps keep more of the impulse).
VEL = {"jacobi": 400.0, "chebyshev": 800.0, "chebyshev-dens": 400.0,
       "jacobi-thin": 400.0}


def _sources(name="jacobi", side=SIDE):
    """A density source in the centred square, velocity sources in [0,
    ``VEL[name]``)."""
    rng = np.random.default_rng(30)
    dens = rng.uniform(0.0, 0.099, (side, side)).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None] & band[None, :])] = 0.0
    u, v = (rng.uniform(0.0, VEL.get(name, 1.0), (side, side)).astype(
        np.float32) for _ in range(2))
    return dens, u, v


def _jax_run(name, shape, mode, backend="reference"):
    """(states after each step, audited displacements, shard_backend) of
    JAX's multi-device step."""
    cfg = fj.SimConfig(n=N, backend=backend, **CONFIGS[name])
    mesh = jmesh.make_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape)
    step = jsharded.make_sharded_step_fn(cfg, mesh, advect_mode=mode,
                                         audited=True)
    src = jsharded.shard_state(
        fj.Sources(*(jnp.asarray(a) for a in _sources(name))), mesh)
    zero = jsharded.shard_state(fj.zero_sources(cfg), mesh)
    state = jsharded.shard_state(fj.zero_state(cfg), mesh)
    states, disps = [], []
    for k in range(STEPS):
        state, disp = step(state, src if k == 0 else zero)
        states.append([np.asarray(a) for a in state[:3]])
        disps.append(float(disp))
    return states, disps, (step.shard_backend, step.advect_mode)


def _cfg(name, **kw):
    return ft.SimConfig(n=N, backend="reference", device="cpu",
                        **{**CONFIGS[name], **kw})


def _torch_run(cfg, shape, mode, name="jacobi", **kw):
    """(step, states after each step, displacements) of the port's step,
    the parts cut as the step's layout asks."""
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step = make_sharded_step_fn(cfg, mesh, advect_mode=mode, audited=True,
                                **kw)
    cut = shard_blocks if step.layout == "blocks" else shard_state
    src = cut(ft.Sources(*(torch.from_numpy(a)
                           for a in _sources(name, cfg.n + 2))), step.mesh)
    zero = cut(ft.zero_sources(cfg), step.mesh)
    state = cut(ft.zero_state(cfg), step.mesh)
    states, disps = [], []
    for k in range(STEPS):
        state, disp = step(state, src if k == 0 else zero)
        states.append([t for t in unshard(state, step.mesh)[:3]])
        disps.append(float(disp))
    return step, states, disps


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(*run):
        if run not in cache:
            cache[run] = _jax_run(*run)
        return cache[run]

    return get


def _close(got, want):
    for k, (g_state, w_state) in enumerate(zip(got, want)):
        for name, g, w in zip(("dens", "u", "v"), g_state, w_state):
            g = g.numpy()
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                       err_msg=f"step {k + 1} {name}")


@pytest.mark.parametrize("name,shape,mode", RUNS,
                         ids=[f"{n}-{s[0]}x{s[1]}-{m}" for n, s, m in RUNS])
def test_block_step_matches_jax(jax_runs, name, shape, mode):
    want, want_disps, (backend, want_mode) = jax_runs(name, shape, mode)
    assert backend == "reference" and want_mode == mode
    step, got, disps = _torch_run(_cfg(name), shape, mode, name,
                                  shard_backend="reference")
    assert step.shard_backend == "reference" and step.layout == "blocks"
    assert step.advect_mode == mode and step.mesh.shape == {
        "x": shape[0], "y": shape[1]}
    assert step.routes == {"projection": "composed", "density": "composed"}
    assert max(disps) > CONFIGS[name]["max_courant"]  # past the window
    np.testing.assert_allclose(disps, want_disps, rtol=1e-6)
    _close(got, want)


def test_thin_slabs_auto_matches_jax(jax_runs):
    """Slabs of 4 rows under a 4-cell window: JAX's ``"auto"`` (with the
    Pallas backend asked for) finds its slab route unviable and runs the
    block route with exact gathers; so does the port's."""
    want, want_disps, route = jax_runs("jacobi-thin", (8, 1), "auto",
                                       "pallas")
    assert route == ("reference", "exact")
    step, got, disps = _torch_run(_cfg("jacobi", max_courant=4), (8, 1),
                                  "auto", "jacobi-thin")
    assert (step.shard_backend, step.advect_mode) == route
    assert step.layout == "blocks"
    np.testing.assert_allclose(disps, want_disps, rtol=1e-6)
    _close(got, want)


CONFIGS["jacobi-thin"] = dict(CONFIGS["jacobi"], max_courant=4)
SHAPES = [(2, 2), (4, 2), (2, 4), (1, 8), (8, 1)]


@pytest.mark.parametrize("name", ["jacobi", "chebyshev", "chebyshev-dens"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"{a}x{b}" for a, b in SHAPES])
def test_exact_block_step_equals_single_device(name, shape):
    cfg = _cfg(name)
    _, got, _ = _torch_run(cfg, shape, "exact", name,
                           shard_backend="reference")
    state = ft.zero_state(cfg)
    src = ft.Sources(*(torch.from_numpy(a) for a in _sources(name)))
    zero = ft.zero_sources(cfg)
    for k in range(STEPS):
        state = ft.step(cfg, state, src if k == 0 else zero)
        for g, w in zip(got[k], state[:3]):
            assert torch.equal(g, w), f"step {k + 1}"


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)],
                         ids=["2x4", "2x2"])
def test_windowed_blocks_equal_windowed_slabs(shape):
    """At n = 62 the (px, py) blocks and the px·py row slabs of the
    flattened mesh gather in the same window: the two routes agree bit
    for bit."""
    cfg = ft.SimConfig(n=62, jacobi_iters=6, max_courant=2,
                       backend="reference", device="cpu")
    blk, got, _ = _torch_run(cfg, shape, "windowed",
                             shard_backend="reference")
    slab, want, _ = _torch_run(cfg, shape, "windowed")
    assert blk.layout == "blocks" and slab.layout == "slabs"
    assert slab.mesh.shape == {"x": shape[0] * shape[1], "y": 1}
    for g_state, w_state in zip(got, want):
        for g, w in zip(g_state, w_state):
            assert torch.equal(g, w)


def test_block_layout():
    """``shard_blocks`` cuts row-major mesh blocks and ``unshard`` with the
    mesh stitches them back; a (px, 1) mesh's blocks are its slabs; the
    block step refuses slabs; ``layout="square"`` is JAX's near-square
    mesh."""
    cfg = _cfg("jacobi")
    state, _ = ft.reference_init(torch.Generator().manual_seed(1), cfg)
    mesh = make_mesh([CPU] * 8, shape=(2, 4))
    parts = shard_blocks(state, mesh)
    assert len(parts.u) == 8 and parts.u[1].shape == (16, 8)
    assert torch.equal(parts.u[5], state.u[16:32, 8:16])
    for a, b in zip(unshard(parts, mesh)[:3], state[:3]):
        assert torch.equal(a, b)
    rows = make_mesh([CPU] * 4)
    for a, b in zip(shard_blocks(state, rows)[:3],
                    shard_state(state, rows)[:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    step = make_sharded_step_fn(cfg, mesh, shard_backend="reference")
    with pytest.raises(TypeError, match="blocks of shape"):
        step(shard_state(state, mesh), shard_state(ft.zero_sources(cfg),
                                                   mesh))
    assert make_mesh([CPU] * 8, layout="square").shape == {"x": 2, "y": 4}
    assert make_mesh([CPU] * 6, layout="square").shape == {"x": 2, "y": 3}
    assert tmesh._factor_2d(9) == (3, 3)
    with pytest.raises(ValueError, match="layout"):
        make_mesh([CPU] * 4, layout="diagonal")


def test_block_halos():
    """The two-phase exchange: the extended block holds its neighbours'
    cells, the diagonal ones included, and zeros beyond a wall; a halo
    deeper than a block raises."""
    g = torch.arange(SIDE * SIDE, dtype=torch.float32).reshape(SIDE, SIDE)
    blocks = Blocks(2, 4, SIDE)
    parts = blocks.cut(g)
    ext = blocks.ext(parts, 3)
    padded = torch.nn.functional.pad(g, (3, 3, 3, 3))
    for e, (r0, c0) in zip(ext, blocks.origins):
        assert torch.equal(e, padded[r0:r0 + 22, c0:c0 + 14])
    halos = blocks.halos(parts)
    top, bot, left, right = halos[5]
    assert torch.equal(top, g[15:16, 8:16]) and bot is None
    assert torch.equal(left, g[16:32, 7]) and torch.equal(right, g[16:32, 16])
    with pytest.raises(ValueError, match="deeper"):
        blocks.ext(parts, 9)
    full = blocks.gather(parts)  # one assembled field per device
    assert all(f is full[0] for f in full) and torch.equal(full[0], g)
