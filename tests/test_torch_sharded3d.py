"""The port's 3-D multi-device step against the JAX package's z-slab route.

The port's ``make_sharded_step_fn_3d`` (``reference`` backend: the z-slab
functions' plain twins) runs on a virtual CPU mesh, one device listed once
per slab; JAX's ``make_sharded_step_fn_3d(..., advect_mode="windowed",
shard_backend="reference")`` (its jnp z-slab route, which its own tests hold
to its Pallas slab route within 2e-6) runs on the virtual 8-device CPU mesh
of ``tests/conftest.py``.  Both start from the zero state with the same
numpy sources, at n = 14, and take two steps (sources on the first).  The
velocity sources are scaled so the impulse moves the backtrace 0.8-2.6
cells: under the window of 2 on 4 slabs, over the window of 1 on 8 slabs, so
both the exact and the clamped gather are compared.  Each JAX configuration
runs once per module.  Tolerance atol 1e-5 times the field's magnitude
(at least 1).  The parity runs agree within 1e-5; the compensated run
differs by up to 1.2e-5 on velocities of 4.5 (2.6e-6 of the field's
magnitude, some 20 ulp, on 337 of 4096 cells above 1e-6): its audited
displacement already differs in the eighth digit before any gather, so the
Chebyshev solves round differently under XLA, not the slab logic, and the
projection's cancellations leave that error on small values too.

Runs: parity on 4 slabs of 4 planes (segments of 3 sweeps, cmax 2); parity
on 8 slabs of 2 planes (1-sweep segments, cmax 1); the compensated mode with
``cheby_iters=6`` on 8 slabs, whose every solve is a chain of 1-sweep
segments across halo exchanges.  Against the port's own single-device step
the sharded step is bit-identical while the audited displacement stays
under the window.
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
    make_mesh, make_sharded_step_fn_3d, shard_state_3d, unshard)
from fluidsimulationcuda_tpu.parallel import mesh as jmesh  # noqa: E402
from fluidsimulationcuda_tpu.parallel import sharded3d as js3  # noqa: E402

N = 14
SIDE = N + 2
CPU = torch.device("cpu")
VEL_SCALE = 200.0  # velocity sources in [-200, 200]
CONFIGS = {
    "parity": dict(jacobi_iters=3),
    "compensated": dict(jacobi_iters=3, pressure_solver="chebyshev",
                        diffusion_solver="chebyshev", cheby_rho=0.85,
                        cheby_iters=6),
}
# (config, slabs, max_courant) that JAX runs, each once per module.
RUNS = [("parity", 4, 2), ("parity", 8, 1), ("compensated", 8, 1)]
STEPS = 2
ATOL = 1e-5
FIELDS = ("dens", "u", "v", "w")


def _sources():
    """A density source in the centred cube, random velocity sources."""
    rng = np.random.default_rng(14)
    dens = rng.uniform(0.0, 0.099, (SIDE,) * 3).astype(np.float32)
    band = np.zeros(SIDE, bool)
    band[SIDE // 2 - SIDE // 8: SIDE // 2 + SIDE // 8] = True
    dens[~(band[:, None, None] & band[None, :, None] & band[None, None, :])] = 0
    vel = [(rng.uniform(-1.0, 1.0, (SIDE,) * 3) * VEL_SCALE).astype(np.float32)
           for _ in range(3)]
    return (dens, *vel)


def _cfg(name, cmax, **kw):
    return ft.SimConfig(n=N, ndim=3, max_courant=cmax, backend="reference",
                        device="cpu", **{**CONFIGS[name], **kw})


def _jax_run(name, slabs, cmax):
    """(states after each step, audited displacements) of JAX's jnp z-slab
    route."""
    cfg = fj.SimConfig(n=N, ndim=3, max_courant=cmax, **CONFIGS[name])
    mesh = jmesh.make_mesh(jax.devices()[:slabs])
    step = js3.make_sharded_step_fn_3d(cfg, mesh, advect_mode="windowed",
                                       shard_backend="reference",
                                       audited=True)
    sources = js3.shard_state_3d(
        fj.Sources(*(jnp.asarray(a) for a in _sources())), mesh)
    zero = js3.shard_state_3d(fj.zero_sources(cfg), mesh)
    state = js3.shard_state_3d(fj.zero_state(cfg), mesh)
    states, disps = [], []
    for k in range(STEPS):
        state, disp = step(state, sources if k == 0 else zero)
        states.append([np.asarray(a) for a in state])
        disps.append(float(disp))
    return states, disps


def _torch_run(name, slabs, cmax, mesh_shape=None, **kw):
    cfg = _cfg(name, cmax, **kw)
    mesh = make_mesh([CPU] * slabs, shape=mesh_shape)
    step = make_sharded_step_fn_3d(cfg, mesh, advect_mode="windowed",
                                   audited=True)
    sources = shard_state_3d(ft.Sources(*map(torch.from_numpy, _sources())),
                             mesh)
    zero = shard_state_3d(ft.zero_sources(cfg), mesh)
    state = shard_state_3d(ft.zero_state(cfg), mesh)
    states, disps = [], []
    for k in range(STEPS):
        state, disp = step(state, sources if k == 0 else zero)
        states.append([t.numpy() for t in unshard(state)])
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
        for name, g, w in zip(FIELDS, g_state, w_state):
            assert np.isfinite(g).all()
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * scale,
                                       err_msg=f"step {k + 1} {name}")


@pytest.mark.parametrize("name,slabs,cmax", RUNS,
                         ids=[f"{n}-{s}slabs-cmax{c}" for n, s, c in RUNS])
def test_sharded3d_step_matches_jax(jax_runs, name, slabs, cmax):
    step, states, disps = _torch_run(name, slabs, cmax)
    want, want_disps = jax_runs(name, slabs, cmax)
    assert step.shard_backend == "slab" and step.advect_mode == "windowed"
    _close(states, want)
    np.testing.assert_allclose(disps, want_disps, rtol=1e-6)


def test_runs_cover_both_sides_of_the_window(jax_runs):
    """The 4-slab run stays under its 2-cell window, the compensated run
    goes over its 1-cell window, so both gathers are exercised."""
    _, disps = jax_runs("parity", 4, 2)
    assert 0.3 < max(disps) < 2
    _, disps = jax_runs("compensated", 8, 1)
    assert max(disps) > 1


def test_2d_mesh_flattens_to_z_slabs(jax_runs):
    """A (2, 2) mesh runs as the 4 z-slabs of its devices, bit-identical
    to the explicit (4, 1) mesh."""
    step, states, _ = _torch_run("parity", 4, 2, mesh_shape=(2, 2))
    assert step.mesh.shape == {"x": 4, "y": 1}
    _, rows, _ = _torch_run("parity", 4, 2)
    for a, b in zip(states, rows):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,slabs,cmax", [("parity", 1, 2),
                                             ("parity", 4, 2),
                                             ("parity", 8, 1),
                                             ("compensated", 8, 1)])
def test_sharded3d_step_matches_single_device(name, slabs, cmax):
    """Three steps on z-slabs equal three ``StableFluids3D`` steps while the
    audited displacement stays under max_courant (the gathers are then
    exact); the sources are scaled down to keep it there."""
    cfg = _cfg(name, cmax)
    mesh = make_mesh([CPU] * slabs)
    step = make_sharded_step_fn_3d(cfg, mesh, audited=True)
    sources = ft.Sources(*(torch.from_numpy(a) * 0.2 for a in _sources()))
    sim = ft.StableFluids3D(cfg)
    single, sharded = ft.zero_state(cfg), shard_state_3d(ft.zero_state(cfg),
                                                         mesh)
    for k in range(3):
        src = sources if k == 0 else ft.zero_sources(cfg)
        sharded, disp = step(sharded, shard_state_3d(src, mesh))
        single = sim.step(single, src)
        assert 0 < float(disp) < cfg.max_courant
    for a, b in zip(unshard(sharded), single):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name,slabs,chunks", [
    ("parity", 4, (3, 4)),       # 3 sweeps fit the 4-plane slab: one segment
    ("parity", 8, (1, 2)),       # 2-plane slabs: 1-sweep segments
    ("compensated", 8, (1, 2)),
    ("parity", 1, (3, 4)),       # one slab: K is the solve's own sweeps
])
def test_chunks(name, slabs, chunks):
    step = make_sharded_step_fn_3d(_cfg(name, 1), make_mesh([CPU] * slabs))
    assert set(step.chunks.values()) == {chunks}


def test_fast_math_reaches_every_solve_of_the_cuda_route_only():
    from fluidsimulationcuda_torch.kernels.dispatch import get_slab3_ops

    cfg = _cfg("compensated", 1, fast_math=True)
    assert not get_slab3_ops(cfg).fast  # the reference backend ignores it
    cuda = ft.SimConfig(n=N, ndim=3, fast_math=True, backend="cuda")
    assert get_slab3_ops(cuda).fast


def test_shard_state_3d_round_trip():
    cfg = _cfg("parity", 2)
    mesh = make_mesh([CPU] * 4)
    src = ft.Sources(*map(torch.from_numpy, _sources()))
    slabs = shard_state_3d(src, mesh)
    assert len(slabs.w) == 4 and tuple(slabs.w[0].shape) == (4, SIDE, SIDE)
    for a, b in zip(unshard(slabs), src):
        assert torch.equal(a, b)
    assert slabs.u[0].data_ptr() != src.u.data_ptr()  # a copy
    with pytest.raises(ValueError, match="divisible"):
        shard_state_3d(ft.zero_state(cfg), make_mesh([CPU] * 3))


def test_step_needs_z_slabs():
    cfg = _cfg("parity", 2)
    step = make_sharded_step_fn_3d(cfg, make_mesh([CPU] * 4))
    with pytest.raises(TypeError, match="slabs"):
        step(ft.zero_state(cfg), ft.zero_sources(cfg))


# ---------------------------------------------------------------------------
# Gates, as JAX's (sharded3d.py:776-806); nothing falls back quietly
# ---------------------------------------------------------------------------


def test_rejects_a_side_that_does_not_divide():
    cfg = ft.SimConfig(n=15, ndim=3, device="cpu")  # side 17
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_step_fn_3d(cfg, make_mesh([CPU] * 4))


def test_rejects_slabs_thinner_than_the_window():
    cfg = _cfg("parity", 2)  # 2-plane slabs on 8 devices, window needs 3
    mesh = make_mesh([CPU] * 8)
    with pytest.raises(ValueError, match="planes per shard"):
        make_sharded_step_fn_3d(cfg, mesh, advect_mode="windowed")
    # Where JAX's "auto" takes the exact all-gather, so does the port's now
    # (tests/test_torch_sharded_exact.py holds it against JAX's).
    assert make_sharded_step_fn_3d(cfg, mesh).advect_mode == "exact"


def test_rejects_one_plane_slabs():
    cfg = _cfg("parity", 0)
    with pytest.raises(ValueError, match=">= 2 planes"):
        make_sharded_step_fn_3d(cfg, make_mesh([CPU] * 16))


def test_rejects_exact_advection():
    """The exact all-gather advection runs on z-slabs now
    (``tests/test_torch_sharded_exact.py``): the one exact request still
    refused is an unknown mode's, and nothing exact quietly becomes
    windowed."""
    step = make_sharded_step_fn_3d(_cfg("parity", 1), make_mesh([CPU] * 4),
                                   advect_mode="exact")
    assert step.advect_mode == "exact"
    with pytest.raises(ValueError, match="advect_mode"):
        make_sharded_step_fn_3d(_cfg("parity", 1), make_mesh([CPU] * 4),
                                advect_mode="Exact")


@pytest.mark.parametrize("solver", ["multigrid", "cg"])
def test_rejects_the_2d_solvers(solver):
    with pytest.raises(ValueError, match="jacobi"):
        make_sharded_step_fn_3d(_cfg("parity", 1, pressure_solver=solver),
                                make_mesh([CPU] * 4))


def test_rejects_a_2d_config_and_unknown_options():
    mesh = make_mesh([CPU] * 4)
    with pytest.raises(ValueError, match="ndim == 3"):
        make_sharded_step_fn_3d(ft.SimConfig(n=14, device="cpu"), mesh)
    with pytest.raises(ValueError, match="advect_mode"):
        make_sharded_step_fn_3d(_cfg("parity", 1), mesh,
                                advect_mode="sideways")
    with pytest.raises(ValueError, match="shard_backend"):
        make_sharded_step_fn_3d(_cfg("parity", 1), mesh,
                                shard_backend="pallas")


def test_reference_route_is_the_reference_backend():
    """JAX's ``shard_backend="reference"`` (its jnp z-slab route) is the
    z-slab route on the plain twins, which the config's backend selects."""
    with pytest.raises(ValueError, match="backend='reference'"):
        make_sharded_step_fn_3d(_cfg("parity", 1), make_mesh([CPU] * 4),
                                shard_backend="reference")
