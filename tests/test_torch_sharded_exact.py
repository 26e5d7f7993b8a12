"""The exact all-gather advection of the port's multi-device steps against the
JAX package's exact routes and the port's own single-device steps.

``make_sharded_step_fn(..., advect_mode="exact")`` and
``make_sharded_step_fn_3d(..., advect_mode="exact")`` (``reference``
backend: the slab functions' plain twins, the exact gathers among them) run
on a virtual CPU mesh, one device listed once per slab.  Each gathered field
is assembled once per device (``parallel.mesh._gather``) and every slab
gathers from it at global coordinates.  JAX's exact routes run on the
virtual 8-device CPU mesh of ``tests/conftest.py``: ``_step_local`` (2-D,
its jnp block route) and ``_step3_local`` (3-D, its jnp z-slab route), the
field all-gathered by ``_gather_global`` / ``jax.lax.all_gather``.

Both start from the zero state with the same numpy sources, which fire on
the first of two steps and move the backtrace past the window (2 cells):
2-D at n = 62 by 3.13 cells (Jacobi) and 3.21 (Chebyshev), 3-D at n = 14
by 3.21 (parity) and 5.07 (compensated).  Every run asserts that its
audited displacement exceeds the window, so the windowed gather would clamp
and only the exact one can agree.  Tolerance atol 1e-5 (3-D: times the
field's magnitude, at least 1, as ``tests/test_torch_sharded3d.py``).
Measured max|Δ| to JAX: 2-D 4.5e-6 (Jacobi, on velocities up to 2.9) and
5.5e-6 (Chebyshev, up to 2.6, whose weight recurrence JAX runs in float32
and the port in float64); 3-D 3.9e-5 on fields up to 8.2 (parity, 4.7e-6
of the magnitude) and 5.4e-5 on fields up to 10.7 (compensated, 5.1e-6):
XLA's roundings of the solves, which the gathers carry along the random
velocities' steep gradients.  Against the port's single-device steps
(``ft.step`` and ``StableFluids3D.step``, which gather exactly under
``advect_mode="auto"``) the sharded steps are equal bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.kernels import (  # noqa: E402
    cuda_sharded_3d as cs3)
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    make_mesh, make_sharded_step_fn, make_sharded_step_fn_3d, mesh as tmesh,
    shard_state, shard_state_3d, unshard)
from fluidsimulationcuda_tpu.parallel import mesh as jmesh  # noqa: E402
from fluidsimulationcuda_tpu.parallel import sharded as jsharded  # noqa: E402
from fluidsimulationcuda_tpu.parallel import sharded3d as js3  # noqa: E402

CPU = torch.device("cpu")
CMAX = 2
STEPS = 2
ATOL = 1e-5
DT = 0.016

N2 = 62
SIDE2 = N2 + 2
# The 2-D velocity sources' upper bound by config: each moves the backtrace
# past the window, the Chebyshev solves (6 sweeps, under-converged) keeping
# several times more of the impulse than the Jacobi ones.
VEL2 = {"parity": 200.0, "chebyshev": 25.0}
CONFIGS2 = {
    "parity": dict(jacobi_iters=6),
    "chebyshev": dict(jacobi_iters=6, pressure_solver="chebyshev",
                      diffusion_solver="chebyshev", cheby_rho=0.9,
                      cheby_iters=6),
}
RUNS2 = [("parity", 4), ("parity", 8), ("chebyshev", 4), ("chebyshev", 8)]

N3 = 14
SIDE3 = N3 + 2
# The 3-D velocity sources' bound by config, in [-VEL3, VEL3].
VEL3 = {"parity": 800.0, "compensated": 400.0}
CONFIGS3 = {
    "parity": dict(jacobi_iters=3),
    "compensated": dict(jacobi_iters=3, pressure_solver="chebyshev",
                        diffusion_solver="chebyshev", cheby_rho=0.85,
                        cheby_iters=6),
}
# (config, slabs, advect_mode): 4 slabs of 4 planes and 8 of 2; "auto" on
# 2-plane slabs, too thin for the window, takes the exact gather in both
# packages.
RUNS3 = [("parity", 4, "exact"), ("parity", 8, "exact"),
         ("parity", 8, "auto"), ("compensated", 8, "exact")]
FIELDS3 = ("dens", "u", "v", "w")


# ---------------------------------------------------------------------------
# Inputs and runs
# ---------------------------------------------------------------------------


def _sources2(name):
    """A density source in the centred square, velocity sources in [0,
    ``VEL2[name]``) that move the backtrace past the window."""
    rng = np.random.default_rng(62)
    dens = rng.uniform(0.0, 0.099, (SIDE2, SIDE2)).astype(np.float32)
    band = np.zeros(SIDE2, bool)
    band[SIDE2 // 2 - SIDE2 // 8: SIDE2 // 2 + SIDE2 // 8] = True
    dens[~(band[:, None] & band[None, :])] = 0.0
    u, v = (rng.uniform(0.0, VEL2[name], (SIDE2, SIDE2)).astype(np.float32)
            for _ in range(2))
    return dens, u, v


def _sources3(name):
    """A density source in the centred cube, velocity sources in
    [-``VEL3[name]``, ``VEL3[name]``] that move the backtrace past the
    window."""
    rng = np.random.default_rng(14)
    dens = rng.uniform(0.0, 0.099, (SIDE3,) * 3).astype(np.float32)
    band = np.zeros(SIDE3, bool)
    band[SIDE3 // 2 - SIDE3 // 8: SIDE3 // 2 + SIDE3 // 8] = True
    dens[~(band[:, None, None] & band[None, :, None]
           & band[None, None, :])] = 0
    vel = [(rng.uniform(-1.0, 1.0, (SIDE3,) * 3)
            * VEL3[name]).astype(np.float32) for _ in range(3)]
    return (dens, *vel)


def _cfg2(name, **kw):
    return ft.SimConfig(n=N2, backend="reference", device="cpu",
                        **{"max_courant": CMAX, **CONFIGS2[name], **kw})


def _cfg3(name, **kw):
    return ft.SimConfig(n=N3, ndim=3, backend="reference", device="cpu",
                        **{"max_courant": CMAX, **CONFIGS3[name], **kw})


def _drive(step, state, sources, zero):
    states, disps = [], []
    for k in range(STEPS):
        state, disp = step(state, sources if k == 0 else zero)
        states.append([np.asarray(a) for a in state if a is not None])
        disps.append(float(disp))
    return states, disps


def _jax_run2(name, slabs):
    """JAX's exact route on a (slabs, 1) mesh: ``_step_local``."""
    cfg = fj.SimConfig(n=N2, max_courant=CMAX, **CONFIGS2[name])
    mesh = jmesh.make_mesh(jax.devices()[:slabs], shape=(slabs, 1))
    step = jsharded.make_sharded_step_fn(cfg, mesh, advect_mode="exact",
                                         audited=True)
    assert step.shard_backend == "reference"
    src = fj.Sources(*(jnp.asarray(a) for a in _sources2(name)))
    return _drive(step, jsharded.shard_state(fj.zero_state(cfg), mesh),
                  jsharded.shard_state(src, mesh),
                  jsharded.shard_state(fj.zero_sources(cfg), mesh))


def _jax_run3(name, slabs, mode):
    """JAX's jnp z-slab route (``_step3_local``) in ``mode``."""
    cfg = fj.SimConfig(n=N3, ndim=3, max_courant=CMAX, **CONFIGS3[name])
    mesh = jmesh.make_mesh(jax.devices()[:slabs])
    step = js3.make_sharded_step_fn_3d(cfg, mesh, advect_mode=mode,
                                       shard_backend="reference",
                                       audited=True)
    src = fj.Sources(*(jnp.asarray(a) for a in _sources3(name)))
    return _drive(step, js3.shard_state_3d(fj.zero_state(cfg), mesh),
                  js3.shard_state_3d(src, mesh),
                  js3.shard_state_3d(fj.zero_sources(cfg), mesh))


def _torch_drive(step, state, sources, zero, shard):
    """``STEPS`` steps of a port sharded step; each state unsharded."""
    out = []
    state = shard(state)
    for k in range(STEPS):
        state, disp = step(state, shard(sources if k == 0 else zero))
        out.append((unshard(state), float(disp)))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(*run):
        if run not in cache:
            cache[run] = (_jax_run2(*run) if len(run) == 2
                          else _jax_run3(*run))
        return cache[run]

    return get


# ---------------------------------------------------------------------------
# The exact steps against JAX's exact routes
# ---------------------------------------------------------------------------


def _torch_states2(name, slabs):
    cfg = _cfg2(name)
    mesh = make_mesh([CPU] * slabs)
    step = make_sharded_step_fn(cfg, mesh, advect_mode="exact", audited=True)
    src = ft.Sources(*(torch.from_numpy(a) for a in _sources2(name)))
    runs = _torch_drive(step, ft.zero_state(cfg), src, ft.zero_sources(cfg),
                        functools.partial(shard_state, mesh=mesh))
    return step, runs


def _torch_states3(name, slabs, mode):
    cfg = _cfg3(name)
    mesh = make_mesh([CPU] * slabs)
    step = make_sharded_step_fn_3d(cfg, mesh, advect_mode=mode, audited=True)
    src = ft.Sources(*map(torch.from_numpy, _sources3(name)))
    runs = _torch_drive(step, ft.zero_state(cfg), src, ft.zero_sources(cfg),
                        functools.partial(shard_state_3d, mesh=mesh))
    return step, runs


def _close(runs, want, names, scaled=False):
    for k, ((state, _), w_state) in enumerate(zip(runs, want)):
        for name, g, w in zip(names, state, w_state):
            g = g.numpy()
            assert np.isfinite(g).all()
            scale = max(1.0, float(np.abs(w).max())) if scaled else 1.0
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * scale,
                                       err_msg=f"step {k + 1} {name}")


@pytest.mark.parametrize("name,slabs", RUNS2,
                         ids=[f"{n}-{s}slabs" for n, s in RUNS2])
def test_exact_step_matches_jax(jax_runs, name, slabs):
    step, runs = _torch_states2(name, slabs)
    want, want_disps = jax_runs(name, slabs)
    assert step.shard_backend == "slab" and step.advect_mode == "exact"
    assert step.routes["density"] == "composed"
    disps = [d for _, d in runs]
    assert max(disps) > CMAX  # past the window: only the exact gather agrees
    np.testing.assert_allclose(disps, want_disps, rtol=1e-6)
    _close(runs, want, ("dens", "u", "v"))


@pytest.mark.parametrize("name,slabs,mode", RUNS3,
                         ids=[f"{n}-{s}slabs-{m}" for n, s, m in RUNS3])
def test_exact_step3_matches_jax(jax_runs, name, slabs, mode):
    step, runs = _torch_states3(name, slabs, mode)
    want, want_disps = jax_runs(name, slabs, mode)
    assert step.shard_backend == "slab" and step.advect_mode == "exact"
    disps = [d for _, d in runs]
    assert max(disps) > CMAX
    np.testing.assert_allclose(disps, want_disps, rtol=1e-5)
    _close(runs, want, FIELDS3, scaled=True)


# ---------------------------------------------------------------------------
# The exact steps against the port's single-device steps, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,slabs", [("parity", 1), *RUNS2],
                         ids=[f"{n}-{s}slabs" for n, s in
                              [("parity", 1), *RUNS2]])
def test_exact_step_equals_single_device(name, slabs):
    cfg = _cfg2(name)
    assert cfg.advect_mode == "auto"  # the single-device step gathers exactly
    _, runs = _torch_states2(name, slabs)
    src = ft.Sources(*(torch.from_numpy(a) for a in _sources2(name)))
    single = ft.zero_state(cfg)
    for k, (state, disp) in enumerate(runs):
        single = ft.step(cfg, single, src if k == 0 else
                         ft.zero_sources(cfg))
        for a, b in zip(state[:3], single[:3]):
            assert torch.equal(a, b), f"step {k + 1}"
    assert max(d for _, d in runs) > CMAX


@pytest.mark.parametrize("name,slabs,mode", [("parity", 1, "exact"), *RUNS3],
                         ids=[f"{n}-{s}slabs-{m}" for n, s, m in
                              [("parity", 1, "exact"), *RUNS3]])
def test_exact_step3_equals_single_device(name, slabs, mode):
    cfg = _cfg3(name)
    _, runs = _torch_states3(name, slabs, mode)
    src = ft.Sources(*map(torch.from_numpy, _sources3(name)))
    sim, single = ft.StableFluids3D(cfg), ft.zero_state(cfg)
    for k, (state, disp) in enumerate(runs):
        single = sim.step(single, src if k == 0 else ft.zero_sources(cfg))
        for a, b in zip(state, single):
            assert torch.equal(a, b), f"step {k + 1}"
    assert max(d for _, d in runs) > CMAX


def test_windowed_step_departs_past_the_window():
    """The same run windowed clamps its gathers and differs from the exact
    step: the displacement really is past the window."""
    cfg = _cfg2("parity")
    mesh = make_mesh([CPU] * 4)
    src = ft.Sources(*(torch.from_numpy(a) for a in _sources2("parity")))
    shard = functools.partial(shard_state, mesh=mesh)
    exact = _torch_drive(make_sharded_step_fn(cfg, mesh, advect_mode="exact",
                                              audited=True),
                         ft.zero_state(cfg), src, ft.zero_sources(cfg), shard)
    windowed = _torch_drive(make_sharded_step_fn(cfg, mesh, audited=True),
                            ft.zero_state(cfg), src, ft.zero_sources(cfg),
                            shard)
    assert not torch.equal(exact[0][0].u, windowed[0][0].u)


# ---------------------------------------------------------------------------
# One slab operation against JAX's, and the all-gather
# ---------------------------------------------------------------------------


def _field(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, shape) * scale).astype(np.float32)


@pytest.mark.parametrize("slab", [0, 1, 3])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_advect_slab_exact_plain_matches_jax_advect_local(b, slab):
    """``advect_slab_exact`` (its plain version, on CPU tensors) on one of
    4 slabs against JAX's ``_advect_local`` under ``shard_map``, at
    displacements up to 9 cells."""
    slabs, m = 4, SIDE2 // 4
    d0 = _field(1, (SIDE2, SIDE2))
    u, v = (_field(s, (SIDE2, SIDE2), 9.0 / (DT * N2)) for s in (2, 3))
    jm = jmesh.make_mesh(jax.devices()[:slabs], shape=(slabs, 1))
    spec = P("x", "y")
    local = jax.jit(jax.shard_map(
        lambda d, uu, vv: jsharded._advect_local(b, d, uu, vv, DT, N2,
                                                 slabs, 1),
        mesh=jm, in_specs=(spec,) * 3, out_specs=spec))
    want = np.asarray(local(*(jnp.asarray(a) for a in (d0, u, v))))
    flags = (int(slab == 0), int(slab == slabs - 1), slab * m)
    rows = slice(slab * m, (slab + 1) * m)
    tu, tv = (torch.from_numpy(np.ascontiguousarray(a[rows]))
              for a in (u, v))
    (got,) = cs.advect_slab_exact((b,), (torch.from_numpy(d0),), tu, tv,
                                  flags, dt=DT, n=N2, m=m, self_adv=False)
    np.testing.assert_allclose(got.numpy(), want[rows], rtol=0, atol=ATOL)
    plain = cs.advect_slab_exact_plain((b,), (torch.from_numpy(d0),), tu, tv,
                                       flags, dt=DT, n=N2, m=m,
                                       self_adv=False)
    assert torch.equal(got, plain[0])


@pytest.mark.parametrize("slab", [0, 3, 7])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_advect3_slab_exact_plain_matches_jax(b, slab):
    """``advect3_flat_slab_exact`` on one of 8 z-slabs of 2 planes (thinner
    than any window) against JAX's ``_advect3_local_exact`` under
    ``shard_map``, at displacements up to 7 cells."""
    slabs, mz = 8, SIDE3 // 8
    d0 = _field(4, (SIDE3,) * 3)
    u, v, w = (_field(s, (SIDE3,) * 3, 7.0 / (DT * N3)) for s in (5, 6, 7))
    zm = JMesh(np.array(jax.devices()[:slabs]), ("z",))
    spec = P("z")
    local = jax.jit(jax.shard_map(
        lambda d, uu, vv, ww: js3._advect3_local_exact(b, d, uu, vv, ww, DT,
                                                       N3, slabs),
        mesh=zm, in_specs=(spec,) * 4, out_specs=spec))
    want = np.asarray(local(*(jnp.asarray(a) for a in (d0, u, v, w))))
    flags = (int(slab == 0), int(slab == slabs - 1), slab * mz)
    planes = slice(slab * mz, (slab + 1) * mz)
    vel = [torch.from_numpy(np.ascontiguousarray(a[planes]))
           for a in (u, v, w)]
    (got,) = cs3.advect3_flat_slab_exact((b,), (torch.from_numpy(d0),), *vel,
                                         flags, dt=DT, n=N3, mz=mz)
    np.testing.assert_allclose(got.numpy(), want[planes], rtol=0, atol=ATOL)


def test_exact_pair_and_triple_share_one_backtrace():
    """The u/v pair (``self_adv``) and the (u, v, w) triple equal their
    fields gathered one at a time, bit for bit."""
    m, flags = SIDE2 // 4, (0, 0, SIDE2 // 4)
    u, v = (torch.from_numpy(_field(s, (SIDE2, SIDE2), 5.0 / (DT * N2)))
            for s in (8, 9))
    rows = slice(m, 2 * m)
    pair = cs.advect_slab_exact((1, 2), (u, v), None, None, flags, dt=DT,
                                n=N2, m=m, self_adv=True)
    for b, f, got in zip((1, 2), (u, v), pair):
        (one,) = cs.advect_slab_exact((b,), (f,), u[rows].contiguous(),
                                      v[rows].contiguous(), flags, dt=DT,
                                      n=N2, m=m, self_adv=False)
        assert torch.equal(got, one)
    mz, flags3 = 4, (0, 0, 4)
    vel = [torch.from_numpy(_field(s, (SIDE3,) * 3, 5.0 / (DT * N3)))
           for s in (10, 11, 12)]
    slab = [f[4:8].contiguous() for f in vel]
    triple = cs3.advect3_flat_slab_exact((1, 2, 3), vel, *slab, flags3,
                                         dt=DT, n=N3, mz=mz)
    for b, f, got in zip((1, 2, 3), vel, triple):
        (one,) = cs3.advect3_flat_slab_exact((b,), (f,), *slab, flags3,
                                             dt=DT, n=N3, mz=mz)
        assert torch.equal(got, one)


@pytest.mark.parametrize("bad", ["rows", "shape", "fields"])
def test_exact_wrappers_check_their_arguments(bad):
    m = SIDE2 // 4
    full = torch.zeros(SIDE2, SIDE2)
    vel = torch.zeros(m, SIDE2)
    args = dict(rows=((0,), (full,), vel, vel, (0, 0, SIDE2 - m + 1)),
                shape=((0,), (full[:-1],), vel, vel, (0, 0, 0)),
                fields=((0, 1, 2), (full,) * 3, vel, vel, (0, 0, 0)))[bad]
    with pytest.raises(ValueError):
        cs.advect_slab_exact(*args, dt=DT, n=N2, m=m, self_adv=False)
    vol = torch.zeros((SIDE3,) * 3)
    slab = torch.zeros(2, SIDE3, SIDE3)
    args3 = dict(rows=((0,), (vol,), slab, slab, slab, (0, 0, SIDE3 - 1)),
                 shape=((0,), (vol[:-1],), slab, slab, slab, (0, 0, 0)),
                 fields=((0,) * 4, (vol,) * 4, slab, slab, slab,
                         (0, 0, 0)))[bad]
    with pytest.raises(ValueError):
        cs3.advect3_flat_slab_exact(*args3, dt=DT, n=N3, mz=2)


class _Slab:
    """A slab on a named device: ``.to`` hands out its tensor."""

    def __init__(self, t, device):
        self.t, self.device = t, device

    def to(self, device):
        return self.t


@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_gather_assembles_one_field_per_device(monkeypatch, devices):
    """``_gather`` over 8 slabs builds the whole field once per distinct
    device (one ``torch.cat`` each), and every slab on a device reads that
    one tensor."""
    slabs = [torch.full((2, 4), float(i)) for i in range(8)]
    where = [f"card{i * devices // 8}" for i in range(8)]
    cats = []
    real_cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda xs, *a, **kw: (
        cats.append(len(xs)), real_cat(xs, *a, **kw))[1])
    fulls = tmesh._gather([_Slab(t, d) for t, d in zip(slabs, where)])
    assert cats == [8] * devices
    assert len({id(f) for f in fulls}) == devices
    for i, f in enumerate(fulls):
        assert f is fulls[where.index(where[i])]
        assert torch.equal(f, real_cat(slabs))


@pytest.mark.parametrize("ndim,slabs", [(2, 4), (2, 8), (3, 4), (3, 8)])
def test_exact_step_assembles_one_field_per_gathered_field(monkeypatch, ndim,
                                                           slabs):
    """One exact step on a one-device mesh: each gathered field (the u/v or
    u/v/w self-advection's and the density) is assembled by one
    ``torch.cat`` of every slab, and every slab gathers from that one
    tensor, not from a copy of its own."""
    if ndim == 2:
        import fluidsimulationcuda_torch.parallel.sharded as mod
        cfg, shard, make = _cfg2("parity"), shard_state, make_sharded_step_fn
        src = ft.Sources(*(torch.from_numpy(a) for a in _sources2("parity")))
    else:
        import fluidsimulationcuda_torch.parallel.sharded3d as mod
        cfg, shard = _cfg3("parity"), shard_state_3d
        make = make_sharded_step_fn_3d
        src = ft.Sources(*map(torch.from_numpy, _sources3("parity")))
    cats, gathers = [], []
    real_cat = torch.cat

    def spy(xs):
        before = len(cats)
        fulls = tmesh._gather(xs)
        gathers.append((len(xs), len(cats) - before,
                        len({id(f) for f in fulls})))
        return fulls

    monkeypatch.setattr(torch, "cat", lambda xs, *a, **kw: (
        cats.append(len(xs)), real_cat(xs, *a, **kw))[1])
    monkeypatch.setattr(mod, "_gather", spy)
    mesh = make_mesh([CPU] * slabs)
    step = make(cfg, mesh, advect_mode="exact")
    step(shard(ft.zero_state(cfg), mesh), shard(src, mesh))
    assert gathers == [(slabs, 1, 1)] * (ndim + 1)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "slab"])
def test_exact_runs_on_the_slab_route(backend):
    step = make_sharded_step_fn(_cfg2("parity"), make_mesh([CPU] * 4),
                                advect_mode="exact", shard_backend=backend)
    assert (step.shard_backend, step.advect_mode) == ("slab", "exact")
    assert step.routes == {"projection": "fused", "density": "composed"}


@pytest.mark.parametrize("mode,want", [("auto", "windowed"),
                                       ("windowed", "windowed"),
                                       ("exact", "exact")])
def test_advect_mode_reports_the_mode_taken(mode, want):
    mesh = make_mesh([CPU] * 4)
    assert make_sharded_step_fn(_cfg2("parity"), mesh,
                                advect_mode=mode).advect_mode == want
    assert make_sharded_step_fn_3d(_cfg3("parity"), mesh,
                                   advect_mode=mode).advect_mode == want


@pytest.mark.parametrize("slabs,cmax,want", [(8, 1, "windowed"),
                                             (8, 2, "exact"),
                                             (4, 3, "windowed"),
                                             (4, 4, "exact")])
def test_auto_takes_the_exact_gather_on_thin_z_slabs(slabs, cmax, want):
    """JAX's rule (``sharded3d.py:799-800``): windowed where every slab
    holds ``max_courant+1`` planes, exact otherwise."""
    cfg = _cfg3("parity", max_courant=cmax)
    step = make_sharded_step_fn_3d(cfg, make_mesh([CPU] * slabs))
    assert step.advect_mode == want


def test_2d_mesh_flattens_under_exact():
    """A (2, 2) mesh runs the exact step as the (4, 1) mesh of its devices,
    bit for bit."""
    cfg = _cfg2("parity")
    src = ft.Sources(*(torch.from_numpy(a) for a in _sources2("parity")))
    out = []
    for shape in ((2, 2), (4, 1)):
        mesh = make_mesh([CPU] * 4, shape=shape)
        step = make_sharded_step_fn(cfg, mesh, advect_mode="exact")
        assert step.mesh.shape == {"x": 4, "y": 1}
        out.append(unshard(step(shard_state(ft.zero_state(cfg), step.mesh),
                                shard_state(src, step.mesh))))
    for a, b in zip(*out):
        if a is not None:
            assert torch.equal(a, b)
