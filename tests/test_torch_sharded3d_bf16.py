"""bf16 storage on the 3-D z-slab step (``make_sharded_step_fn_3d`` with
``dtype=torch.bfloat16``) against the JAX package.

JAX's bf16 z-slab step is its jnp per-slab program ``_step3_local`` under
``shard_map`` (its Pallas z-slab route takes float32 only,
``parallel/sharded3d.py:814-818``).  Its bf16 gathers
(``_advect3_local_exact``, ``_advect3_local_windowed``) compute the
backtrace coordinates and the blend in bf16, which cannot resolve a
fraction of a cell at these sides
(``test_jax_bf16_slab_gather_loses_the_cell`` pins it); the port gathers
in float32 and rounds once.  So the oracle is JAX's own ``_step3_local``
with those two functions swapped (pytest's ``monkeypatch`` on the module
attribute) for the same functions run on float32-widened inputs and
rounded once.  It runs eagerly, op by op (``jax.disable_jit``), with the
slabs as a batch axis named "z" (``jax.vmap``; its one-slab halo shifts,
a partial ``ppermute``, which vmap does not take, move the same data
through ``all_gather``).  JAX's jitted ``shard_map`` program of the same
step rounds as that eager run except where XLA's CPU compile fuses a
float32 product into a sum: there it rounds once (a fused multiply-add),
so the gathers' departure ``xx - dt0*u`` moves by a float32 rounding
(``test_xla_fusion_rounds_the_gathers_coordinates_once``: with XLA's
``fusion`` pass off, JAX's jitted slab gather equals the port's bit for
bit; with it on, a few cells move by a bf16 unit, which a step's
projection spreads; the jitted step's gap is pinned by
``test_jax_jitted_zslab_step_differs_by_its_fused_gathers``).  Nothing
in the JAX package changes.

- (a) The port's ``reference`` bf16 z-slab step equals the oracle bit for
  bit after two steps (impulse sources on the first) at n = 14 and 30 on
  4 and 8 slabs: parity, compensated (with fast math, which both ignore
  there), ``chebyshev-dens``; windowed in a 2-cell window on 4-plane
  slabs and a 1-cell window on 8-plane slabs (sources the windows
  cross), exact on 4-plane slabs (``"auto"`` under the default 4-cell
  window).  The two packages chunk the solves differently (JAX K = 3 on
  8-plane slabs and 1 on 4-plane slabs; the port 4-7 and 3), which
  changes no bit.  On 2 slabs it is held to JAX's jitted program within
  that program's gap.
- (b) The same step equals the port's single-device ``reference`` bf16
  ``step3`` bit for bit under exact gathers (``"auto"`` on 4- and 2-plane
  slabs).
- (c) The kernels' plain twins composed into the z-slab step
  (``_ZSlabStep(..., plain=True)`` on a ``cuda`` config, what the bf16
  kernels equal bit for bit on the card) equal the single-device twins'
  step (``step3`` on ``_Ops3(cfg, plain=True)``) bit for bit, with solves
  of up to eight segments.
- (d) JAX's own bf16 slab gather at n = 126 lies rel-L2 0.347 from its
  float32 gather on the same values; the port's 0.0017, one bf16
  rounding.

The same numpy arrays, drawn from ``np.random.default_rng``, go to both
packages; each rounds them to bf16.  Each JAX run is cached per module.
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
from fluidsimulationcuda_torch.kernels import cuda_sharded_3d as cs3  # noqa: E402
from fluidsimulationcuda_torch.models.stable_fluids_3d import _Ops3  # noqa: E402
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    make_mesh, make_sharded_step_fn_3d, shard_state_3d, unshard)
from fluidsimulationcuda_torch.parallel.sharded3d import _ZSlabStep  # noqa: E402
from fluidsimulationcuda_tpu.parallel import mesh as jmesh  # noqa: E402
from fluidsimulationcuda_tpu.parallel import sharded3d as js3  # noqa: E402

CPU = torch.device("cpu")
BF16 = torch.bfloat16
DT = 0.016
STEPS = 2
CMAX = 4  # SimConfig.max_courant's default: "auto" is exact below 5 planes
# Few sweeps: JAX's bf16 program runs eagerly, op by op (``_jax_run``), so
# its time grows with them; enough for solves of several segments.
MODES = {
    "parity": dict(jacobi_iters=4),
    "compensated": dict(pressure_solver="chebyshev",
                        diffusion_solver="chebyshev", cheby_rho=0.85,
                        cheby_iters=6, cheby_press_iters=8, fast_math=True),
    "chebyshev-dens": dict(jacobi_iters=4, diffusion_solver="chebyshev-dens",
                           cheby_rho=0.85, cheby_dens_iters=6),
}
# (n, slabs, mode, max_courant, advect_mode) of the JAX runs held bit for
# bit: windowed gathers in a 2-cell window on 4-plane slabs (the thinnest
# that takes it at n = 14) and in a 1-cell window, which their sources
# cross, and the exact gather that "auto" takes on 4-plane slabs under the
# default window.  JAX run eagerly dominates this file (~30-45 s a run);
# its windowed gather sums (2*cmax+1)^3 masked shifts, 125 in a 2-cell
# window and 729 in the default 4-cell one, whose runs take minutes, so
# the 4-cell window's bf16 gathers are held to their twins on the card
# and behind the CPU shim (tests/test_torch_rehearse_bf16_slab3.py), and
# "auto" on 2-plane slabs to the single-device step (b).
RUNS = [(14, 4, "parity", 2, "windowed"),
        (30, 4, "compensated", 1, "windowed"),
        (30, 8, "chebyshev-dens", CMAX, "auto")]
# JAX's jitted program, held to its stated gap.
JIT_RUN = (30, 2, "parity", CMAX, "exact")
IDS = [f"n{n}-{s}slabs-{m}-{g}" for n, s, m, _, g in RUNS]


def _sources(n: int, windowed: bool):
    """reference_init's distributions in 3-D, drawn with numpy; for the
    windowed runs velocity sources that move the backtrace past the
    4-cell window on the first step."""
    rng = np.random.default_rng(n)
    side = n + 2
    shape = (side,) * 3
    dens = rng.uniform(0.0, 0.099, shape).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None, None] & band[None, :, None] & band[None, None, :])] = 0
    scale = 8.0 / (DT * DT * n) if windowed else 0.99
    vel = [(rng.uniform(-1.0, 1.0, shape) * scale).astype(np.float32)
           for _ in range(3)]
    return [dens, *vel]


def _bits(x) -> np.ndarray:
    """The raw bf16 words of a port tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _widened(gather):
    """JAX's slab gather ``gather`` on float32-widened fields and
    velocities, rounded to the field's dtype once."""
    def widened(b, d0, u, v, w, *rest):
        f32 = [a.astype(jnp.float32) for a in (d0, u, v, w)]
        return gather(b, *f32, *rest).astype(d0.dtype)

    return widened


def _partial_ppermute(size: int):
    """``lax.ppermute`` for a batch axis: vmap takes only a full
    permutation, and ``_extend_z`` shifts by one slab, the wall slabs
    receiving zeros.  The same data movement through ``all_gather``."""
    def ppermute(x, axis_name, perm):
        sources = dict((d, s) for s, d in perm)
        table = jnp.asarray([sources.get(d, -1) for d in range(size)])
        s = table[jax.lax.axis_index(axis_name)]
        full = jax.lax.all_gather(x, axis_name)
        return jnp.where(s >= 0, full[jnp.maximum(s, 0)], jnp.zeros_like(x))

    return ppermute


def _jax_run(n, slabs, mode, cmax, advect_mode):
    """The oracle's state after ``STEPS`` steps as raw bf16 words, the
    mode it took and its largest audited displacement: JAX's
    ``_step3_local`` run eagerly, op by op, on the slabs as a batch axis
    named "z" (``jax.vmap``), with the float32 gathers swapped in."""
    cfg = fj.SimConfig(n=n, ndim=3, dtype=jnp.bfloat16, max_courant=cmax,
                       **MODES[mode])
    side = n + 2
    # JAX's factory checks the geometry and resolves "auto"; it compiles
    # nothing until it is called.
    taken = js3.make_sharded_step_fn_3d(
        cfg, jmesh.make_mesh(jax.devices()[:slabs]),
        advect_mode=advect_mode, shard_backend="reference").advect_mode

    def cut(tree):
        return type(tree)(*(jnp.asarray(a).astype(jnp.bfloat16).reshape(
            slabs, side // slabs, side, side) for a in tree))

    src = cut(fj.Sources(*_sources(n, advect_mode == "windowed")))
    zeros, state = cut(fj.zero_sources(cfg)), cut(fj.zero_state(cfg))
    step = jax.vmap(functools.partial(js3._step3_local, cfg, slabs, taken,
                                      True), axis_name="z")
    disps = []
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        for name in ("_advect3_local_exact", "_advect3_local_windowed"):
            mp.setattr(js3, name, _widened(getattr(js3, name)))
        mp.setattr(jax.lax, "ppermute", _partial_ppermute(slabs))
        for k in range(STEPS):
            state, disp = step(state, src if k == 0 else zeros)
            disps.append(float(disp[0]))
    return (tuple(_bits(f).reshape((side,) * 3) for f in state), taken,
            max(disps))


def _jax_jit_run(n, slabs, mode, cmax, advect_mode):
    """The state after ``STEPS`` steps of JAX's own jitted step
    (``make_sharded_step_fn_3d``: ``_step3_local`` under ``shard_map``,
    XLA's default CPU compile), the float32 gathers swapped in, as raw
    bf16 words."""
    cfg = fj.SimConfig(n=n, ndim=3, dtype=jnp.bfloat16, max_courant=cmax,
                       **MODES[mode])
    src = fj.Sources(*(jnp.asarray(a).astype(jnp.bfloat16)
                       for a in _sources(n, advect_mode == "windowed")))
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_advect3_local_exact", "_advect3_local_windowed"):
            mp.setattr(js3, name, _widened(getattr(js3, name)))
        step = js3.make_sharded_step_fn_3d(
            cfg, jmesh.make_mesh(jax.devices()[:slabs]),
            advect_mode=advect_mode, shard_backend="reference")
        state, src, zeros = (js3.shard_state_3d(t, step.mesh) for t in (
            fj.zero_state(cfg), src, fj.zero_sources(cfg)))
        for k in range(STEPS):
            state = step(state, src if k == 0 else zeros)
    return tuple(_bits(f) for f in state)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(*run):
        if run not in cache:
            cache[run] = _jax_run(*run)
        return cache[run]

    return get


def _cfg(n, mode, cmax=CMAX, **kw):
    return ft.SimConfig(n=n, ndim=3, backend="reference", device="cpu",
                        dtype=BF16, max_courant=cmax, **{**MODES[mode], **kw})


def _twins_cfg(cfg):
    """``cfg`` on the ``cuda`` backend on the CPU, where only the plain
    twins run."""
    out = cfg.replace()
    object.__setattr__(out, "backend", "cuda")
    return out


def _drawn(n, windowed=False, dtype=BF16):
    """(zero state, sources, zero sources): the draw rounded to bf16, in
    ``dtype``."""
    src = ft.Sources(*(torch.from_numpy(a).to(BF16).to(dtype)
                       for a in _sources(n, windowed)))
    zero = ft.Sources(*(torch.zeros_like(t) for t in src))
    return ft.FluidState(*(torch.zeros_like(t) for t in src)), src, zero


def _sharded_run(cfg, slabs, step=None, advect_mode="auto", windowed=False):
    """The port's z-slab state after ``STEPS`` steps, unsharded, and the
    step function (``make_sharded_step_fn_3d`` unless given)."""
    mesh = make_mesh([CPU] * slabs)
    if step is None:
        step = make_sharded_step_fn_3d(cfg, mesh, advect_mode=advect_mode)
    state, src, zero = (shard_state_3d(t, mesh)
                        for t in _drawn(cfg.n, windowed, cfg.dtype))
    for k in range(STEPS):
        state = step(state, src if k == 0 else zero)
    return unshard(state), step


def _single_run(cfg, ops=None):
    state, src, zero = _drawn(cfg.n)
    for k in range(STEPS):
        state = ft.step3(cfg, state, src if k == 0 else zero, ops)
    return state


def _equal(got, want):
    for name, g, w in zip(("dens", "u", "v", "w"), got, want):
        assert g.dtype == BF16, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


# ---------------------------------------------------------------------------
# (a) The reference z-slab step against JAX's, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,slabs,mode,cmax,advect_mode", RUNS, ids=IDS)
def test_reference_bf16_zslab_step_equals_jax(jax_runs, n, slabs, mode, cmax,
                                              advect_mode):
    windowed = advect_mode == "windowed"
    got, step = _sharded_run(_cfg(n, mode, cmax), slabs,
                             advect_mode=advect_mode, windowed=windowed)
    want, taken, _ = jax_runs(n, slabs, mode, cmax, advect_mode)
    assert step.advect_mode == taken
    assert taken == ("windowed" if (n + 2) // slabs > cmax else "exact")
    for name, g, w in zip(("dens", "u", "v", "w"), got, want):
        assert g.dtype == BF16
        np.testing.assert_array_equal(_bits(g), w, err_msg=name)


def test_jax_jitted_zslab_step_differs_by_its_fused_gathers():
    """A recorded difference (ROADMAP §C): JAX's jitted ``shard_map``
    program, the one its factory runs, rounds the gathers' departure once
    where the eager oracle (and the port) rounds it twice
    (``test_xla_fusion_rounds_the_gathers_coordinates_once``): after two
    steps at n = 30 on 2 slabs (parity, exact gathers) it differs from
    the port's ``reference`` bf16 z-slab step in a cell of the density by
    a bf16 unit and equals it everywhere else."""
    n, slabs, mode, cmax, advect_mode = JIT_RUN
    got, _ = _sharded_run(_cfg(n, mode, cmax), slabs,
                          advect_mode=advect_mode)
    want = _jax_jit_run(*JIT_RUN)
    cells = []
    for name, g, w in zip(("dens", "u", "v", "w"), got, want):
        units = _units(_bits(g), w)
        cells.append(int((units > 0).sum()))
        print(f"{name}: {cells[-1]} of {units.size} cells differ, at most "
              f"{int(units.max())} bf16 units")
        assert units.max() <= 2, name
    assert 0 < sum(cells) <= 8


def test_windowed_runs_cross_the_window(jax_runs):
    """The windowed runs' sources move the backtrace past their window,
    so their gathers clamp: the window is exercised, not idle; the
    windowed bf16 step then differs from the exact one (here also in the
    4-cell window)."""
    for n, slabs, mode, cmax, advect_mode in RUNS:
        if advect_mode == "windowed":
            assert jax_runs(n, slabs, mode, cmax, advect_mode)[2] > cmax
    cfg = _cfg(14, "parity")
    windowed, _ = _sharded_run(cfg, 2, advect_mode="windowed", windowed=True)
    exact, _ = _sharded_run(cfg, 2, advect_mode="exact", windowed=True)
    assert any(not torch.equal(a, b) for a, b in zip(windowed, exact))


def test_chunkings_differ_on_four_plane_slabs():
    """On 8 slabs of 4 planes at n = 30 JAX chunks a solve in segments of
    K = 1 sweep (``min(8, iters, (mz-2)//2)`` falls to 1), the port in
    K = 3 with a 4-plane halo: the bit-for-bit run there shows that the
    chunking changes no bf16 number (its Jacobi solves 3 + 1 sweeps, its
    density's Chebyshev chain 3 + 3, x_{k-1} carried across)."""
    step = make_sharded_step_fn_3d(_cfg(30, "chebyshev-dens"),
                                   make_mesh([CPU] * 8))
    assert set(step.chunks.values()) == {(3, 4)}


# ---------------------------------------------------------------------------
# (b) Against the port's single-device reference step; (c) the twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slabs", [2, 4, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_reference_bf16_zslab_step_equals_single_device(mode, slabs):
    """Under exact gathers: "auto" takes them on the 4- and 2-plane slabs
    of 4 and 8 slabs (the default 4-cell window is deeper)."""
    cfg = _cfg(14, mode)
    got, step = _sharded_run(cfg, slabs,
                             advect_mode="exact" if slabs == 2 else "auto")
    assert step.advect_mode == "exact"
    _equal(got, _single_run(cfg))


TWIN_RUNS = [(14, 2, "parity"), (14, 4, "compensated"),
             (14, 8, "chebyshev-dens"), (30, 2, "compensated"),
             (30, 8, "compensated"), (30, 4, "parity")]


@pytest.mark.parametrize("n,slabs,mode", TWIN_RUNS,
                         ids=[f"n{n}-{s}slabs-{m}" for n, s, m in TWIN_RUNS])
def test_twins_zslab_step_equals_single_device_twins(n, slabs, mode):
    """The plain twins hand each solve's float32 iterate from segment to
    segment and round once at its end, as the single-device twins round
    once a solve: equal bit for bit with fast math (the fmaf sweeps) on,
    under exact gathers, on slabs of 16 down to 2 planes (on 4-plane
    slabs the 8 pressure sweeps run 3 + 3 + 2, on 2-plane slabs a segment
    a sweep)."""
    cfg = _twins_cfg(_cfg(n, mode))
    mesh = make_mesh([CPU] * slabs).reshape(slabs, 1)
    got, _ = _sharded_run(cfg, slabs, step=_ZSlabStep(cfg, mesh, False, True,
                                                      plain=True))
    _equal(got, _single_run(cfg, _Ops3(cfg, plain=True)))


def test_twins_and_reference_differ_in_bf16():
    """The twins round a solve once, JAX's jnp route (the reference forms)
    every sweep: the two bf16 z-slab steps differ; in float32 the two
    routes are one."""
    cfg = _cfg(14, "parity")
    twins = _twins_cfg(cfg)
    mesh = make_mesh([CPU] * 4).reshape(4, 1)
    ref, _ = _sharded_run(cfg, 4, advect_mode="exact")
    plain, _ = _sharded_run(twins, 4, step=_ZSlabStep(twins, mesh, False,
                                                      True, plain=True))
    assert any(not torch.equal(a, b) for a, b in zip(ref, plain))
    f32 = cfg.replace(dtype=torch.float32)
    f32_twins = _twins_cfg(f32)
    ref32, _ = _sharded_run(f32, 4, advect_mode="exact")
    plain32, _ = _sharded_run(f32_twins, 4, step=_ZSlabStep(
        f32_twins, mesh, False, True, plain=True))
    for a, b in zip(ref32, plain32):
        assert torch.equal(a, b)


def test_audited_bf16_zslab_step():
    """``audited=True`` on bf16 slabs: the state equals the plain step's
    bit for bit and the displacement is bf16, dt*n rounded to bf16 first,
    as JAX's ``_disp3_global`` takes it."""
    cfg = _cfg(14, "parity")
    mesh = make_mesh([CPU] * 4)
    state, src, _ = (shard_state_3d(t, mesh) for t in _drawn(14))
    got, disp = make_sharded_step_fn_3d(cfg, mesh, audited=True)(state, src)
    plain = make_sharded_step_fn_3d(cfg, mesh)(state, src)
    for a, b in zip(unshard(got), unshard(plain)):
        assert torch.equal(a, b)
    assert disp.dtype == BF16 and float(disp) > 0
    vel = unshard(got)
    # The second advection's displacement, from the step's own velocity
    # before its density gather: at most the audited one.
    top = max(float(f.abs().max()) for f in vel[1:])
    dt0 = torch.full((), DT * 14, dtype=BF16)
    assert float(disp) >= float(torch.tensor(top, dtype=BF16) * dt0)


def test_state_stays_bf16_on_every_route():
    cfg = _cfg(14, "compensated")
    for c, step in ((cfg, None), (_twins_cfg(cfg), _ZSlabStep(
            _twins_cfg(cfg), make_mesh([CPU] * 2).reshape(2, 1), False,
            False, plain=True))):
        got, _ = _sharded_run(c, 2, step=step, advect_mode="windowed",
                              windowed=True)
        assert all(f.dtype == BF16 and bool(torch.isfinite(f).all())
                   for f in got)


# ---------------------------------------------------------------------------
# The bf16 forms' entry checks, and JAX's bf16 gather
# ---------------------------------------------------------------------------


def test_bf16_segment_dtypes():
    """A bf16 solve's segment that does not end it hands its float32
    iterate on; a bf16 guess goes beside a bf16 rhs only."""
    x = torch.zeros((8, 6, 6), dtype=BF16)
    kw = dict(mz=4, H=2, alpha=0.1, beta=1.6, sweeps=1)
    got = cs3.fused_jacobi3_slab(1, x.float(), x, (1, 0, 0), fast=True,
                                 ends_solve=False, **kw)
    assert got.dtype == torch.float32
    assert cs3.fused_jacobi3_slab(1, x, x, (1, 0, 0), **kw).dtype == BF16
    with pytest.raises(TypeError):
        cs3.fused_jacobi3_slab(1, x, x.float(), (1, 0, 0), **kw)


def test_solve_rhs3_rounds_once():
    """``solve_rhs3`` is K5's bf16 fold: ``x0 + dt*src`` in float32, times
    1/beta in fast mode, rounded to bf16 once."""
    rng = np.random.default_rng(5)
    x0, src = (torch.from_numpy(rng.uniform(-1, 1, (4, 6, 6)).astype(
        np.float32)).to(BF16) for _ in range(2))
    beta = 1.6
    want = ((x0.float() + torch.tensor(DT, dtype=torch.float32)
             * src.float()) * np.float32(1 / beta)).to(BF16)
    assert torch.equal(cs3.solve_rhs3(x0, src, DT, beta, True), want)
    twice = (x0 + torch.tensor(DT, dtype=BF16) * src) * (1 / beta)
    assert not torch.equal(cs3.solve_rhs3(x0, src, DT, beta, True),
                           twice.to(BF16))


def _units(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The distance in bf16 units between two arrays of raw bf16 words
    (the words mapped to ordered integers, -0 beside +0)."""
    def ordered(w):
        w = w.astype(np.int32)
        return np.where(w < 0, -(w & 0x7FFF), w)

    return np.abs(ordered(a) - ordered(b))


def test_xla_fusion_rounds_the_gathers_coordinates_once():
    """The cause of the gap the jitted step shows (ROADMAP §C): XLA's CPU
    compile fuses the float32 departure ``xx - dt0*u`` of JAX's gathers
    into one loop, where the product and the difference contract into one
    fused multiply-add, rounded once; op by op (and in the port, and in
    K14) each rounds.  With XLA's ``fusion`` pass off the jitted program
    rounds as the eager one.  On JAX's own windowed slab gather under
    ``shard_map`` (float32-widened, rounded once, as the oracle swaps it
    in), the fused program therefore differs from the port's slab gather
    in a few cells by a bf16 unit, and the unfused one equals it bit for
    bit."""
    from jax.sharding import Mesh, PartitionSpec
    from fluidsimulationcuda_torch.parallel.mesh import _ext

    rng = np.random.default_rng(24)
    n, slabs, cmax = 14, 4, 2
    side, mz = n + 2, (n + 2) // slabs
    dt0 = np.float32(DT) * np.float32(n)
    u = (rng.uniform(-1, 1, (side,) * 3) * 3 / (DT * n)).astype(
        jnp.bfloat16).astype(np.float32)
    xx = np.arange(side, dtype=np.float32)

    def coord(uu):
        return jnp.arange(side, dtype=jnp.float32) - jnp.asarray(dt0) * uu

    unfused = {"xla_disable_hlo_passes": "fusion"}
    fused = np.asarray(jax.jit(coord)(u))
    plain = np.asarray(jax.jit(coord).lower(u).compile(unfused)(u))
    np.testing.assert_array_equal(
        fused, (xx - np.float64(dt0) * u.astype(np.float64)).astype(
            np.float32))
    np.testing.assert_array_equal(plain, xx - dt0 * u)
    assert (fused != plain).any()

    fields = [(rng.uniform(-1, 1, (side,) * 3) * s).astype(np.float32)
              for s in (1.0, *[3 / (DT * n)] * 3)]
    mesh = Mesh(np.array(jax.devices()[:slabs]), ("z",))
    spec = PartitionSpec("z")
    gather = jax.jit(jax.shard_map(
        lambda *a: _widened(js3._advect3_local_windowed)(
            0, *a, DT, n, slabs, cmax),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=spec))
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in fields]
    jit_words = _bits(gather(*args))
    plain_words = _bits(gather.lower(*args).compile(unfused)(*args))

    t16 = [torch.from_numpy(a).to(BF16) for a in fields]
    cut = [list(t.split(mz)) for t in t16]
    exts = _ext(cut[0], cmax + 1)
    port = _bits(torch.cat([cs3.advect3_flat_slab_plain(
        (0,), (exts[i],), *(f[i] for f in cut[1:]),
        (int(i == 0), int(i == slabs - 1), i * mz), dt=DT, n=n, cmax=cmax,
        mz=mz)[0] for i in range(slabs)]))
    np.testing.assert_array_equal(plain_words, port)
    units = _units(jit_words, port)
    print(f"fused jit vs port: {int((units > 0).sum())} of {units.size} "
          f"cells, at most {int(units.max())} bf16 units")
    assert 0 < (units > 0).sum() <= 64 and units.max() <= 2


def test_jax_bf16_slab_gather_loses_the_cell():
    """A recorded difference (ROADMAP §C): at n = 126 on 4 slabs JAX's own
    bf16 ``_advect3_local_exact`` computes the backtrace and the blend in
    bf16, which past 64 cells cannot hold a fraction of a cell: on a
    random field moved up to 2 cells it lies rel-L2 0.347 from its
    float32 gather on the same values, while the port's bf16 slab gather
    (K14's exact form's twin: float32 coordinates and blend, rounded
    once) lies 0.0017 from it, one bf16 rounding.  JAX's slab function
    runs eagerly, as the oracle does, under ``jax.vmap(...,
    axis_name="z")`` (its all-gather and axis index on the batch axis)."""
    n, slabs = 126, 4
    side = n + 2
    mz = side // slabs
    rng = np.random.default_rng(48)
    d0, *vel = (rng.uniform(-1.0, 1.0, (side,) * 3).astype(np.float32)
                * np.float32(s) for s in (1.0, *[2.0 / (DT * n)] * 3))

    def gather(dtype):
        fields = [jnp.asarray(a).astype(jnp.bfloat16).astype(dtype)
                  .reshape(slabs, mz, side, side) for a in (d0, *vel)]
        out = jax.vmap(lambda d, u, v, w: js3._advect3_local_exact(
            0, d, u, v, w, DT, n, slabs), axis_name="z")(*fields)
        return np.asarray(out.astype(jnp.float32)).reshape((side,) * 3)

    f32, jax16 = gather(jnp.float32), gather(jnp.bfloat16)
    t16 = [torch.from_numpy(a).to(BF16) for a in (d0, *vel)]
    port = torch.cat([cs3.advect3_flat_slab_exact_plain(
        (0,), (t16[0],), *(f[i * mz:(i + 1) * mz] for f in t16[1:]),
        (int(i == 0), int(i == slabs - 1), i * mz), dt=DT, n=n, mz=mz)[0]
        for i in range(slabs)]).float().numpy()

    def rel(a):
        return float(np.linalg.norm(a - f32) / np.linalg.norm(f32))

    print(f"rel-L2 to JAX's float32 slab gather: JAX bf16 {rel(jax16):.4f}, "
          f"port bf16 {rel(port):.4f}")
    assert rel(jax16) > 0.05
    assert rel(port) < 0.005
