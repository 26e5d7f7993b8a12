"""bf16 storage on the single-device 3-D step (JAX's ``SimConfig(ndim=3,
dtype=jnp.bfloat16)``), against the JAX package.

JAX's bf16 3-D step runs its jnp ops (``_use_pallas3`` takes float32 only).
Its own bf16 gather blends in bf16, which cannot resolve a fraction of a
cell at these sides (``test_jax_bf16_gather3_loses_the_cell``), so the
port's gathers widen their inputs, gather in float32 and round once.  The
oracle here is JAX's own jnp ``step3``, run eagerly, with ``o3.advect3``
swapped (pytest's ``monkeypatch`` on the module attribute) for that gather
on widened inputs: JAX's float32 ``advect3``, or ``advect3_windowed`` at
``max_courant`` for the windowed runs, rounded to bf16 once.  Nothing in
the JAX package changes.

- The port's ``reference`` bf16 step equals the oracle bit for bit after
  two steps at n = 14 and n = 30: parity (8 iterations), the compensated
  mode (0.85, 10, 12) and ``chebyshev-dens``, exact and windowed (a
  1-cell window that the sources' velocities cross).
- Each op on bf16 inputs equals its JAX counterpart bit for bit.
- The ``cuda`` backend's plain twins composed into the step (what the
  kernels' bf16 forms equal bit for bit on the card) lie within
  ``TWIN_UNITS`` bf16 units of the oracle (8 exact, 24 windowed) and
  within rel-L2 0.15 of the float32 step.
- ``step_audited3``, the bf16 z-slab step against the single-device one,
  the bf16 3-D state from JAX arrays
  and the checkpoint round trips.

The same numpy arrays, drawn from ``np.random.default_rng(seed)``, go to
both packages; each rounds them to bf16.  ``-s`` prints the twins' gaps.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.core.state import state_from_numpy  # noqa: E402
from fluidsimulationcuda_torch.models import stable_fluids_3d as t3  # noqa: E402
from fluidsimulationcuda_torch.ops import chebyshev as tcheby  # noqa: E402
from fluidsimulationcuda_torch.ops import source as tsource  # noqa: E402
from fluidsimulationcuda_torch.ops import three_d as to3  # noqa: E402
from fluidsimulationcuda_torch.utils import checkpoint as tcp  # noqa: E402
from fluidsimulationcuda_tpu.models import stable_fluids_3d as j3  # noqa: E402
from fluidsimulationcuda_tpu.ops import chebyshev as jcheby  # noqa: E402
from fluidsimulationcuda_tpu.ops import source as jsource  # noqa: E402
from fluidsimulationcuda_tpu.ops import three_d as jo3  # noqa: E402
from fluidsimulationcuda_tpu.utils import checkpoint as jcp  # noqa: E402

BF16 = torch.bfloat16
DT = 0.016
STEPS = 2
CMAX = 1  # the windowed runs' window: (2*1+1)^3 masked shifts in JAX
MODES = {
    "parity": dict(jacobi_iters=8),
    "compensated": dict(pressure_solver="chebyshev",
                        diffusion_solver="chebyshev", cheby_rho=0.85,
                        cheby_iters=10, cheby_press_iters=12, fast_math=True),
    "chebyshev-dens": dict(jacobi_iters=8, diffusion_solver="chebyshev-dens",
                           cheby_rho=0.85),
}
# The twins' largest gap to the oracle after two steps at n = 30, in bf16
# units of each field's magnitude, by gather: JAX rounds every op of a
# solve to bf16, the twins once a solve, and the windowed runs' fast
# self-advection (the backtrace crosses the window) amplifies the gap
# (measured: at most 5 exact, 15.8 windowed).
TWIN_UNITS = {False: 8, True: 24}


def _sources(seed, n, windowed):
    """reference_init's distributions in 3-D, drawn with numpy; for the
    windowed runs velocity sources large enough that the step's backtrace
    crosses the 1-cell window."""
    rng = np.random.default_rng(seed)
    side = n + 2
    shape = (side,) * 3
    dens = rng.uniform(0.0, 0.099, shape).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None, None] & band[None, :, None] & band[None, None, :])] = 0
    scale = 3.0 / (DT * DT * n) if windowed else 0.99
    vel = [(rng.uniform(-1.0, 1.0, shape) * scale).astype(np.float32)
           for _ in range(3)]
    return [dens, *vel]


def _t(a):
    """A float32 numpy array as a bf16 tensor."""
    return torch.from_numpy(np.array(a)).to(BF16)


def _j(a):
    """A float32 numpy array as a bf16 JAX array."""
    return jnp.asarray(a).astype(jnp.bfloat16)


def _bits(x) -> np.ndarray:
    """The raw bf16 words of a port tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _ulp(x: np.ndarray) -> float:
    """One bf16 rounding unit at the magnitude of ``x``'s largest value."""
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _widened_gather(cmax):
    """JAX's float32 gather on widened bf16 inputs, rounded once: its
    ``advect3``, or ``advect3_windowed`` in the window of ``cmax``."""
    advect3, windowed = jo3.advect3, jo3.advect3_windowed

    def gather(b, d0, u, v, w, dt, n):
        f32 = [a.astype(jnp.float32) for a in (d0, u, v, w)]
        out = (advect3(b, *f32, dt, n) if cmax is None
               else windowed(b, *f32, dt, n, cmax=cmax))
        return out.astype(d0.dtype)

    return gather


def _configs(n, mode, windowed):
    jcfg = fj.SimConfig(n=n, ndim=3, backend="reference", dtype=jnp.bfloat16,
                        max_courant=CMAX, **MODES[mode])
    tcfg = ft.SimConfig(n=n, ndim=3, backend="reference", device="cpu",
                        dtype=BF16, max_courant=CMAX,
                        advect_mode="windowed" if windowed else "exact",
                        **MODES[mode])
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_run(n, mode, windowed):
    """The oracle's state after ``STEPS`` steps (impulse sources on step
    1), as raw bf16 words, and its audited displacement on step 1."""
    jcfg, _ = _configs(n, mode, windowed)
    src = fj.Sources(*map(_j, _sources(7, n, windowed)))
    zeros = fj.zero_sources(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jo3, "advect3", _widened_gather(CMAX if windowed
                                                   else None))
        state, disp = j3.step_audited3(jcfg, fj.zero_state(jcfg), src)
        for _ in range(STEPS - 1):
            state = j3.step3(jcfg, state, zeros)
    return tuple(_bits(f) for f in state), float(disp)


def _port_run(cfg, n, windowed, ops=None, dtype=BF16):
    src = ft.Sources(*(torch.from_numpy(a).to(BF16).to(dtype)
                       for a in _sources(7, n, windowed)))
    state = ft.zero_state(cfg)
    for k in range(STEPS):
        state = ft.step3(cfg, state, src if k == 0 else ft.zero_sources(cfg),
                         ops)
    return state


# ---------------------------------------------------------------------------
# The reference step against JAX's, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["exact", "windowed"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [14, 30])
def test_reference_bf16_step3_equals_jax(n, mode, windowed):
    _, tcfg = _configs(n, mode, windowed)
    got = _port_run(tcfg, n, windowed)
    want, _ = _jax_run(n, mode, windowed)
    for name, g, w in zip(("dens", "u", "v", "w"), got, want):
        assert g.dtype == BF16
        np.testing.assert_array_equal(_bits(g), w, err_msg=name)


@pytest.mark.parametrize("n", [14, 30])
def test_windowed_runs_cross_the_window(n):
    """The windowed runs' sources move the backtrace past the 1-cell
    window, so the windowed and exact bf16 steps differ: the window is
    exercised, not idle."""
    _, tcfg = _configs(n, "parity", True)
    windowed = _port_run(tcfg, n, True)
    exact = _port_run(tcfg.replace(advect_mode="exact"), n, True)
    assert _jax_run(n, "parity", True)[1] > CMAX
    assert any(not torch.equal(a, b) for a, b in zip(windowed, exact))


# ---------------------------------------------------------------------------
# Each op on bf16 inputs, bit for bit
# ---------------------------------------------------------------------------

N = 14
SIDE = N + 2


def _fields(seed, *scales):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, (SIDE,) * 3).astype(np.float32)
            * np.float32(s) for s in scales]


def _alpha():
    a = DT * 0.0025 * N * N
    return a, 1.0 + 6.0 * a


OPS = {
    "diffuse3": lambda m, x, x0, p, u, v, w: (
        m.diffuse3(1, x, x0, *_alpha(), 8)),
    "pressure_solve3": lambda m, x, x0, p, u, v, w: m.pressure_solve3(x0, 8),
    "divergence3": lambda m, x, x0, p, u, v, w: m.divergence3(u, v, w, N),
    "apply_pressure_gradient3": lambda m, x, x0, p, u, v, w: (
        m.apply_pressure_gradient3(u, v, w, p, N)),
    "set_bnd3 b=0": lambda m, x, x0, p, u, v, w: m.set_bnd3(0, x),
    "set_bnd3 b=1": lambda m, x, x0, p, u, v, w: m.set_bnd3(1, x),
    "set_bnd3 b=2": lambda m, x, x0, p, u, v, w: m.set_bnd3(2, x),
    "set_bnd3 b=3": lambda m, x, x0, p, u, v, w: m.set_bnd3(3, x),
    "fix_edges3": lambda m, x, x0, p, u, v, w: m.fix_edges3(x),
    "embed_interior3": lambda m, x, x0, p, u, v, w: (
        m.embed_interior3(2, x[1:-1, 1:-1, 1:-1])),
}


@pytest.mark.parametrize("op", list(OPS))
def test_op_on_bf16_equals_jax(op):
    arrays = _fields(40, 1.0, 1.0, 1.0, 3.0, 3.0, 3.0)
    got = OPS[op](to3, *map(_t, arrays))
    want = OPS[op](jo3, *map(_j, arrays))
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert g.dtype == BF16
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_cheby_diffuse3_on_bf16_equals_jax(b):
    x, x0 = _fields(41 + b, 1.0, 1.0)
    a, beta = _alpha()
    got = tcheby.cheby_diffuse3(b, _t(x), _t(x0), a, beta, 10, 0.85)
    want = jcheby.cheby_diffuse3(b, _j(x), _j(x0), a, beta, 10, 0.85)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_add_source_on_bf16_equals_jax():
    x, s = _fields(45, 1.0, 50.0)
    np.testing.assert_array_equal(
        _bits(tsource.add_source(_t(x), _t(s), DT)),
        _bits(jsource.add_source(_j(x), _j(s), DT)))


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["exact", "windowed"])
def test_gather_on_bf16_equals_the_widened_jax_gather(windowed):
    """The port's bf16 gather is JAX's float32 gather on widened inputs,
    rounded once (the oracle's swap), at any displacement."""
    d0, u, v, w = _fields(46, 1.0, 100.0, 100.0, 100.0)
    args = (_t(d0), _t(u), _t(v), _t(w), DT, N)
    jargs = (_j(d0), _j(u), _j(v), _j(w), DT, N)
    if windowed:
        got = to3.advect3_windowed(0, *args, cmax=2)
    else:
        got = to3.advect3(0, *args)
    want = _widened_gather(2 if windowed else None)(0, *jargs)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_first_sweep_reads_the_raw_guess_ring_in_bf16():
    """The first sweep of a solve reads the guess as it is, its ghost
    faces included (the reference quirk, docs/PERFORMANCE.md finding 12),
    in bf16 as in float32: a guess whose faces are not derived from its
    interior gives JAX's result bit for bit, and another one than the same
    guess with derived faces."""
    x, x0 = _fields(47, 1.0, 1.0)
    a, beta = _alpha()
    raw = to3.diffuse3(1, _t(x), _t(x0), a, beta, 3)
    want = jo3.diffuse3(1, _j(x), _j(x0), a, beta, 3)
    np.testing.assert_array_equal(_bits(raw), _bits(want))
    derived = to3.diffuse3(1, to3.set_bnd3(1, _t(x)), _t(x0), a, beta, 3)
    assert not torch.equal(raw, derived)


# ---------------------------------------------------------------------------
# The cuda backend's plain twins, JAX's bf16 gather, the other entry points
# ---------------------------------------------------------------------------


def _twins_cfg(tcfg):
    """``tcfg`` on the ``cuda`` backend on the CPU, where its wrappers run
    their plain twins (``_Ops3(cfg, plain=True)`` composes them)."""
    cfg = tcfg.replace()
    object.__setattr__(cfg, "backend", "cuda")
    return cfg


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["exact", "windowed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_twins_step3_near_jax_and_float32(mode, windowed):
    n = 30
    _, tcfg = _configs(n, mode, windowed)
    cfg = _twins_cfg(tcfg)
    got = _port_run(cfg, n, windowed, t3._Ops3(cfg, plain=True))
    want, _ = _jax_run(n, mode, windowed)
    f32 = _port_run(tcfg.replace(dtype=torch.float32), n, windowed,
                    dtype=torch.float32)
    for name, g, w, r in zip(("dens", "u", "v", "w"), got, want, f32):
        assert g.dtype == BF16
        w = torch.from_numpy(w.copy()).view(BF16).float().numpy()
        units = float(np.abs(g.float().numpy() - w).max()) / _ulp(w)
        rel = float(torch.linalg.vector_norm(g.double() - r.double())
                    / torch.linalg.vector_norm(r.double()))
        print(f"{mode} {'windowed' if windowed else 'exact'} {name}: twins "
              f"{units:.1f} bf16 units from JAX, rel-L2 {rel:.2e} to float32")
        assert units <= TWIN_UNITS[windowed], name
        assert rel < 0.15, name


def test_jax_bf16_gather3_loses_the_cell():
    """At n = 126 JAX's own bf16 ``advect3`` blends coordinates in bf16,
    which past 64 cells cannot hold a fraction of a cell: on a random
    field moved up to 2 cells it lies rel-L2 0.347 from its float32 gather
    on the same values, while the port's bf16 gather (float32
    coordinates, rounded once) lies 0.0017 from it, a bf16 rounding."""
    n = 126
    rng = np.random.default_rng(48)
    side = n + 2
    d0, *vel = (rng.uniform(-1.0, 1.0, (side,) * 3).astype(np.float32)
                * np.float32(s) for s in (1.0, *[2.0 / (DT * n)] * 3))
    f32 = np.asarray(jo3.advect3(0, *(_j(a).astype(jnp.float32)
                                      for a in (d0, *vel)), DT, n))
    jax16 = np.asarray(jo3.advect3(0, *map(_j, (d0, *vel)), DT, n)
                       ).astype(np.float32)
    port = to3.advect3(0, *map(_t, (d0, *vel)), DT, n).float().numpy()

    def rel(a):
        return float(np.linalg.norm(a - f32) / np.linalg.norm(f32))

    print(f"rel-L2 to JAX's float32 gather: JAX bf16 {rel(jax16):.4f}, "
          f"port bf16 {rel(port):.4f}")
    assert rel(jax16) > 0.05
    assert rel(port) < 0.005


def test_step_audited3_in_bf16():
    """The audited step equals ``step3`` bit for bit in bf16, and its
    displacement, bf16 as JAX's is, equals the oracle's."""
    n = 14
    _, tcfg = _configs(n, "parity", False)
    src = ft.Sources(*map(_t, _sources(7, n, False)))
    state, disp = t3.step_audited3(tcfg, ft.zero_state(tcfg), src)
    plain = ft.step3(tcfg, ft.zero_state(tcfg), src)
    for a, b in zip(state, plain):
        assert torch.equal(a, b)
    assert disp.dtype == BF16
    assert float(disp) == _jax_run(n, "parity", False)[1] > 0


def test_sharded_step3_refuses_bf16():
    """The z-slab step used to refuse bf16 until its bf16 forms landed
    (tests/test_torch_sharded3d_bf16.py holds it against JAX); now the
    single-device bf16 config builds it in every gather mode, and under
    exact gathers its step equals the single-device bf16 step bit for
    bit."""
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    shard_state_3d, unshard)
    from fluidsimulationcuda_torch.parallel.sharded3d import (
        make_sharded_step_fn_3d)

    cfg = ft.SimConfig(n=14, ndim=3, dtype=BF16, device="cpu")
    mesh = make_mesh([torch.device("cpu")] * 2)  # slabs of 8 planes
    src = ft.Sources(*map(_t, _sources(7, 14, False)))
    for mode in ("auto", "exact", "windowed"):
        step = make_sharded_step_fn_3d(cfg, mesh, advect_mode=mode)
        assert step.advect_mode == ("exact" if mode == "exact"
                                    else "windowed")
    got = unshard(make_sharded_step_fn_3d(cfg, mesh, advect_mode="exact")(
        shard_state_3d(ft.zero_state(cfg), mesh), shard_state_3d(src, mesh)))
    for a, b in zip(got, ft.step3(cfg, ft.zero_state(cfg), src)):
        assert a.dtype == BF16 and torch.equal(a, b)


def test_state_from_numpy_carries_a_jax_bf16_3d_state():
    arrays = _fields(49, 1.0, 1.0, 1.0, 1.0)
    jstate = fj.FluidState(*map(_j, arrays))
    got = state_from_numpy(jstate, "cpu", BF16)
    for g, w in zip(got, jstate):
        assert g.dtype == BF16 and g.shape == (SIDE,) * 3
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_bf16_3d_checkpoint_round_trips(tmp_path):
    """A bf16 3-D state (``w`` included) saved by the port loads back bit
    for bit, and one JAX saved (its ``|V2`` words) loads into the port with
    the same bits."""
    arrays = _fields(50, 1.0, 1.0, 1.0, 1.0)
    cfg = ft.SimConfig(n=N, ndim=3, dtype=BF16, device="cpu")
    state = ft.FluidState(*map(_t, arrays))
    path = str(tmp_path / "port.npz")
    tcp.save_checkpoint(path, state, cfg, step=3)
    got, gcfg, step = tcp.load_checkpoint(path, "cpu")
    assert (gcfg.dtype, gcfg.ndim, step) == (BF16, 3, 3)
    for g, w in zip(got, state):
        assert torch.equal(g, w)
    jcfg = fj.SimConfig(n=N, ndim=3, dtype=jnp.bfloat16, backend="reference")
    jpath = str(tmp_path / "jax.npz")
    jcp.save_checkpoint(jpath, fj.FluidState(*map(_j, arrays)), jcfg, step=5)
    got, gcfg, step = tcp.load_checkpoint(jpath, "cpu")
    assert (gcfg.dtype, gcfg.ndim, step) == (BF16, 3, 5)
    for g, w in zip(got, state):
        assert torch.equal(g, w)


def test_cuda_projection_keeps_float32_divergence_and_pressure():
    """On the ``cuda`` backend (its plain twins on the CPU) a bf16 3-D
    projection takes a float32 divergence (K7's bf16 form writes float32)
    to a float32 pressure (the float32 K5) and writes bf16 velocities (K8's
    bf16 form), where JAX's jnp step keeps both in bf16: its max|div|
    afterwards stays at the float32 projection's (a ratio of 1.000 at
    256³ on the card), within 5% here; the reference backend's, JAX's,
    lies farther from it."""
    from fluidsimulationcuda_torch.kernels import cuda_ops_3d as co3

    n = 30
    _, tcfg = _configs(n, "parity", False)
    cfg = _twins_cfg(tcfg.replace(jacobi_iters=20))
    rng = np.random.default_rng(51)
    vel = [rng.uniform(-1.0, 1.0, (n + 2,) * 3).astype(np.float32)
           for _ in range(3)]
    u, v, w = map(_t, vel)
    div = co3.divergence3_p(u, v, w, n)
    p = co3.fused_jacobi3(0, div, div, 1.0, 6.0, 20, zero_init=True)
    assert (div.dtype, p.dtype) == (torch.float32, torch.float32)
    assert all(f.dtype == BF16 for f in co3.gradient3_p(u, v, w, p, n))

    def max_div(fields):
        return float(to3.divergence3(*(f.float() for f in fields), n)
                     [1:-1, 1:-1, 1:-1].abs().max())

    twins = max_div(t3._Ops3(cfg, plain=True).project(u, v, w))
    ref16 = max_div(t3._Ops3(tcfg.replace(jacobi_iters=20)).project(u, v, w))
    f32 = max_div(t3._Ops3(tcfg.replace(jacobi_iters=20,
                                        dtype=torch.float32)).project(
        *(f.float() for f in (u, v, w))))
    print(f"max|div| after a 20-sweep projection: float32 {f32:.4e}, cuda "
          f"bf16 {twins:.4e}, reference bf16 {ref16:.4e}")
    assert abs(twins / f32 - 1.0) < 0.05
    assert abs(ref16 - f32) > abs(twins - f32)
