"""The port's utilities and scenarios against the JAX package's, on the CPU.

Every comparison feeds both packages the same inputs: deterministic
scenarios are compared as they are, random ones on what they draw no
matter the generator (the nozzle mask and the fields it sets), the
stability report on one state given to both, and the validation bars on
JAX's own draws (``jax.random.key(0)``), which the test hands to the port
by patching the port module's ``reference_init``.  Tolerances: 1e-6 on
the scenarios' arrays, rtol 1e-5 on the bars (the port's reference ops
equal JAX's within 1e-5 over a step, tests/test_torch_step.py).
"""
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.core import config as tconfig  # noqa: E402
from fluidsimulationcuda_torch.models import scenarios as tsc  # noqa: E402
from test_torch_gpu import _residual_bars, _spy_residuals  # noqa: E402
from fluidsimulationcuda_torch.utils import checkpoint as tck  # noqa: E402
from fluidsimulationcuda_torch.utils import stability as tst  # noqa: E402
from fluidsimulationcuda_torch.utils import timing as ttm  # noqa: E402
from fluidsimulationcuda_torch.utils import validate as tva  # noqa: E402
from fluidsimulationcuda_tpu.core import config as jconfig  # noqa: E402
from fluidsimulationcuda_tpu.models import scenarios as jsc  # noqa: E402
from fluidsimulationcuda_tpu.utils import checkpoint as jck  # noqa: E402
from fluidsimulationcuda_tpu.utils import stability as jst  # noqa: E402
from fluidsimulationcuda_tpu.utils import validate as jva  # noqa: E402


def _pair(**kw):
    """The same configuration in both packages, on the CPU."""
    return (fj.SimConfig(backend="reference", **kw),
            ft.SimConfig(backend="reference", device="cpu", **kw))


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor)
                                   else np.asarray(x))


def _to_torch(fields):
    return type(fields)._make(None if f is None else
                              torch.from_numpy(np.array(f)) for f in fields)


# ---------------------------------------------------------------------------
# perf_operating_point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [256, 1024, 2048, 4096, 5000, 8192, 16384])
@pytest.mark.parametrize("ndim", [2, 3])
def test_perf_operating_point_matches_jax(side, ndim):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tconfig.perf_operating_point(side, ndim)
    assert got == jconfig.perf_operating_point(side, ndim)


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["vortex-pair", "jets"])
@pytest.mark.parametrize("n", [30, 62])
def test_deterministic_scenarios_match_jax(name, n):
    jcfg, tcfg = _pair(n=n)
    js, jsrc, jcont = jsc.SCENARIOS[name](jax.random.key(0), jcfg)
    ts, tsrc, tcont = tsc.SCENARIOS[name](
        torch.Generator().manual_seed(0), tcfg)
    assert tcont == jcont
    for a, b in zip(list(ts) + list(tsrc), list(js) + list(jsrc)):
        if b is None:
            assert a is None
            continue
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("ndim,n", [(2, 30), (2, 62), (3, 30)])
def test_plume_matches_jax_where_it_draws_nothing(ndim, n):
    """The nozzle, the density and upward velocity it sets, and zero jitter
    outside it, as JAX's; the jitter is 0.3 times the generator's normal
    draws, reproducible from its seed."""
    jcfg, tcfg = _pair(n=n, ndim=ndim)
    _, jsrc, jcont = jsc.plume(jax.random.key(0), jcfg)
    ts, tsrc, tcont = tsc.plume(torch.Generator().manual_seed(5), tcfg)
    assert tcont and jcont
    nozzle = _np(jsrc.dens) != 0.0
    assert nozzle.any() and (_np(tsrc.dens) != 0.0).tolist() == nozzle.tolist()
    np.testing.assert_array_equal(_np(tsrc.dens), _np(jsrc.dens))
    np.testing.assert_array_equal(_np(tsrc.v), _np(jsrc.v))
    for name in ("u", "w") if ndim == 3 else ("u",):
        t = _np(getattr(tsrc, name))
        assert (t[~nozzle] == 0.0).all() and (t[nozzle] != 0.0).all()
    assert (tsrc.w is None) == (jsrc.w is None) == (ndim == 2)
    again = tsc.plume(torch.Generator().manual_seed(5), tcfg)[1]
    draws = torch.randn(tcfg.grid_shape,
                        generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(_np(again.u), _np(tsrc.u))
    np.testing.assert_array_equal(_np(tsrc.u)[nozzle],
                                  (0.3 * draws).numpy()[nozzle])
    for a, b in zip(ts, fj.zero_state(jcfg)):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("name", ["vortex-pair", "jets"])
def test_2d_only_scenarios_refuse_3d(name):
    cfg = ft.SimConfig(n=14, ndim=3, device="cpu")
    with pytest.raises(ValueError, match="2-D only"):
        tsc.SCENARIOS[name](torch.Generator(), cfg)


def test_reference_scenario_is_reference_init():
    cfg = ft.SimConfig(n=30, device="cpu")
    state, src, cont = tsc.reference_square(torch.Generator().manual_seed(3),
                                            cfg)
    want = ft.reference_init(torch.Generator().manual_seed(3), cfg)[1]
    assert not cont
    for a, b in zip(src, want):
        assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------------------------
# Stability
# ---------------------------------------------------------------------------


def _state(rng, n, ndim, scale=1.0):
    shape = (n + 2,) * ndim
    return [rng.uniform(-scale, scale, shape).astype(np.float32)
            for _ in range(4 if ndim == 3 else 3)]


@pytest.mark.parametrize("case", ["finite", "nan", "inf", "window", "3d"])
def test_check_stability_matches_jax(case):
    rng = np.random.default_rng(11)
    ndim = 3 if case == "3d" else 2
    n = 14 if ndim == 3 else 30
    fields = _state(rng, n, ndim, scale=40.0 if case == "window" else 1.0)
    if case == "nan":
        fields[1][3, 4] = np.nan
    if case == "inf":
        fields[0][5, 5] = np.inf
    jcfg, tcfg = _pair(n=n, ndim=ndim, max_courant=2)
    jstate = fj.FluidState(*map(jnp.asarray, fields))
    tstate = ft.FluidState(*map(torch.from_numpy, fields))
    jrep = jst.check_stability(jcfg, jstate)
    trep = tst.check_stability(tcfg, tstate)
    for name in tst.StabilityReport._fields:
        got, want = getattr(trep, name), getattr(jrep, name)
        assert got.dim() == 0
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)
    assert tst.is_stable(tcfg, tstate) == jst.is_stable(jcfg, jstate)
    assert tst.is_stable(tcfg, tstate) == (case in ("finite", "3d"))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
def test_port_checkpoint_loads_in_jax(tmp_path, ndim):
    """The port writes what JAX reads, bit for bit; the port's ``cuda``
    backend is stored as JAX's ``pallas`` (a config for the card needs no
    card to be built)."""
    rng = np.random.default_rng(ndim)
    fields = _state(rng, 14, ndim)
    cfg = ft.SimConfig(n=14, ndim=ndim, jacobi_iters=7, cheby_rho=0.9,
                       backend="cuda", device="cuda")
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, ft.FluidState(*map(torch.from_numpy, fields)),
                        cfg, step=9)
    state, jcfg, step = jck.load_checkpoint(path)
    assert step == 9
    assert (jcfg.n, jcfg.ndim, jcfg.jacobi_iters, jcfg.cheby_rho) == \
        (14, ndim, 7, 0.9)
    assert jcfg.backend == "pallas" and jcfg.dtype == jnp.float32
    for a, b in zip(state, fields):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert (state.w is None) == (ndim == 2)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("backend,want", [("reference", "reference"),
                                          ("auto", "auto")])
def test_jax_checkpoint_loads_in_the_port(tmp_path, ndim, backend, want):
    rng = np.random.default_rng(10 + ndim)
    fields = _state(rng, 14, ndim)
    jcfg = fj.SimConfig(n=14, ndim=ndim, backend=backend, fast_math=True,
                        max_courant=3)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, fj.FluidState(*map(jnp.asarray, fields)), jcfg,
                        step=4)
    state, cfg, step = tck.load_checkpoint(path, device="cpu")
    assert step == 4 and cfg.backend == want and cfg.device.type == "cpu"
    assert cfg.fast_math and cfg.max_courant == 3 and cfg.ndim == ndim
    assert cfg.dtype == torch.float32
    for a, b in zip(state, fields):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)


def test_jax_pallas_checkpoint_maps_to_cuda(tmp_path):
    """JAX's ``pallas`` backend reads as ``cuda``; the device is the
    caller's, and ``cuda`` on the CPU is refused, not moved to another
    backend."""
    jcfg = fj.SimConfig(n=14, backend="pallas")
    path = str(tmp_path / "jax.npz")
    state, _ = fj.reference_init(jax.random.key(0), jcfg)
    jck.save_checkpoint(path, state, jcfg)
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
    cfg = tck.config_from_meta(meta["config"], "cuda")
    assert cfg.backend == "cuda" and cfg.device.type == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tck.load_checkpoint(path, device="cpu")


def _rewrite_meta(path, edit):
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["_meta"]).decode())
    edit(meta)
    payload["_meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **payload)


def test_checkpoint_forward_compat_config_fields(tmp_path):
    """Mirror of tests/test_batched_and_utils.py:174-200: an unknown key is
    dropped, a missing one defaulted."""
    cfg = ft.SimConfig(n=14, jacobi_iters=4, backend="reference",
                       device="cpu")
    state, _ = ft.reference_init(torch.Generator().manual_seed(7), cfg)
    p = str(tmp_path / "ck.npz")
    tck.save_checkpoint(p, state, cfg, step=3)

    def edit(meta):
        meta["config"]["some_future_field"] = 42
        del meta["config"]["fast_math"]

    _rewrite_meta(p, edit)
    state2, cfg2, step2 = tck.load_checkpoint(p, device="cpu")
    assert step2 == 3 and cfg2.n == 14 and cfg2.fast_math is False
    np.testing.assert_array_equal(state.dens.numpy(), state2.dens.numpy())


def test_checkpoint_newer_schema_rejected(tmp_path):
    cfg = ft.SimConfig(n=14, jacobi_iters=4, backend="reference",
                       device="cpu")
    state, _ = ft.reference_init(torch.Generator().manual_seed(8), cfg)
    p = str(tmp_path / "ck.npz")
    tck.save_checkpoint(p, state, cfg)
    _rewrite_meta(p, lambda meta: meta.update(version=999))
    with pytest.raises(ValueError, match="schema version"):
        tck.load_checkpoint(p, device="cpu")


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A failed write leaves the earlier checkpoint in place."""
    cfg = ft.SimConfig(n=14, device="cpu")
    state = ft.zero_state(cfg)
    p = str(tmp_path / "ck.npz")
    tck.save_checkpoint(p, state, cfg, step=1)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tck.np, "savez_compressed", boom)
    with pytest.raises(OSError):
        tck.save_checkpoint(p, state, cfg, step=2)
    assert tck.load_checkpoint(p, device="cpu")[2] == 1


# ---------------------------------------------------------------------------
# Validation bars, on JAX's draws
# ---------------------------------------------------------------------------


N_VAL = 30
PERF = dict(pressure_solver="chebyshev", diffusion_solver="chebyshev",
            cheby_rho=0.9, cheby_iters=10, cheby_press_iters=14,
            fast_math=True)
# The residual bars on few sweeps of a mild diffusion, where every residual
# stays far above float32 rounding.  A residual is a difference of nearly
# equal float32 terms, and XLA contracts the solves' and the residual's
# multiply-adds into fused ones where the port rounds each operation (as
# its kernels do).  So on the very same states the two packages' residual
# ratios differ by up to 26% on a converged solve (n=30, 8 sweeps, visc
# 0.0025: Jacobi residual 1.5e-9, rounding noise, the case the bars' twins
# exist for) and by 1e-6 to 4.3e-5 on 2-3 sweeps at visc 0.25, diff 0.1
# (measured; ROADMAP §C).  Here: at most 4.7e-7.
FEW = dict(jacobi_iters=2, visc=0.025, diff=0.01)
PERF_FEW = dict(PERF, cheby_iters=3, cheby_press_iters=4, cheby_dens_iters=3)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's bars draw what JAX's draw: ``jax.random.key(0)``'s
    ``reference_init``, given to the port as tensors on its device."""
    def draws(generator, cfg):
        jcfg = fj.SimConfig(n=cfg.n, ndim=cfg.ndim)
        state, src = fj.reference_init(jax.random.key(0), jcfg)
        return (ft.FluidState(*(None if f is None else torch.from_numpy(
                    np.array(f)).to(cfg.device) for f in state)),
                ft.Sources(*(None if f is None else torch.from_numpy(
                    np.array(f)).to(cfg.device) for f in src)))

    monkeypatch.setattr(tva, "reference_init", draws)


@pytest.fixture
def replay(monkeypatch, jax_draws):
    """The port's bars see the states JAX's bars saw: each JAX step
    function records its outputs, and the port's step function of the same
    call replays them.  The bars then differ only in what they compute on
    those states.  Run JAX's bar first."""
    tapes = []
    jax_step_fn = jva.make_step_fn

    def record(cfg):
        step, tape = jax_step_fn(cfg), []
        tapes.append(tape)

        def run(state, drive):
            state = step(state, drive)
            tape.append(_to_torch(state))
            return state

        return run

    def play(cfg):
        tape = tapes.pop(0)
        return lambda state, drive: tape.pop(0)

    monkeypatch.setattr(jva, "make_step_fn", record)
    monkeypatch.setattr(tva, "make_step_fn", play)
    return tapes


def _bar_cfgs(**kw):
    return _pair(n=N_VAL, jacobi_iters=8, **kw)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=what)


def _start(jcfg):
    """JAX's post-injection state, in both packages."""
    jstate, _ = jva.inject_exact(jcfg)
    return jstate, _to_torch(jstate)


def test_inject_exact_and_displacement_audits_match_jax(jax_draws):
    jcfg, tcfg = _bar_cfgs()
    jstate, jdisp = jva.inject_exact(jcfg)
    tstate, tdisp = tva.inject_exact(tcfg)
    _close(tdisp, jdisp, "inject_exact displacement")
    for a, b in zip(tstate, jstate):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    start = _to_torch(jstate)
    _close(tva.audit_displacement(tcfg, start, 3),
           jva.audit_displacement(jcfg, jstate, 3), "audit_displacement")
    for cmax in (1, 4):
        jw = jcfg.replace(max_courant=cmax, advect_mode="windowed")
        tw = tcfg.replace(max_courant=cmax, advect_mode="windowed")
        jc, jd = jva.select_cmax(jw, jstate, 3)
        tc, td = tva.select_cmax(tw, start, 3)
        assert tc == jc, (cmax, tc, jc)
        _close(td, jd, f"select_cmax from {cmax}")


@pytest.mark.parametrize("mode", ["parity", "perf"])
def test_divergence_audit_matches_jax(jax_draws, mode):
    """On each package's own trajectory from JAX's post-injection state."""
    jcfg, tcfg = _bar_cfgs(**(PERF_FEW if mode == "perf" else {}))
    jstate, start = _start(jcfg)
    _close(tva.audit_divergence(tcfg, start, 3),
           jva.audit_divergence(jcfg, jstate, 3), "audit_divergence")


@pytest.mark.parametrize("name", ["audit_diffusion_residual",
                                  "audit_diffusion_residual_twin",
                                  "audit_dens_residual"])
def test_residual_audits_match_jax(replay, name):
    jcfg, tcfg = _pair(n=N_VAL, **FEW, **PERF_FEW)
    jstate, start = _start(jcfg)
    jr, jpair = getattr(jva, name)(jcfg, jstate, 2)
    tr, tpair = getattr(tva, name)(tcfg, start, 2)
    assert not replay  # every recorded state was replayed
    assert jpair[1] > 1e-6  # the Jacobi residual is no rounding noise
    _close(tr, jr, name)
    _close(tpair, jpair, name)


def test_validate_perf_point_matches_jax(replay):
    """The compensated mode: every bar runs."""
    jcfg, tcfg = _pair(n=N_VAL, **FEW)
    perf = PERF_FEW
    jbars = jva.validate_perf_point(jcfg, jcfg.replace(**perf), steps=2)
    tbars = tva.validate_perf_point(tcfg, tcfg.replace(**perf), steps=2)
    assert not replay
    assert list(tbars) == list(jbars)
    for k, v in jbars.items():
        if isinstance(v, bool):
            assert tbars[k] is v, k
        else:
            _close(tbars[k], v, k)


def test_validate_perf_point_at_the_operating_point(replay, monkeypatch):
    """``run --perf --validate`` at n=254: the compensated point the CLI
    picks there, (0.9, 10, 14) as at 2048², against Jacobi-20, over the
    CLI's 20 steps, on the same states in both packages.  The keys and
    verdicts agree; max|div| agrees at rtol 1e-5; each residual ratio
    agrees within its float32 rounding bound (the packages round the
    multiply-adds differently), lies below 1 by more than that bound, and
    rests on Jacobi residuals far above rounding.  ``-s`` prints the
    bars."""
    jcfg, tcfg = _pair(n=254, jacobi_iters=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rho, k_d, k_p = tconfig.perf_operating_point(256, 2)
    perf = dict(PERF, cheby_rho=rho, cheby_iters=k_d, cheby_press_iters=k_p)
    seen = _spy_residuals(monkeypatch, tva)
    jbars = jva.validate_perf_point(jcfg, jcfg.replace(**perf))
    tbars = tva.validate_perf_point(tcfg, tcfg.replace(**perf))
    assert not replay and len(seen) == 32
    assert list(tbars) == list(jbars)
    residual = _residual_bars(seen)
    for k, v in jbars.items():
        if isinstance(v, bool):
            assert tbars[k] is v, k
        elif k in residual:
            ratio, units, bound = residual[k]
            print(f"{k}: JAX {v:.7g}, port {tbars[k]:.7g} (relative "
                  f"{abs(tbars[k] - v) / v:.3g}); Jacobi residual "
                  f"{units:.4g} rounding units, ratio bound {bound:.3g}")
            assert ratio == tbars[k]
            assert abs(tbars[k] - v) <= bound * v, k
            assert 1.0 - v > bound and units > 1e3, k
        else:
            print(f"{k}: JAX {v:.7g}, port {tbars[k]:.7g}")
            _close(tbars[k], v, k)
    assert tbars["ok"]


def test_validate_parity_against_itself():
    """Mirror of tests/test_batched_and_utils.py:320-331 on the port's own
    draws: a parity "perf" config passes the divergence bar and runs no
    residual bar."""
    cfg = ft.SimConfig(n=N_VAL, jacobi_iters=8, backend="reference",
                       device="cpu")
    same = tva.validate_perf_point(cfg, cfg, steps=2)
    assert same["divergence_ok"] and same["ok"]
    assert set(same) == {"max_abs_divergence", "jacobi_max_abs_divergence",
                         "divergence_ok", "ok"}


# ---------------------------------------------------------------------------
# Timing and rendering
# ---------------------------------------------------------------------------


def test_profile_phases_reports_positive_times():
    cfg = ft.SimConfig(n=30, jacobi_iters=4, device="cpu")
    rep = ttm.profile_phases(cfg, torch.Generator().manual_seed(0))
    assert isinstance(rep, ttm.PhaseReport)
    times = [rep.source, rep.diffusion, rep.divergence, rep.projection,
             rep.advection, rep.per_sweep, rep.step_estimate]
    assert all(t > 0 for t in times)
    assert rep.cells == 32 * 32 and rep.mcells_per_s > 0
    text = rep.pretty()
    assert "full step (est)" in text and "relay" not in text
    with pytest.raises(ValueError, match="2-D"):
        ttm.profile_phases(cfg.replace(ndim=3))


def test_wallclock_chains_the_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1.0

    assert ttm.wallclock(fn, torch.zeros(3), reps=2, chain=4) > 0
    assert len(calls) == 4 + 2 * 4  # a warm-up chain, then the timed ones


@pytest.mark.parametrize("what", ["density", "velocity"])
def test_png_written(tmp_path, what):
    pytest.importorskip("matplotlib")
    from fluidsimulationcuda_torch.utils import viz

    cfg = ft.SimConfig(n=30, device="cpu")
    _, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    path = str(tmp_path / f"{what}.png")
    if what == "density":
        viz.save_density_png(path, src.dens)
    else:
        viz.save_velocity_png(path, src.u, src.v)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_utils_exports():
    import fluidsimulationcuda_torch.utils as tu

    assert set(tu.__all__) == set(fj.utils.__all__) - {
        "enable_compilation_cache"}
    for name in tu.__all__:
        assert getattr(ft, name) is getattr(tu, name)
    assert ft.SCENARIOS is tsc.SCENARIOS
