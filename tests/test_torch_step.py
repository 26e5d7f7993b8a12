"""The port's 2-D step against the JAX package's, its config and its state.

Sources come from numpy (a seed) and go to both packages; JAX runs its
``reference`` backend on the CPU.  The step tolerance is that of
tests/test_step_parity.py (rtol = atol = 1e-5), the golden tolerance that of
tests/test_golden.py (atol 1e-5).
"""
import dataclasses
import glob
import inspect
import os
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
from fluidsimulationcuda_torch.core.state import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from fluidsimulationcuda_tpu.core import config as jconfig  # noqa: E402

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden",
                                       "*.npz")))
MODES = {
    "parity": dict(),
    "perf": dict(pressure_solver="chebyshev", diffusion_solver="chebyshev",
                 cheby_rho=0.9, cheby_iters=10, cheby_press_iters=14,
                 fast_math=True),
}


def _sources(seed, n):
    """reference_init's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    side = n + 2
    dens = rng.uniform(0.0, 0.099, (side, side)).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None] & band[None, :])] = 0.0
    u = rng.uniform(0.0, 0.99, (side, side)).astype(np.float32)
    v = rng.uniform(0.0, 0.99, (side, side)).astype(np.float32)
    return dens, u, v


def _jax_run(cfg, srcs, steps, every=False):
    step = fj.make_step_fn(cfg)
    state = fj.zero_state(cfg)
    sources = fj.Sources(*map(jnp.asarray, srcs))
    zeros = fj.zero_sources(cfg)
    for k in range(steps):
        state = step(state, sources if (k == 0 or every) else zeros)
    return state


def _torch_sources(srcs):
    return ft.Sources(*(torch.from_numpy(np.array(a)) for a in srcs))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("steps", [1, 10])
def test_step_matches_jax(mode, steps):
    kw = dict(n=30, jacobi_iters=20, backend="reference", **MODES[mode])
    srcs = _sources(steps, 30)
    want = _jax_run(fj.SimConfig(**kw), srcs, steps)
    tcfg = ft.SimConfig(device="cpu", **kw)
    got = ft.simulate(tcfg, ft.zero_state(tcfg), _torch_sources(srcs), steps)
    for name in ("dens", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# Configurations no other test pins (ROADMAP.md §C): the Chebyshev
# density solve alone, each Chebyshev solve alone, and the windowed step.
PINNED = {
    "chebyshev-dens": dict(diffusion_solver="chebyshev-dens", cheby_rho=0.9),
    "chebyshev pressure": dict(pressure_solver="chebyshev", cheby_rho=0.9,
                               cheby_iters=10, cheby_press_iters=14),
    "chebyshev diffusion": dict(diffusion_solver="chebyshev", cheby_rho=0.9,
                                cheby_iters=10),
    "windowed cmax=1": dict(advect_mode="windowed", max_courant=1),
    "windowed cmax=2 chebyshev-dens": dict(
        advect_mode="windowed", max_courant=2,
        diffusion_solver="chebyshev-dens", cheby_rho=0.9),
}


@pytest.mark.parametrize("every", [False, True],
                         ids=["sources on step 1", "sources every step"])
@pytest.mark.parametrize("config", list(PINNED))
def test_pinned_configs_match_jax(config, every):
    kw = dict(n=30, jacobi_iters=20, backend="reference", **PINNED[config])
    srcs = _sources(5, 30)
    want = _jax_run(fj.SimConfig(**kw), srcs, 6, every)
    tcfg = ft.SimConfig(device="cpu", **kw)
    got = ft.simulate(tcfg, ft.zero_state(tcfg), _torch_sources(srcs), 6,
                      sources_every_step=every)
    for name in ("dens", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p) for p in GOLDEN])
def test_golden(path):
    with np.load(path) as z:
        n, steps, iters = int(z["n"]), int(z["steps"]), int(z["iters"])
        cfg = ft.SimConfig(n=n, jacobi_iters=iters, backend="reference",
                           device="cpu")
        src = _torch_sources([z["dens_src"], z["u_src"], z["v_src"]])
        got = ft.simulate(cfg, ft.zero_state(cfg), src, steps)
        for name in ("dens", "u", "v"):
            np.testing.assert_allclose(getattr(got, name).numpy(), z[name],
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("every", [False, True])
def test_simulate_equals_python_loop(every):
    cfg = ft.SimConfig(n=30, jacobi_iters=8, backend="reference", device="cpu")
    src = _torch_sources(_sources(3, 30))
    got = ft.simulate(cfg, ft.zero_state(cfg), src, 5, sources_every_step=every)
    sim = ft.StableFluids2D(cfg)
    want = ft.zero_state(cfg)
    for k in range(5):
        want = sim.step(want, src if (k == 0 or every) else None)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_step_audited_matches_step_and_jax():
    kw = dict(n=30, jacobi_iters=8, backend="reference")
    srcs = _sources(4, 30)
    tcfg = ft.SimConfig(device="cpu", **kw)
    src = _torch_sources(srcs)
    state = ft.step(tcfg, ft.zero_state(tcfg), src)
    audited, disp = ft.step_audited(tcfg, state, src)
    plain = ft.step(tcfg, state, src)
    for a, b in zip(audited[:3], plain[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jcfg = fj.SimConfig(**kw)
    jstate = fj.step(jcfg, fj.zero_state(jcfg), fj.Sources(*map(jnp.asarray, srcs)))
    _, jdisp = fj.step_audited(jcfg, jstate, fj.Sources(*map(jnp.asarray, srcs)))
    assert float(disp) > 0
    np.testing.assert_allclose(float(disp), float(jdisp), rtol=1e-5)


def test_state_round_trip_from_jax():
    cfg = fj.SimConfig(n=30, jacobi_iters=4, backend="reference")
    state0, sources = fj.reference_init(jax.random.key(0), cfg)
    jstate = fj.step(cfg, state0, sources)
    tstate = state_from_numpy(jstate, device="cpu")
    assert all(t.dtype == torch.float32 for t in tstate[:3])
    back = state_to_numpy(tstate)
    for name in ("dens", "u", "v"):
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(jstate, name)))
    # ...and the JAX package takes the numpy state back as it is.
    again = fj.FluidState(*map(jnp.asarray, back[:3]))
    np.testing.assert_array_equal(np.asarray(again.u), np.asarray(jstate.u))


def test_state_from_npz():
    with np.load(GOLDEN[0]) as z:
        state = state_from_numpy(z, device="cpu")
        np.testing.assert_array_equal(state.dens.numpy(), z["dens"])


def test_reference_init_distributions():
    cfg = ft.SimConfig(n=62, device="cpu")
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    again = ft.reference_init(torch.Generator().manual_seed(0), cfg)[1]
    assert all(bool((t == 0).all()) for t in state[:3])
    side, c, r = 64, 32, 8
    inside = src.dens[c - r:c + r, c - r:c + r]
    outside = src.dens.clone()
    outside[c - r:c + r, c - r:c + r] = 0
    assert float(inside.min()) >= 0 and float(inside.max()) <= 0.099
    assert float(inside.max()) > 0 and bool((outside == 0).all())
    for t in (src.u, src.v):
        assert tuple(t.shape) == (side, side)
        assert 0 <= float(t.min()) and float(t.max()) <= 0.99
    for a, b in zip(src[:3], again[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_config_twin_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.SimConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.SimConfig)}
    assert set(tf) == set(jf) | {"device"}
    for name, default in jf.items():
        if name not in ("dtype", "backend"):
            assert tf[name] == default, name
    assert tf["dtype"] == torch.float32 and tf["backend"] == "auto"
    assert tconfig.PERF_POINTS_2D == jconfig.PERF_POINTS_2D
    assert tconfig.PERF_POINT_3D == jconfig.PERF_POINT_3D


def test_config_backend_resolution():
    assert ft.SimConfig().resolved_backend == "cuda"
    assert ft.SimConfig(device="cpu").resolved_backend == "reference"
    assert ft.SimConfig(device="cuda", backend="reference").resolved_backend == "reference"
    with pytest.raises(ValueError):
        # needs a CUDA device; nothing falls back
        ft.SimConfig(backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        ft.SimConfig(backend="pallas")
    with pytest.raises(ValueError):
        ft.SimConfig(dtype=torch.float64)


def test_default_config_targets_the_card():
    """Entry points run on the card unless the caller asks for the CPU; on
    a machine without one, a default config fails at its first tensor and
    nothing falls back to the CPU."""
    cfg = ft.SimConfig()
    assert cfg.device == torch.device("cuda")
    assert cfg.resolved_backend == "cuda"
    default = inspect.signature(state_from_numpy).parameters["device"].default
    assert torch.device(default) == torch.device("cuda")
    if torch.cuda.is_available():
        assert ft.zero_state(cfg).u.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ft.zero_state(cfg)


@pytest.mark.parametrize("kw", [dict(pressure_solver="multigrid"),
                                dict(pressure_solver="cg"),
                                dict(ndim=3, advect_mode="windowed")])
def test_unported_options_raise(kw):
    """The options the port once refused, and this test's name still
    recalls (the multigrid and CG pressure solves, the windowed 3-D
    gather), now run: a step from the zero state
    with numpy sources returns finite states of the grid's shape.  Their
    numbers are held against JAX in tests/test_torch_multigrid.py,
    tests/test_torch_cg.py and tests/test_torch_step3_windowed.py."""
    cfg = ft.SimConfig(n=14, device="cpu", **kw)
    step = ft.step3 if cfg.ndim == 3 else ft.step
    rng = np.random.default_rng(0)
    src = type(ft.zero_sources(cfg))(*(
        None if z is None else torch.from_numpy(
            rng.uniform(0.0, 0.99, tuple(z.shape)).astype(np.float32))
        for z in ft.zero_sources(cfg)))
    out = step(cfg, ft.zero_state(cfg), src)
    for x in out:
        if x is not None:
            assert tuple(x.shape) == cfg.grid_shape
            assert bool(torch.isfinite(x).all())
    assert float(out.u.abs().max()) > 0


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_math"])
@pytest.mark.parametrize("solver", ["jacobi", "chebyshev", "multigrid", "cg"])
def test_plain_opset_is_what_the_wrappers_run_on_cpu(solver, fast):
    """``make_opset(cfg, plain=True)``, the oracle of a fast-math step on
    the card, is the ``cuda`` backend's arithmetic: on CPU tensors, where
    each wrapper runs its plain twin, the two steps agree to the bit, and
    without fast math both equal the ``reference`` backend's."""
    from fluidsimulationcuda_torch.kernels import cuda_ops

    kw = MODES["perf"] if solver == "chebyshev" else dict(
        pressure_solver=solver, mg_cycles=1)
    cfg = ft.SimConfig(n=30, device="cpu", **{**kw, "fast_math": fast})
    src = ft.Sources(*map(torch.from_numpy, _sources(4, 30)))
    plain = ft.step(cfg, ft.zero_state(cfg), src,
                    cuda_ops.make_opset(cfg, plain=True))
    wrappers = dataclasses.replace(cfg)
    object.__setattr__(wrappers, "backend", "cuda")  # CPU tensors: plain
    for a, b in zip(plain[:3], ft.step(wrappers, ft.zero_state(cfg), src)[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if not fast:
        for a, b in zip(plain[:3], ft.step(cfg, ft.zero_state(cfg), src)[:3]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("side,point", [(2048, (0.9, 10, 14)),
                                        (8192, (0.96, 12, 14))])
def test_perf_point_measured(side, point):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tconfig.perf_operating_point(side) == point


@pytest.mark.parametrize("side,anchor", [(4096, 2048), (1024, 2048),
                                         (16384, 8192), (5000, 8192)])
def test_perf_point_unvalidated_warns(side, anchor):
    """4096² lies between the anchors and takes the 2048² point, as in the
    JAX package."""
    with pytest.warns(UserWarning, match="unvalidated at this size"):
        got = tconfig.perf_operating_point(side)
    assert got == tconfig.PERF_POINTS_2D[anchor]
