"""The port's 3-D step against the JAX package's, its config and its state.

Sources come from numpy (a seed) and go to both packages; JAX runs its
``reference`` backend on the CPU, at n=22 as tests/test_pallas_3d.py runs
the 3-D step.  The step tolerance is that of tests/test_step_parity.py
(rtol = atol = 1e-5), in parity mode, in the compensated mode at the 3-D
point (0.85, 10, 12; ``fast_math`` set on both, which the reference backends
ignore) and with Chebyshev on the density alone.
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
from fluidsimulationcuda_torch.core import config as tconfig  # noqa: E402
from fluidsimulationcuda_torch.core.state import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from fluidsimulationcuda_torch.models import stable_fluids_3d as t3  # noqa: E402
from fluidsimulationcuda_tpu.models import stable_fluids_3d as j3  # noqa: E402

N = 22
SIDE = N + 2
STEPS = 5
MODES = {
    "parity": dict(),
    "compensated": dict(pressure_solver="chebyshev",
                        diffusion_solver="chebyshev", cheby_rho=0.85,
                        cheby_iters=10, cheby_press_iters=12, fast_math=True),
    "chebyshev-dens": dict(diffusion_solver="chebyshev-dens", cheby_rho=0.85),
}
TOL = dict(rtol=1e-5, atol=1e-5)


def _sources(seed):
    """reference_init's distributions in 3-D, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shape = (SIDE,) * 3
    dens = rng.uniform(0.0, 0.099, shape).astype(np.float32)
    band = np.zeros(SIDE, bool)
    band[SIDE // 2 - SIDE // 8: SIDE // 2 + SIDE // 8] = True
    dens[~(band[:, None, None] & band[None, :, None] & band[None, None, :])] = 0
    vel = [rng.uniform(0.0, 0.99, shape).astype(np.float32) for _ in range(3)]
    return [dens, *vel]


def _tcfg(mode, **kw):
    return ft.SimConfig(n=N, ndim=3, backend="reference", device="cpu",
                        **MODES[mode], **kw)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(mode):
    """The JAX states after steps 1..STEPS (impulse sources on step 1)."""
    cfg = fj.SimConfig(n=N, ndim=3, backend="reference", **MODES[mode])
    step = j3.make_step_fn_3d(cfg)
    state = fj.zero_state(cfg)
    sources = fj.Sources(*map(jnp.asarray, _sources(7)))
    zeros = fj.zero_sources(cfg)
    out = []
    for k in range(STEPS):
        state = step(state, sources if k == 0 else zeros)
        out.append(fj.FluidState(*map(np.asarray, state)))
    return out


def _torch_sources(arrays):
    return ft.Sources(*(torch.from_numpy(np.array(a)) for a in arrays))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("steps", [1, STEPS])
def test_step3_matches_jax(mode, steps):
    cfg = _tcfg(mode)
    sim = ft.StableFluids3D(cfg)
    state = sim.step(ft.zero_state(cfg), _torch_sources(_sources(7)))
    for _ in range(steps - 1):
        state = sim.step(state)
    want = _jax_trajectory(mode)[steps - 1]
    for name in ("dens", "u", "v", "w"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   getattr(want, name), err_msg=name, **TOL)


def test_step_audited3_matches_step3_and_jax():
    cfg = _tcfg("parity", jacobi_iters=8)
    srcs = _sources(8)
    src = _torch_sources(srcs)
    state = ft.step3(cfg, ft.zero_state(cfg), src)
    audited, disp = t3.step_audited3(cfg, state, src)
    plain = ft.step3(cfg, state, src)
    for a, b in zip(audited, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jcfg = fj.SimConfig(n=N, ndim=3, backend="reference", jacobi_iters=8)
    jsrc = fj.Sources(*map(jnp.asarray, srcs))
    jstate = j3.step3(jcfg, fj.zero_state(jcfg), jsrc)
    _, jdisp = j3.step_audited3(jcfg, jstate, jsrc)
    assert float(disp) > 0
    np.testing.assert_allclose(float(disp), float(jdisp), rtol=1e-6)


def test_stable_fluids3d_and_make_step_fn_3d_equal_step3():
    cfg = _tcfg("parity", jacobi_iters=6)
    src = _torch_sources(_sources(9))
    want = ft.step3(cfg, ft.zero_state(cfg), src)
    want2 = ft.step3(cfg, want, ft.zero_sources(cfg))
    got = t3.make_step_fn_3d(cfg)(ft.zero_state(cfg), src)
    got2 = ft.StableFluids3D(cfg).step(got)  # no sources: zero sources
    for a, b in zip((*got, *got2), (*want, *want2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_reference_init3_mask_and_ranges():
    cfg = ft.SimConfig(n=30, ndim=3, device="cpu")
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    again = ft.reference_init(torch.Generator().manual_seed(0), cfg)[1]
    assert all(tuple(t.shape) == (32, 32, 32) and bool((t == 0).all())
               for t in state)
    c, r = 16, 4
    cube = (slice(c - r, c + r),) * 3
    inside = src.dens[cube]
    outside = src.dens.clone()
    outside[cube] = 0
    assert 0 <= float(inside.min()) and float(inside.max()) <= 0.099
    assert float(inside.max()) > 0 and bool((outside == 0).all())
    for t in (src.u, src.v, src.w):
        assert tuple(t.shape) == (32, 32, 32)
        assert 0 <= float(t.min()) and float(t.max()) <= 0.99
    for a, b in zip(src, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_zero_state3_carries_w():
    cfg = ft.SimConfig(n=6, ndim=3, device="cpu")
    for s in (ft.zero_state(cfg), ft.zero_sources(cfg)):
        assert all(tuple(t.shape) == (8, 8, 8) for t in s)
    assert ft.zero_state(cfg.replace(ndim=2)).w is None
    assert cfg.grid_shape == (8, 8, 8) and cfg.num_cells == 512


@pytest.mark.parametrize("kw", [
    dict(pressure_solver="multigrid"),
    dict(pressure_solver="cg"),
    dict(diffusion_solver="chebyshev"),  # uncompensated: no validated point
    dict(ndim=4),
])
def test_config3_gates(kw):
    with pytest.raises(ValueError):
        ft.SimConfig(**{"ndim": 3, "device": "cpu", **kw})
    jkw = {"ndim": 3, **kw}
    with pytest.raises(ValueError):
        fj.SimConfig(**jkw)  # the same gate as the JAX package


def test_config3_accepts_the_compensated_mode():
    cfg = _tcfg("compensated")
    assert cfg.press_cheby_iters == 12
    assert tconfig.perf_operating_point(256, ndim=3) == (0.85, 10, 12)


def test_state_round_trip3_from_jax():
    """A JAX 3-D FluidState crosses into the port with its w and steps on
    there as it does in JAX."""
    jcfg = fj.SimConfig(n=N, ndim=3, backend="reference", jacobi_iters=6)
    state0, sources = fj.reference_init(jax.random.key(0), jcfg)
    jstate = j3.step3(jcfg, state0, sources)
    tstate = state_from_numpy(jstate, device="cpu")
    assert tstate.w is not None and tstate.w.dtype == torch.float32
    back = state_to_numpy(tstate)
    for name in ("dens", "u", "v", "w"):
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(jstate, name)))
    tcfg = _tcfg("parity", jacobi_iters=6)
    got = ft.step3(tcfg, tstate, ft.zero_sources(tcfg))
    want = j3.step3(jcfg, jstate, fj.zero_sources(jcfg))
    for name in ("dens", "u", "v", "w"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)


def test_state_from_numpy_2d_has_no_w():
    arrays = {k: np.zeros((4, 4), np.float32) for k in ("dens", "u", "v")}
    state = state_from_numpy(arrays, device="cpu")
    assert state.w is None
    assert state_to_numpy(state).w is None


ENTRY_3D = [
    lambda c: ft.StableFluids3D(c),
    lambda c: t3.make_step_fn_3d(c),
    lambda c: ft.step3(c, ft.zero_state(c), ft.zero_sources(c)),
    lambda c: t3.step_audited3(c, ft.zero_state(c), ft.zero_sources(c)),
    lambda c: t3.vel_step3(c, *(ft.zero_state(c)[1:]), *(ft.zero_state(c)[1:])),
    lambda c: t3.dens_step3(c, *ft.zero_state(c)[:1], *ft.zero_state(c)),
]
ENTRY_2D = [
    lambda c: ft.StableFluids2D(c),
    lambda c: ft.make_step_fn(c),
    lambda c: ft.step(c, ft.zero_state(c), ft.zero_sources(c)),
    lambda c: ft.step_audited(c, ft.zero_state(c), ft.zero_sources(c)),
]


@pytest.mark.parametrize("entry", range(len(ENTRY_3D)))
def test_3d_entry_points_refuse_2d(entry):
    with pytest.raises(ValueError, match="ndim == 3"):
        ENTRY_3D[entry](ft.SimConfig(n=6, device="cpu"))


@pytest.mark.parametrize("entry", range(len(ENTRY_2D)))
def test_2d_entry_points_refuse_3d(entry):
    with pytest.raises(ValueError, match="ndim == 2"):
        ENTRY_2D[entry](ft.SimConfig(n=6, ndim=3, device="cpu"))


def test_windowed_advection_is_not_ported_in_3d():
    """The windowed 3-D gather, once refused (as this test's name still
    recalls), now runs: a step with numpy
    sources returns finite volumes of the grid's shape (held against JAX
    in tests/test_torch_step3_windowed.py)."""
    cfg = ft.SimConfig(n=N, ndim=3, jacobi_iters=4, device="cpu",
                       advect_mode="windowed", max_courant=1)
    out = ft.step3(cfg, ft.zero_state(cfg), _torch_sources(_sources(3)))
    for x in out:
        assert tuple(x.shape) == cfg.grid_shape
        assert bool(torch.isfinite(x).all())
    assert float(out.w.abs().max()) > 0
