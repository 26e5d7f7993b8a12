"""bf16 storage on the 2-D step (JAX's ``SimConfig(dtype=jnp.bfloat16)``),
against the JAX package.

- Each bf16 plain version of ``cuda_ops`` (what the bf16 kernel forms are
  held to on the card) against JAX's Pallas kernel on the same bf16
  inputs, in interpret mode as tests/test_torch_cuda_ops.py runs it, at
  side 64 (one 64-row strip: JAX chains no solve there), within one bf16
  rounding unit of the field's magnitude.
- The port's ``reference`` bf16 step against JAX's ``reference`` bf16 step
  (n=30, 8 iterations, 5 steps, the setup of
  tests/test_step_parity.py:118-135), on one grid and on a batch of three
  (JAX's vmapped batched step), within one bf16 rounding unit of each
  field's magnitude (measured: 0, bit for bit), and the ``cuda`` backend's
  bf16 step (its plain versions on the CPU) against JAX's Pallas bf16 step
  in interpret mode.
- The bf16 kernel forms themselves, compiled for the CPU behind the shim of
  dev/rehearse_kernels_cpu.py, against their plain versions bit for bit.
- The refusals (3-D, the sharded steps, the kernels without a bf16 form;
  multigrid and CG now build their config, tests/test_torch_bf16_solvers.py
  holds them), the same bits from both packages' float32 -> bf16
  rounding, and bf16 checkpoints in JAX's file layout.

The same numpy arrays, drawn from ``np.random.default_rng(seed)``, go to
both packages; each rounds them to bf16.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.core.state import (  # noqa: E402
    state_from_numpy, zero_sources_like)
from fluidsimulationcuda_torch.kernels import (  # noqa: E402
    checks, cuda_ops, cuda_ops_3d, cuda_sharded, cuda_step)
from fluidsimulationcuda_torch.models import batched as tb  # noqa: E402
from fluidsimulationcuda_torch.utils import checkpoint as tcp  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.models import batched as jb  # noqa: E402
from fluidsimulationcuda_tpu.utils import checkpoint as jcp  # noqa: E402

BF16 = torch.bfloat16
DT = 0.016
SIDE = 64


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_ops, "INTERPRET", True)


def _fields(seed, *scales, shape=(SIDE, SIDE)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, shape).astype(np.float32) * np.float32(s)
            for s in scales]


def _t(a):
    """A float32 numpy array as a bf16 tensor."""
    return torch.from_numpy(np.array(a)).to(BF16)


def _j(a):
    """A float32 numpy array as a bf16 JAX array."""
    return jnp.asarray(a).astype(jnp.bfloat16)


def _ulp(x: np.ndarray) -> float:
    """One bf16 rounding unit at the magnitude of ``x``'s largest value
    (8 significant bits)."""
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _close_ulp(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == BF16
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=_ulp(w))


# ---------------------------------------------------------------------------
# Each bf16 plain version against JAX's Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

JACOBI_MODES = {
    "jacobi": dict(),
    "src_dt": dict(src_dt=DT),
    "zero_init": dict(zero_init=True),
    "fast": dict(src_dt=DT, fast=True),
    "chebyshev": dict(src_dt=DT, cheby_rho=0.9),
    "chebyshev_fast": dict(src_dt=DT, cheby_rho=0.9, fast=True),
}


@pytest.mark.parametrize("iters", [3, 20])
@pytest.mark.parametrize("mode", list(JACOBI_MODES))
def test_fused_jacobi_bf16_matches_pallas(interpret, mode, iters):
    """3 and 20 sweeps: at side 64 JAX's strip is the whole grid
    (``_pick_tm(64) == 64``), so ``max_fused=20`` chains neither and the
    solve rounds to bf16 once, as the port's does."""
    assert pallas_ops._pick_tm(SIDE) == SIDE
    kw = JACOBI_MODES[mode]
    b = 0 if "zero_init" in kw else 1
    x, x0 = _fields(11, 0.5, 1.0)
    want = pallas_ops.fused_jacobi(b, _j(x), _j(x0), 0.42, 2.68, iters, **kw)
    got = cuda_ops.fused_jacobi(b, _t(x), _t(x0), 0.42, 2.68, iters, **kw)
    assert want.dtype == jnp.bfloat16
    _close_ulp(got, want)


@pytest.mark.parametrize("cheby_rho,iters", [(None, 20), (0.9, 14)])
def test_fused_project_bf16_matches_pallas(interpret, cheby_rho, iters):
    u, v = _fields(12, 1.0, 1.0)
    want = pallas_ops.fused_project(_j(u), _j(v), SIDE - 2, iters,
                                    cheby_rho=cheby_rho)
    got = cuda_ops.fused_project(_t(u), _t(v), SIDE - 2, iters,
                                 cheby_rho=cheby_rho)
    _close_ulp(got, tuple(want))


def test_divergence_p_bf16_matches_pallas(interpret):
    u, v = _fields(13, 1.0, 1.0)
    want = pallas_ops.divergence_p(_j(u), _j(v), SIDE - 2)
    _close_ulp(cuda_ops.divergence_p(_t(u), _t(v), SIDE - 2), want)


def test_gradient_p_bf16_matches_pallas(interpret):
    u, v, p = _fields(14, 1.0, 1.0, 0.1)
    want = pallas_ops.gradient_p(_j(u), _j(v), _j(p), SIDE - 2)
    _close_ulp(cuda_ops.gradient_p(_t(u), _t(v), _t(p), SIDE - 2),
               tuple(want))


def _velocities(seed, cells=1.5):
    """Velocities moving the backtrace up to ``cells`` cells."""
    return _fields(seed, *(2 * [cells / (DT * (SIDE - 2))]))


def test_advect_shift_bf16_matches_pallas(interpret):
    (d,), (u, v) = _fields(15, 1.0), _velocities(16)
    want = pallas_ops.advect_shift(0, _j(d), _j(u), _j(v), DT, SIDE - 2,
                                   cmax=2)
    _close_ulp(cuda_ops.advect_shift(0, _t(d), _t(u), _t(v), DT, SIDE - 2,
                                     cmax=2), want)


def test_advect_shift_fused_bf16_pair_matches_pallas(interpret):
    u, v = _velocities(17)
    want = pallas_ops.advect_shift_fused((1, 2), (_j(u), _j(v)), _j(u),
                                         _j(v), DT, SIDE - 2, cmax=2)
    got = cuda_ops.advect_shift_fused((1, 2), (_t(u), _t(v)), _t(u), _t(v),
                                      DT, SIDE - 2, cmax=2)
    _close_ulp(got, tuple(want))


# ---------------------------------------------------------------------------
# The bf16 step against JAX's
# ---------------------------------------------------------------------------

N = 30
STEP_CONFIGS = {
    "parity": dict(),
    "chebyshev": dict(pressure_solver="chebyshev",
                      diffusion_solver="chebyshev", cheby_iters=5,
                      cheby_rho=0.95),
}


def _sources(seed, batch=(), n=N):
    """reference_init's source distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    side = n + 2
    shape = batch + (side, side)
    dens = rng.uniform(0.0, 0.099, shape).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[..., ~(band[:, None] & band[None, :])] = 0.0
    u = rng.uniform(0.0, 0.99, shape).astype(np.float32)
    v = rng.uniform(0.0, 0.99, shape).astype(np.float32)
    return dens, u, v


@functools.lru_cache(maxsize=None)
def _jax_states(config, batch, steps=5):
    """JAX's bf16 reference step (vmapped over a batch) from the zero state,
    sources on step 1: the states after each step, as float32 numpy."""
    cfg = fj.SimConfig(n=N, jacobi_iters=8, backend="reference",
                       dtype=jnp.bfloat16, **STEP_CONFIGS[config])
    src = fj.Sources(*map(_j, _sources(20, batch)))
    zeros = fj.Sources(*(jnp.zeros_like(a) for a in src[:3]))
    state = fj.FluidState(*(jnp.zeros_like(a) for a in src[:3]))
    step = (jb.make_batched_step_fn(cfg) if batch
            else fj.make_step_fn(cfg))
    out = []
    for k in range(steps):
        state = step(state, src if k == 0 else zeros)
        assert state.u.dtype == jnp.bfloat16
        out.append(tuple(np.asarray(x, np.float32) for x in state[:3]))
    return out


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one grid", "batch"])
@pytest.mark.parametrize("config", list(STEP_CONFIGS))
def test_reference_step_bf16_matches_jax(config, batch):
    """After each of 5 steps: one bf16 rounding unit of each field's
    magnitude (measured 0.0: the port rounds where JAX's jnp ops round)."""
    cfg = ft.SimConfig(n=N, jacobi_iters=8, backend="reference",
                       dtype=BF16, device="cpu", **STEP_CONFIGS[config])
    src = ft.Sources(*state_from_numpy(
        dict(zip(("dens", "u", "v"), _sources(20, batch))), "cpu",
        BF16)[:3])
    state, zeros = ft.FluidState(*zero_sources_like(src)), \
        zero_sources_like(src)
    step = tb.make_batched_step_fn(cfg) if batch else ft.make_step_fn(cfg)
    for k, want in enumerate(_jax_states(config, batch)):
        state = step(state, src if k == 0 else zeros)
        for name, g, w in zip(("dens", "u", "v"), state[:3], want):
            assert g.dtype == BF16
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=_ulp(w),
                                       err_msg=f"{name} step {k + 1}")


@functools.lru_cache(maxsize=None)
def _jax_pallas_states(steps):
    cfg = fj.SimConfig(n=SIDE - 2, jacobi_iters=8, backend="pallas",
                       dtype=jnp.bfloat16, max_courant=2)
    src = fj.Sources(*map(_j, _sources(21, n=SIDE - 2)))
    zeros = fj.Sources(*(jnp.zeros_like(a) for a in src[:3]))
    state = fj.FluidState(*(jnp.zeros_like(a) for a in src[:3]))
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    try:
        for k in range(steps):
            state = fj.step(cfg, state, src if k == 0 else zeros)
    finally:
        pallas_ops.INTERPRET = prev
    return tuple(np.asarray(x, np.float32) for x in state[:3])


def test_cuda_step_bf16_matches_jax_pallas():
    """The ``cuda`` backend's bf16 step (its plain versions on the CPU: K1
    and K3 composing the density step, no K4) against JAX's Pallas bf16
    step in interpret mode, both windowed at 2 cells, after 2 steps at
    n=62: JAX's bar for kernel against jnp under the same storage
    (tests/test_pallas_ops.py:382-383) would be rel-L2 0.01; here within
    one bf16 rounding unit of each field's magnitude."""
    cfg = ft.SimConfig(n=SIDE - 2, jacobi_iters=8, backend="reference",
                       dtype=BF16, device="cpu", max_courant=2,
                       advect_mode="windowed")
    object.__setattr__(cfg, "backend", "cuda")
    src = ft.Sources(*map(_t, _sources(21, n=SIDE - 2)))
    state = ft.FluidState(*zero_sources_like(src))
    cuda_ops.reset_launch_counts()
    for k in range(2):
        state = ft.step(cfg, state, src if k == 0 else zero_sources_like(src))
    for name, g, w in zip(("dens", "u", "v"), state[:3],
                          _jax_pallas_states(2)):
        assert g.dtype == BF16
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=_ulp(w), err_msg=name)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_generate_trajectories_bf16_keeps_bf16_and_f32_audit(backend):
    cfg = ft.SimConfig(n=14, jacobi_iters=4, backend="reference",
                       dtype=BF16, device="cpu")
    object.__setattr__(cfg, "backend", backend)
    state, snaps, dmax = tb.generate_trajectories(
        torch.Generator().manual_seed(0), cfg, 2, 4, snapshot_every=2)
    assert all(f.dtype == BF16 and f.shape == (2, 16, 16)
               for f in state[:3])
    assert snaps.dtype == BF16 and snaps.shape == (2, 2, 16, 16)
    assert dmax.dtype == torch.float32 and float(dmax) > 0
    assert all(bool(torch.isfinite(f).all()) for f in state[:3])


def test_bf16_cuda_opset_composes_the_density_step():
    """bf16 launches K1 then K3 for the density (JAX's composition): the
    plain versions on the CPU count nothing, so the composition shows in
    the OpSet's result equalling ``diffuse_src`` then ``advect``."""
    cfg = ft.SimConfig(n=SIDE - 2, dtype=BF16, device="cpu",
                       backend="reference")
    object.__setattr__(cfg, "backend", "cuda")
    ops = cuda_ops.make_opset(cfg)
    src, base = _fields(22, 1.0, 1.0)
    u, v = _velocities(23)
    a = cfg.diffusion_alpha_diff
    args = (0, _t(src), _t(base), _t(u), _t(v), a, 1 + 4 * a, 8, DT,
            SIDE - 2)
    got = ops.diffuse_advect(*args)
    d = ops.diffuse_src(0, _t(src), _t(base), a, 1 + 4 * a, 8, DT)
    assert torch.equal(got, ops.advect(0, d, _t(u), _t(v), DT, SIDE - 2))
    with pytest.raises(TypeError):
        cuda_ops.fused_dens_advect(*args)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(pressure_solver="multigrid"),
                                dict(pressure_solver="cg"), dict(ndim=3)],
                         ids=["multigrid", "cg", "3-D"])
def test_config_refuses_bf16_beyond_the_2d_step(kw):
    """bf16 storage runs the 2-D step on one device with every pressure
    solve: multigrid (a bf16 divergence to a float32 pressure, as JAX's)
    and CG (bf16 throughout) build their config, held against JAX in
    tests/test_torch_bf16_solvers.py.  The single-device 3-D step runs
    bf16 too (tests/test_torch_step3_bf16.py), and so does the 3-D
    z-slab step, which used to refuse it (tests/test_torch_sharded3d_bf16.py
    holds it against JAX): the 3-D config builds and its z-slab step takes
    bf16 slabs to bf16 slabs."""
    cfg = ft.SimConfig(n=14, dtype=BF16, device="cpu", **kw)
    assert cfg.dtype == BF16
    if kw.get("ndim") != 3:
        assert cfg.pressure_solver == kw["pressure_solver"]
        return
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    shard_state_3d, unshard)
    from fluidsimulationcuda_torch.parallel.sharded3d import (
        make_sharded_step_fn_3d)

    mesh = make_mesh([torch.device("cpu")] * 2)
    step = make_sharded_step_fn_3d(cfg, mesh)
    state = shard_state_3d(ft.zero_state(cfg), mesh)
    src = shard_state_3d(ft.Sources(*(torch.full_like(f, 0.5)
                                      for f in ft.zero_state(cfg))), mesh)
    out = unshard(step(state, src))
    assert all(f.dtype == BF16 and bool(torch.isfinite(f).all())
               for f in out)


def test_config_refuses_other_dtypes():
    with pytest.raises(ValueError):
        ft.SimConfig(n=14, dtype=torch.float16, device="cpu")


def test_sharded_step_refuses_bf16():
    """The multi-device step's slab route is float32, as JAX's, and
    refuses bf16 storage; bf16 runs on the block route, which
    ``"auto"`` takes for it (ROADMAP §A 5 (b),
    tests/test_torch_sharded_blocks_bf16.py)."""
    from fluidsimulationcuda_torch.parallel import make_mesh
    from fluidsimulationcuda_torch.parallel.sharded import (
        make_sharded_step_fn)

    cfg = ft.SimConfig(n=62, dtype=BF16, device="cpu")
    mesh = make_mesh([torch.device("cpu")] * 4)
    with pytest.raises(ValueError, match="float32"):
        make_sharded_step_fn(cfg, mesh, advect_mode="windowed",
                             shard_backend="slab")
    assert make_sharded_step_fn(cfg, mesh, advect_mode="windowed").layout \
        == "blocks"


def test_kernels_without_a_bf16_form_raise():
    """K1-damp takes a bf16 rhs (its bf16-rhs forms), never a bf16 guess
    on a float32 rhs; the velocity pair has no bf16 form, nor have the
    row-slab kernels (the row-slab route stays float32, as JAX's; the
    z-slab kernels have theirs since tests/test_torch_sharded3d_bf16.py,
    the 3-D kernels of one volume since tests/test_torch_step3_bf16.py)."""
    x, y, z = (_t(a) for a in _fields(24, 1.0, 1.0, 1.0))
    with pytest.raises(TypeError):
        cuda_ops.mg_smooth(x, y.float(), 2)
    with pytest.raises(TypeError):
        cuda_ops.fused_jacobi(0, x, y.float(), 1.0, 4.0, 2, damp=0.8)
    with pytest.raises(TypeError):
        cuda_ops.fused_jacobi_pair(1, 2, x, z, y, y, 0.1, 1.4, 2)
    with pytest.raises(TypeError):
        cuda_step.fused_advect_project(x, y, SIDE - 2, 4, DT, cmax=1)
    with pytest.raises(TypeError):
        cuda_ops.fused_jacobi(0, x, y.float(), 1.0, 4.0, 2)
    slab = torch.zeros((8, 8), dtype=BF16)
    with pytest.raises(TypeError):
        cuda_sharded.fused_jacobi_slab(0, slab, slab, (1, 0, 0), m=4, K=2,
                                       alpha=1.0, beta=4.0, sweeps=1)
    vol = torch.zeros((8, 8, 8), dtype=BF16)
    with pytest.raises(TypeError):
        cuda_ops_3d.gradient3_p(vol, vol, vol, vol, 6)


# ---------------------------------------------------------------------------
# Rounding, state and checkpoints across the packages
# ---------------------------------------------------------------------------


def _rounding_inputs():
    """Random values over many binades, halfway cases (ties to even both
    ways), subnormals, infinities and the largest float32."""
    rng = np.random.default_rng(30)
    vals = (rng.uniform(-1, 1, 4096)
            * np.exp2(rng.integers(-140, 120, 4096))).astype(np.float32)
    ties = (np.arange(1, 513, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                        np.finfo(np.float32).max, 0.016, 1 / 30],
                       np.float32)
    return np.concatenate([vals, ties, -ties, special])


def test_float32_to_bf16_rounds_to_the_same_bits():
    a = _rounding_inputs()
    port = torch.from_numpy(a).to(BF16).view(torch.int16).numpy()
    jax_bits = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(
        np.int16)
    np.testing.assert_array_equal(port, jax_bits)


def test_state_from_numpy_carries_jax_bf16_state():
    """A JAX bf16 state (and the float32 arrays it was rounded from) into
    a port bf16 state with the same bits; float32 by default."""
    arrays = _sources(31, (2,))
    jstate = fj.FluidState(*map(_j, arrays))
    for obj in (jstate, dict(zip(("dens", "u", "v"), arrays))):
        got = state_from_numpy(obj, "cpu", BF16)
        for g, w in zip(got[:3], jstate[:3]):
            assert g.dtype == BF16 and g.shape == (2, 32, 32)
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), np.asarray(w).view(np.int16))
    assert state_from_numpy(jstate, "cpu").u.dtype == torch.float32


def _jax_bf16_checkpoint(path):
    cfg = fj.SimConfig(n=30, dtype=jnp.bfloat16, backend="reference",
                       jacobi_iters=8)
    state = fj.FluidState(*map(_j, _sources(32)))
    jcp.save_checkpoint(str(path), state, cfg, step=7)
    return state


def test_loads_a_bf16_checkpoint_jax_wrote(tmp_path):
    path = tmp_path / "jax16.npz"
    jstate = _jax_bf16_checkpoint(path)
    state, cfg, step = tcp.load_checkpoint(str(path), "cpu")
    assert cfg.dtype == BF16 and step == 7 and cfg.jacobi_iters == 8
    for g, w in zip(state[:3], jstate[:3]):
        assert g.dtype == BF16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))


def test_jax_cannot_load_its_own_bf16_checkpoint(tmp_path):
    """A recorded difference (ROADMAP §C): JAX saves bf16 fields as raw
    ``|V2`` words and its ``load_checkpoint`` then refuses them."""
    path = tmp_path / "jax16.npz"
    _jax_bf16_checkpoint(path)
    with np.load(path) as z:
        assert z["u"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jcp.load_checkpoint(str(path))


def test_bf16_checkpoint_writes_jax_layout_and_round_trips(tmp_path):
    path = tmp_path / "port16.npz"
    cfg = ft.SimConfig(n=30, dtype=BF16, device="cpu", jacobi_iters=8)
    state = ft.FluidState(*map(_t, _sources(33)))
    tcp.save_checkpoint(str(path), state, cfg, step=3)
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        assert meta["config"]["dtype"] == "bfloat16"
        for name, f in zip(("dens", "u", "v"), state[:3]):
            assert z[name].dtype == np.dtype("V2")
            np.testing.assert_array_equal(z[name].view(np.int16),
                                          f.view(torch.int16).numpy())
    back, cfg2, step = tcp.load_checkpoint(str(path), "cpu")
    assert cfg2 == cfg and step == 3
    assert all(torch.equal(a, b) for a, b in zip(back[:3], state[:3]))


# ---------------------------------------------------------------------------
# The bf16 kernel forms on the CPU, behind the shim
# ---------------------------------------------------------------------------

_SHIM_SIDE, _SHIM_BATCH = 18, 2
_SHIM_LABELS = [c.label for c in
                checks.kernel_checks_bf16(_SHIM_SIDE, "cpu", 0)
                + checks.kernel_checks_bf16(_SHIM_SIDE, "cpu", 0,
                                            batch=_SHIM_BATCH)]


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """jacobi_tiles.cu (the tiled K1 every bf16 solve takes), jacobi.cu,
    project.cu and advect.cu built for the CPU behind
    dev/rehearse_kernels_cpu.py's shim."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "dev", "rehearse_kernels_cpu.py")
    spec = importlib.util.spec_from_file_location("_rehearse_bf16", path)
    rehearse = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rehearse)
    lib = rehearse.build_shim_library(
        ("jacobi_tiles.cu", "jacobi.cu", "project.cu", "advect.cu"),
        out=tmp_path_factory.mktemp("cpu_shim_bf16"))
    return rehearse, lib


@pytest.mark.parametrize("label", _SHIM_LABELS)
def test_bf16_kernel_forms_match_plain_behind_the_shim(shim, label):
    """Each bf16 form through the CUDA source compiled for the CPU, against
    its plain version, bit for bit, with its launches counted under its
    bf16 name.  K1's solves launch the tiled K1 (``jacobi_sweeps_bf16``,
    and ``jacobi_sweeps`` for the float32 pressure inside
    ``fused_project``), whose labels ``checks.JAC16``/``checks.PROJ16``
    name; the per-sweep K1's bf16 form runs on no path any more."""
    rehearse, lib = shim
    check = {c.label: c for c in
             checks.kernel_checks_bf16(_SHIM_SIDE, "cpu", 0)
             + checks.kernel_checks_bf16(_SHIM_SIDE, "cpu", 0,
                                         batch=_SHIM_BATCH)}[label]
    with rehearse.kernels_on_cpu(lib):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
    want = check.plain()
    assert {k for k, c in counts.items() if c} == set(check.kernels)
    for g, w in zip(checks._as_tuple(got), checks._as_tuple(want)):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
