"""The bf16 forms of the z-slab kernels: K13 per sweep
(``csrc/jacobi3_slab.cu``) and as the tiled slab walk
(``csrc/jacobi3_tiles.cu``), K14 windowed and exact
(``csrc/advect3_slab.cu``), K15 and K16 (``csrc/project3_slab.cu``).  A
CUDA kernel has no interpret mode, so this file compiles the four sources
with ``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py`` (the tiled walk runs a block's threads
together, ``__syncthreads()`` a barrier) and holds every bf16 form bit for
bit, dtype included, against its plain twin on CPU tensors:

- every call of ``checks.kernel_checks_slab3_bf16`` on top, interior and
  bottom slabs of 8 planes at side 24 (slab planes from ``plane0`` 0, 8
  and 16): K13 from a bf16 guess or a float32 iterate, ending its solve
  or handing its float32 iterate on, Chebyshev segments first and chained
  with x_{k-1} carried, fast on a prescaled rhs; K14 under and over the
  4-cell window and exact from the assembled bf16 volumes; K15 and K16;
- the tiled slab walk's bf16 form at T of 1 to 6 against the per-sweep
  K13's bf16 form on the same segments (first, chained, 1 sweep, handing
  on), each launch's operand types checked (a bf16 guess read by the
  first launch, the float32 iterate and x_{k-1} carried in, bf16 written
  only where the segment ends the chain);
- the bf16 z-slab step through the kernels (the ``cuda`` backend on CPU
  tensors) against the plain twins' step, ``_ZSlabStep(..., plain=True)``,
  bit for bit over two steps, its launches those of
  ``chip_smoke.expected_launches_sharded3``: parity windowed, compensated
  with fast math exact (chains of segments), and on 48³ slabs of 16
  planes where the fast chains take the tiled walk;
- the operand types the slab walk's bf16 form refuses.

Skips only without ``g++``.
"""
import contextlib
import ctypes
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.core.config import PERF_POINT_3D  # noqa: E402
from fluidsimulationcuda_torch.kernels import build, checks  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops as co  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded_3d as cs3  # noqa: E402
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    make_mesh, shard_state_3d, unshard)
from fluidsimulationcuda_torch.parallel.sharded3d import _ZSlabStep  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi3_tiles.cu", "jacobi3_slab.cu", "advect3_slab.cu",
           "project3_slab.cu")
SIDE, MZ = 24, 8
BF16 = torch.bfloat16
DT = checks.DT
RHO, K_D, K_P = PERF_POINT_3D
CHECKS = checks.kernel_checks_slab3_bf16(SIDE, MZ, "cpu", 0)
# Position of the slab walk's operand types (csrc/jacobi3_tiles.cu,
# fsc_jacobi3_slab_sweeps_bf16), and of the per-sweep K13's.
WALK_TYPES, SWEEP_TYPES = 22, 19


def _load_shim():
    spec = importlib.util.spec_from_file_location(
        "rehearse_kernels_cpu", ROOT / "dev" / "rehearse_kernels_cpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shim():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels behind the CPU shim")
    mod = _load_shim()
    lib = mod.build_shim_library(SOURCES, mod.OUT / "bf16_slab3")
    return mod, lib


def _run(shim, fn, *args, per_launch=None, sms=1, **kw):
    """``fn`` through the shim library on a shim device of ``sms`` SMs,
    with ``per_launch`` sweeps a tiled launch (0: the per-sweep K13; None:
    as the path chooses): (result, [(kernel, args)] of each launch, the
    launch counts of the call)."""
    mod, lib = shim
    launches = []
    launch = co._launch

    def spy(kernel, fn_, *a):
        launches.append((kernel, a))
        launch(kernel, fn_, *a)

    forced = (contextlib.nullcontext() if per_launch is None
              else co.launch_sweeps(per_launch))
    co._launch = spy
    co.reset_launch_counts()
    try:
        with mod.kernels_on_cpu(lib) as handle, forced:
            mod.set_device(handle, sms)
            out = fn(*args, **kw)
    finally:
        co._launch = launch
    return out, launches, {k: c for k, c in co.launch_counts().items() if c}


def _same(got, want) -> bool:
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(_same(g, w)
                                             for g, w in zip(got, want))
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("i", range(len(CHECKS)),
                         ids=[c.label for c in CHECKS])
def test_bf16_slab_form_matches_plain(shim, i):
    check = CHECKS[i]
    got, _, counts = _run(shim, check.run)
    assert set(counts) == set(check.kernels)
    assert _same(got, check.plain())


# The segments the walk is held on: (what, guess, x_{k-1} carried, start,
# sweeps, carry_out).
SEGMENTS = {
    "first": ("src", False, 0, 5, True),
    "first, ends the chain": ("src", False, 0, 7, False),
    "1 sweep": ("src", False, 0, 1, True),
    "chained": ("p", True, 3, 4, True),
    "chained, ends the chain": ("p", True, 3, 4, False),
}


def _segment(t, i, what):
    guess, carried, start, sweeps, carry_out = SEGMENTS[what]
    H = MZ
    args = (1, t.ext(getattr(t, guess), i, H),
            t.ext(t.p, i, H) if carried else None, t.ext(t.rhs_fast, i, H),
            t.flags(i))
    kw = dict(mz=MZ, H=H, alpha=t.a_visc, beta=1 + 6 * t.a_visc,
              cheby_rho=RHO, start=start, sweeps=sweeps, fast=True,
              carry_in=carried, carry_out=carry_out)
    return args, kw


@pytest.mark.parametrize("per_launch", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("what", list(SEGMENTS))
@pytest.mark.parametrize("pos", ["top", "interior", "bottom"])
def test_slab_walk_bf16_matches_per_sweep_form(shim, pos, what, per_launch):
    t = checks._Bf16Slab3Inputs(SIDE, MZ, "cpu", 1)
    args, kw = _segment(t, t.positions()[pos], what)
    got, launches, _ = _run(shim, cs3.fused_cheby3_slab, *args,
                            per_launch=per_launch, sms=4, **kw)
    chain, per_sweep, _ = _run(shim, cs3.fused_cheby3_slab, *args,
                               per_launch=0, **kw)
    assert _same(got, chain)
    assert _same(got, cs3.fused_cheby3_slab_plain(*args, **kw))
    start, sweeps = kw["start"], kw["sweeps"]
    stop = start + sweeps
    plan = co.sweep_plan(start, stop, stop, per_launch, prep=False,
                         cheby=True, carry_out=kw["carry_out"])
    assert [k for k, _ in launches] == ["jacobi3_slab_sweeps_bf16"] * len(
        plan)
    guess_bf16 = args[1].dtype == BF16
    for (_, a), step in zip(launches, plan):
        ends = step.ends_solve and not kw["carry_out"]
        assert a[WALK_TYPES] == (
            (co._X_BF16 if step.reads_guess and guess_bf16 else 0)
            | (co._XM_BF16 if step.reads_guess_as_xm and guess_bf16 else 0)
            | (co._OUT_BF16 if ends else 0))
    assert [k for k, _ in per_sweep] == ["jacobi3_slab_bf16"] * sweeps
    assert [a[SWEEP_TYPES] & co._OUT_BF16 for _, a in per_sweep] == [
        0] * (sweeps - 1) + [0 if kw["carry_out"] else co._OUT_BF16]


def test_slab_walk_bf16_refuses_a_guess_read_twice(shim):
    """No launch reads the caller's guess both as x_k and as x_{k-1}: the
    library refuses those operand types (cudaErrorInvalidValue)."""
    lib = ctypes.CDLL(str(shim[1]))
    fn = lib.fsc_jacobi3_slab_sweeps_bf16
    fn.argtypes = build._SIGNATURES["fsc_jacobi3_slab_sweeps_bf16"]
    fn.restype = ctypes.c_int
    t = checks._Bf16Slab3Inputs(SIDE, MZ, "cpu", 0)
    x, rhs = t.ext(t.x, 1, MZ), t.ext(t.rhs_fast, 1, MZ)
    omegas = (ctypes.c_float * 2)(1.0, 1.0)
    out = torch.empty_like(x)

    def launch(xm, types):
        return fn(x.data_ptr(), rhs.data_ptr(), None, xm, out.data_ptr(),
                  None, None, SIDE, 0, 1.0, 6.0, 1 / 6, 1 / 6, 0.0,
                  ctypes.addressof(omegas), 6, 1, 2, x.shape[0], 1, -1, -1,
                  types, None)

    assert launch(x.data_ptr(), co._X_BF16 | co._XM_BF16) != 0
    assert launch(None, co._X_BF16 | co._OUT_BF16) == 0


STEPS3 = {
    "parity windowed": (SIDE, 3, dict(jacobi_iters=10, max_courant=2),
                        "windowed"),
    "compensated fast exact": (SIDE, 4, dict(
        pressure_solver="chebyshev", diffusion_solver="chebyshev",
        cheby_rho=RHO, cheby_iters=K_D, cheby_press_iters=K_P,
        fast_math=True), "exact"),
    "compensated fast, tiled walk": (48, 3, dict(
        pressure_solver="chebyshev", diffusion_solver="chebyshev",
        cheby_rho=RHO, cheby_iters=K_D, cheby_press_iters=K_P,
        fast_math=True), "auto"),
}


@pytest.mark.parametrize("mode", list(STEPS3))
def test_bf16_zslab_step_through_the_kernels(shim, mode):
    import chip_smoke

    side, slabs, kw, advect_mode = STEPS3[mode]
    cfg = ft.SimConfig(n=side - 2, ndim=3, dtype=BF16, device="cpu",
                       backend="reference", **kw)
    object.__setattr__(cfg, "backend", "cuda")
    mesh = make_mesh([torch.device("cpu")] * slabs).reshape(slabs, 1)
    exact = advect_mode == "exact"
    gen = torch.Generator().manual_seed(3)
    state0, src = ft.reference_init(gen, cfg)
    src = ft.Sources(*(s * 400.0 for s in src))  # past the window
    state0, src, zero = (shard_state_3d(x, mesh) for x in (
        state0, src, ft.zero_sources(cfg)))

    def run(step):
        state = state0
        for k in range(2):
            state = step(state, src if k == 0 else zero)
        return unshard(state)

    kernels = _ZSlabStep(cfg, mesh, False, exact)
    got, _, counts = _run(shim, run, kernels, sms=8)
    per_step = chip_smoke.expected_launches_sharded3(cfg, slabs, exact)
    assert counts == {k: 2 * c for k, c in per_step.items() if c}
    assert all(f.dtype == BF16 for f in got)
    if mode.endswith("tiled walk"):
        assert counts["jacobi3_slab_sweeps_bf16"] > 0
    assert _same(tuple(got), tuple(run(_ZSlabStep(cfg, mesh, False, exact,
                                                  plain=True))))
