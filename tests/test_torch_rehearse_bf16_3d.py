"""The bf16 forms of the 3-D kernels: K5 per sweep (``csrc/jacobi3.cu``) and
tiled (``csrc/jacobi3_tiles.cu``), K6 (``csrc/advect3.cu``), K7 and K8
(``csrc/project3.cu``).  A CUDA kernel has no interpret mode, so this file
compiles the four sources with ``g++ -ffp-contract=off`` behind the host
shim of ``dev/rehearse_kernels_cpu.py`` (the tiled K5 runs a block's
threads together, ``__syncthreads()`` a barrier) and holds every bf16 form
bit for bit against its plain twin on CPU tensors:

- every call of ``checks.kernel_checks3_bf16`` at volume side 18 (their
  guesses' ghost faces random, so each first sweep reads a raw ring), and
  each tiled call against the same call on the per-sweep K5's bf16 form;
- the tiled K5's bf16 form at T of 1 to 6 on solves of 1, T+1, 10 and 12
  sweeps (side 18, and side 34 on 64 shim SMs: two tiles a side, many
  z-chunks), against the per-sweep chain and the twin, each launch's
  operand types checked (the caller's guess read as bf16 by the first
  launch, as x_{k-1} by a second after a 1-sweep first, bf16 written by
  the last only);
- K6's bf16 form on random, smooth and shear velocities, one field and the
  triple, exact and in windows of 1 and 2 cells;
- the bf16 3-D step through the kernels (the ``cuda`` backend on CPU
  tensors) against the plain twins' step, ``_Ops3(cfg, plain=True)``, bit
  for bit over two steps, its launches those of
  ``chip_smoke.expected_launches3``: parity, compensated with fast math
  (the tiled K5), windowed;
- the operand types the tiled K5's bf16 form refuses.

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
from fluidsimulationcuda_torch.kernels import cuda_ops_3d as co3  # noqa: E402
from fluidsimulationcuda_torch.models.stable_fluids_3d import _Ops3  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi3_tiles.cu", "jacobi3.cu", "advect3.cu", "project3.cu")
SIDE = 18
BF16 = torch.bfloat16
DT = checks.DT
RHO, K_D, K_P = PERF_POINT_3D
CHECKS = checks.kernel_checks3_bf16(SIDE, "cpu", 0)
# Position of the tiled K5's operand types (csrc/jacobi3_tiles.cu,
# fsc_jacobi3_sweeps_bf16) and of its sweep count.
TYPES, COUNT = 18, 17


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "bf16_3d")
    return mod, lib


def _run(shim, fn, *args, per_launch=None, sms=1, **kw):
    """``fn`` through the shim library on a shim device of ``sms`` SMs,
    with ``per_launch`` sweeps a tiled launch (0: the per-sweep K5; None:
    as the path chooses): (result, [(kernel, args)] of each solve's
    launch, the launch counts of the call)."""
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
    if isinstance(got, tuple):
        return all(_same(g, w) for g, w in zip(got, want))
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("i", range(len(CHECKS)),
                         ids=[c.label for c in CHECKS])
def test_bf16_3d_form_matches_plain(shim, i):
    check = CHECKS[i]
    got, _, counts = _run(shim, check.run)
    assert set(counts) == set(check.kernels)
    assert _same(got, check.plain())


@pytest.mark.parametrize("i", [i for i, c in enumerate(CHECKS)
                               if c.kernels == checks.JAC3_16],
                         ids=[c.label for c in CHECKS
                              if c.kernels == checks.JAC3_16])
def test_tiled_bf16_k5_matches_its_per_sweep_form(shim, i):
    check = CHECKS[i]
    got, *_ = _run(shim, check.run)
    chain, _, counts = _run(shim, check.run, per_launch=0)
    assert set(counts) == set(checks.JAC3_SWEEP_16)
    assert torch.equal(got, chain)


# (side, T, sweeps): 1, T+1, 10 and 12 sweeps for T of 1 to 6 at side 18;
# T3 on 10 and 12 at side 34.
PLANS = sorted({(SIDE, t, k) for t in range(1, 7) for k in (1, t + 1, 10, 12)}
               | {(34, 6, 10), (34, 6, 12)})
SMS = {SIDE: 1, 34: 64}


@pytest.mark.parametrize("side,per_launch,iters", PLANS)
def test_tiled_bf16_k5_at_any_sweeps_per_launch(shim, side, per_launch,
                                                iters):
    t = checks._Bf16Inputs3(side, "cpu", side)
    args = (1, t.src, t.x0, t.a_visc, 1 + 6 * t.a_visc, iters)
    kw = dict(src_dt=DT, fast=True, cheby_rho=RHO)
    got, launches, _ = _run(shim, co3.fused_jacobi3, *args,
                            per_launch=per_launch, sms=SMS[side], **kw)
    chain, *_ = _run(shim, co3.fused_jacobi3, *args, per_launch=0, **kw)
    assert torch.equal(got, chain)
    assert _same(got, co3.fused_jacobi3_plain(*args, **kw))
    plan = co.sweep_plan(0, iters, iters, per_launch, prep=True, cheby=True)
    assert [k for k, _ in launches] == ["jacobi3_sweeps_bf16"] * len(plan)
    for (_, a), step in zip(launches, plan):
        assert a[COUNT] == step.count
        assert a[TYPES] == ((co._X_BF16 if step.reads_guess else 0)
                            | (co._XM_BF16 if step.reads_guess_as_xm else 0)
                            | (co._OUT_BF16 if step.ends_solve else 0))


FLOWS = ("random", "smooth", "shear")


@pytest.mark.parametrize("cmax", [None, 1, 2], ids=["exact", "cmax1",
                                                    "cmax2"])
@pytest.mark.parametrize("flow", FLOWS)
def test_bf16_k6_on_flows(shim, flow, cmax):
    t = checks._Inputs(24, "cpu", 5, ndim=3)
    vel = tuple(f.to(BF16) for f in checks.gather_velocities(t)[flow][:3])
    x = t.x.to(BF16)
    for bs, fields in (((0,), (x,)), ((1, 2, 3), vel)):
        args = (bs, fields, *vel, DT, t.n, cmax)
        got, _, counts = _run(shim, co3.advect3_shift_fused, *args)
        assert counts == {"advect3_bf16" if cmax is None
                          else "advect3_windowed_bf16": 1}
        assert _same(got, co3.advect3_shift_fused_plain(*args))


STEPS3 = {"parity": dict(jacobi_iters=6),
          "compensated fast": dict(pressure_solver="chebyshev",
                                   diffusion_solver="chebyshev",
                                   cheby_rho=RHO, cheby_iters=K_D,
                                   cheby_press_iters=K_P, fast_math=True),
          "windowed": dict(jacobi_iters=6, advect_mode="windowed",
                           max_courant=1)}


@pytest.mark.parametrize("mode", list(STEPS3))
def test_bf16_step3_through_the_kernels(shim, mode):
    import chip_smoke

    cfg = ft.SimConfig(n=SIDE - 2, ndim=3, dtype=BF16, device="cpu",
                       backend="reference", **STEPS3[mode])
    object.__setattr__(cfg, "backend", "cuda")
    gen = torch.Generator().manual_seed(3)
    state0, src = ft.reference_init(gen, cfg)
    src = ft.Sources(*(s * 400.0 for s in src))  # past the 1-cell window

    def run(ops=None):
        state = state0
        for k in range(2):
            state = ft.step3(cfg, state, src if k == 0
                             else ft.zero_sources(cfg), ops)
        return state

    got, _, counts = _run(shim, run)
    per_step = chip_smoke.expected_launches3(cfg)
    assert counts == {k: 2 * c for k, c in per_step.items() if c}
    assert all(f.dtype == BF16 for f in got)
    assert _same(tuple(got), tuple(run(_Ops3(cfg, plain=True))))


def test_tiled_bf16_k5_refuses_a_guess_read_twice(shim):
    """No launch reads the caller's guess both as x_k and as x_{k-1}: the
    library refuses those operand types (cudaErrorInvalidValue)."""
    lib = ctypes.CDLL(str(shim[1]))
    fn = lib.fsc_jacobi3_sweeps_bf16
    fn.argtypes = build._SIGNATURES["fsc_jacobi3_sweeps_bf16"]
    fn.restype = ctypes.c_int
    t = checks._Bf16Inputs3(SIDE, "cpu", 0)
    omegas = (ctypes.c_float * 2)(1.0, 1.0)
    out = torch.empty_like(t.x)

    def launch(xm, types):
        return fn(t.x.data_ptr(), t.x0.data_ptr(), None, xm, out.data_ptr(),
                  None, None, SIDE, 0, 1.0, 6.0, 1 / 6, 1 / 6, 0.0,
                  ctypes.addressof(omegas), 6, 1, 2, types, None)

    assert launch(t.x.data_ptr(), co._X_BF16 | co._XM_BF16) != 0
    assert launch(None, co._X_BF16 | co._OUT_BF16) == 0
