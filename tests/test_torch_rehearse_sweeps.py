"""The tiled K1 (``csrc/jacobi_tiles.cu``) runs T sweeps of a solve per
launch in shared-memory tiles.  A CUDA kernel has no interpret mode, so
this file compiles it with ``g++ -ffp-contract=off`` behind the host shim
of ``dev/rehearse_kernels_cpu.py`` (a block's threads run together,
``__syncthreads()`` is a barrier, the dynamic shared memory one buffer a
block), beside the per-sweep K1 (``csrc/jacobi.cu``), K4, K3 and K2, and
holds it bit for bit against the per-sweep K1 chain (the same sweeps one
launch each, ``cuda_ops.launch_sweeps(0)``) and against the plain version
``fused_jacobi_plain``: sides 34 and 66, one grid and a batch of three
whose first grid takes another boundary mode (``nb1``, as
``fused_jacobi_pair`` stacks u and v), every mode of a solve, T of 1, 2, 3
and 5 with solves of 1, T-1, T, T+1 and 20 sweeps, float32 and bf16
storage.  Each launch is checked against ``cuda_ops.sweep_plan``: the
sweeps it covers, its ω, where it stores the rhs it built and x_{k-1},
and which operands it reads and writes as bf16.  K4 takes the last sweep
of a density solve from the state the tiled chain leaves, which equals
the per-sweep chain's.  ``sweep_plan`` is also tested as a pure function.
Skips only without ``g++``.
"""
import ctypes
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fluidsimulationcuda_torch.core.config import PERF_POINTS_2D  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops as co  # noqa: E402
from fluidsimulationcuda_torch.ops.chebyshev import cheby_omegas  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi_tiles.cu", "jacobi.cu", "dens_advect.cu", "advect.cu",
           "project.cu")
DT = checks.DT
RHO, K_D, _ = PERF_POINTS_2D[2048]
MODES = {
    "jacobi": dict(),
    "zero_init": dict(zero_init=True),
    "src_dt": dict(src_dt=DT),
    "fast": dict(src_dt=DT, fast=True),
    "chebyshev": dict(src_dt=DT, cheby_rho=RHO),
    "chebyshev+fast": dict(src_dt=DT, fast=True, cheby_rho=RHO),
}
# (T, iters): 1, T-1, T, T+1 and 20 sweeps for T of 1, 2, 3 and 5.
PLANS = sorted({(t, k) for t in (1, 2, 3, 5) for k in (1, t - 1, t, t + 1, 20)
                if k >= 1})
GRIDS = {"34": (34, 0), "66x3": (66, 3)}
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}
# Positions of fsc_jacobi_sweeps(_bf16)'s arguments (csrc/jacobi_tiles.cu).
XM_OUT, RHS_OUT, OMEGAS, FIRST, COUNT, TYPES = 5, 6, 14, 16, 17, 21


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "sweeps")
    return mod, lib


def _run(shim, per_launch, fn, *args, **kw):
    """``fn`` through the shim library with ``per_launch`` sweeps a K1
    launch: (result, [(kernel, args)] of each launch)."""
    mod, lib = shim
    launches = []
    launch = co._launch

    def spy(kernel, fn_, *a):
        launches.append((kernel, a))
        if kernel.startswith("jacobi_sweeps"):  # the ω the launch was given
            w = ctypes.cast(a[OMEGAS], ctypes.POINTER(ctypes.c_float))
            launches[-1] = (kernel, a, [w[s] for s in range(a[COUNT])])
        launch(kernel, fn_, *a)

    co._launch = spy
    try:
        with mod.kernels_on_cpu(lib), co.launch_sweeps(per_launch):
            return fn(*args, **kw), launches
    finally:
        co._launch = launch


def _inputs(grid, dtype):
    side, batch = GRIDS[grid]
    t = checks._Inputs(side, "cpu", side, batch=batch)
    return t, tuple(f.to(dtype) for f in (t.src, t.x0))


def _solve(b, x_init, x0, alpha, beta, iters, **kw):
    """``fused_jacobi`` on one grid, or on a batch whose first grid takes
    boundary mode 2 and the rest ``b`` (the launch's nb1 split)."""
    if x0.dim() == 2:
        return co.fused_jacobi(b, x_init, x0, alpha, beta, iters, **kw)
    kw = dict(dict(zero_init=False, src_dt=None, fast=False, cheby_rho=None),
              **kw)
    return co._solve(2, 1, b, x_init, x0, alpha, beta, iters, **kw)


def _plain(b, x_init, x0, alpha, beta, iters, **kw):
    if x0.dim() == 2:
        return co.fused_jacobi_plain(b, x_init, x0, alpha, beta, iters, **kw)
    return torch.cat([
        co.fused_jacobi_plain(2, x_init[:1], x0[:1], alpha, beta, iters,
                              **kw),
        co.fused_jacobi_plain(b, x_init[1:], x0[1:], alpha, beta, iters,
                              **kw)])


def _check_plan(launches, plan, kw, dtype):
    """Each tiled launch against its step of the plan."""
    tiled = [launch for launch in launches
             if launch[0].startswith("jacobi_sweeps")]
    assert len(tiled) == len(plan)
    omegas = cheby_omegas(RHO, 20) if "cheby_rho" in kw else None
    bf16 = dtype == torch.bfloat16
    for (kernel, a, ws), step in zip(tiled, plan):
        assert kernel == ("jacobi_sweeps_bf16" if bf16 else "jacobi_sweeps")
        assert (a[FIRST], a[COUNT]) == (step.first, step.count)
        assert (a[RHS_OUT] is not None) == step.stores_rhs
        assert (a[XM_OUT] is not None) == step.stores_xm
        ks = range(step.first, step.first + step.count)
        assert ws == [co._f32(omegas[k - 1]) if omegas and k >= 1 else 0.0
                      for k in ks]
        if bf16:
            assert a[TYPES] == (
                (co._X_BF16 if step.reads_guess else 0)
                | (co._XM_BF16 if step.reads_guess_as_xm else 0)
                | (co._OUT_BF16 if step.ends_solve else 0))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("per_launch,iters", PLANS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_tiled_k1_matches_per_sweep_chain_and_plain(shim, grid, mode,
                                                    per_launch, iters, dtype):
    dtype = DTYPES[dtype]
    t, (src, x0) = _inputs(grid, dtype)
    kw = MODES[mode]
    args = (1, src, x0, t.a_visc, 1 + 4 * t.a_visc, iters)
    got, launches = _run(shim, per_launch, _solve, *args, **kw)
    chain, per_sweep = _run(shim, 0, _solve, *args, **kw)
    assert got.dtype == dtype
    assert torch.equal(got, chain)
    assert torch.equal(got, _plain(*args, **kw))
    _check_plan(launches, co.sweep_plan(
        0, iters, iters, per_launch, prep="src_dt" in kw or "fast" in kw,
        cheby="cheby_rho" in kw, guess="zero_init" not in kw), kw, dtype)
    name = "jacobi_sweep_bf16" if dtype == torch.bfloat16 else "jacobi_sweep"
    assert [k for k, *_ in per_sweep] == [name] * iters


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["zero_init", "src_dt", "chebyshev+fast"])
@pytest.mark.parametrize("side,per_launch", [(55, 5), (59, 3), (119, 5)])
def test_tiled_k1_where_a_tile_holds_only_the_last_ghost_line(
        shim, side, per_launch, mode, dtype):
    """A side one past a multiple of the output tile's height (55, 59) or
    width (119) at T sweeps a launch leaves the last row or column of
    tiles only the grid's last ghost line, whose value derives from the
    line before it: the launch takes a halo one cell deeper there, and the
    result stays bit for bit."""
    dtype = DTYPES[dtype]
    t = checks._Inputs(side, "cpu", side)
    src, x0 = (f.to(dtype) for f in (t.src, t.x0))
    args = (2, src, x0, t.a_visc, 1 + 4 * t.a_visc, 20)
    kw = MODES[mode]
    got, _ = _run(shim, per_launch, co.fused_jacobi, *args, **kw)
    chain, _ = _run(shim, 0, co.fused_jacobi, *args, **kw)
    assert torch.equal(got, chain)
    assert torch.equal(got, co.fused_jacobi_plain(*args, **kw))


@pytest.mark.parametrize("per_launch,iters", [(1, 2), (2, 6), (3, 20),
                                              (5, 1), (5, 6), (5, 20)])
@pytest.mark.parametrize("mode", ["src_dt", "fast", "chebyshev",
                                  "chebyshev+fast"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_k4_after_the_tiled_chain(shim, grid, mode, per_launch, iters):
    """``fused_dens_advect``: the tiled K1 runs iters-1 sweeps, K4 the last
    from the state the chain leaves; equal to the same call on the
    per-sweep K1 bit for bit and to its plain version (within
    ``checks.TOL`` in fast mode, bit for bit otherwise)."""
    t, _ = _inputs(grid, torch.float32)
    kw = {k: v for k, v in MODES[mode].items() if k != "src_dt"}
    args = (0, t.src, t.x0, t.u, t.v, t.a_diff, 1 + 4 * t.a_diff, iters, DT,
            t.n)
    got, launches = _run(shim, per_launch, co.fused_dens_advect, *args,
                         cmax=1, **kw)
    chain, _ = _run(shim, 0, co.fused_dens_advect, *args, cmax=1, **kw)
    want = co.fused_dens_advect_plain(*args, cmax=1, **kw)
    assert torch.equal(got, chain)
    err = checks.max_abs_diff(got, want)
    assert err <= checks.TOL if "fast" in kw else err == 0.0
    assert [k for k, *_ in launches][-1] == "dens_advect"
    _check_plan(launches, co.sweep_plan(
        0, iters - 1, iters, per_launch, prep=True,
        cheby="cheby_rho" in kw), MODES[mode], torch.float32)


@pytest.mark.parametrize("per_launch", [1, 2, 3, 5])
@pytest.mark.parametrize("mode", ["src_dt", "fast", "chebyshev",
                                  "chebyshev+fast"])
def test_tiled_chain_leaves_the_per_sweep_state(shim, mode, per_launch):
    """What K4 reads after 19 sweeps (x, x_{k-1}, the stored rhs, k and
    prep of ``_Sweeps``) is the same after the tiled launches as after 19
    per-sweep launches; the rhs only on the interior, which is all a sweep
    reads of it."""
    mod, lib = shim
    t, _ = _inputs("66x3", torch.float32)
    kw = MODES[mode]
    states = []
    for forced in (per_launch, 0):
        with mod.kernels_on_cpu(lib) as handle, co.launch_sweeps(forced):
            run = co._Sweeps(0, t.src, t.x0, t.a_diff, 1 + 4 * t.a_diff, 20,
                             zero_init=False, src_dt=DT,
                             fast=kw.get("fast", False),
                             cheby_rho=kw.get("cheby_rho"))
            run.run(handle, 19, 3, 3, 0)
        states.append(run)
    tiled, chain = states
    assert (tiled.k, tiled.prep) == (chain.k, chain.prep) == (19, False)
    assert torch.equal(tiled.x, chain.x)
    assert (tiled.xm is None) == (chain.xm is None)
    if chain.xm is not None:
        assert torch.equal(tiled.xm, chain.xm)
    assert torch.equal(tiled.rhs[..., 1:-1, 1:-1], chain.rhs[..., 1:-1, 1:-1])
    assert tiled.next_args()[4:] == chain.next_args()[4:]


def test_launch_sweeps_takes_0_to_the_most_a_launch_runs(shim):
    """``launch_sweeps`` refuses a negative count; the library runs a
    launch of 20 sweeps (its kMaxSweeps, JAX's max_fused), a whole solve,
    and refuses one of 21 through ``_launch``, with nothing launched;
    ``SWEEPS_PER_LAUNCH`` lies in between."""
    with pytest.raises(ValueError):
        with co.launch_sweeps(-1):
            pass
    assert 1 <= co.SWEEPS_PER_LAUNCH <= 20
    t, _ = _inputs("34", torch.float32)
    args = (1, t.src, t.x0, t.a_visc, 1 + 4 * t.a_visc)
    got, launches = _run(shim, 20, co.fused_jacobi, *args, 20, src_dt=DT)
    assert [k for k, *_ in launches] == ["jacobi_sweeps"]
    assert torch.equal(got, co.fused_jacobi_plain(*args, 20, src_dt=DT))
    co.reset_launch_counts()
    with pytest.raises(RuntimeError, match="jacobi_sweeps failed"):
        _run(shim, 21, co.fused_jacobi, *args, 21, src_dt=DT)
    assert co.launch_counts()["jacobi_sweeps"] == 0


def _steps(plan):
    return [(s.first, s.count) for s in plan]


@pytest.mark.parametrize("start,stop,end,per_launch,want", [
    (0, 20, 20, 5, [(0, 5), (5, 5), (10, 5), (15, 5)]),
    (0, 20, 20, 3, [(0, 3), (3, 3), (6, 3), (9, 3), (12, 3), (15, 3),
                    (18, 2)]),
    (0, 19, 20, 5, [(0, 5), (5, 5), (10, 5), (15, 4)]),
    (0, 4, 4, 5, [(0, 4)]),
    (0, 0, 1, 5, []),
    (7, 12, 12, 2, [(7, 2), (9, 2), (11, 1)]),
    (0, 3, 3, 1, [(0, 1), (1, 1), (2, 1)]),
])
def test_sweep_plan_covers_the_sweeps(start, stop, end, per_launch, want):
    """The sweeps of each launch: T each, the remainder last; a launch's
    first sweep k takes ω = cheby_omegas[k-1] (``SweepLaunch.first``)."""
    plan = co.sweep_plan(start, stop, end, per_launch, prep=True, cheby=True)
    assert _steps(plan) == want
    assert [s.ends_solve for s in plan] == [
        s.first + s.count == end for s in plan]


def test_sweep_plan_stores_only_what_follows_reads():
    # A folded 20-sweep solve: the first launch stores its rhs, no
    # x_{k-1} (Jacobi), the last writes the result (bf16 in bf16 storage).
    plan = co.sweep_plan(0, 20, 20, 5, prep=True, cheby=False)
    assert [s.stores_rhs for s in plan] == [True, False, False, False]
    assert not any(s.stores_xm for s in plan)
    assert [s.reads_guess for s in plan] == [True, False, False, False]
    assert [s.ends_solve for s in plan] == [False, False, False, True]
    # One launch for the whole solve: nothing follows, nothing is stored.
    (one,) = co.sweep_plan(0, 4, 4, 5, prep=True, cheby=True)
    assert (one.stores_rhs, one.stores_xm, one.ends_solve) == (False, False,
                                                               True)
    # The density's Chebyshev chain before K4: every launch stores its
    # x_{k-1}, the first its rhs, none ends the solve (K4 does).
    plan = co.sweep_plan(0, 9, 10, 5, prep=True, cheby=True)
    assert [s.stores_xm for s in plan] == [True, True]
    assert [s.stores_rhs for s in plan] == [True, False]
    assert not any(s.ends_solve for s in plan)
    # A 1-sweep launch's x_{k-1} is its input: it stores none, and after a
    # first 1-sweep launch the next reads the caller's guess as x_{k-1}.
    plan = co.sweep_plan(0, 3, 3, 1, prep=False, cheby=True)
    assert not any(s.stores_xm for s in plan)
    assert [s.reads_guess_as_xm for s in plan] == [False, True, False]
    # The zero guess: no guess to read, as x or as x_{k-1}.
    plan = co.sweep_plan(0, 3, 3, 1, prep=False, cheby=True, guess=False)
    assert not any(s.reads_guess or s.reads_guess_as_xm for s in plan)
