"""The tiled 3-D Jacobi (``csrc/jacobi3_tiles.cu``) runs T3 sweeps of a
Chebyshev solve in fast mode per launch, each block walking a (y, x) tile
along z in shared memory: K5's solves on a volume and K13's segments on a
z-slab.  A CUDA kernel has no interpret mode, so this file compiles it
with ``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py`` (a block's threads run together,
``__syncthreads()`` is a barrier, the dynamic shared memory one buffer a
block), beside the per-sweep K5 (``csrc/jacobi3.cu``) and K13
(``csrc/jacobi3_slab.cu``), and holds it bit for bit against the per-sweep
chains (the same sweeps one launch each, ``cuda_ops.launch_sweeps(0)``)
and within ``checks.TOL`` against the plain versions
``fused_jacobi3_plain`` and ``fused_cheby3_slab_plain`` (both take
``fmaf``'s product and sum in float64, the z-slab one since its bf16
forms came): volumes of
side 18 and 34 (34 needs two tiles in y and two z-chunks, the last of each
moved back to end at the volume's end) for the step's three kinds of
solve (a source fold, the zero guess, a guess), T of 1 to 6 with solves
of 1, T-1, T, T+1 and 20 sweeps, and the 10- and 12-sweep solves at
T3 = 6; side 66 (two tiles in x); top, interior and bottom z-slabs, a
Chebyshev chain split into segments with ``start > 0`` and x_{k-1}
carried in and out, at T of 1 to 6 and on the 8-slab step's geometry
(10- and 12-sweep segments, 6 + 4 and 6 + 6 launches); the rule of
``cuda_ops.tiled3`` (the one mode the library builds, and buffers of at
least 5*T3 planes).  Each launch is checked against
``cuda_ops.sweep_plan``: the sweeps it covers, its ω, the sweeps done
before it on a slab, and where it stores the rhs it built and x_{k-1}.
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

from fluidsimulationcuda_torch.core.config import PERF_POINT_3D  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops as co  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops_3d as co3  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded_3d as cs3  # noqa: E402
from fluidsimulationcuda_torch.ops.chebyshev import cheby_omegas  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi3_tiles.cu", "jacobi3.cu", "jacobi3_slab.cu")
DT = checks.DT
RHO = PERF_POINT_3D[0]
FAST_CHEBY = dict(fast=True, cheby_rho=RHO)
# The step's Chebyshev+fast solves on a volume: (b, guess and rhs, kwargs).
SOLVES = {
    "source fold": (1, ("src", "x0"), dict(src_dt=DT)),
    "zero guess": (0, ("p", "p"), dict(zero_init=True)),
    "guess": (2, ("x", "x0"), dict()),
}
# (side, T, iters): 1, T-1, T, T+1 and 20 sweeps for T of 1 to 6, and the
# compensated point's 10- and 12-sweep solves at T3.
PLANS = sorted({(side, t, k) for side in (18, 34) for t in range(1, 7)
                for k in (1, t - 1, t, t + 1, 20) if k >= 1}
               | {(34, 6, 10), (34, 6, 12)})
# The shim device's SMs for each volume side: one z-chunk a tile at 18,
# chunks of 2 planes at 34 (many chunks, the last moved back).
SMS = {18: 1, 34: 64}
# Positions of the tiled kernel's arguments (csrc/jacobi3_tiles.cu).
XM_OUT, RHS_OUT, OMEGAS, FIRST, COUNT, DONE = 5, 6, 14, 16, 17, 19


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "sweeps3")
    return mod, lib


def _run(shim, per_launch, fn, *args, sms=1, **kw):
    """``fn`` through the shim library with ``per_launch`` sweeps a tiled
    launch (0: the per-sweep kernels; None: as the path chooses,
    ``cuda_ops.tiled3``) on a shim device of ``sms`` SMs (more SMs, more
    z-chunks a launch): (result, [(kernel, args, ω)] of each launch)."""
    mod, lib = shim
    launches = []
    launch = co._launch

    def spy(kernel, fn_, *a):
        ws = None
        if kernel.endswith("_sweeps"):  # the ω the launch was given
            w = ctypes.cast(a[OMEGAS], ctypes.POINTER(ctypes.c_float))
            ws = [w[s] for s in range(a[COUNT])]
        launches.append((kernel, a, ws))
        launch(kernel, fn_, *a)

    forced = (contextlib.nullcontext() if per_launch is None
              else co.launch_sweeps(per_launch))
    co._launch = spy
    try:
        with mod.kernels_on_cpu(lib) as handle, forced:
            mod.set_device(handle, sms)
            return fn(*args, **kw), launches
    finally:
        co._launch = launch


def _check_plan(launches, plan, kernel, done=None):
    """Each tiled launch against its step of the plan; ``done``: the
    segment's first sweep, for a z-slab's sweeps done before a launch."""
    assert [k for k, *_ in launches] == [kernel] * len(plan)
    omegas = cheby_omegas(RHO, 40)
    for (_, a, ws), step in zip(launches, plan):
        assert (a[FIRST], a[COUNT]) == (step.first, step.count)
        assert (a[RHS_OUT] is not None) == step.stores_rhs
        assert (a[XM_OUT] is not None) == step.stores_xm
        if done is not None:
            assert a[DONE] == step.first - done
        ks = range(step.first, step.first + step.count)
        assert ws == [co._f32(omegas[k - 1]) if k >= 1 else 0.0 for k in ks]


def _volume(side):
    return checks._Inputs(side, "cpu", side, ndim=3)


def _solve_args(t, solve, iters):
    b, (x, rhs), kw = SOLVES[solve]
    alpha, beta = ((1.0, 6.0) if b == 0
                   else (t.a_visc, 1 + 6 * t.a_visc))
    return (b, getattr(t, x), getattr(t, rhs), alpha, beta, iters), kw


@pytest.mark.parametrize("side,per_launch,iters", PLANS)
@pytest.mark.parametrize("solve", list(SOLVES))
def test_tiled_k5_matches_per_sweep_chain_and_plain(shim, solve, side,
                                                    per_launch, iters):
    t = _volume(side)
    args, kw = _solve_args(t, solve, iters)
    kw = dict(kw, **FAST_CHEBY)
    got, launches = _run(shim, per_launch, co3.fused_jacobi3, *args,
                         sms=SMS[side], **kw)
    chain, per_sweep = _run(shim, 0, co3.fused_jacobi3, *args, **kw)
    assert torch.equal(got, chain)
    want = co3.fused_jacobi3_plain(*args, **kw)
    assert checks.max_abs_diff(got, want) <= checks.TOL
    _check_plan(launches, co.sweep_plan(
        0, iters, iters, per_launch, prep=True, cheby=True,
        guess="zero_init" not in kw), "jacobi3_sweeps")
    assert [k for k, *_ in per_sweep] == ["jacobi3_sweep"] * iters


@pytest.mark.parametrize("solve", ["zero guess", "source fold"])
def test_tiled_k5_with_two_tiles_in_x(shim, solve):
    """Side 66 at T = 3 on 5 SMs: two tiles in x, three in y and 5 chunks
    in z, the last of each moved back; 7 sweeps in three launches."""
    t = _volume(66)
    args, kw = _solve_args(t, solve, 7)
    kw = dict(kw, **FAST_CHEBY)
    got, launches = _run(shim, 3, co3.fused_jacobi3, *args, sms=5, **kw)
    chain, _ = _run(shim, 0, co3.fused_jacobi3, *args, **kw)
    assert torch.equal(got, chain)
    want = co3.fused_jacobi3_plain(*args, **kw)
    assert checks.max_abs_diff(got, want) <= checks.TOL
    assert len(launches) == 3


# The z-slab step's Chebyshev+fast segments on slabs of 8 planes at side
# 24 with H = 8 halo planes, as checks.kernel_checks_slab3 builds them.
SLAB_SEGMENTS = {
    "first segment": dict(start=0, sweeps=3),
    "chained segment": dict(start=3, sweeps=7),
    "pressure": dict(start=0, sweeps=7, zero_init=True),
}
SIDE3, MZ = 24, 8


def _segment_args(t, i, H, segment):
    """(args, kwargs) of ``fused_cheby3_slab`` for ``segment`` of slab
    ``i``: a chained segment's x_{k-1} carried in, every segment's handed
    on (``carry_out``)."""
    zero = segment.get("zero_init", False)
    xm = t.ext(t.p, i, H) if segment["start"] > 0 else None
    rhs = t.p if zero else t.x0
    args = (0 if zero else 1, t.ext(t.x, i, H), xm, t.ext(rhs, i, H),
            t.flags(i))
    alpha, beta = (1.0, 6.0) if zero else (t.a_visc, 1 + 6 * t.a_visc)
    kw = dict(mz=t.mz, H=H, alpha=alpha, beta=beta, carry_in=xm is not None,
              carry_out=True, **FAST_CHEBY, **segment)
    return args, kw


@pytest.mark.parametrize("per_launch,sms", [(1, 1), (2, 3), (3, 16), (4, 2),
                                            (6, 4)])
@pytest.mark.parametrize("segment", list(SLAB_SEGMENTS))
@pytest.mark.parametrize("pos", ["top", "interior", "bottom"])
def test_tiled_k13_matches_per_sweep_chain_and_plain(shim, pos, segment,
                                                     per_launch, sms):
    """One z-slab segment from the tiled kernel, the per-sweep K13 chain
    and the plain version; a chained segment resumes at ``start`` with
    x_{k-1} carried in, and every segment hands x_{k-1} on
    (``carry_out``), held too."""
    t = checks._Slab3Inputs(SIDE3, MZ, "cpu", 0)
    seg = SLAB_SEGMENTS[segment]
    args, kw = _segment_args(t, t.positions()[pos], MZ, seg)
    got, launches = _run(shim, per_launch, cs3.fused_cheby3_slab, *args,
                         sms=sms, **kw)
    chain, per_sweep = _run(shim, 0, cs3.fused_cheby3_slab, *args, **kw)
    want = cs3.fused_cheby3_slab_plain(*args, **kw)
    for g, c, w in zip(got, chain, want):
        assert torch.equal(g, c)
        assert checks.max_abs_diff(g, w) <= checks.TOL
    start, stop = seg["start"], seg["start"] + seg["sweeps"]
    _check_plan(launches, co.sweep_plan(
        start, stop, stop, per_launch, prep=True, cheby=True,
        guess=not seg.get("zero_init"), carry_out=True),
        "jacobi3_slab_sweeps", done=start)
    assert [k for k, *_ in per_sweep] == ["jacobi3_slab"] * seg["sweeps"]


def _chain(t, i, H, segments, segment):
    """A Chebyshev+fast chain as ``segments`` (their sweeps) on slab ``i``,
    each on freshly cut buffers of its input (as the z-slab step exchanges
    them), x_{k-1} carried from segment to segment: each segment's (x,
    x_{k-1})."""
    x, xm, done, out = t.x, None, 0, []
    for sweeps in segments:
        ms = None if xm is None else t.ext(xm, i, H)
        res = segment(1, t.ext(x, i, H), ms, t.ext(t.x0, i, H), t.flags(i),
                      mz=t.mz, H=H, alpha=t.a_visc, beta=1 + 6 * t.a_visc,
                      start=done, sweeps=sweeps, carry_in=ms is not None,
                      carry_out=True, **FAST_CHEBY)
        out.append(res)
        # The global volume with this slab's planes replaced: the next
        # segment's buffers come from it.
        x, xm = t.x.clone(), t.x.clone()
        x[i * t.mz:(i + 1) * t.mz], xm[i * t.mz:(i + 1) * t.mz] = res
        done += sweeps
    return out


@pytest.mark.parametrize("per_launch", [2, 3, 6])
@pytest.mark.parametrize("pos", ["top", "interior", "bottom"])
def test_chebyshev_chain_split_into_segments(shim, pos, per_launch):
    """A 12-sweep chain as segments of 5, 5 and 2 sweeps: the slab equals
    the per-sweep chain's at every segment and the whole chain's plain
    result within ``checks.TOL``."""
    t = checks._Slab3Inputs(SIDE3, MZ, "cpu", 1)
    i, H = t.positions()[pos], 6

    def tiled(*args, **kw):
        return _run(shim, per_launch, cs3.fused_cheby3_slab, *args, sms=4,
                    **kw)[0]

    def per_sweep(*args, **kw):
        return _run(shim, 0, cs3.fused_cheby3_slab, *args, **kw)[0]

    segments = (5, 5, 2)
    want = _chain(t, i, H, segments, cs3.fused_cheby3_slab_plain)
    for (a, am), (b, bm), (w, wm) in zip(
            _chain(t, i, H, segments, tiled),
            _chain(t, i, H, segments, per_sweep), want):
        assert torch.equal(a, b) and torch.equal(am, bm)
        assert checks.max_abs_diff((a, am), (w, wm)) <= checks.TOL


@pytest.mark.parametrize("sweeps", [10, 12])
@pytest.mark.parametrize("pos", ["top", "interior", "bottom"])
def test_step_geometry_chain_takes_the_tiled_k13(shim, pos, sweeps):
    """The 8-slab step's geometry at a small side: a chain of two
    ``sweeps``-sweep segments on slabs of 16 planes of 48³ with H =
    sweeps+1 (buffers of 38 and 42 planes, at least 5*T3), run as the
    path chooses: each segment T3 + the rest sweeps in launches of the
    tiled K13, x_{k-1} carried from the first to the second; equal to the
    per-sweep chain bit for bit and to the plain chain within
    ``checks.TOL``."""
    t = checks._Slab3Inputs(48, 16, "cpu", 2)
    i, H = t.positions()[pos], sweeps + 1
    plans = []

    def path(*args, **kw):
        res, launches = _run(shim, None, cs3.fused_cheby3_slab, *args, sms=8,
                             **kw)
        plans.append(launches)
        return res

    def per_sweep(*args, **kw):
        return _run(shim, 0, cs3.fused_cheby3_slab, *args, **kw)[0]

    segments = (sweeps, sweeps)
    want = _chain(t, i, H, segments, cs3.fused_cheby3_slab_plain)
    for (a, am), (b, bm), (w, wm) in zip(
            _chain(t, i, H, segments, path),
            _chain(t, i, H, segments, per_sweep), want):
        assert torch.equal(a, b) and torch.equal(am, bm)
        assert checks.max_abs_diff((a, am), (w, wm)) <= checks.TOL
    T3 = co.SWEEPS_PER_LAUNCH_3D
    for done, launches in zip((0, sweeps), plans):
        _check_plan(launches, co.sweep_plan(
            done, done + sweeps, done + sweeps, T3, prep=True, cheby=True,
            carry_out=True), "jacobi3_slab_sweeps", done=done)


@pytest.mark.parametrize("pos", ["top", "interior", "bottom"])
def test_thin_buffers_keep_the_per_sweep_k13(shim, pos):
    """A 7-sweep segment on a 24-plane buffer (slabs of 8 planes, H = 8:
    fewer than 5*T3 planes) takes the per-sweep K13 on the path, one
    launch a sweep, and equals the tiled kernel's result bit for bit."""
    t = checks._Slab3Inputs(SIDE3, MZ, "cpu", 3)
    args, kw = _segment_args(t, t.positions()[pos], MZ,
                             SLAB_SEGMENTS["chained segment"])
    got, launches = _run(shim, None, cs3.fused_cheby3_slab, *args, **kw)
    tiled, _ = _run(shim, co.SWEEPS_PER_LAUNCH_3D, cs3.fused_cheby3_slab,
                    *args, sms=4, **kw)
    assert [k for k, *_ in launches] == ["jacobi3_slab"] * 7
    for g, w in zip(got, tiled):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cheby,fast,planes,tiled", [
    (True, True, None, True), (True, True, 30, True),
    (True, True, 29, False), (True, False, None, False),
    (False, True, None, False), (False, False, 60, False)])
def test_tiled3_takes_fast_chebyshev_on_volumes_and_thick_buffers(
        cheby, fast, planes, tiled):
    """``cuda_ops.tiled3``: the tiled kernel's one mode, on a volume or on
    a z-slab buffer of at least 5*T3 planes."""
    assert co.SWEEPS_PER_LAUNCH_3D == 6
    assert co.tiled3(cheby, fast, planes) is tiled


def test_tiled_chain_leaves_the_per_sweep_state(shim):
    """After a volume solve's tiled launches (x, x_{k-1}, the stored rhs,
    k and prep of ``_Sweeps``) equal what the per-sweep launches leave;
    the rhs only on the interior, which is all a sweep reads of it."""
    mod, lib = shim
    t = _volume(18)
    states = []
    for forced in (3, 0):
        with mod.kernels_on_cpu(lib) as handle, co.launch_sweeps(forced):
            run = co._Sweeps(1, t.src, t.x0, t.a_visc, 1 + 6 * t.a_visc, 8,
                             zero_init=False, src_dt=DT, fast=True,
                             cheby_rho=RHO, kernel="jacobi3_sweep")
            run.run3(handle, carry_out=True)
        states.append(run)
    tiled, chain = states
    assert (tiled.k, tiled.prep) == (chain.k, chain.prep) == (8, False)
    assert torch.equal(tiled.x, chain.x)
    assert torch.equal(tiled.xm, chain.xm)
    inner = (slice(1, -1),) * 3
    assert torch.equal(tiled.rhs[inner], chain.rhs[inner])


def test_launch_sweeps_takes_the_most_a_3d_launch_runs(shim):
    """The library runs a 3-D launch of 6 sweeps (its kMaxSweeps) and
    refuses one of 7 through ``_launch``, with nothing launched;
    ``SWEEPS_PER_LAUNCH_3D`` lies in between."""
    assert 1 <= co.SWEEPS_PER_LAUNCH_3D <= 6
    t = _volume(18)
    args = (1, t.src, t.x0, t.a_visc, 1 + 6 * t.a_visc)
    kw = dict(src_dt=DT, **FAST_CHEBY)
    got, launches = _run(shim, 6, co3.fused_jacobi3, *args, 6, **kw)
    assert [k for k, *_ in launches] == ["jacobi3_sweeps"]
    chain, _ = _run(shim, 0, co3.fused_jacobi3, *args, 6, **kw)
    assert torch.equal(got, chain)
    co.reset_launch_counts()
    with pytest.raises(RuntimeError, match="jacobi3_sweeps failed"):
        _run(shim, 7, co3.fused_jacobi3, *args, 7, **kw)
    assert co.launch_counts()["jacobi3_sweeps"] == 0


@pytest.mark.parametrize("mode", [
    dict(), dict(zero_init=True), dict(src_dt=DT), dict(src_dt=DT, fast=True),
    dict(src_dt=DT, cheby_rho=RHO)],
    ids=["jacobi", "zero_init", "src_dt", "fast", "chebyshev"])
def test_other_modes_keep_the_per_sweep_k5(shim, mode):
    """A solve outside the tiled kernel's mode takes the per-sweep K5 even
    inside ``launch_sweeps(3)``, and the library refuses a tiled launch of
    it, with nothing counted."""
    mod, lib = shim
    t = _volume(18)
    args = (1, t.src, t.x0, t.a_visc, 1 + 6 * t.a_visc, 4)
    _, launches = _run(shim, 3, co3.fused_jacobi3, *args, **mode)
    assert [k for k, *_ in launches] == ["jacobi3_sweep"] * 4
    co.reset_launch_counts()
    with mod.kernels_on_cpu(lib) as handle:
        run = co._Sweeps(*args, zero_init=mode.get("zero_init", False),
                         src_dt=mode.get("src_dt"),
                         fast=mode.get("fast", False),
                         cheby_rho=mode.get("cheby_rho"),
                         kernel="jacobi3_sweep")
        step = co.sweep_plan(0, 4, 4, 3, prep=run.prep,
                             cheby=run.omegas is not None,
                             guess=run.x is not None)[0]
        with pytest.raises(RuntimeError, match="jacobi3_sweeps failed"):
            run.launch(handle, step)
    assert co.launch_counts()["jacobi3_sweeps"] == 0


def test_sweep_plan_carries_x_km1_out_of_a_segment():
    """``carry_out``: the last launch of a Chebyshev segment stores
    x_{k-1} for the next segment (a 1-sweep launch's is its input)."""
    plan = co.sweep_plan(3, 10, 10, 3, prep=True, cheby=True,
                         carry_out=True)
    assert [(s.first, s.count) for s in plan] == [(3, 3), (6, 3), (9, 1)]
    assert [s.stores_xm for s in plan] == [True, True, False]
    plan = co.sweep_plan(0, 8, 8, 4, prep=False, cheby=True)
    assert [s.stores_xm for s in plan] == [True, False]
    plan = co.sweep_plan(0, 8, 8, 4, prep=False, cheby=True, carry_out=True)
    assert [s.stores_xm for s in plan] == [True, True]
    plan = co.sweep_plan(0, 8, 8, 4, prep=False, cheby=False, carry_out=True)
    assert not any(s.stores_xm for s in plan)
