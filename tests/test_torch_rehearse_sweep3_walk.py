"""The float32 per-sweep K5 and K13 in the vector walk
(``csrc/jacobi3_walk.cuh`` through ``csrc/jacobi3.cu`` and
``csrc/jacobi3_slab.cu``): a thread owns V = 4 consecutive cells of a row
(``cuda_ops.VECTOR_WIDTHS``) and walks ``cuda_ops.SWEEP3_WALK`` planes in
z, the bf16 forms' body on float32 operands.  A CUDA kernel has no
interpret mode, so this file compiles both sources (and K6-K8's, for the
step) with ``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py`` and holds the walk bit for bit against
the one-cell kernel and the plain twins on CPU tensors:

- raw library calls on the same operands in both forms (out and the rhs
  a first sweep stores): Jacobi, dividing and fast, with and without
  ``kPrep`` (a folded source, the rhs stored), Chebyshev (x_{k-1} read and
  absent), from the zero guess, at walks that divide the planes and walks
  that do not; K5 on volumes of sides 20 and 24, K13 on plane ranges of a
  z-slab buffer from ``lo`` > 1 with its wall planes ``gtop``/``gbot`` at,
  inside and past a thread's walk;
- solves of 1, 2, 3 and 20 sweeps through ``fused_jacobi3`` in every mode
  the step takes (a guess, a source fold, the zero guess, fast, Chebyshev
  and Chebyshev+fast on the per-sweep kernel) at side 24, every launch at
  width 4 (``cuda_ops.width_counts``), equal to the one-cell form's and to
  the plain twin's; at side 22, which 4 does not divide, every launch at
  width 1;
- every per-sweep K13 call of ``checks.kernel_checks_slab3`` (top,
  interior and bottom slabs) at width 4, bit for bit with the one-cell
  form and its plain twin;
- z-slab solves cut into chained segments, each slab's buffers cut anew
  from the assembled volume between them (a Chebyshev chain with x_{k-1}
  carried across, and a Jacobi solve), equal to the unsegmented solve on
  the volume;
- the float32 3-D parity step at side 24, on one volume and on 3 z-slabs,
  through the kernels against the ``reference`` backend bit for bit,
  every per-sweep launch at width 4, as many as ``chip_smoke`` counts;
- the library refuses widths other than 1 and 4, a side 4 does not
  divide, a walk below 1 and a misaligned pointer.

Skips only without ``g++``.
"""
import ctypes
import functools
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
from fluidsimulationcuda_torch.kernels import cuda_sharded_3d as cs3  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi3.cu", "jacobi3_slab.cu", "advect3.cu", "project3.cu",
           "advect3_slab.cu", "project3_slab.cu")
PREP, FAST, CHEBY = co._PREP, co._FAST, co._CHEBY
RHO = PERF_POINT_3D[0]
# Sweep modes of a raw launch: (flags, with a source, from the zero guess,
# with x_{k-1}).
MODES = {
    "jacobi": (0, False, False, False),
    "jacobi, folded source": (PREP, True, False, False),
    "fast, prescaled by the sweep": (PREP | FAST, False, False, False),
    "fast, folded source": (PREP | FAST, True, False, False),
    "fast, prescaled rhs": (FAST, False, False, False),
    "chebyshev": (CHEBY, False, False, True),
    "chebyshev, no x_{k-1}": (CHEBY, False, False, False),
    "chebyshev fast": (CHEBY | FAST, False, False, True),
    "zero guess": (0, False, True, False),
    "zero guess, folded source": (PREP, True, True, False),
}
WALKS = (1, 2, 3, 5, 64)
# K13's plane ranges on a 15-plane buffer: (lo, hi, gtop, gbot).
SLAB_PLANES = 15
GEOMETRIES = {
    "interior": (1, 14, -1, -1),
    "from lo 4": (4, 11, -1, -1),
    "top wall past halo planes": (1, 14, 4, -1),
    "bottom wall before halo planes": (1, 14, -1, 9),
    "both walls": (2, 13, 3, 11),
    "a wall at lo": (5, 12, 5, -1),
    "a wall at hi - 1": (3, 10, -1, 9),
}


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "sweep3_walk")
    return mod, lib


@pytest.fixture(scope="module")
def lib(shim):
    handle = ctypes.CDLL(str(shim[1]))
    for name in ("fsc_jacobi3_sweep", "fsc_jacobi3_slab"):
        fn = getattr(handle, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


class Operands:
    """The operands of one raw float32 sweep of ``planes`` planes of
    ``side``², from a seeded generator."""

    def __init__(self, side, planes, mode, seed):
        flags, src, zero, xm = MODES[mode]
        gen = torch.Generator().manual_seed(seed)
        self.shape = (planes, side, side)

        def field():
            return 2 * torch.rand(self.shape, generator=gen) - 1

        self.side, self.flags = side, flags
        self.x = None if zero else field()
        self.rhs = field()
        self.src = field() if src else None
        self.xm = field() if xm else None

    def run(self, fn, width, walk, geometry=()):
        out = torch.full(self.shape, 7.0)
        rhs_out = torch.full(self.shape, 7.0) if self.flags & PREP else None
        a = 0.3
        ptr = co._ptr
        rc = fn(ptr(self.x), self.rhs.data_ptr(), ptr(self.src), ptr(self.xm),
                out.data_ptr(), ptr(rhs_out), self.side, 2, a, 1 + 6 * a,
                a / (1 + 6 * a), 1 / (1 + 6 * a), 0.05, 1.4, self.flags,
                *geometry, width, walk, None)
        assert rc == 0
        return out, rhs_out


def _same(got, want) -> bool:
    if isinstance(got, (tuple, list)):
        return all(_same(g, w) for g, w in zip(got, want))
    if got is None or want is None:
        return got is None and want is None
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_k5_walk_equals_one_cell(lib, mode):
    for side in (20, 24):
        ops = Operands(side, side, mode, seed=side)
        want = ops.run(lib.fsc_jacobi3_sweep, 1, 1)
        for walk in WALKS:
            assert _same(ops.run(lib.fsc_jacobi3_sweep, 4, walk), want), \
                (side, walk)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("mode", list(MODES))
def test_k13_walk_equals_one_cell(lib, mode, geometry):
    ops = Operands(20, SLAB_PLANES, mode, seed=3)
    want = ops.run(lib.fsc_jacobi3_slab, 1, 1, GEOMETRIES[geometry])
    for walk in WALKS:
        got = ops.run(lib.fsc_jacobi3_slab, 4, walk, GEOMETRIES[geometry])
        assert _same(got, want), walk


def test_refused_launches_raise_and_count_nothing(lib):
    """Widths other than 1 and 4, a side 4 does not divide, a walk below 1
    and an operand off its 16-byte access are refused
    (cudaErrorInvalidValue); the wrapper's launch helper raises and counts
    nothing."""
    ops = Operands(20, 20, "jacobi", 0)
    fn = lib.fsc_jacobi3_sweep

    def rc(x, side=20, width=4, walk=3):
        out = torch.empty(ops.shape)
        return fn(x, ops.rhs.data_ptr(), None, None, out.data_ptr(), None,
                  side, 0, 0.3, 2.8, 0.1, 0.3, 0.0, 0.0, 0, width, walk, None)

    x = ops.x.data_ptr()
    assert rc(x) == 0 and rc(x, width=1) == 0
    for width in (2, 3, 8, 0):
        assert rc(x, width=width) == 1, width
    assert rc(x, side=18) == 1 and rc(x, side=18, width=1) == 0
    assert rc(x, walk=0) == 1
    assert rc(x + 4) == 1  # one float off its 16-byte access
    co.reset_launch_counts()
    co.reset_width_counts()
    out = torch.empty(ops.shape)
    with pytest.raises(RuntimeError, match="jacobi3_sweep failed"):
        co._launch_vector("jacobi3_sweep", 4, fn, x, ops.rhs.data_ptr(),
                          None, None, out.data_ptr(), None, 20, 0, 0.3, 2.8,
                          0.1, 0.3, 0.0, 0.0, 0, 4, 0, None)
    assert co.launch_counts()["jacobi3_sweep"] == 0
    assert sum(co.width_counts()["jacobi3_sweep"].values()) == 0


def _through(shim, fn, widths=None, per_launch=None):
    """``fn()`` through the shim (inside ``vector_widths(widths)`` and
    ``launch_sweeps(per_launch)`` where given): (its result, launches of
    the per-sweep K5 and K13 by width)."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib):
        with (co.vector_widths(widths) if widths is not None
              else _nothing()):
            with (co.launch_sweeps(per_launch) if per_launch is not None
                  else _nothing()):
                co.reset_width_counts()
                got = fn()
                counts = co.width_counts()
    return got, {k: counts[k] for k in ("jacobi3_sweep", "jacobi3_slab")}


def _nothing():
    import contextlib
    return contextlib.nullcontext()


# The step's solves on a volume: (b, guess, rhs, kwargs); Chebyshev+fast
# on the per-sweep kernel (the tiled one's mode, forced per sweep).
SOLVES = {
    "guess": (2, "x", "x0", dict()),
    "source fold": (1, "src", "x0", dict(src_dt=checks.DT)),
    "zero guess": (0, "p", "p", dict(zero_init=True)),
    "fast": (1, "src", "x0", dict(src_dt=checks.DT, fast=True)),
    "chebyshev": (3, "src", "x0", dict(src_dt=checks.DT, cheby_rho=RHO)),
    "chebyshev+fast": (1, "src", "x0", dict(src_dt=checks.DT, fast=True,
                                            cheby_rho=RHO)),
}


@functools.lru_cache(maxsize=2)
def _volume(side):
    return checks._Inputs(side, "cpu", side, ndim=3)


@pytest.mark.parametrize("iters", [1, 2, 3, 20])
@pytest.mark.parametrize("solve", list(SOLVES))
@pytest.mark.parametrize("side", [24, 22])
def test_k5_solves_in_the_walk(shim, side, solve, iters):
    """A solve through ``fused_jacobi3``: in the walk where 4 divides the
    side (every launch at width 4), else one cell a thread; equal to the
    one-cell form and to the plain twin, bit for bit (the twin's fast
    sweeps round as ``fmaf`` does, within ``checks.TOL``)."""
    t = _volume(side)
    b, x, rhs, kw = SOLVES[solve]
    alpha, beta = (1.0, 6.0) if b == 0 else (t.a_visc, 1 + 6 * t.a_visc)
    args = (b, getattr(t, x), getattr(t, rhs), alpha, beta, iters)
    forced = 0 if kw.get("fast") and "cheby_rho" in kw else None

    def run():
        return co3.fused_jacobi3(*args, **kw)

    got, widths = _through(shim, run, per_launch=forced)
    one, one_widths = _through(shim, run, (1,), per_launch=forced)
    assert torch.equal(got, one)
    vec = 4 if side % 4 == 0 else 1
    assert widths["jacobi3_sweep"] == {4: 0, 1: 0, vec: iters}
    assert one_widths["jacobi3_sweep"] == {4: 0, 1: iters}
    plain = co3.fused_jacobi3_plain(*args, **kw)
    tol = checks.TOL if kw.get("fast") else 0.0
    assert checks.max_abs_diff(got, plain) <= tol


@functools.lru_cache(maxsize=1)
def _slab_calls():
    return [c for c in checks.kernel_checks_slab3(24, 8, "cpu", 0)
            if c.kernels == checks.JAC3_SLAB_SWEEP]


def test_k13_calls_in_the_walk_match_one_cell_and_plain(shim):
    """Every call of ``checks.kernel_checks_slab3`` (top, interior and
    bottom slabs of 8 planes of 24³) whose segments take the per-sweep
    K13: every launch at width 4, bit for bit with the one-cell form and
    within ``checks.TOL`` of its plain twin (bit for bit outside fast
    mode)."""
    calls = _slab_calls()
    assert len(calls) >= 12
    for check in calls:
        got, widths = _through(shim, check.run)
        one, one_widths = _through(shim, check.run, (1,))
        assert _same(checks._as_tuple(got), checks._as_tuple(one)), \
            check.label
        n = sum(widths["jacobi3_slab"].values())
        assert widths["jacobi3_slab"] == {4: n, 1: 0} and n > 0, check.label
        assert one_widths["jacobi3_slab"] == {4: 0, 1: n}, check.label
        tol = checks.TOL if "fast" in check.label else 0.0
        assert checks.max_abs_diff(got, check.plain()) <= tol, check.label


SIDE3, MZ = 24, 8


def _segments(t, segments, cheby, solve):
    """A solve cut into ``segments`` (their sweeps) on every z-slab of
    ``t``, each segment's buffers cut from the volume the last one left
    (as the z-slab step exchanges them), a Chebyshev chain's x_{k-1}
    carried across: the volume after the last segment."""
    H = max(segments) + 1
    x, xm, done = t.x, None, 0
    for sweeps in segments:
        outs = []
        for i in range(t.slabs):
            kw = dict(mz=t.mz, H=H, alpha=t.a_visc, beta=1 + 6 * t.a_visc,
                      sweeps=sweeps)
            xe, re_ = t.ext(x, i, H), t.ext(t.x0, i, H)
            if cheby:
                me = None if xm is None else t.ext(xm, i, H)
                outs.append(solve(1, xe, me, re_, t.flags(i), cheby_rho=RHO,
                                  start=done, carry_in=me is not None,
                                  carry_out=True, **kw))
            else:
                outs.append((solve(1, xe, re_, t.flags(i), **kw), None))
        x = torch.cat([o[0] for o in outs])
        xm = torch.cat([o[1] for o in outs]) if cheby else None
        done += sweeps
    return x


@pytest.mark.parametrize("segments", [(3, 4), (2, 2, 3)])
@pytest.mark.parametrize("cheby", [False, True], ids=["jacobi", "chebyshev"])
def test_chained_segments_equal_the_unsegmented_solve(shim, cheby, segments):
    """A 7-sweep solve on 3 z-slabs of 8 planes of 24³ in chained segments
    through the walk equals the same solve on the volume through K5's
    walk (and the one-cell K13's segments), bit for bit."""
    t = checks._Slab3Inputs(SIDE3, MZ, "cpu", 2)
    solve = cs3.fused_cheby3_slab if cheby else cs3.fused_jacobi3_slab
    got, widths = _through(shim, lambda: _segments(t, segments, cheby, solve))
    one, _ = _through(shim, lambda: _segments(t, segments, cheby, solve),
                      (1,))
    kw = dict(cheby_rho=RHO) if cheby else {}
    whole, _ = _through(shim, lambda: co3.fused_jacobi3(
        1, t.x, t.x0, t.a_visc, 1 + 6 * t.a_visc, 7, **kw))
    assert widths["jacobi3_slab"] == {4: 7 * t.slabs, 1: 0}
    assert torch.equal(got, one)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("slabs", [0, 3], ids=["volume", "3 z-slabs"])
def test_float32_step3_through_the_walk(shim, slabs):
    """The float32 3-D parity step at n = 22 (side 24) through the kernels,
    two steps, against the ``reference`` backend on one volume or on 3
    z-slabs of 8 planes, bit for bit; every per-sweep launch at width 4,
    as many as ``chip_smoke`` counts."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (
        make_mesh, make_sharded_step_fn_3d, shard_state_3d, unshard)

    cfg = ft.SimConfig(n=22, ndim=3, jacobi_iters=6, device="cpu",
                       backend="reference")
    object.__setattr__(cfg, "backend", "cuda")
    state0, src = ft.reference_init(torch.Generator().manual_seed(7), cfg)
    ref = cfg.replace(backend="reference")
    if slabs:
        mesh = make_mesh([torch.device("cpu")] * slabs)
        step, ref_step = (make_sharded_step_fn_3d(c, mesh) for c in (cfg, ref))
        kernel = "jacobi3_slab"
        want = chip_smoke.expected_launches_sharded3(
            cfg, slabs, step.advect_mode == "exact")[kernel]

        def run(fn):
            state = shard_state_3d(state0, mesh)
            for k in range(2):
                state = fn(state, shard_state_3d(
                    src if k == 0 else ft.zero_sources(cfg), mesh))
            return unshard(state)
    else:
        kernel = "jacobi3_sweep"
        want = chip_smoke.expected_launches3(cfg)[kernel]
        step = functools.partial(ft.step3, cfg)
        ref_step = functools.partial(ft.step3, ref)

        def run(fn):
            state = state0
            for k in range(2):
                state = fn(state, src if k == 0 else ft.zero_sources(cfg))
            return state

    got, widths = _through(shim, lambda: run(step))
    assert widths[kernel] == {4: 2 * want, 1: 0} and want > 0
    for a, b in zip(got, run(ref_step)):
        assert torch.equal(a, b)
