"""The vector form of the per-sweep bf16 K5 and K13 (``csrc/jacobi3_walk.cuh``
through ``csrc/jacobi3.cu`` and ``csrc/jacobi3_slab.cu``): a thread owns
V = 4 consecutive cells of a row (``cuda_ops.VECTOR_WIDTHS``) and walks
``cuda_ops.SWEEP3_WALK`` planes in z.  A CUDA kernel has no interpret
mode, so this file compiles both sources (and K6-K8's, for the step) with
``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py`` and holds the vector form bit for bit
against the one-cell form and the plain twins on CPU tensors:

- raw library calls on the same operands in both forms (out and the rhs
  a first sweep stores): every operand-type instantiation (x, x_{k-1} and
  out each bf16 or float32, the rhs bf16), Jacobi, Chebyshev (x_{k-1}
  read and absent), fast, with and without ``kPrep`` (a folded source
  and the rhs stored) and from the zero guess, at walks that divide the
  planes and walks that do not; K5 on volumes of sides 20 and 24, K13 on
  plane ranges of a z-slab buffer from ``lo`` > 1, with its wall planes
  ``gtop``/``gbot`` at, inside and past a thread's walk (the walk steps
  two planes across a wall plane with halo planes beyond it);
- every per-sweep K5 and K13 call of ``checks.kernel_checks3_bf16`` and
  ``checks.kernel_checks_slab3_bf16`` (the 1-sweep solve among them)
  against its plain twin at sides 4 divides, each walk, every launch
  counted at width 4 (``cuda_ops.width_counts``), and at sides it does not
  divide, every launch at width 1;
- the bf16 3-D step through the kernels against the plain twins' step;
- views at storage offsets that misalign an operand take the one-cell
  form, and the library refuses widths other than 1 and 4, a side 4 does
  not divide, a walk below 1 and a misaligned pointer.

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
from fluidsimulationcuda_torch.kernels import build, checks  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops as co  # noqa: E402
from fluidsimulationcuda_torch.models.stable_fluids_3d import _Ops3  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi3.cu", "jacobi3_slab.cu", "advect3.cu", "project3.cu")
BF16 = torch.bfloat16
PREP, FAST, CHEBY = co._PREP, co._FAST, co._CHEBY
# The operand types: which of x, x_{k-1} and out hold bf16.
TYPES = list(range(8))
# Sweep modes: (flags, with a source, from the zero guess).
MODES = {
    "jacobi": (0, False, False),
    "jacobi, folded source": (PREP, True, False),
    "fast, prescaled by the sweep": (PREP | FAST, False, False),
    "fast, folded source": (PREP | FAST, True, False),
    "chebyshev": (CHEBY, False, False),
    "chebyshev fast": (CHEBY | FAST, False, False),
    "zero guess": (0, False, True),
    "zero guess, folded source": (PREP, True, True),
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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "bf16_sweep3_vec")
    return mod, lib


@pytest.fixture(scope="module")
def lib(shim):
    handle = ctypes.CDLL(str(shim[1]))
    for name in ("fsc_jacobi3_sweep_bf16", "fsc_jacobi3_slab_bf16"):
        fn = getattr(handle, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


class Operands:
    """The operands of one raw bf16 sweep of ``planes`` planes of
    ``side``², each stored as ``types`` says, from a seeded generator."""

    def __init__(self, side, planes, types, mode, seed):
        flags, src, zero = MODES[mode]
        gen = torch.Generator().manual_seed(seed)
        shape = (planes, side, side)

        def field(bf16):
            t = 2 * torch.rand(shape, generator=gen) - 1
            return t.to(BF16) if bf16 else t

        self.side, self.flags = side, flags
        self.types = types
        self.x = None if zero else field(types & co._X_BF16)
        self.rhs = field(True)
        self.src = field(types & co._X_BF16) if src else None
        self.xm = field(types & co._XM_BF16) if flags & CHEBY else None
        self.out_dtype = BF16 if types & co._OUT_BF16 else torch.float32
        self.shape = shape

    def run(self, fn, width, walk, geometry=()):
        out = torch.full(self.shape, 7.0, dtype=self.out_dtype)
        rhs_out = (torch.full(self.shape, 7.0, dtype=BF16)
                   if self.flags & PREP else None)
        a = 0.3
        ptr = co._ptr
        rc = fn(ptr(self.x), self.rhs.data_ptr(), ptr(self.src), ptr(self.xm),
                out.data_ptr(), ptr(rhs_out), self.side, 2, a, 1 + 6 * a,
                a / (1 + 6 * a), 1 / (1 + 6 * a), 0.05, 1.4, self.flags,
                *geometry, self.types, width, walk, None)
        assert rc == 0
        return out, rhs_out


def _same(got, want) -> bool:
    return all((g is None and w is None)
               or (g.dtype == w.dtype and torch.equal(g, w))
               for g, w in zip(got, want))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("types", TYPES)
def test_k5_vector_form_equals_one_cell(lib, types, mode):
    for side in (20, 24):
        ops = Operands(side, side, types, mode, seed=side + types)
        fn = lib.fsc_jacobi3_sweep_bf16
        want = ops.run(fn, 1, 1)
        for walk in WALKS:
            assert _same(ops.run(fn, 4, walk), want), (side, walk)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("types", TYPES)
def test_k13_vector_form_equals_one_cell(lib, types, geometry):
    lo, hi, gtop, gbot = GEOMETRIES[geometry]
    fn = lib.fsc_jacobi3_slab_bf16
    for mode in MODES:
        ops = Operands(20, SLAB_PLANES, types, mode, seed=types)
        want = ops.run(fn, 1, 1, (lo, hi, gtop, gbot))
        for walk in WALKS:
            got = ops.run(fn, 4, walk, (lo, hi, gtop, gbot))
            assert _same(got, want), (mode, walk)


@functools.lru_cache(maxsize=4)
def _per_sweep_checks(side: int, slab: bool) -> list[checks.Check]:
    """The calls whose solves take the per-sweep K5 or K13's bf16 form."""
    if slab:
        calls = checks.kernel_checks_slab3_bf16(side, side // 3, "cpu", 0)
        kernel = checks.JAC3_SLAB_SWEEP_16
    else:
        calls = checks.kernel_checks3_bf16(side, "cpu", 0)
        kernel = checks.JAC3_SWEEP_16
    return [c for c in calls if c.kernels == kernel]


def _through(shim, check, walk):
    """The check's call through the shim at ``walk``: (result, launches
    by width of its per-sweep bf16 kernel)."""
    mod, lib = shim
    saved = co.SWEEP3_WALK
    co.SWEEP3_WALK = walk
    try:
        with mod.kernels_on_cpu(lib):
            co.reset_width_counts()
            got = check.run()
            return got, co.width_counts()[check.kernels[0]]
    finally:
        co.SWEEP3_WALK = saved


@pytest.mark.parametrize("walk", [1, 3, 4, 7])
@pytest.mark.parametrize("side, slab", [(20, False), (24, True)],
                         ids=["K5 side 20", "K13 side 24"])
def test_per_sweep_calls_in_the_vector_form_match_plain(shim, side, slab,
                                                        walk):
    calls = _per_sweep_checks(side, slab)
    assert len(calls) >= (30 if slab else 19)
    for check in calls:
        got, widths = _through(shim, check, walk)
        assert _same(checks._as_tuple(got), checks._as_tuple(check.plain())), \
            check.label
        assert widths[1] == 0 and widths[4] > 0, (check.label, widths)


@pytest.mark.parametrize("side, slab", [(18, False), (22, False),
                                        (21, True)],
                         ids=["K5 side 18", "K5 side 22", "K13 side 21"])
def test_sides_four_does_not_divide_take_the_one_cell_form(shim, side, slab):
    for check in _per_sweep_checks(side, slab)[:6]:
        got, widths = _through(shim, check, co.SWEEP3_WALK)
        assert _same(checks._as_tuple(got), checks._as_tuple(check.plain())), \
            check.label
        assert widths[4] == 0 and widths[1] > 0, (check.label, widths)


@pytest.mark.parametrize("mode", ["parity", "windowed"])
def test_bf16_step3_through_the_vector_form(shim, mode):
    """The bf16 3-D step at side 20 through the kernels against the plain
    twins' step, two steps; every per-sweep K5 launch at width 4, as many
    as ``chip_smoke.expected_launches3`` counts."""
    import chip_smoke

    kw = dict(jacobi_iters=6)
    if mode == "windowed":
        kw.update(advect_mode="windowed", max_courant=1)
    cfg = ft.SimConfig(n=18, ndim=3, dtype=BF16, device="cpu",
                       backend="reference", **kw)
    object.__setattr__(cfg, "backend", "cuda")
    state0, src = ft.reference_init(torch.Generator().manual_seed(5), cfg)

    def run(ops=None):
        state = state0
        for k in range(2):
            state = ft.step3(cfg, state, src if k == 0
                             else ft.zero_sources(cfg), ops)
        return state

    mod, lib = shim
    with mod.kernels_on_cpu(lib):
        co.reset_launch_counts()
        co.reset_width_counts()
        got = run()
        counts = co.launch_counts()
        widths = co.width_counts()["jacobi3_sweep_bf16"]
    want = 2 * chip_smoke.expected_launches3(cfg)["jacobi3_sweep_bf16"]
    assert counts["jacobi3_sweep_bf16"] == want > 0
    assert widths == {4: want, 1: 0}
    assert _same(tuple(got), tuple(run(_Ops3(cfg, plain=True))))


def _view(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` in a contiguous view ``shift`` elements into a larger buffer."""
    flat = torch.zeros(x.numel() + 8, dtype=x.dtype)
    out = flat[shift:shift + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("shift, width", [(0, 4), (4, 4), (2, 1), (1, 1)])
def test_misaligned_views_take_the_one_cell_form(shim, shift, width):
    """A bf16 guess at a storage offset of ``shift`` values: the first
    sweep takes width 4 where the offset keeps its 8-byte access aligned,
    the one-cell form where it does not, with the same bits."""
    from fluidsimulationcuda_torch.kernels import cuda_ops_3d as co3

    t = checks._Bf16Inputs3(20, "cpu", 0)
    x = _view(t.x, shift)
    a = t.a_visc
    got, widths = _through(shim, checks.Check(
        "view", checks.JAC3_SWEEP_16,
        lambda: co3.fused_jacobi3(1, x, t.x0, a, 1 + 6 * a, 1, src_dt=0.1),
        lambda: None), 3)
    want = co3.fused_jacobi3_plain(1, x, t.x0, a, 1 + 6 * a, 1, src_dt=0.1)
    assert _same((got,), (want,))
    assert widths == {4: int(width == 4), 1: int(width == 1)}
    assert co.vector_width("jacobi3_sweep_bf16", 20, x, t.x0) == width


def test_refused_launches_raise_and_count_nothing(lib):
    """Widths other than 1 and 4, a side 4 does not divide, a walk below 1
    and an operand off its 4-cell access are refused
    (cudaErrorInvalidValue); the wrapper's launch helper raises and counts
    nothing."""
    ops = Operands(20, 20, 0, "jacobi", 0)
    fn = lib.fsc_jacobi3_sweep_bf16

    def rc(x, side=20, width=4, walk=3):
        out = torch.empty(ops.shape)
        return fn(x, ops.rhs.data_ptr(), None, None, out.data_ptr(), None,
                  side, 0, 0.3, 2.8, 0.1, 0.3, 0.0, 0.0, 0, 0, width, walk,
                  None)

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
    with pytest.raises(RuntimeError, match="jacobi3_sweep_bf16 failed"):
        co._launch_vector("jacobi3_sweep_bf16", 4, fn, x, ops.rhs.data_ptr(),
                          None, None, out.data_ptr(), None, 20, 0, 0.3, 2.8,
                          0.1, 0.3, 0.0, 0.0, 0, 0, 4, 0, None)
    assert co.launch_counts()["jacobi3_sweep_bf16"] == 0
    assert sum(co.width_counts()["jacobi3_sweep_bf16"].values()) == 0
