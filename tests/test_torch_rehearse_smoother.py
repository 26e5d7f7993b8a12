"""K1-damp (``csrc/jacobi_tiles.cu``, ``fsc_jacobi_sweeps_damp``) is the
multigrid smoother: the damped sweeps of a smooth in one launch on K1's
tiles, or every sweep of a solve in one launch on a grid that one tile
holds whole.  A CUDA kernel has no interpret mode, so this file compiles
it with ``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py`` beside the per-sweep K1 (``csrc/jacobi.cu``)
and K2-K4, and holds it bit for bit against the per-sweep damped chain
(the same sweeps one launch each, ``cuda_ops.launch_sweeps(0)``), against
``ops.multigrid._smooth`` and against ``fused_jacobi_plain(damp=0.8)``:
from a guess and from zero, 1, 2, 3 and 40 sweeps, T of 1, 2 and 5 sweeps
a tiled launch, sides 16, 18, 34 and 66, one grid and a batch of three
whose first grid takes another boundary mode (the launch's ``nb1``
split); the whole-grid launch at 1, 2 and 40 sweeps in both tiles the
library takes, up to the largest side each holds (where a sweep range
that shrank a line a sweep, as the tiled form's does, would drop grid
rows); the launches of ``cuda_ops.damped_plan`` and ``sweep_plan``; the
launch counts ``chip_smoke.py`` expects of the multigrid step, and that
step on the shim against the ``reference`` backend.  Its bf16-rhs forms
(the finest level of a bf16 multigrid solve) against their plain twin,
bit for bit, from zero, a bf16 and a float32 guess, on both tiles, a whole
16² grid and split over launches, one grid and a batch of three; the
per-sweep route's refusal; the bf16 multigrid and CG steps on the shim.
Skips only without ``g++``.
"""
import contextlib
import importlib.util
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops as co  # noqa: E402
from fluidsimulationcuda_torch.ops.multigrid import OMEGA, _smooth  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi_tiles.cu", "jacobi.cu", "dens_advect.cu", "advect.cu",
           "project.cu")
SIDES = (16, 18, 34, 66)
# Positions of fsc_jacobi_sweeps_damp's arguments (csrc/jacobi_tiles.cu).
COUNT, TILE_ROWS, WHOLE = 9, 13, 14


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "smoother")
    return mod, lib


def _run(shim, forced, fn, *args):
    """``fn(*args)`` through the shim library inside the context
    ``forced()``: (result, [(kernel, args)] of each launch)."""
    mod, lib = shim
    launches = []
    launch = co._launch

    def spy(kernel, fn_, *a):
        launches.append((kernel, a))
        launch(kernel, fn_, *a)

    co._launch = spy
    try:
        with mod.kernels_on_cpu(lib), forced():
            return fn(*args), launches
    finally:
        co._launch = launch


def _inputs(side: int, batch: int):
    gen = torch.Generator().manual_seed(side + batch)
    shape = ((batch,) if batch else ()) + (side, side)
    return tuple(torch.rand(shape, generator=gen) * 2 - 1 for _ in range(2))


def _smooth_card(p, div, sweeps, zero_init):
    """``mg_smooth`` on one grid; on a batch, its first grid in boundary
    mode 2 and the rest in mode 0 (the launch's nb1 split)."""
    if p.dim() == 2:
        return co.mg_smooth(p, div, sweeps, zero_init)
    return co._solve(2, 1, 0, p, div, 1.0, 4.0, sweeps, zero_init=zero_init,
                     src_dt=None, fast=False, cheby_rho=None, damp=OMEGA)


def _plain(p, div, sweeps, zero_init):
    """``fused_jacobi_plain(damp=0.8)`` with ``_smooth_card``'s modes, and
    ``_smooth`` where the mode is 0."""
    def one(b, pp, dd):
        return co.fused_jacobi_plain(b, pp, dd, 1.0, 4.0, sweeps,
                                     zero_init=zero_init, damp=OMEGA)
    if p.dim() == 2:
        got = one(0, p, div)
        assert torch.equal(got, _smooth(p, div, sweeps, zero_init))
        return got
    rest = one(0, p[1:], div[1:])
    assert torch.equal(rest, _smooth(p[1:], div[1:], sweeps, zero_init))
    return torch.cat([one(2, p[:1], div[:1]), rest])


def _damped(launches):
    return [a for kernel, a in launches if kernel == "jacobi_sweeps_damp"]


@pytest.mark.parametrize("sweeps", [1, 2, 3, 40])
@pytest.mark.parametrize("per_launch", [1, 2, 5])
@pytest.mark.parametrize("tile_rows", [16, 64])
@pytest.mark.parametrize("zero_init", [False, True], ids=["guess", "zero"])
@pytest.mark.parametrize("batch", [0, 3], ids=["one", "batch3"])
@pytest.mark.parametrize("side", SIDES)
def test_tiled_k1_damp_matches_chain_and_plain(shim, side, batch, zero_init,
                                               tile_rows, per_launch, sweeps):
    """T sweeps a launch on tiles of 16 and 64 rows
    (``smooth_launches(T, tile_rows)``) equal the per-sweep damped chain
    and the plain smoother bit for bit, in the launches of ``sweep_plan``:
    T sweeps each, the remainder last, none a whole-grid launch."""
    args = (*_inputs(side, batch), sweeps, zero_init)
    got, launches = _run(shim, lambda: co.smooth_launches(per_launch,
                                                          tile_rows),
                         _smooth_card, *args)
    chain, per_sweep = _run(shim, lambda: co.launch_sweeps(0), _smooth_card,
                            *args)
    assert torch.equal(got, chain)
    assert torch.equal(got, _plain(*args))
    plan = co.sweep_plan(0, sweeps, sweeps, per_launch, prep=False,
                         cheby=False, guess=not zero_init)
    assert [kernel for kernel, _ in launches] == (["jacobi_sweeps_damp"]
                                                  * len(plan))
    assert [(a[COUNT], a[TILE_ROWS], a[WHOLE])
            for a in _damped(launches)] == [
        (step.count, tile_rows, 0) for step in plan]
    assert [kernel for kernel, _ in per_sweep] == ["jacobi_sweep_damp"] * sweeps


@pytest.mark.parametrize("side", SIDES)
def test_launch_sweeps_forces_tiled_damped_launches(shim, side):
    """``launch_sweeps(T)``, which forces every K1 solve, sends a damped
    one to tiled launches of T sweeps on 64-row tiles, never a whole-grid
    launch; bit for bit with the chain."""
    args = (*_inputs(side, 3), 40, True)
    got, launches = _run(shim, lambda: co.launch_sweeps(3), _smooth_card,
                         *args)
    chain, _ = _run(shim, lambda: co.launch_sweeps(0), _smooth_card, *args)
    assert torch.equal(got, chain)
    assert [(a[COUNT], a[TILE_ROWS], a[WHOLE])
            for a in _damped(launches)] == [(3, 64, 0)] * 13 + [(1, 64, 0)]


@pytest.mark.parametrize("sweeps", [1, 2, 40])
@pytest.mark.parametrize("zero_init", [False, True], ids=["guess", "zero"])
@pytest.mark.parametrize("batch", [0, 3], ids=["one", "batch3"])
@pytest.mark.parametrize("side,rows", [(16, 32), (18, 32), (26, 32)])
def test_whole_grid_launch_runs_every_sweep(shim, side, rows, batch,
                                            zero_init, sweeps):
    """Every sweep of a solve in one launch, each grid whole in one
    block's tile of ``rows`` rows (``smooth_launches(tile_rows=rows,
    whole=True)``):
    the coarsest level's 40 sweeps at 16², equal the per-sweep damped
    chain and the plain smoother bit for bit."""
    args = (*_inputs(side, batch), sweeps, zero_init)
    got, launches = _run(shim, lambda: co.smooth_launches(tile_rows=rows,
                                                          whole=True),
                         _smooth_card, *args)
    chain, _ = _run(shim, lambda: co.launch_sweeps(0), _smooth_card, *args)
    assert torch.equal(got, chain)
    assert torch.equal(got, _plain(*args))
    assert [(a[COUNT], a[TILE_ROWS], a[WHOLE])
            for a in _damped(launches)] == [(sweeps, rows, 1)]
    assert len(launches) == 1


@pytest.mark.parametrize("sweeps", [2, 15, 16, 40])
@pytest.mark.parametrize("batch", [0, 3], ids=["one", "batch3"])
def test_whole_grid_keeps_every_row_in_range(shim, batch, sweeps):
    """The largest grid the whole-grid tile holds, 30² in 32 rows: its
    last ghost row sits on the tile's row 30, which a range that shrank a
    line a sweep at each end (the tiled form's, ``lo = s + 1``,
    ``hi = 31 - s``) would leave stale from the second sweep on, as its
    first ghost row; the result equals the per-sweep chain bit for bit
    after 2, 15, 16 and 40 sweeps."""
    side, rows = 30, 32
    args = (*_inputs(side, batch), sweeps, False)
    got, launches = _run(shim, lambda: co.smooth_launches(tile_rows=rows,
                                                          whole=True),
                         _smooth_card, *args)
    chain, _ = _run(shim, lambda: co.launch_sweeps(0), _smooth_card, *args)
    assert len(launches) == 1
    assert torch.equal(got, chain)
    assert torch.equal(got, _plain(*args))


@pytest.mark.parametrize("side,rows,whole,sweeps", [
    (31, 32, True, 40), (34, 32, True, 40), (16, 64, True, 40),
    (14, 16, True, 2), (34, 16, False, 7), (34, 32, False, 2),
    (34, 64, False, 21)])
def test_k1_damp_refuses_what_its_tile_cannot_hold(shim, side, rows, whole,
                                                   sweeps):
    """A grid larger than the whole-grid tile less its outer ring, a
    whole grid in a tile other than the 32-row one, tiles of 32 rows (not
    built), a launch whose halo leaves no output row (7 sweeps on 16 rows)
    or of more than 20 sweeps on tiles: the library refuses the launch,
    ``_launch`` raises and nothing is counted; nothing falls back to
    another form or the chain."""
    co.reset_launch_counts()
    with pytest.raises(RuntimeError, match="jacobi_sweeps_damp failed"):
        _run(shim, lambda: co.smooth_launches(sweeps, rows, whole),
             co.mg_smooth, *_inputs(side, 0), sweeps, True)
    assert co.launch_counts()["jacobi_sweeps_damp"] == 0
    assert co.launch_counts()["jacobi_sweep_damp"] == 0


@pytest.mark.parametrize("side", SIDES)
def test_the_path_takes_damped_plan(shim, side):
    """Unforced, a solve takes the route ``damped_plan`` gives its side:
    a 2-sweep smooth one launch, a 40-sweep solve one whole-grid launch
    where the grid fits, tiled launches where it does not; bit for bit
    with the chain."""
    for sweeps in (2, 40):
        args = (*_inputs(side, 3), sweeps, True)
        got, launches = _run(shim, contextlib.nullcontext, _smooth_card,
                             *args)
        chain, _ = _run(shim, lambda: co.launch_sweeps(0), _smooth_card,
                        *args)
        assert torch.equal(got, chain)
        route = co.damped_plan(side, sweeps, 3)
        assert [(a[COUNT], a[TILE_ROWS], a[WHOLE])
                for a in _damped(launches)] == [
            (s.count, route.tile_rows, int(route.whole))
            for s in co.sweep_plan(0, sweeps, sweeps, route.per_launch,
                                   prep=False, cheby=False, guess=False)]


T = co.SWEEPS_PER_LAUNCH


@pytest.mark.parametrize("side,sweeps,grids,want", [
    (16, 40, 1, (40, 32, True)), (16, 2, 64, (2, 32, True)),
    (30, 40, 5000, (40, 32, True)), (32, 2, 1, (6, 16, False)),
    (66, 40, 1, (6, 16, False)), (1024, 2, 1, (6, 16, False)),
    (128, 2, 64, (6, 16, False)), (1414, 2, 1, (6, 16, False)),
    (1415, 2, 1, (T, 64, False)), (2048, 2, 1, (T, 64, False)),
    (256, 2, 64, (T, 64, False)), (8192, 40, 1, (T, 64, False)),
])
def test_damped_plan_routes_each_level(side, sweeps, grids, want):
    """``damped_plan`` as a pure function: a whole-grid launch of every
    sweep where the 32-row tile holds the grid (``WHOLE_GRID_SIDE``: 16²,
    the coarsest level, whatever the batch), then the tile of
    ``DAMPED_TILES`` by the launch's cells: 16-row tiles below 2 M cells
    at the 6 sweeps a launch their halo allows, 64-row tiles at T from
    there (2048², and the 64 × 256² batch)."""
    assert (co.WHOLE_GRID_SIDE, co.DAMPED_TILES) == (
        30, ((2_000_000, 64), (0, 16)))
    assert co.damped_plan(side, sweeps, grids) == want


def test_damped_plan_yields_to_the_forcing_contexts():
    """``launch_sweeps(t)`` forces tiled launches of t sweeps on 64-row
    tiles (0: the per-sweep chain) on damped solves too, never a
    whole-grid launch; ``smooth_launches`` overrides both for damped
    solves alone, as given (the library refuses what its tile cannot
    hold); it refuses a negative count and a tile the library lacks."""
    with co.launch_sweeps(3):
        assert co.damped_plan(16, 40) == (3, 64, False)
    with co.launch_sweeps(0):
        assert co.damped_plan(2048, 2) == (0, 64, False)
        with co.smooth_launches(tile_rows=32, whole=True):
            assert co.damped_plan(16, 40) == (40, 32, True)
    with co.smooth_launches(0):
        assert co.damped_plan(16, 40) == (0, 64, False)
    with co.smooth_launches(7, 16):
        assert co.damped_plan(2048, 40) == (7, 16, False)
    for bad in (dict(per_launch=-1), dict(tile_rows=48)):
        with pytest.raises(ValueError):
            with co.smooth_launches(**bad):
                pass


def test_sweep_plan_of_a_damped_solve():
    """A damped solve builds no rhs and carries no x_{k-1}: its launches
    store nothing beside x; the first reads the guess unless the solve
    starts from zero; a 40-sweep solve on tiles at T = 10 is four
    launches, in one whole-grid launch one."""
    plan = co.sweep_plan(0, 2, 2, co.SWEEPS_PER_LAUNCH, prep=False,
                         cheby=False)
    assert [(s.first, s.count, s.reads_guess, s.stores_rhs, s.stores_xm,
             s.ends_solve) for s in plan] == [(0, 2, True, False, False,
                                               True)]
    plan = co.sweep_plan(0, 40, 40, 10, prep=False, cheby=False, guess=False)
    assert [(s.first, s.count) for s in plan] == [(0, 10), (10, 10),
                                                  (20, 10), (30, 10)]
    assert not any(s.reads_guess or s.reads_guess_as_xm or s.stores_rhs
                   or s.stores_xm for s in plan)
    (one,) = co.sweep_plan(0, 40, 40, 40, prep=False, cheby=False,
                           guess=False)
    assert (one.count, one.ends_solve, one.reads_guess) == (40, True, False)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("n,cycles,want", [
    (2046, 2, 60), (2046, 1, 30), (254, 2, 36), (254, 1, 18), (62, 2, 20),
])
def test_multigrid_step_launches_k1_damp_a_smooth(n, cycles, want):
    """The multigrid step's damped launches (``chip_smoke.
    expected_launches``): 2 projections × cycles × (two smooths on every
    level whose interior is at least 16, one solve of 40 sweeps on the
    coarsest), each one launch: 60 at 2048² with two cycles (272 per-sweep
    launches before K1-damp), 36 on the 256² batch (224); none per sweep."""
    cfg = ft.SimConfig(n=n, pressure_solver="multigrid", mg_cycles=cycles,
                       device="cpu")
    launches = _chip_smoke().expected_launches(cfg)
    assert launches["jacobi_sweeps_damp"] == want
    assert "jacobi_sweep_damp" not in launches


@pytest.mark.parametrize("cycles", [1, 2])
def test_multigrid_step_on_the_shim(shim, cycles):
    """The multigrid 2-D step at 64² (levels 64², tiled; 32² and the
    coarsest 16², whole) through the ``cuda`` backend on the shim: the
    launches ``chip_smoke.expected_launches`` counts, and the state of the
    ``reference`` backend bit for bit."""
    mod, lib = shim
    ref = ft.SimConfig(n=62, backend="reference", device="cpu",
                       pressure_solver="multigrid", mg_cycles=cycles)
    cfg = ref.replace()
    object.__setattr__(cfg, "backend", "cuda")
    state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
    with mod.kernels_on_cpu(lib):
        co.reset_launch_counts()
        got = ft.step(cfg, state, src)
        counts = co.launch_counts()
    want = ft.step(ref, state, src)
    design = _chip_smoke().expected_launches(cfg)
    assert counts == {k: design.get(k, 0) for k in co.KERNELS}
    assert counts["jacobi_sweeps_damp"] == 2 * cycles * 5
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K1-damp's bf16-rhs forms (the finest level of a bf16 multigrid solve)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# fsc_jacobi_sweeps_damp_bf16's operand types (its last argument before the
# stream): x bf16 (1), out bf16 (4).
TYPES = 15


def _bf16_inputs(side: int, batch: int, guess: str):
    x, div = _inputs(side, batch)
    return (x.to(BF16) if guess == "bf16" else x), div.to(BF16)


def _plain16(p, div, sweeps, zero_init):
    """``fused_jacobi_plain(damp=0.8)``'s bf16-rhs forms with
    ``_smooth_card``'s boundary modes."""
    def one(b, pp, dd):
        return co.fused_jacobi_plain(b, pp, dd, 1.0, 4.0, sweeps,
                                     zero_init=zero_init, damp=OMEGA)
    if p.dim() == 2:
        return one(0, p, div)
    return torch.cat([one(2, p[:1], div[:1]), one(0, p[1:], div[1:])])


ROUTES = {"tiles16": (34, 2, lambda: co.smooth_launches(tile_rows=16)),
          "tiles64": (34, 2, lambda: co.smooth_launches(tile_rows=64)),
          "whole": (16, 40, contextlib.nullcontext),
          "split": (34, 7, lambda: co.smooth_launches(3, 16))}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("guess", ["zero", "float32", "bf16"])
@pytest.mark.parametrize("batch", [0, 3], ids=["one", "batch3"])
def test_bf16_rhs_forms_match_plain(shim, route, guess, batch):
    """K1-damp on a bf16 rhs against its plain twin, bit for bit: from zero
    or a bf16 guess (w and 1-w rounded to bf16, the result bf16) and from a
    float32 guess (float32 throughout, ``_smooth`` on that guess), on 16-
    and 64-row tiles (one launch of a 2-sweep smooth), on a whole 16² grid
    (40 sweeps in one launch) and split over tiled launches of 3 sweeps
    (7 sweeps: the iterate float32 between launches, only the last launch
    writing bf16), one grid and a batch of three.  Each launch counts as
    ``jacobi_sweeps_damp_bf16`` and passes the operand types of its x and
    its output."""
    side, sweeps, forced = ROUTES[route]
    x, div = _bf16_inputs(side, batch, guess)
    zero = guess == "zero"
    co.reset_launch_counts()
    got, launches = _run(shim, forced, _smooth_card, x, div, sweeps, zero)
    want = _plain16(x, div, sweeps, zero)
    out_dtype = torch.float32 if guess == "float32" else BF16
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(got, want)
    if guess == "float32" and batch == 0:
        assert torch.equal(got, _smooth(x, div, sweeps))
    kernels = {k for k, _ in launches}
    assert kernels == {"jacobi_sweeps_damp_bf16"}
    types = [a[TYPES] for _, a in launches]
    first_x = 1 if guess == "bf16" else 0
    last_out = 0 if guess == "float32" else 4
    assert types[0] & 1 == first_x and all(t & 1 == 0 for t in types[1:])
    assert types[-1] & 4 == last_out and all(t & 4 == 0 for t in types[:-1])
    assert len(launches) == {"split": 3}.get(route, 1)


def test_bf16_rhs_refuses_the_per_sweep_route(shim):
    """The per-sweep damped K1 has no bf16 form: forced there
    (``smooth_launches(0)``), a damped solve on a bf16 rhs raises
    ``TypeError`` and launches nothing; it takes no other route."""
    x, div = _bf16_inputs(34, 0, "float32")
    co.reset_launch_counts()
    with pytest.raises(TypeError, match="per-sweep damped K1"):
        _run(shim, lambda: co.smooth_launches(0), co.mg_smooth, x, div, 2)
    assert not any(co.launch_counts().values())


@pytest.mark.parametrize("solver", ["multigrid", "cg"])
def test_bf16_solver_step_on_the_shim(shim, solver):
    """The bf16 multigrid and CG steps at 64² through the ``cuda`` backend
    on the shim: the launches ``chip_smoke.expected_launches`` counts (8
    of K1-damp's bf16-rhs forms in the two-cycle multigrid step), every
    field bf16, and the ``cuda`` OpSet's plain twins bit for bit."""
    mod, lib = shim
    ref = ft.SimConfig(n=62, backend="reference", device="cpu", dtype=BF16,
                       pressure_solver=solver, mg_cycles=2)
    cfg = ref.replace()
    object.__setattr__(cfg, "backend", "cuda")
    state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
    with mod.kernels_on_cpu(lib):
        co.reset_launch_counts()
        got = ft.step(cfg, state, src)
        counts = co.launch_counts()
    want = ft.step(cfg, state, src, co.make_opset(cfg, plain=True))
    design = _chip_smoke().expected_launches(cfg)
    assert counts == {k: design.get(k, 0) for k in co.KERNELS}
    assert counts["jacobi_sweeps_damp_bf16"] == (8 if solver == "multigrid"
                                                 else 0)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == BF16
        assert torch.equal(a, b)
