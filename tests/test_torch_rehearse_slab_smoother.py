"""K9-damp (``csrc/jacobi_tiles.cu``, ``fsc_jacobi_slab_sweeps_damp_group``)
is the fine-level smoother of the slab multigrid: K1-damp's damped sweeps
on the tiled K9's slab walk over every slab of a device in one launch, its
halo rows read from the neighbouring slabs' own arrays.  A CUDA kernel has
no interpret mode, so this file compiles it with ``g++ -ffp-contract=off``
behind the host shim of ``dev/rehearse_kernels_cpu.py`` (a block's threads
run together, ``__syncthreads()`` is a barrier) beside K1-K4 and K9-K12,
and holds ``cuda_sharded.smooth_slabs`` bit for bit against the plain
twins ``smooth_slab_plain`` (one slab on its halo-extended buffer) and
``smooth_slabs_plain`` (which equal ``ops.multigrid._smooth`` on the
slab's rows, ``tests/test_torch_sharded_solvers.py``): top, interior and
bottom slabs of 66² (3 slabs of 22 rows) and the slab of 34² that holds
both walls, smooths of 2 and 8 sweeps from a guess and from zero, on the
tiles of 64, 32 and 16 rows the library takes, one launch a smooth and
one a sweep; 1, 2, 4 and 8 slabs of 64² and, against ``_smooth``, a thin
mesh of 16 slabs of 4 rows (thinner than the plain twin's 8-row halo),
smooths of 1 to 7 sweeps and of 40 (in several launches), from a guess
and from zero, with the neighbours' rows given as pointers into their
arrays and as copied halos; on every tile, in groups cut to the library's
table, with no ``torch.cat``; its refusals and ``group_smooth_tiling``.
Then K1-damp, the replicated coarse level's smoother, on odd sides (33 and
65, the coarse grids of n = 62 and 126; phase 3c runs 1025² on the card)
against ``_smooth`` and ``damped_plan`` on odd sides, and the multigrid
and CG slab steps through the ``cuda`` backend on the shim against the
``reference`` backend, with the launches
``chip_smoke.expected_launches_sharded`` counts.  Skips only without
``g++``.
"""
import ctypes
import importlib.util
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops as co  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.ops.multigrid import _smooth  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi_tiles.cu", "jacobi.cu", "dens_advect.cu", "advect.cu",
           "project.cu", "project_slab.cu", "advect_slab.cu")
K = 8  # the slab multigrid's halo (parallel/solvers.py, SMOOTH_HALO)
# (side, slab rows, slab index): top, interior and bottom slabs of three,
# and one slab that holds both wall rows.
POSITIONS = {"top": (66, 22, 0), "interior": (66, 22, 1),
             "bottom": (66, 22, 2), "both walls": (34, 34, 0)}
# Positions of fsc_jacobi_slab_sweeps_damp_group's arguments.
G_SLABS, G_M, G_COUNT, G_TILE = 2, 3, 10, 11


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "slab_smoother")
    return mod, lib


def _run(shim, forced, fn, *args, **kw):
    """``fn`` through the shim library inside ``launch_sweeps(*forced)``
    (None: the path's own tiling): (result, [(kernel, args)] of each
    launch)."""
    mod, lib = shim
    launches = []
    launch = co._launch

    def spy(kernel, fn_, *a):
        launches.append((kernel, a))
        launch(kernel, fn_, *a)

    co._launch = spy
    try:
        with mod.kernels_on_cpu(lib):
            if forced is None:
                return fn(*args, **kw), launches
            with co.launch_sweeps(*forced):
                return fn(*args, **kw), launches
    finally:
        co._launch = launch


def _slab(position):
    side, m, i = POSITIONS[position]
    return checks._SlabInputs(side, m, "cpu", side), i


def _one_slab_plain(t, i, sweeps, zero_init):
    """Slab i's smooth on its ``K``-row halo-extended buffer."""
    return cs.smooth_slab_plain(t.ext(t.x, i, K), t.ext(t.x0, i, K),
                                t.flags(i), m=t.m, K=K, sweeps=sweeps,
                                zero_init=zero_init)


@pytest.mark.parametrize("per_launch", [0, 8], ids=["a-sweep", "a-smooth"])
@pytest.mark.parametrize("tile", [64, 32, 16])
@pytest.mark.parametrize("zero_init", [False, True], ids=["guess", "zero"])
@pytest.mark.parametrize("sweeps", [2, 8])
@pytest.mark.parametrize("position", list(POSITIONS))
def test_k9_damp_matches_its_plain_twin(shim, position, sweeps, zero_init,
                                        tile, per_launch):
    """Slab i of a smooth of every slab at once is bit for bit
    ``smooth_slab_plain`` on its halo-extended buffer; a launch takes
    ``T`` sweeps (at most the tile's halo allows: 6 on 16 rows) over the
    whole group on the given tile.  The smoother takes every slab now,
    where it took one slab's extended buffer: the check runs the group and
    reads slab i (before, one slab's launches and their band and wall
    rows)."""
    t, i = _slab(position)
    got, launches = _run(shim, (per_launch, tile), cs.smooth_slabs,
                         t.slab_list(t.x), t.slab_list(t.x0), t.flag_list(),
                         sweeps=sweeps, zero_init=zero_init)
    assert torch.equal(got[i], _one_slab_plain(t, i, sweeps, zero_init))
    per = 1 if per_launch == 0 else min(per_launch, (tile - 3) // 2)
    counts = [min(per, sweeps - done) for done in range(0, sweeps, per)]
    assert [k for k, _ in launches] == (["jacobi_slab_sweeps_damp_group"]
                                        * len(counts))
    for (_, a), count in zip(launches, counts):
        assert (a[G_SLABS], a[G_M], a[G_COUNT], a[G_TILE]) == (
            t.slabs, t.m, count, tile)


@pytest.mark.parametrize("position", list(POSITIONS))
def test_k9_damp_on_the_path_tiling(shim, position):
    """Without an override the 2-sweep smooth is one launch over every
    slab on the tile of ``group_smooth_tiling``, bit for bit with the
    plain twin (before, one launch a slab on ``slab_smooth_tiling``'s)."""
    t, i = _slab(position)
    got, launches = _run(shim, None, cs.smooth_slabs, t.slab_list(t.x),
                         t.slab_list(t.x0), t.flag_list(), sweeps=2)
    assert torch.equal(got[i], _one_slab_plain(t, i, 2, False))
    (_, a), = launches
    assert (a[G_COUNT], a[G_TILE]) == co.group_smooth_tiling(
        t.slabs * t.m * t.side, t.m, 2)


def _refused(shim, slabs, count, tile):
    """A grouped launch of ``slabs`` copies of an 8-slab mesh's slab 1
    (``count`` sweeps on ``tile``-row tiles) raises through ``_launch``
    and counts nothing."""
    mod, lib = shim
    t, p, d, _ = _mesh("8 slabs")
    out = torch.empty_like(d[0])
    table = (ctypes.c_void_p * (7 * slabs))(
        *([None, p[1].data_ptr(), None, None, d[1].data_ptr(), None,
           out.data_ptr()] * slabs))
    walls = (ctypes.c_int * (2 * slabs))()
    co.reset_launch_counts()
    with mod.kernels_on_cpu(lib) as handle, pytest.raises(
            RuntimeError, match="jacobi_slab_sweeps_damp_group failed"):
        co._launch("jacobi_slab_sweeps_damp_group",
                   handle.fsc_jacobi_slab_sweeps_damp_group,
                   ctypes.addressof(table), ctypes.addressof(walls), slabs,
                   t.m, t.side, 0, 1.0, 4.0, 0.8, 0.2, count, tile, 0)
    assert co.launch_counts()["jacobi_slab_sweeps_damp_group"] == 0


def test_k9_damp_launches_the_library_refuses(shim):
    """A tile of 48 rows, and 7 sweeps on a 16-row tile (whose halo allows
    6), are refused through ``_launch`` with nothing counted (now by the
    grouped launch, the smoother's one kernel)."""
    for count, tile in ((2, 48), (7, 16)):
        _refused(shim, 1, count, tile)


# Meshes of K9-damp: (side, slab rows).  The thin mesh's
# 4-row slabs are thinner than the plain twin's 8-row halo: it is held to
# _smooth on the whole grid (which the plain twin equals on a slab's rows).
MESHES = {"1 slab": (64, 64), "2 slabs": (64, 32), "4 slabs": (64, 16),
          "8 slabs": (64, 8), "16 thin slabs": (64, 4)}
GROUP_SWEEPS = (1, 2, 3, 4, 5, 6, 7, 40)


def _mesh(name):
    side, m = MESHES[name]
    t = checks._SlabInputs(side, m, "cpu", side + m)
    return t, t.slab_list(t.p), t.slab_list(t.x0), t.flag_list()


def _group_cases():
    """(mesh, sweeps, zero_init, copy): every smooth with the neighbours'
    rows as pointers, the 2- and 7-sweep ones from copied halos too."""
    for mesh in MESHES:
        for sweeps in GROUP_SWEEPS:
            for zero_init in (False, True):
                yield mesh, sweeps, zero_init, False
                if sweeps in (2, 7):
                    yield mesh, sweeps, zero_init, True


def _held(t, p, d, fl, sweeps, zero_init, got):
    """``got`` against the plain twin, or on slabs thinner than their halo
    against ``_smooth`` on the whole grid."""
    if t.m >= cs.SMOOTH_HALO:
        want = cs.smooth_slabs_plain(p, d, fl, sweeps=sweeps,
                                     zero_init=zero_init)
    else:
        whole = _smooth(t.p, t.x0, sweeps, zero_init)
        want = [t.slab(whole, i) for i in range(t.slabs)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("mesh,sweeps,zero_init,copy", list(_group_cases()))
def test_grouped_k9_damp_matches_plain(shim, mesh, sweeps, zero_init,
                                       copy):
    """Bit for bit with the plain twin (or ``_smooth`` on the thin mesh),
    in ``ceil(sweeps / T)`` launches of
    ``group_smooth_tiling``'s T on all the slabs at once, each launch
    given the group's slabs, rows and tile."""
    t, p, d, fl = _mesh(mesh)
    got, launches = _run(shim, None, cs._smooth_group, p, d, fl, sweeps,
                         zero_init, copy=copy)
    _held(t, p, d, fl, sweeps, zero_init, got)
    per, tile = co.group_smooth_tiling(t.side * t.side, t.m, sweeps)
    counts = [min(per, sweeps - done) for done in range(0, sweeps, per)]
    assert [k for k, _ in launches] == (["jacobi_slab_sweeps_damp_group"]
                                        * len(counts))
    for (_, a), count in zip(launches, counts):
        assert (a[G_SLABS], a[G_M], a[G_COUNT], a[G_TILE]) == (
            t.slabs, t.m, count, tile)


@pytest.mark.parametrize("per_launch", [0, 1, 3, 6, 20])
@pytest.mark.parametrize("tile", [64, 32, 16])
def test_grouped_k9_damp_on_every_tile(shim, tile, per_launch):
    """On tiles of 64, 32 and 16 rows at T of 1 to 20 (``launch_sweeps``;
    capped by the tile's halo and the 16-row slabs), a 7- and a 20-sweep
    smooth on 4 slabs stay bit for bit."""
    t, p, d, fl = _mesh("4 slabs")
    for sweeps in (7, 20):
        got, launches = _run(shim, (per_launch, tile), cs.smooth_slabs, p,
                             d, fl, sweeps=sweeps)
        _held(t, p, d, fl, sweeps, False, got)
        per = min(max(per_launch, 1), (tile - 3) // 2, 20, t.m)
        assert len(launches) == -(-sweeps // per)
        assert all(a[G_TILE] == tile for _, a in launches)


def test_grouped_k9_damp_cuts_a_group_to_the_table(shim, monkeypatch):
    """A device's slabs beyond ``GROUP_SLABS`` (the library's table) go to
    further launches of the same sweeps: 8 slabs in tables of 3 are three
    launches a smooth, bit for bit."""
    monkeypatch.setattr(co, "GROUP_SLABS", 3)
    t, p, d, fl = _mesh("8 slabs")
    got, launches = _run(shim, None, cs.smooth_slabs, p, d, fl, sweeps=2)
    _held(t, p, d, fl, 2, False, got)
    assert [a[G_SLABS] for _, a in launches] == [3, 3, 2]


def test_grouped_k9_damp_launches_the_library_refuses(shim):
    """More slabs than its table (129) and a launch of more sweeps than a
    slab has rows (a neighbour's halo would pass its array) are refused
    through ``_launch`` with nothing counted."""
    for slabs, count, tile in ((129, 2, 16), (1, 9, 64)):
        _refused(shim, slabs, count, tile)


@pytest.mark.parametrize("sweeps,zero_init", [(2, False), (2, True),
                                              (40, False)])
def test_grouped_k9_damp_copies_no_halo(shim, monkeypatch, sweeps,
                                        zero_init):
    """On slabs of one device a smooth builds no extended slab: no
    ``torch.cat`` runs (its plain twin runs one a slab a chunk), and the
    result is bit for bit the plain twin's."""
    t, p, d, fl = _mesh("8 slabs")
    want = cs.smooth_slabs_plain(p, d, fl, sweeps=sweeps, zero_init=zero_init)
    cats = []
    cat = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda *a, **k: cats.append(1) or cat(*a, **k))
    got, _ = _run(shim, None, cs.smooth_slabs, p, d, fl, sweeps=sweeps,
                  zero_init=zero_init)
    assert cats == []
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_group_smooth_tiling_is_a_pure_function():
    """The first of ``GROUP_TILES`` whose cells a launch reaches, T the
    smooth's sweeps up to the tile's halo and the slab's rows;
    ``launch_sweeps`` forces either."""
    assert co.GROUP_TILES[-1][0] == 0
    for least, tile in co.GROUP_TILES:
        assert co.group_smooth_tiling(max(least, 1), 256, 2) == (2, tile)
        assert co.group_smooth_tiling(max(least, 1), 256, 40)[0] == min(
            (tile - 3) // 2, 20)
        assert co.group_smooth_tiling(max(least, 1), 4, 40)[0] == min(
            (tile - 3) // 2, 4)
    for tile in (64, 32, 16):
        with co.launch_sweeps(0, tile_rows=tile):
            assert co.group_smooth_tiling(10**7, 256, 2) == (1, tile)
        with co.launch_sweeps(20, tile_rows=tile):
            assert co.group_smooth_tiling(10**7, 256, 20) == (
                min((tile - 3) // 2, 20), tile)


@pytest.mark.parametrize("side", [1025, 1027, 33, 65, 129])
@pytest.mark.parametrize("sweeps", [2, 40])
def test_damped_plan_keeps_odd_sides_off_the_deeper_halo(side, sweeps):
    """On an odd side ``damped_plan`` takes the largest T whose output
    tile leaves no last tile of the grid's last ghost line alone (the
    deeper halo of ``plan_tiling``): at 1025², the slab multigrid's coarse
    grid at 2048², a 2-sweep smooth at T = 5 on 16-row tiles (6 before:
    1025 % 4 = 1) and the 40-sweep solve at T = 10 on the 64-row tile of
    a solve longer than a 16-row launch takes (``LONG_SOLVE_CELLS``); even
    sides keep T = ``SWEEPS_PER_LAUNCH`` or the most the tile's halo
    allows, as before."""
    route = co.damped_plan(side, sweeps)
    assert not co._deeper_halo(side, route.per_launch, route.tile_rows)
    limit = min(co.SWEEPS_PER_LAUNCH, (route.tile_rows - 3) // 2)
    assert all(co._deeper_halo(side, t, route.tile_rows)
               for t in range(route.per_launch + 1, limit + 1))
    if side == 1025:
        assert route == (co.DampedRoute(10, 64, False) if sweeps == 40
                         else co.DampedRoute(5, 16, False))
    for even in (side - 1, side + 1, 2048, 1024, 256):
        if even > co.WHOLE_GRID_SIDE:
            rows = co.damped_plan(even, sweeps).tile_rows
            assert co.damped_plan(even, sweeps).per_launch == min(
                co.SWEEPS_PER_LAUNCH, (rows - 3) // 2)


@pytest.mark.parametrize("sweeps,zero_init", [(2, False), (2, True),
                                              (40, True)])
@pytest.mark.parametrize("side", [33, 65])
def test_k1_damp_on_odd_sides(shim, side, sweeps, zero_init):
    """The slab multigrid's coarse grid is odd, (n/2 + 2)² with n/2 odd
    (33² at n = 62, 1025² at 2048²): K1-damp, which the graded hierarchy
    gives only sides that are multiples of 8 and 16², equals ``_smooth``
    there bit for bit, in the launches of ``damped_plan``."""
    gen = torch.Generator().manual_seed(side)
    p, div = (torch.rand(side, side, generator=gen) * 2 - 1
              for _ in range(2))
    got, launches = _run(shim, None, co.mg_smooth, p, div, sweeps,
                         zero_init)
    assert torch.equal(got, _smooth(p, div, sweeps, zero_init))
    per_launch = co.damped_plan(side, sweeps).per_launch
    assert [k for k, _ in launches] == ["jacobi_sweeps_damp"] * -(
        -sweeps // per_launch)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("solver,slabs", [("multigrid", 1),
                                          ("multigrid", 4),
                                          ("multigrid", 8), ("cg", 4)])
def test_slab_solver_step_on_the_shim(shim, solver, slabs):
    """The row-slab step with the multigrid or CG projection at 64²
    through the ``cuda`` backend on the shim: the launches of
    ``chip_smoke.expected_launches_sharded`` (K9-damp twice a cycle over
    all the slabs, K1-damp on the replicated 33² coarse grid) and the
    state of the ``reference`` backend, bit for bit.  The smooths are one
    launch for every slab now, where K9-damp launched once a slab: the
    check counts ``jacobi_slab_sweeps_damp_group`` (8 a step) where it
    counted ``jacobi_slab_sweeps_damp`` (8 a step a slab).  That kernel is
    gone, so its count is no longer read."""
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_state, unshard)

    mod, lib = shim
    ref = ft.SimConfig(n=62, jacobi_iters=6, max_courant=2,
                       backend="reference", device="cpu",
                       pressure_solver=solver, mg_cycles=2, cg_iters=12)
    cfg = ref.replace()
    object.__setattr__(cfg, "backend", "cuda")
    mesh = make_mesh([torch.device("cpu")] * slabs)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
    state, src = shard_state(state, mesh), shard_state(src, mesh)
    step = make_sharded_step_fn(cfg, mesh)
    with mod.kernels_on_cpu(lib):
        co.reset_launch_counts()
        got = unshard(step(state, src))
        counts = co.launch_counts()
    want = unshard(make_sharded_step_fn(ref, mesh)(state, src))
    design = _chip_smoke().expected_launches_sharded(cfg, slabs)
    assert counts == {k: design.get(k, 0) for k in co.KERNELS}
    if solver == "multigrid":
        assert counts["jacobi_slab_sweeps_damp_group"] == 2 * 2 * 2
        assert counts["jacobi_sweeps_damp"] == 2 * 2 * (
            1 + -(-40 // co.damped_plan(33, 40).per_launch))
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
