"""K9-damp (``csrc/jacobi_tiles.cu``, ``fsc_jacobi_slab_sweeps_damp``) is
the fine-level smoother of the slab multigrid: K1-damp's damped sweeps on
the tiled K9's slab walk, a smooth in one launch on the halo-extended slab
buffer.  A CUDA kernel has no interpret mode, so this file compiles it with
``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py`` (a block's threads run together,
``__syncthreads()`` is a barrier) beside K1-K4 and K9-K12, and holds
``cuda_sharded.smooth_slab`` bit for bit against its plain twin
``smooth_slab_plain`` (which equals ``ops.multigrid._smooth`` on the slab's
rows, ``tests/test_torch_sharded_solvers.py``): top, interior and bottom
slabs of 66² (3 slabs of 22 rows) and the slab of 34² that holds both
walls, smooths of 2 and 8 sweeps from a guess and from zero, on the tiles
of 64, 32 and 16 rows the library takes (K9's tile and K1-damp's), one
launch a smooth and one a sweep; the band and wall rows each launch is
given; the launches the library refuses; ``slab_smooth_tiling`` as a pure
function.  Then K1-damp, the replicated coarse level's smoother, on odd
sides (33 and 65, the coarse grids of n = 62 and 126; phase 3c runs 1025²
on the card) against ``_smooth``, and the multigrid and CG slab steps
through the ``cuda`` backend on the shim against the ``reference`` backend,
with the launches ``chip_smoke.expected_launches_sharded`` counts.  Skips
only without ``g++``.
"""
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
# Positions of fsc_jacobi_slab_sweeps_damp's arguments.
COUNT, ROWS, DONE, GTOP, GBOT, TILE = 9, 10, 11, 12, 13, 14


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


@pytest.mark.parametrize("per_launch", [0, 8], ids=["a-sweep", "a-smooth"])
@pytest.mark.parametrize("tile", [64, 32, 16])
@pytest.mark.parametrize("zero_init", [False, True], ids=["guess", "zero"])
@pytest.mark.parametrize("sweeps", [2, 8])
@pytest.mark.parametrize("position", list(POSITIONS))
def test_k9_damp_matches_its_plain_twin(shim, position, sweeps, zero_init,
                                        tile, per_launch):
    """Bit for bit with ``smooth_slab_plain``; a launch takes ``T`` sweeps
    (at most the tile's halo allows: 6 on 16 rows), each on the band its
    sweeps leave exact, with the buffer's wall rows."""
    t, i = _slab(position)
    args = (t.ext(t.x, i, K), t.ext(t.x0, i, K), t.flags(i))
    kw = dict(m=t.m, K=K, sweeps=sweeps, zero_init=zero_init)
    got, launches = _run(shim, (per_launch, tile), cs.smooth_slab, *args,
                         **kw)
    assert torch.equal(got, cs.smooth_slab_plain(*args, **kw))
    per = 1 if per_launch == 0 else min(per_launch, (tile - 3) // 2)
    counts = [min(per, sweeps - done) for done in range(0, sweeps, per)]
    assert [k for k, _ in launches] == ["jacobi_slab_sweeps_damp"] * len(
        counts)
    walls = cs._wall_rows(t.flags(i), K, t.m)
    done = 0
    for (_, a), count in zip(launches, counts):
        assert (a[COUNT], a[ROWS], a[DONE], a[GTOP], a[GBOT], a[TILE]) == (
            count, t.m + 2 * K, done, *walls, tile)
        assert (a[0] is None) == (zero_init and done == 0)
        done += count


@pytest.mark.parametrize("position", list(POSITIONS))
def test_k9_damp_on_the_path_tiling(shim, position):
    """Without an override the 2-sweep smooth is one launch on the tile of
    ``slab_smooth_tiling``, bit for bit with the plain twin."""
    t, i = _slab(position)
    args = (t.ext(t.x, i, K), t.ext(t.x0, i, K), t.flags(i))
    kw = dict(m=t.m, K=K, sweeps=2)
    got, launches = _run(shim, None, cs.smooth_slab, *args, **kw)
    assert torch.equal(got, cs.smooth_slab_plain(*args, **kw))
    (_, a), = launches
    rows = t.m + 2 * K
    assert (a[COUNT], a[TILE]) == co.slab_smooth_tiling(rows, t.side, 2)


def test_k9_damp_launches_the_library_refuses(shim):
    """A tile of 48 rows, and 7 sweeps on a 16-row tile (whose halo allows
    6), are refused through ``_launch`` with nothing counted."""
    mod, lib = shim
    t, i = _slab("interior")
    x, rhs = t.ext(t.x, i, K), t.ext(t.x0, i, K)
    out = torch.empty_like(x)
    gtop, gbot = cs._wall_rows(t.flags(i), K, t.m)
    # slab_smooth_tiling never asks for these: the library is called as
    # smooth_slab calls it.
    for count, tile in ((2, 48), (7, 16)):
        co.reset_launch_counts()
        with mod.kernels_on_cpu(lib) as handle, pytest.raises(
                RuntimeError, match="jacobi_slab_sweeps_damp failed"):
            co._launch("jacobi_slab_sweeps_damp",
                       handle.fsc_jacobi_slab_sweeps_damp, x.data_ptr(),
                       rhs.data_ptr(), out.data_ptr(), t.side, 0, 1.0, 4.0,
                       0.8, 0.2, count, t.m + 2 * K, 0, gtop, gbot, tile, 0)
        assert co.launch_counts()["jacobi_slab_sweeps_damp"] == 0


def test_slab_smooth_tiling_is_a_pure_function():
    """The first of K1-damp's ``DAMPED_TILES`` whose cells a buffer
    reaches, T the smooth's sweeps up to the tile's halo; ``launch_sweeps``
    forces either."""
    least, tall = co.DAMPED_TILES[0]
    assert co.DAMPED_TILES[-1][0] == 0
    short = co.DAMPED_TILES[-1][1]
    assert co.slab_smooth_tiling(272, 2048, 2) == (2, short)
    assert co.slab_smooth_tiling(2064, 2048, 2) == (2, tall)
    assert co.slab_smooth_tiling(least // 100, 100, 2)[1] == tall
    assert co.slab_smooth_tiling(least // 100 - 1, 100, 2)[1] == short
    for tile in (64, 32, 16):
        with co.launch_sweeps(1, tile_rows=tile):
            assert co.slab_smooth_tiling(272, 2048, 2) == (1, tile)
        with co.launch_sweeps(20, tile_rows=tile):
            assert co.slab_smooth_tiling(272, 2048, 20) == (
                min((tile - 3) // 2, 20), tile)
    with co.launch_sweeps(0):
        assert co.slab_smooth_tiling(272, 2048, 2)[0] == 1


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
    ``chip_smoke.expected_launches_sharded`` (K9-damp twice a cycle on each
    slab, K1-damp on the replicated 33² coarse grid) and the state of the
    ``reference`` backend, bit for bit."""
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
        assert counts["jacobi_slab_sweeps_damp"] == 2 * 2 * 2 * slabs
        assert counts["jacobi_sweeps_damp"] == 2 * 2 * (
            1 + -(-40 // co.damped_plan(33, 40).per_launch))
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
