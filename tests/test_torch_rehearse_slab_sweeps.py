"""The tiled K9 (``csrc/jacobi_tiles.cu``, ``fsc_jacobi_slab_sweeps``) runs
T sweeps of a row-slab solve per launch in shared-memory tiles over the
halo-extended slab buffer.  A CUDA kernel has no interpret mode, so this
file compiles it with ``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py`` (a block's threads run together,
``__syncthreads()`` is a barrier, the dynamic shared memory one buffer a
block), beside the per-sweep K9 (``csrc/jacobi_slab.cu``), K10-K12 and
K18, and holds it bit for bit against the per-sweep K9 chain (the same
sweeps one launch each, ``cuda_ops.launch_sweeps(0)``) and against the
plain twin ``fused_jacobi_slab_plain`` (within ``checks.TOL`` in fast
mode, whose plain twin multiplies and adds where the kernels call
``fmaf``, as the per-sweep K9 already differs from it): top, interior and
bottom slabs of 66² (3 slabs of 22 rows) and the one slab of 34² that
holds both walls, every solve mode, T of 1, 2, 3 and 5 with solves of 1,
T-1, T, T+1 and the halo's full depth, on tiles of 64 and 32 rows;
``fused_project_slab``, ``fused_dens_slab`` and ``fused_jacobi_slab_split``
(B13: the tiled K9's first launch reading its tiles from the split
operands, ``jacobi_slab_sweeps_split``, then the tiled K9; bit for bit
against K9 on the concatenation, against the chain it is held to, K18's
one sweep then the per-sweep K9, and against the plain twin, in its
Jacobi, zero-guess and fast modes, JAX's B13's; a Chebyshev flag is
refused); the geometries where a wall row or
the last ghost column would sit on the edge of a tile's output and the
launch takes a deeper halo; launches the library refuses.  Each launch is
checked against ``cuda_ops.sweep_plan`` (its sweeps, ω, the band it
writes, where it stores the rhs it built and x_{k-1}); ``slab_tiling`` is
tested as a pure function.  Skips only without ``g++``.
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
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.ops.chebyshev import cheby_omegas  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi_tiles.cu", "jacobi_slab.cu", "project_slab.cu",
           "advect_slab.cu", "jacobi_slab_split.cu")
DT = checks.DT
RHO = PERF_POINTS_2D[2048][0]
MODES = {
    "jacobi": dict(),
    "zero_init": dict(zero_init=True),
    "fast": dict(fast=True),
    "chebyshev": dict(cheby_rho=RHO),
    "chebyshev+fast": dict(fast=True, cheby_rho=RHO),
    "chebyshev zero_init": dict(zero_init=True, cheby_rho=RHO),
}
K = 8  # the halo: a solve of up to K sweeps
# (T, sweeps): 1, T-1, T, T+1 and K sweeps for T of 1, 2, 3 and 5.
PLANS = sorted({(t, k) for t in (1, 2, 3, 5) for k in (1, t - 1, t, t + 1, K)
                if k >= 1})
# (side, slab rows, slab index): top, interior and bottom slabs of three,
# and one slab that holds both wall rows.
POSITIONS = {"top": (66, 22, 0), "interior": (66, 22, 1),
             "bottom": (66, 22, 2), "both walls": (34, 34, 0)}
TILES = (64, 32)
# Positions of fsc_jacobi_slab_sweeps's arguments (csrc/jacobi_tiles.cu).
XM_OUT, RHS_OUT, OMEGAS, FIRST, COUNT, ROWS, DONE, GTOP, GBOT, TILE = (
    5, 6, 14, 16, 17, 18, 19, 20, 21, 22)


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "slab_sweeps")
    return mod, lib


def _run(shim, per_launch, tile, fn, *args, **kw):
    """``fn`` through the shim library with ``per_launch`` sweeps a K9
    launch on tiles of ``tile`` rows: (result, [(kernel, args, ω)] of each
    launch)."""
    mod, lib = shim
    launches = []
    launch = co._launch

    def spy(kernel, fn_, *a):
        ws = []
        if kernel == "jacobi_slab_sweeps":  # the ω the launch was given
            w = ctypes.cast(a[OMEGAS], ctypes.POINTER(ctypes.c_float))
            ws = [w[s] for s in range(a[COUNT])]
        launches.append((kernel, a, ws))
        launch(kernel, fn_, *a)

    co._launch = spy
    try:
        with mod.kernels_on_cpu(lib), co.launch_sweeps(per_launch,
                                                        tile_rows=tile):
            return fn(*args, **kw), launches
    finally:
        co._launch = launch


def _slab(position):
    side, m, i = POSITIONS[position]
    return checks._SlabInputs(side, m, "cpu", side), i


def _check_plan(launches, plan, rows, walls, omegas, tile, done=0):
    """Each tiled launch against its step of the plan: its sweeps, its ω,
    the sweeps done before it (its band), the buffer's rows and wall rows,
    the tile, and where it stores the rhs it built and x_{k-1}."""
    tiled = [launch for launch in launches
             if launch[0] == "jacobi_slab_sweeps"]
    assert len(tiled) == len(plan)
    for (_, a, ws), step in zip(tiled, plan):
        assert (a[FIRST], a[COUNT]) == (step.first, step.count)
        assert (a[ROWS], a[DONE], a[GTOP], a[GBOT], a[TILE]) == (
            rows, step.first, *walls, tile)
        assert step.first >= done
        assert (a[RHS_OUT] is not None) == step.stores_rhs
        assert (a[XM_OUT] is not None) == step.stores_xm
        ks = range(step.first, step.first + step.count)
        assert ws == [co._f32(omegas[k - 1]) if omegas and k >= 1 else 0.0
                      for k in ks]


# Positions of fsc_jacobi_slab_sweeps_split's arguments.
S_RHS_OUT, S_FLAGS, S_COUNT, S_M, S_K, S_GTOP, S_GBOT, S_TILE = (
    7, 14, 15, 16, 17, 18, 19, 20)
# B13's modes: JAX's (no Chebyshev).
SPLIT_MODES = ("jacobi", "zero_init", "fast")


def _check_split_launch(launch, step, m, K, walls, tile):
    """B13's first launch against the first step of its plan: its sweeps
    from sweep 0, the slab's rows, halo and wall rows, the tile, no
    Chebyshev flag; it stores the rhs it read wherever a launch follows."""
    kernel, a, _ = launch
    assert kernel == "jacobi_slab_sweeps_split"
    assert step.first == 0
    assert (a[S_COUNT], a[S_M], a[S_K], a[S_GTOP], a[S_GBOT], a[S_TILE]) == (
        step.count, m, K, *walls, tile)
    assert a[S_FLAGS] & 4 == 0
    assert (a[S_RHS_OUT] is not None) == (not step.ends_solve)


def _near_plain(got, want, fast):
    err = checks.max_abs_diff(got, want)
    assert err <= checks.TOL if fast else err == 0.0


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("per_launch,sweeps", PLANS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("position", list(POSITIONS))
def test_tiled_k9_matches_per_sweep_chain_and_plain(shim, position, mode,
                                                    per_launch, sweeps,
                                                    tile):
    t, i = _slab(position)
    kw = MODES[mode]
    args = (1, t.ext(t.src, i, K), t.ext(t.x0, i, K), t.flags(i))
    kw = dict(kw, m=t.m, K=K, alpha=t.a_visc, beta=1 + 4 * t.a_visc,
              sweeps=sweeps)
    got, launches = _run(shim, per_launch, tile, cs.fused_jacobi_slab,
                         *args, **kw)
    chain, per_sweep = _run(shim, 0, tile, cs.fused_jacobi_slab, *args, **kw)
    assert torch.equal(got, chain)
    _near_plain(got, cs.fused_jacobi_slab_plain(*args, **kw),
                kw.get("fast", False))
    omegas = cheby_omegas(RHO, sweeps) if "cheby_rho" in kw else None
    _check_plan(launches, co.sweep_plan(
        0, sweeps, sweeps, per_launch, prep=kw.get("fast", False),
        cheby=omegas is not None, guess=not kw.get("zero_init", False)),
        t.m + 2 * K, cs._wall_rows(t.flags(i), K, t.m), omegas, tile)
    assert [k for k, *_ in per_sweep] == ["jacobi_slab"] * sweeps


@pytest.mark.parametrize("per_launch,tile", [(1, 64), (2, 32), (3, 64),
                                             (5, 32), (5, 64)])
@pytest.mark.parametrize("position", list(POSITIONS))
def test_tiled_k9_in_the_slab_wrappers(shim, position, per_launch, tile):
    """``fused_project_slab`` (the 20-sweep pressure solve from zero and
    the Chebyshev 14), ``fused_dens_slab`` (the folded source built by the
    first launch and stored for the rest, K12 gathering from the swept
    buffer's band; in fast mode too) and ``fused_jacobi_slab_split`` at the
    step's margins: equal to the same call on the per-sweep K9 bit for
    bit, and to the plain twins (fast within ``checks.TOL``).  B13's first
    launch is now the tiled K9's split-source form, T sweeps from sweep 0
    (``jacobi_slab_sweeps_split``), where K18 ran sweep 1 before the tiled
    K9 took sweep 2 on: its plan starts at sweep 0 and its first step is
    checked as that launch."""
    t, i = _slab(position)
    fl, n, m, cmax = t.flags(i), t.n, t.m, 2
    av, ad = t.a_visc, t.a_diff
    Kp, Kd, Ks = 23, 20 + 1 + cmax, 21
    cases = [
        (cs.fused_project_slab, cs.fused_project_slab_plain,
         (t.ext(t.u, i, Kp), t.ext(t.v, i, Kp), fl),
         dict(n=n, iters=20, m=m, K=Kp), 20, Kp, 0),
        (cs.fused_project_slab, cs.fused_project_slab_plain,
         (t.ext(t.u, i, 17), t.ext(t.v, i, 17), fl),
         dict(n=n, iters=14, m=m, K=17, cheby_rho=RHO), 14, 17, 0),
        *[(cs.fused_dens_slab, cs.fused_dens_slab_plain,
           (0, t.ext(t.src, i, Kd), t.ext(t.x0, i, Kd), t.slab(t.u, i),
            t.slab(t.v, i), fl),
           dict(alpha=ad, beta=1 + 4 * ad, iters=20, dt=DT, n=n, cmax=cmax,
                m=m, K=Kd, fast=fast), 20, Kd, 0) for fast in (False, True)],
        *[(cs.fused_jacobi_slab_split, cs.fused_jacobi_slab_split_plain,
           (1, *t.split(t.x, i, Ks), *t.split(t.x0, i, Ks), fl),
           dict(m=m, K=Ks, alpha=av, beta=1 + 4 * av, sweeps=20, **kw), 20,
           Ks, 0) for kw in (dict(), dict(zero_init=True), dict(fast=True))],
    ]
    for fn, plain, args, kw, sweeps, halo, done in cases:
        got, launches = _run(shim, per_launch, tile, fn, *args, **kw)
        chain, _ = _run(shim, 0, tile, fn, *args, **kw)
        for a, b in zip(checks._as_tuple(got), checks._as_tuple(chain)):
            assert torch.equal(a, b), (fn.__name__, kw)
        for a, b in zip(checks._as_tuple(got),
                        checks._as_tuple(plain(*args, **kw))):
            _near_plain(a, b, kw.get("fast", False))
        cheby = kw.get("cheby_rho")
        prep = fn is cs.fused_dens_slab or kw.get("fast")
        plan = co.sweep_plan(
            done, sweeps, sweeps, per_launch, prep=bool(prep),
            cheby=cheby is not None,
            guess=fn is not cs.fused_project_slab
            and not kw.get("zero_init", False))
        if fn is cs.fused_jacobi_slab_split:
            _check_split_launch(launches[0], plan[0], m, halo,
                                cs._wall_rows(fl, halo, m), tile)
            plan = plan[1:]
        _check_plan(launches, plan, m + 2 * halo, cs._wall_rows(fl, halo, m),
                    cheby_omegas(RHO, sweeps) if cheby else None, tile, done)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("per_launch,sweeps", PLANS)
@pytest.mark.parametrize("mode", SPLIT_MODES)
@pytest.mark.parametrize("position", list(POSITIONS))
def test_split_source_k9_matches_concat_chain_and_plain(shim, position, mode,
                                                        per_launch, sweeps,
                                                        tile):
    """B13 (``fused_jacobi_slab_split``): the tiled K9's first launch of T
    sweeps reading its tiles from the three operands, then the tiled K9,
    equals ``fused_jacobi_slab`` on the ``torch.cat`` of the operands (the
    same launches), the per-sweep chain it is held to (K18's one sweep,
    then the per-sweep K9) bit for bit, and its plain twin (fast within
    ``checks.TOL``); its launches follow ``sweep_plan`` from sweep 0."""
    t, i = _slab(position)
    kw = dict(MODES[mode], m=t.m, K=K, alpha=t.a_visc,
              beta=1 + 4 * t.a_visc, sweeps=sweeps)
    x, rhs, fl = t.split(t.src, i, K), t.split(t.x0, i, K), t.flags(i)
    args = (1, *x, *rhs, fl)
    got, launches = _run(shim, per_launch, tile, cs.fused_jacobi_slab_split,
                         *args, **kw)
    chain, per_sweep = _run(shim, 0, tile, cs.fused_jacobi_slab_split,
                            *args, **kw)
    concat, _ = _run(shim, per_launch, tile, cs.fused_jacobi_slab, 1,
                     t.ext(t.src, i, K), t.ext(t.x0, i, K), fl, **kw)
    assert torch.equal(got, chain)
    assert torch.equal(got, concat)
    _near_plain(got, cs.fused_jacobi_slab_split_plain(*args, **kw),
                kw.get("fast", False))
    plan = co.sweep_plan(0, sweeps, sweeps, per_launch,
                         prep=kw.get("fast", False), cheby=False,
                         guess=not kw.get("zero_init", False))
    walls = cs._wall_rows(fl, K, t.m)
    _check_split_launch(launches[0], plan[0], t.m, K, walls, tile)
    _check_plan(launches, plan[1:], t.m + 2 * K, walls, None, tile)
    assert [k for k, *_ in per_sweep] == (["jacobi_slab_split"]
                                          + ["jacobi_slab"] * (sweeps - 1))


def test_split_launches_the_library_refuses(shim):
    """The split-source launch takes at most the halo's depth in sweeps,
    tiles of 64 or 32 rows and no Chebyshev flag: a launch of 9 sweeps
    over an 8-row halo, a 48-row tile and a Chebyshev launch are refused
    through ``_launch`` with nothing counted."""
    mod, lib = shim
    t, i = _slab("interior")
    x, rhs = t.split(t.src, i, K), t.split(t.x0, i, K)
    out = torch.empty((t.m + 2 * K, t.side))
    for count, tile, flags in ((9, 64, 0), (2, 48, 0), (2, 64, 4)):
        co.reset_launch_counts()
        with mod.kernels_on_cpu(lib) as handle, pytest.raises(
                RuntimeError, match="jacobi_slab_sweeps_split failed"):
            co._launch("jacobi_slab_sweeps_split",
                       handle.fsc_jacobi_slab_sweeps_split,
                       *(a.data_ptr() for a in (*x, *rhs)), out.data_ptr(),
                       None, t.side, 1, 1.0, 5.0, 0.2, 0.2, flags, count,
                       t.m, K, -1, -1, tile, 0)
        assert co.launch_counts()["jacobi_slab_sweeps_split"] == 0


@pytest.mark.parametrize("mode", ["jacobi", "zero_init", "chebyshev+fast"])
@pytest.mark.parametrize("side,m,K_,per_launch,tile,sweeps", [
    # A 32-row tile at T = 5 outputs 22 rows from the band's first row, 5:
    # a one-slab buffer of 24 rows with a 26-row halo puts gtop (row 26)
    # on its first tile's last output row and gbot (row 49) on the first
    # output row of its third; the second launch moves both off the edges.
    (24, 24, 26, 5, 32, 5), (24, 24, 26, 5, 32, 10),
    # A 64-row tile at T = 5 outputs 118 columns: a side of 119 leaves the
    # last row of tiles only the last ghost column.
    (119, 17, 8, 5, 64, 8),
])
def test_tiled_k9_where_a_border_line_sits_on_a_tile_edge(
        shim, side, m, K_, per_launch, tile, sweeps, mode):
    """A wall row on a tile's last (gtop) or first (gbot) output row, or
    the last ghost column on its first output column, derives from a line
    the halo leaves stale: the launch takes a halo one cell deeper there,
    and the result stays bit for bit."""
    t = checks._SlabInputs(side, m, "cpu", side)
    kw = dict(MODES[mode], m=m, K=K_, alpha=t.a_visc,
              beta=1 + 4 * t.a_visc, sweeps=sweeps)
    for i in sorted({0, t.slabs - 1}):
        args = (2, t.ext(t.src, i, K_), t.ext(t.x0, i, K_), t.flags(i))
        got, _ = _run(shim, per_launch, tile, cs.fused_jacobi_slab, *args,
                      **kw)
        chain, _ = _run(shim, 0, tile, cs.fused_jacobi_slab, *args, **kw)
        assert torch.equal(got, chain)
        _near_plain(got, cs.fused_jacobi_slab_plain(*args, **kw),
                    kw.get("fast", False))


def test_launches_the_library_refuses(shim):
    """The library runs a launch of 20 sweeps (its kMaxSweeps) and
    refuses one of 21, a tile of other than 64 or 32 rows and a 32-row
    tile too short for T = 15, each through ``_launch`` with nothing
    counted."""
    t, i = _slab("interior")
    args = (1, t.ext(t.src, i, 20), t.ext(t.x0, i, 20), t.flags(i))
    kw = dict(m=t.m, K=20, alpha=t.a_visc, beta=1 + 4 * t.a_visc)
    got, launches = _run(shim, 20, 64, cs.fused_jacobi_slab, *args,
                         sweeps=20, **kw)
    assert [k for k, *_ in launches] == ["jacobi_slab_sweeps"]
    assert torch.equal(got, cs.fused_jacobi_slab_plain(*args, sweeps=20,
                                                       **kw))
    kw["K"] = 21
    args = (1, t.ext(t.src, i, 21), t.ext(t.x0, i, 21), t.flags(i))
    for per_launch, tile in ((21, 64), (5, 48), (15, 32)):
        co.reset_launch_counts()
        with pytest.raises(RuntimeError, match="jacobi_slab_sweeps failed"):
            _run(shim, per_launch, tile, cs.fused_jacobi_slab, *args,
                 sweeps=21, **kw)
        assert co.launch_counts()["jacobi_slab_sweeps"] == 0


def test_slab_tiling_picks_the_tile_by_the_buffer():
    """``slab_tiling`` as a pure function: the first of ``SLAB_TILINGS``
    whose cell count a buffer reaches, the thin and few-slab buffers of
    2048² on the short tile, the one-slab 2048² and the 8192² slab buffers
    on the tall one; a solve of at most ``SLAB_ONE_LAUNCH`` sweeps in one
    launch, a longer one in launches of the tiling's T."""
    least, per_tall, tall = co.SLAB_TILINGS[0]
    _, per_short, short = co.SLAB_TILINGS[-1]
    one = co.SLAB_ONE_LAUNCH
    assert (tall, short) == (64, 32)
    assert co.SLAB_TILINGS[-1][0] == 0
    for rows, side in ((48, 2048), (32, 2048), (304, 2048), (320, 2048)):
        assert co.slab_tiling(rows, side, 20) == (per_short, short)
        assert co.slab_tiling(rows, side, one) == (one, short)
        assert co.slab_tiling(rows, side, 1) == (per_short, short)
    for rows, side in ((2096, 2048), (2096, 8192), (2144, 8192)):
        assert co.slab_tiling(rows, side, 40) == (per_tall, tall)
        assert co.slab_tiling(rows, side, one) == (max(per_tall, one), tall)
    assert co.slab_tiling(least // 100, 100, 20) == (per_tall, tall)
    assert co.slab_tiling(least // 100 - 1, 100, 20) == (per_short, short)
    for per, tile in ((per_tall, tall), (per_short, short), (one, short)):
        assert 1 <= per <= 20 and tile - 2 * (per + 1) >= 1


def test_slab_step_launches_follow_the_tiling():
    """The launches ``chip_smoke.expected_launches_sharded`` counts for the
    steps phase 10 runs, chunk by chunk (K9 launches a step, per-sweep ->
    tiled): 800 -> 160 at 2048² on 8 slabs (T = 5 on 304- and 320-row
    buffers), 464 -> 96 in the perf mode, 800 -> 112 at 8192² on 4 slabs
    (40 iterations, T = 8), 12800 -> 1920 on 128 slabs with
    ``fuse_sweeps=8`` (a launch a chunk), 100 -> 15 on one slab."""
    import chip_smoke
    import fluidsimulationcuda_torch as ft
    from fluidsimulationcuda_torch.core.config import perf_operating_point

    parity = ft.SimConfig(n=2046, jacobi_iters=20, device="cpu")
    rho, k_d, k_p = perf_operating_point(2048)
    perf = parity.replace(pressure_solver="chebyshev",
                          diffusion_solver="chebyshev", cheby_rho=rho,
                          cheby_iters=k_d, cheby_press_iters=k_p,
                          fast_math=True)
    big = ft.SimConfig(n=8190, jacobi_iters=40, device="cpu")
    for cfg, slabs, k9 in ((parity, 8, 160), (perf, 8, 96), (big, 4, 112),
                           (parity.replace(fuse_sweeps=8), 128, 1920),
                           (parity, 1, 15)):
        want = chip_smoke.expected_launches_sharded(cfg, slabs)
        assert want == {"jacobi_slab_sweeps": k9,
                        "divergence_slab": 2 * slabs,
                        "gradient_slab": 2 * slabs,
                        "advect_slab": 2 * slabs}
