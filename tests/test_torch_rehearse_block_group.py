"""The grouped K9-block (``csrc/jacobi_tiles.cu``,
``jacobi_block_group_kernel``: a chunk of a block solve over every block
of a device in one launch, each block's halo read from its neighbours'
own arrays) behind the host shim of ``dev/rehearse_kernels_cpu.py`` (a
CUDA kernel has no interpret mode, so this file compiles the sources with
``g++ -ffp-contract=off``; a tile's threads run together as fibers).

Each form (Jacobi as deep as its halo and shorter, the zero guess, the
reciprocal form, Chebyshev first and chained chunks, fast and from zero,
the damped smooths), in float32 and bf16, on every block of (2, 2),
(2, 4), (4, 2) and (8, 1) meshes of 64² and a (3, 3) mesh of 66² (every
combination of walls a block can hold, the interior block's none), is
held bit for bit against the per-block K9-block on ``Blocks.ext``'s
buffers and against the plain twin, on tiles of 32 and 64 rows; so too
with every neighbour read from a copy of its strips (the route of a
neighbour on another device), and a copy of the sources whose grouped
kernel takes the wrong neighbour's rows fails.  The ``cuda`` block step
through the grouped kernel equals
the step on the per-block kernel and, with exact gathers, the
single-device step, bit for bit, with the launches of
``chip_smoke.expected_launches_blocks``; a block solve on the ``cuda``
backend runs no ``torch.cat``.  Skips only without ``g++``.
"""
import importlib.util
import re
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks, cuda_ops, dispatch  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    Blocks, make_mesh, make_sharded_step_fn, shard_blocks, unshard)
from fluidsimulationcuda_torch.parallel import sharded  # noqa: E402
from fluidsimulationcuda_torch.parallel import solvers  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi_tiles.cu", "advect_slab.cu", "project_slab.cu")
CPU = torch.device("cpu")


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
    return mod, mod.build_shim_library(SOURCES, mod.OUT / "block_group")


def _run(shim, fn, *args, **kw):
    """fn through the shim library: (result, launch counts)."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib):
        cuda_ops.reset_launch_counts()
        out = fn(*args, **kw)
        return out, {k: c for k, c in cuda_ops.launch_counts().items() if c}


def _fields(side: int, seed: int, dtype):
    g = torch.Generator().manual_seed(seed)
    x, rhs, xm = (torch.randn((side, side), generator=g) for _ in range(3))
    return tuple(t.to(dtype) for t in (x, rhs, xm))


def _forms(K: int, av: float):
    return checks.block_chunk_forms(K, av)


def _group(op, blocks, b, xs, rhs, xms, n, K, sweeps, coef, kw, plain=False):
    """The grouped call (or its plain twin) of a form, its outputs in one
    tuple."""
    return checks.block_chunk("plain" if plain else "group",
                              (op, b, sweeps, coef, kw), blocks, xs, rhs,
                              xms, n, K)


def _per_block(op, blocks, b, xs, rhs, xms, n, K, sweeps, coef, kw):
    """The same chunk as JAX composes it: ``Blocks.ext``, then one
    per-block K9-block launch a block."""
    return checks.block_chunk("per-block", (op, b, sweeps, coef, kw), blocks,
                              xs, rhs, xms, n, K)


def _same(a, b) -> bool:
    a, b = tuple(a), tuple(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


MESHES = [((2, 2), 64), ((2, 4), 64), ((4, 2), 64), ((8, 1), 64),
          ((3, 3), 66)]
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


def _setup(shape, side, dtype, seed=0):
    px, py = shape
    blocks = Blocks(px, py, side)
    xs, rhs, xms = (blocks.cut(f) for f in _fields(side, seed, dtype))
    K = min(8, blocks.m, blocks.k)
    return blocks, list(xs), list(rhs), list(xms), K


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape,side", MESHES,
                         ids=[f"{a}x{b}" for (a, b), _ in MESHES])
def test_grouped_equals_per_block_and_plain(shim, shape, side, dtype):
    """Every form on every block of the mesh: one grouped launch, bit for
    bit the per-block K9-block on ``Blocks.ext``'s buffers (one launch a
    block) and the plain twin, in the storage dtype."""
    blocks, xs, rhs, xms, K = _setup(shape, side, dtype)
    n, tag = side - 2, "_bf16" if dtype == torch.bfloat16 else ""
    for name, (op, b, sweeps, coef, kw) in _forms(K, 0.3).items():
        args = (op, blocks, b, xs, rhs, xms, n, K, sweeps, coef, kw)
        got, counts = _run(shim, _group, *args)
        assert counts == {f"jacobi_block_group{tag}": 1}, name
        per, counts = _run(shim, _per_block, *args)
        assert counts == {f"jacobi_block_sweeps{tag}": len(rhs)}, name
        assert _same(got, per), name
        assert _same(got, _group(*args, plain=True)), name


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("tile", [32, 64])
def test_both_tiles_and_copied_strips(shim, monkeypatch, tile, dtype):
    """On 32- and 64-row tiles (``launch_sweeps``' ``tile_rows``; a ghost
    line inside a tile's band either way), each form loaded as the path
    loads it, and with every neighbour read from a copy of its strips (as
    one on another device is), the grouped chunk stays the plain twin's."""
    blocks, xs, rhs, xms, K = _setup((2, 4), 64, dtype, seed=1)
    forms = _forms(K, 0.3)
    regions = cs._regions
    for copy in (False, True):
        monkeypatch.setattr(cs, "_regions",
                            lambda *a, copy_=copy: regions(*a, copy=copy_))
        for name, (op, b, sweeps, coef, kw) in forms.items():
            args = (op, blocks, b, xs, rhs, xms, 62, K, sweeps, coef, kw)
            with cuda_ops.launch_sweeps(K, tile_rows=tile):
                got, _ = _run(shim, _group, *args)
            assert _same(got, _group(*args, plain=True)), (name, copy)


def _disc(blocks, parts):
    """``parts`` zeroed outside a disc of a quarter of the grid's side (a
    negative cell becomes -0.0), as a step's fields are around its
    impulse."""
    side = blocks.side
    ax = torch.arange(side, dtype=torch.float32) - side / 2
    disc = ((ax[:, None] ** 2 + ax[None, :] ** 2) <= (side / 4) ** 2)
    return [p * m.to(p.dtype) for p, m in zip(parts, blocks.cut(disc))]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape,side", [((2, 4), 64), ((3, 3), 66)],
                         ids=["2x4", "3x3"])
def test_zero_numerators_skip_the_division(shim, shape, side, dtype):
    """On fields that are zero (and -0.0) outside a disc, where most
    numerators are zero and the grouped kernel skips their division, every
    form stays bit for bit the per-block K9-block (which divides) and the
    plain twin."""
    blocks, xs, rhs, xms, K = _setup(shape, side, dtype, seed=4)
    xs, rhs, xms = (_disc(blocks, f) for f in (xs, rhs, xms))
    assert any(bool((torch.signbit(x) & (x == 0)).any()) for x in rhs)
    for name, (op, b, sweeps, coef, kw) in _forms(K, 0.3).items():
        args = (op, blocks, b, xs, rhs, xms, side - 2, K, sweeps, coef, kw)
        got, _ = _run(shim, _group, *args)
        per, _ = _run(shim, _per_block, *args)
        assert _same(got, per), name
        assert _same(got, _group(*args, plain=True)), name


def test_the_path_library_refuses_the_variants_and_bad_launches(shim):
    """The library takes tiles of 32 and 64 rows of 128 columns: the
    128- and 16-row tiles that were timed and not kept are refused through
    ``_launch``, and so are more blocks than the table (65), a halo deeper
    than a block and a damped form with other flags, with nothing
    counted."""
    blocks, xs, rhs, xms, K = _setup((2, 2), 64, torch.float32)
    for rows in (128, 16):
        with cuda_ops.launch_sweeps(K, tile_rows=rows):
            with pytest.raises(RuntimeError, match="failed to launch"):
                _run(shim, cs.fused_jacobi_blocks, blocks, 1, xs, rhs, n=62,
                     K=K, alpha=0.3, beta=2.2, sweeps=K)
    mod, lib = shim
    with mod.kernels_on_cpu(lib) as so:
        cuda_ops.reset_launch_counts()
        for blocks_, halo, flags in ((65, 4, 0), (4, 33, 0),
                                     (4, 4, cuda_ops._DAMP | cuda_ops._FAST)):
            table = (cs.ctypes.c_void_p * (29 * 65))(
                *([rhs[0].data_ptr()] * (29 * 65)))
            ints = (cs.ctypes.c_int * (3 * 65))()
            omegas = (cs.ctypes.c_float * 8)()
            err = so.fsc_jacobi_block_group(
                cs.ctypes.addressof(table), cs.ctypes.addressof(ints),
                blocks_, 32, 32, halo, 62, 0, 1.0, 4.0, 0.25, 0.25, 0.0, 0.0,
                cs.ctypes.addressof(omegas), flags, 0, 2, 32, None)
            assert err != 0
        assert not any(cuda_ops.launch_counts().values())


def test_a_wrong_neighbour_fails(shim, tmp_path):
    """A copy of the sources whose grouped kernel reads the lines after a
    block (below it, right of it) from the neighbour before it (region 2
    taken as region 0) builds and runs, and the checks catch it."""
    mod, _ = shim
    csrc = tmp_path / "csrc"
    shutil.copytree(ROOT / "fluidsimulationcuda_torch" / "csrc", csrc)
    src = (csrc / "jacobi_tiles.cu").read_text()
    broken, count = re.subn(r"Line\{2, w - len\}", "Line{0, w - len}", src)
    assert count == 1
    (csrc / "jacobi_tiles.cu").write_text(broken)
    saved = mod.CSRC
    mod.CSRC = csrc
    try:
        lib = mod.build_shim_library(("jacobi_tiles.cu",), tmp_path / "out")
    finally:
        mod.CSRC = saved
    blocks, xs, rhs, xms, K = _setup((4, 2), 64, torch.float32)
    op, b, sweeps, coef, kw = _forms(K, 0.3)["jacobi"]
    args = (op, blocks, b, xs, rhs, xms, 62, K, sweeps, coef, kw)
    got, _ = _run((mod, lib), _group, *args)
    want = _group(*args, plain=True)
    assert max(float((g - w).abs().max()) for g, w in zip(got, want)) > 1e-3


MODES = {
    "parity": dict(),
    "chebyshev": dict(pressure_solver="chebyshev",
                      diffusion_solver="chebyshev", cheby_rho=0.9,
                      cheby_iters=10),
    "multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
}
STEPS = [("parity", (2, 2), torch.float32), ("chebyshev", (2, 4),
                                              torch.float32),
         ("multigrid", (4, 2), torch.float32), ("parity", (2, 4),
                                                torch.bfloat16),
         ("multigrid", (2, 2), torch.bfloat16)]


@pytest.mark.parametrize("mode,shape,dtype", STEPS,
                         ids=[f"{m}-{s[0]}x{s[1]}-{str(d)[6:]}"
                              for m, s, d in STEPS])
def test_block_step_through_the_grouped_kernel(shim, mode, shape, dtype):
    """The exact block step on the ``cuda`` backend (every solve on the
    grouped K9-block through the shim) equals the same step on the
    per-block K9-block bit for bit and, in float32, the single-device
    ``reference`` step; its launches are
    ``chip_smoke.expected_launches_blocks``' (one grouped launch a chunk,
    no per-block one)."""
    import chip_smoke

    ref = ft.SimConfig(n=30, jacobi_iters=8, max_courant=2,
                       backend="reference", device="cpu", **MODES[mode])
    cfg = ref.replace(dtype=dtype)
    object.__setattr__(cfg, "backend", "cuda")  # only the shim allows it
    state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
    state = ft.FluidState(*(x.to(dtype) for x in state[:3]))
    src = ft.Sources(*(x.to(dtype) for x in src[:3]))
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step = make_sharded_step_fn(cfg, mesh, advect_mode="exact",
                                shard_backend="reference")
    per_block = sharded._BlockStep(cfg, mesh, False, True)
    per_block.ops = per_block.ops._replace(jacobi_group=None,
                                           smooth_group=None)
    parts = shard_blocks(state, mesh), shard_blocks(src, mesh)
    got, counts = _run(shim, step, *parts)
    want, per_counts = _run(shim, per_block, *parts)
    for g, w in zip(unshard(got, mesh), unshard(want, mesh)):
        if g is not None:
            assert g.dtype == dtype and torch.equal(g, w)
    tag = "_bf16" if dtype == torch.bfloat16 else ""
    expected = chip_smoke.expected_launches_blocks(cfg, *shape, True)
    assert counts == {k: c for k, c in expected.items() if c}
    assert f"jacobi_block_sweeps{tag}" not in counts
    assert per_counts[f"jacobi_block_sweeps{tag}"] == (
        shape[0] * shape[1] * expected[f"jacobi_block_group{tag}"])
    if dtype == torch.float32 and mode != "multigrid":
        single = ft.StableFluids2D(ref).step(state, src)
        for g, w in zip(unshard(got, mesh), single[:3]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("solve", ["jacobi", "chebyshev", "smooth"])
def test_a_cuda_block_solve_runs_no_cat(shim, monkeypatch, solve):
    """A block solve on the ``cuda`` backend builds no extended block: no
    ``torch.cat`` runs for x, the rhs or x_{k-1} (the per-block route runs
    three a block a chunk), one grouped launch a chunk, and the result is
    the plain twins' composition bit for bit."""
    blocks, xs, rhs, _, _ = _setup((2, 4), 64, torch.float32, seed=3)
    cfg = ft.SimConfig(n=62, backend="reference", device="cpu")
    object.__setattr__(cfg, "backend", "cuda")
    ops = dispatch.get_block_ops(cfg)
    plain = dispatch.get_block_ops(cfg, plain=True)

    def run(o):
        if solve == "jacobi":
            return sharded._diffuse_blocks(o, blocks, 62, 1, xs, rhs, 0.3,
                                           2.2, 20)
        if solve == "chebyshev":
            return sharded._cheby_blocks(o, blocks, 62, 0, None, rhs, 1.0,
                                         4.0, 20, 0.9, zero_init=True)
        parts = solvers._block_parts(rhs, 62, blocks, o.smooth,
                                     o.smooth_group)
        return parts.smooth(xs, rhs, 10, False)

    want = run(plain)
    cats = []
    cat = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda *a, **k: cats.append(1) or cat(*a, **k))
    got, counts = _run(shim, run, ops)
    assert cats == []
    assert counts == {"jacobi_block_group": 3 if solve != "smooth" else 2}
    assert _same(got, want)
