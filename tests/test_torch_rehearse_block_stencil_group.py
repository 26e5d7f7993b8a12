"""The grouped K11-block and K12-block (``csrc/block_group.cuh``:
``gradient_block_group_kernel`` and ``advect_block_group_kernel``, the
block route's gradient and gathers over every block of a device in one
launch, each block's neighbours read from their own arrays) behind the
host shim of ``dev/rehearse_kernels_cpu.py`` (a CUDA kernel has no
interpret mode, so this file compiles the sources with ``g++
-ffp-contract=off``).

Every form (the gradient; the u/v pair and the density, windowed at cmax
1, 2 and 4 with departures inside and past the window, and exact with
departures that cross blocks), in float32 and bf16 and at every width the
library keeps, on every block of (2, 2), (2, 4), (4, 2), (8, 1) and (1, 8)
meshes of 64² and a (3, 3) mesh of 66² (22-cell blocks, which 4 does not
divide; every wall, ghost rows and columns), is held bit for bit against
the per-block kernels on ``Blocks.halos``', ``ext``'s and ``gather``'s
buffers and against the plain twins; so too with every neighbour read
from a copy (the route of a neighbour on another device) and on zero
fields.  The library refuses other widths, misaligned vectors, a window
deeper than a block and tables over 64 blocks.  The ``cuda`` block step
through the grouped kernels equals the step on the per-block kernels and,
with exact gathers, the single-device step, bit for bit, with the
launches of ``chip_smoke.expected_launches_blocks``, and a ``cuda``
gradient or gather on one device runs no ``torch.cat`` and no
``.contiguous()`` copy.  Skips only without ``g++``.
"""
import ctypes
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks, cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.ops.advect import departure  # noqa: E402
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    Blocks, make_mesh, make_sharded_step_fn, shard_blocks, unshard)
from fluidsimulationcuda_torch.parallel import sharded  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi_tiles.cu", "advect_slab.cu", "project_slab.cu")
CPU = torch.device("cpu")
MESHES = [((2, 2), 64), ((2, 4), 64), ((4, 2), 64), ((8, 1), 64),
          ((1, 8), 64), ((3, 3), 66)]
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}
# BLOCK_STENCIL_FORMS and a 2-cell window.
FORMS = dict(checks.BLOCK_STENCIL_FORMS,
             **{"pair cmax 2": ("pair", (1, 2), 2, 1.0),
                "density cmax 2 over the window": ("density", (0,), 2,
                                                   3.0)})


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
    return mod, mod.build_shim_library(SOURCES,
                                       mod.OUT / "block_stencil_group")


def _run(shim, fn, *args, **kw):
    """fn through the shim library: (result, launch counts)."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib):
        cuda_ops.reset_launch_counts()
        out = fn(*args, **kw)
        return out, {k: c for k, c in cuda_ops.launch_counts().items() if c}


def _same(a, b) -> bool:
    a, b = tuple(a), tuple(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _setup(shape, side, dtype, seed=0):
    """The blocks and the (u, v, p) block lists of random fields, u and v
    moving the backtrace up to 2 cells (``checks``' scale)."""
    blocks = Blocks(*shape, side)
    g = torch.Generator().manual_seed(seed)
    n = side - 2
    scale = 2.0 / (checks.DT * n)
    u, v = (scale * (2 * torch.rand(side, side, generator=g) - 1)
            for _ in range(2))
    p = torch.randn(side, side, generator=g)
    return blocks, [list(blocks.cut(f.to(dtype))) for f in (u, v, p)]


def _name(form, dtype) -> str:
    return checks._stencil_name(form, "_bf16" if dtype == torch.bfloat16
                                else "")


def _widths(name) -> tuple:
    return cuda_ops.VECTOR_WIDTHS[name] + (1,)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape,side", MESHES,
                         ids=[f"{a}x{b}" for (a, b), _ in MESHES])
def test_grouped_equals_per_block_and_plain(shim, shape, side, dtype):
    """Every form on every block of the mesh, at every width the library
    keeps that divides the blocks' side: one grouped launch, bit for bit
    the per-block kernels on ``Blocks.halos``', ``ext``'s or ``gather``'s
    buffers (one launch a block) and the plain twin, in the storage
    dtype."""
    blocks, (us, vs, ps) = _setup(shape, side, dtype)
    n = side - 2
    for mode, form in FORMS.items():
        cmax = form[2]
        if cmax is not None and cmax + 1 > min(blocks.m, blocks.k):
            continue
        args = (form, blocks, us, vs, ps, n)
        name = _name(form, dtype)
        want = checks.block_stencil("plain", *args)
        per, counts = _run(shim, checks.block_stencil, "per-block", *args)
        assert _same(per, want), mode
        assert sum(counts.values()) == len(us), (mode, counts)
        for width in _widths(name):
            if blocks.k % width:
                continue
            cuda_ops.reset_width_counts()
            with cuda_ops.vector_widths((width,)):
                got, counts = _run(shim, checks.block_stencil, "group",
                                   *args)
            assert counts == {name: 1}, (mode, counts)
            assert cuda_ops.width_counts()[name][width] == 1, (mode, width)
            assert _same(got, want), (mode, width)


def _blocks_of(blocks, i, j):
    return (i // blocks.m) * blocks.py + j // blocks.k


def test_departures_cross_blocks():
    """The inputs above reach across blocks: on the (2, 4) mesh some
    departures take their four corners from two blocks and some from
    four, within the window and exactly."""
    blocks, (us, vs, _) = _setup((2, 4), 64, torch.float32)
    u, v = blocks.stitch(us), blocks.stitch(vs)
    ax = torch.arange(64, dtype=torch.float32)
    for cmax, scale in ((4, 1.0), (None, 12.0)):
        x, y = departure(scale * u, scale * v, ax[None, :], ax[:, None],
                         checks.DT, 62, cmax)
        i0, j0 = y.long()[1:-1, 1:-1], x.long()[1:-1, 1:-1]
        owners = torch.stack([_blocks_of(blocks, i0 + di, j0 + dj)
                              for di in (0, 1) for dj in (0, 1)])
        count = torch.tensor([len(set(c.tolist()))
                              for c in owners.reshape(4, -1).T])
        assert (count == 2).any() and (count == 4).any(), cmax


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_copied_neighbours(shim, monkeypatch, dtype):
    """With every neighbour read from a copy (its row or column for the
    gradient; for the gathers the cells the launch can read: the window's
    strips and corners, or the whole block for the exact form), as one on
    another device is, every form stays the plain twin's."""
    blocks, (us, vs, ps) = _setup((3, 3), 66, dtype, seed=1)
    grad, parts = cs._grad_sources, cs._gather_parts
    monkeypatch.setattr(cs, "_grad_sources",
                        lambda *a, **k: grad(*a, copy=True))
    monkeypatch.setattr(cs, "_gather_parts",
                        lambda *a, **k: parts(*a, copy=True))
    for mode, form in FORMS.items():
        args = (form, blocks, us, vs, ps, 64)
        got, counts = _run(shim, checks.block_stencil, "group", *args)
        assert counts == {_name(form, dtype): 1}, mode
        assert _same(got, checks.block_stencil("plain", *args)), mode


def test_window_copies_hold_only_the_reachable_cells():
    """The windowed gather's copy of a block on another device is the
    bounding box of its ``cmax+1``-deep strips facing the launch's blocks:
    a block beside one of them gives its facing strip, a corner block its
    corner, a block next to none nothing; the exact gather copies whole
    blocks."""
    blocks = Blocks(3, 3, 66)
    fields = ([torch.zeros(22, 22) for _ in range(9)],)
    _, ints, keep = cs._gather_parts(blocks, fields, {4}, CPU, 5, copy=True)
    boxes = [tuple(ints[3 * j:3 * j + 3]) for j in range(9)]
    assert boxes[4] == (22, 22, 22)  # the launch's own block, whole
    assert boxes[1] == (22 - 5, 22, 22)  # above: its last 5 rows
    assert boxes[3] == (22, 22 - 5, 5)  # left: its last 5 columns
    assert boxes[8] == (44, 44, 5)  # below right: its first 5 x 5
    assert sorted(t.shape for t in keep) == sorted(
        [(22, 22), (5, 22), (5, 22), (22, 5), (22, 5)] + [(5, 5)] * 4)
    _, ints, _ = cs._gather_parts(blocks, fields, {0}, CPU, 5)
    assert ints[3 * 8:3 * 9] == [0, 0, 0]  # not next to block 0: none
    _, _, keep = cs._gather_parts(blocks, fields, {0}, CPU, None)
    assert [t.shape for t in keep] == [(22, 22)] * 8


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_zero_fields(shim, dtype):
    """On zero fields (and p zero, -0.0 included, outside a disc, where the
    gradient's numerators are zero) every form stays bit for bit the
    per-block kernels and the plain twin."""
    blocks, (us, vs, ps) = _setup((2, 4), 64, dtype, seed=2)
    zeros = [torch.zeros_like(u) for u in us]
    ax = torch.arange(64, dtype=torch.float32) - 32
    disc = blocks.cut((ax[:, None] ** 2 + ax[None, :] ** 2) <= 16 ** 2)
    ps = [-p * d.to(p.dtype) for p, d in zip(ps, disc)]
    for operands in ((zeros, zeros, zeros), (us, vs, ps), (zeros, zeros,
                                                           ps)):
        for mode, form in FORMS.items():
            args = (form, blocks, *operands, 62)
            got, _ = _run(shim, checks.block_stencil, "group", *args)
            per, _ = _run(shim, checks.block_stencil, "per-block", *args)
            assert _same(got, per), mode
            assert _same(got, checks.block_stencil("plain", *args)), mode


def test_the_library_refuses_bad_launches(shim):
    """The library takes the widths it keeps (the gradient 1 and 2, in
    bf16 also 4 and 8; the gathers 1, 2 and 4, the float32 exact one 1 and
    2) where they divide the blocks' side, aligned vectors, a window no
    deeper than a block less a cell and tables of at most 64 blocks (256
    parts): a width outside them raises through ``_launch`` with nothing
    counted, and so do the raw calls below."""
    blocks, (us, vs, ps) = _setup((2, 4), 64, torch.float32)
    for width in (8, 16):
        with cuda_ops.vector_widths((width,)):
            for form in (FORMS["gradient"], FORMS["pair"]):
                with pytest.raises(RuntimeError, match="failed to launch"):
                    _run(shim, checks.block_stencil, "group", form, blocks,
                         us, vs, ps, 62)
    mod, lib = shim
    with mod.kernels_on_cpu(lib) as so:
        cuda_ops.reset_launch_counts()
        u = us[0]
        ptrs = (ctypes.c_void_p * (9 * 65))(*([u.data_ptr()] * (9 * 65)))
        ints = (ctypes.c_int * (4 * 65))(*([32, 16, 1, 1] * 65))
        ok_ints = (ctypes.c_int * 4)(32, 16, 1, 1)
        h = cs.co._f32(1 / 62)
        assert so.fsc_gradient_block_group(ctypes.addressof(ptrs),
                                           ctypes.addressof(ok_ints), 1, 32,
                                           16, 62, h, 1, None) == 0
        for blocks_, width, hh in ((65, 1, h), (0, 1, h), (1, 3, h),
                                   (1, 4, h), (1, 8, h), (1, 1, 0.0)):
            err = so.fsc_gradient_block_group(
                ctypes.addressof(ptrs), ctypes.addressof(ints), blocks_, 32,
                16, 62, hh, width, None)
            assert err != 0, (blocks_, width, hh)
        # A misaligned vector: u one float past an aligned address.
        bad = (ctypes.c_void_p * 9)(u.data_ptr() + 4, *([u.data_ptr()] * 8))
        assert so.fsc_gradient_block_group(ctypes.addressof(bad),
                                           ctypes.addressof(ok_ints), 1, 32,
                                           16, 62, h, 2, None) != 0
        parts = (ctypes.c_void_p * (2 * 257))(*([u.data_ptr()] * (2 * 257)))
        part_ints = (ctypes.c_int * (3 * 257))(
            *[x for j in range(8) for x in (*blocks.origins[j], 16)],
            *([0] * (3 * 249)))
        blks = (ctypes.c_void_p * (4 * 65))(*([u.data_ptr()] * (4 * 65)))
        blk_ints = (ctypes.c_int * (2 * 65))(*([0, 0] * 65))

        def gather(nparts, nblocks, cmax, width, fn="fsc_advect_block_group"):
            return getattr(so, fn)(
                ctypes.addressof(parts), ctypes.addressof(part_ints),
                nparts, ctypes.addressof(blks), ctypes.addressof(blk_ints),
                nblocks, 32, 16, 62, 4, 2, 1, 2, 0.992, cmax, width, None)

        assert gather(8, 1, 4, 4) == 0
        for args in ((8, 65, 4, 1), (257, 1, 4, 1), (8, 1, 16, 1),
                     (8, 1, -1, 1), (8, 1, 4, 8), (8, 1, 4, 3), (4, 1, 4, 1)):
            assert gather(*args) != 0, args
        exact = "fsc_advect_block_group_exact"
        assert gather(8, 1, 99, 2, exact) == 0
        assert gather(8, 1, 99, 4, exact) != 0
        assert gather(8, 1, 99, 4, exact + "_bf16") == 0
        assert not any(cuda_ops.launch_counts().values())


MODES = {
    "parity": dict(),
    "chebyshev": dict(pressure_solver="chebyshev",
                      diffusion_solver="chebyshev", cheby_rho=0.9,
                      cheby_iters=10),
    "multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
}
STEPS = [("parity", (2, 4), torch.float32, "exact"),
         ("chebyshev", (3, 3), torch.float32, "windowed"),
         ("multigrid", (4, 2), torch.float32, "exact"),
         ("parity", (2, 2), torch.bfloat16, "windowed"),
         ("chebyshev", (2, 4), torch.bfloat16, "exact")]


@pytest.mark.parametrize("mode,shape,dtype,gather", STEPS,
                         ids=[f"{m}-{s[0]}x{s[1]}-{str(d)[6:]}-{g}"
                              for m, s, d, g in STEPS])
def test_block_step_through_the_grouped_stencils(shim, mode, shape, dtype,
                                                 gather):
    """The block step on the ``cuda`` backend (its gradients and gathers
    on the grouped K11-block and K12-block through the shim) equals the
    same step on the per-block kernels bit for bit and, exact in float32
    outside the multigrid, the single-device ``reference`` step; its
    launches are ``chip_smoke.expected_launches_blocks``' (one grouped
    gradient a projection, one grouped gather a gather, no per-block
    one)."""
    import chip_smoke

    side = 33 if shape == (3, 3) else 32
    ref = ft.SimConfig(n=side - 2, jacobi_iters=8, max_courant=2,
                       backend="reference", device="cpu", **MODES[mode])
    cfg = ref.replace(dtype=dtype)
    object.__setattr__(cfg, "backend", "cuda")  # only the shim allows it
    state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
    state = ft.FluidState(*(x.to(dtype) for x in state[:3]))
    src = ft.Sources(*(x.to(dtype) for x in src[:3]))
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step = make_sharded_step_fn(cfg, mesh, advect_mode=gather,
                                shard_backend="reference")
    per_block = sharded._BlockStep(cfg, mesh, False, gather == "exact")
    per_block.ops = per_block.ops._replace(gradient_group=None,
                                           advect_group=None)
    parts = shard_blocks(state, mesh), shard_blocks(src, mesh)
    got, counts = _run(shim, step, *parts)
    want, per_counts = _run(shim, per_block, *parts)
    for g, w in zip(unshard(got, mesh), unshard(want, mesh)):
        if g is not None:
            assert g.dtype == dtype and torch.equal(g, w)
    tag = "_bf16" if dtype == torch.bfloat16 else ""
    expected = chip_smoke.expected_launches_blocks(cfg, *shape,
                                                   gather == "exact")
    assert counts == {k: c for k, c in expected.items() if c}
    adv = "advect_block" + ("_exact" if gather == "exact" else "") + tag
    assert per_counts[f"gradient_block{tag}"] == 2 * len(parts[0].u)
    assert per_counts[adv] == 2 * len(parts[0].u)
    if dtype == torch.float32 and mode != "multigrid" and gather == "exact":
        single = ft.StableFluids2D(ref).step(state, src)
        for g, w in zip(unshard(got, mesh), single[:3]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("what", ["gradient", "pair", "exact pair",
                                  "density", "exact density"])
def test_a_cuda_stencil_copies_nothing(shim, monkeypatch, what):
    """A gradient or gather on the ``cuda`` backend with every block on one
    device builds no halo, extended block or assembled field: no
    ``torch.cat`` and no ``.contiguous()`` copy runs (the per-block route
    runs them for ``Blocks.halos``, ``ext`` and ``gather``)."""
    blocks, (us, vs, ps) = _setup((2, 4), 64, torch.float32, seed=3)
    args = (FORMS[what], blocks, us, vs, ps, 62)
    calls = []
    cat, contiguous = torch.cat, torch.Tensor.contiguous

    def counted_cat(*a, **k):
        calls.append("cat")
        return cat(*a, **k)

    def counted_contiguous(self, *a, **k):
        calls.append("contiguous")
        return contiguous(self, *a, **k)

    monkeypatch.setattr(torch, "cat", counted_cat)
    monkeypatch.setattr(torch.Tensor, "contiguous", counted_contiguous)
    _run(shim, checks.block_stencil, "per-block", *args)
    assert calls
    calls.clear()
    got, counts = _run(shim, checks.block_stencil, "group", *args)
    assert calls == [] and sum(counts.values()) == 1
    monkeypatch.undo()
    assert _same(got, checks.block_stencil("plain", *args))
