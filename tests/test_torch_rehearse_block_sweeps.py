"""The block route's kernels (``csrc/jacobi_tiles.cu``'s K9-block,
``csrc/advect_slab.cu``'s K12-block, ``csrc/project_slab.cu``'s K10-block
and K11-block) behind the host shim of ``dev/rehearse_kernels_cpu.py`` (a
CUDA kernel has no interpret mode, so this file compiles the sources with
``g++ -ffp-contract=off``; K9-block's tiles run a block's threads together
as fibers).

Each form is held bit for bit against its plain twin
(``kernels/checks.py``, ``kernel_checks_block``) on every block of a 3 x 3
mesh of 22² blocks of a 66² grid, so every combination of walls a block
can hold (none, one edge, a corner) and blocks with r0 > 0 and c0 > 0;
on blocks of (1, 3) and (3, 1) meshes, which hold two opposite walls; and
on the one block of a (1, 1) mesh, which holds them all.  K9-block runs
Jacobi chunks as deep as their halo and shorter, the zero guess, the
reciprocal form (rounded as ``fmaf`` in both), Chebyshev chunks (the
first, whose sweep 0 is plain, and chained ones with x_{k-1} carried in,
returned beside x_k), and the damped smooths.  A Chebyshev solve chunked
through the kernel equals the plain twin's whole solve on the whole grid,
and the block step on the ``cuda`` backend (the kernels through the shim)
equals the ``reference`` backend's on (2, 2) and (2, 4) meshes, bit for
bit, with the launches counted.  A copy of the sources whose K9-block
ignores the block's column origin fails the checks.  The bf16 forms
(``*_bf16``: bf16 operands, float32 arithmetic, a rounding at each store)
are held the same way against their plain twins, which round where the
kernels store, on every block of the four meshes; a bf16 Chebyshev solve
chunked through K9-block's bf16 form equals the same chunks on the twins;
and the bf16 block step through the kernels equals the step on the plain
twins (``_BlockStep(..., plain=True)``) bit for bit, launching only bf16
forms.  Skips only without ``g++``.
"""
import importlib.util
import re
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks, cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.ops.chebyshev import (  # noqa: E402
    cheby_diffuse, cheby_omegas)
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    Blocks, make_mesh, make_sharded_step_fn, shard_blocks, shard_state,
    unshard)

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("jacobi_tiles.cu", "advect_slab.cu", "project_slab.cu")
CPU = torch.device("cpu")
SIDE = 66


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "block_sweeps")
    return mod, lib


def _run(shim, fn, *args, **kw):
    """fn through the shim library: (result, launch counts)."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib):
        cuda_ops.reset_launch_counts()
        out = fn(*args, **kw)
        return out, {k: c for k, c in cuda_ops.launch_counts().items() if c}


def _mesh_origins(px: int, py: int) -> dict[str, tuple[int, int]]:
    return {f"block {i} of ({px}, {py})": o
            for i, o in enumerate(Blocks(px, py, SIDE).origins)}


MESHES = [(3, 3), (1, 3), (3, 1), (1, 1)]


@pytest.mark.parametrize("px,py", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_block_forms_match_plain(shim, px, py):
    m, k = SIDE // px, SIDE // py
    cases = checks.kernel_checks_block(SIDE, m, k, "cpu", 0,
                                       _mesh_origins(px, py))
    assert len(cases) == px * py * 23
    for c in cases:
        got, counts = _run(shim, c.run)
        assert counts == {c.kernels[0]: 1}, c.label
        want = c.plain()
        assert checks.max_abs_diff(got, want) == 0.0, c.label


@pytest.mark.parametrize("px,py", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_block_bf16_forms_match_plain(shim, px, py):
    """Every bf16 form of the four block kernels, in every mode the step
    gives it, against its plain twin bit for bit (fast forms too: the
    twin rounds as ``fmaf`` does), each launching its bf16 form once."""
    m, k = SIDE // px, SIDE // py
    cases = checks.kernel_checks_block(SIDE, m, k, "cpu", 0,
                                       _mesh_origins(px, py), bf16=True)
    assert len(cases) == px * py * 23
    for c in cases:
        assert c.kernels[0].endswith("_bf16"), c.label
        got, counts = _run(shim, c.run)
        assert counts == {c.kernels[0]: 1}, c.label
        want = c.plain()
        for g in (got if isinstance(got, tuple) else (got,)):
            assert g.dtype == torch.bfloat16, c.label
        assert checks.max_abs_diff(got, want) == 0.0, c.label


@pytest.mark.parametrize("zero_init", [False, True])
def test_chunked_chebyshev_bf16_through_the_kernels(shim, zero_init):
    """A 10-sweep bf16 Chebyshev solve on the 3 x 3 blocks of 66² in
    chunks of 8 and 2 sweeps (``parallel.sharded._cheby_blocks``: x and
    x_{k-1} rounded to bf16 at each chunk's end and exchanged in bf16)
    through K9-block's bf16 form equals the same chunks on the plain twin
    bit for bit, with one launch a block a chunk."""
    from fluidsimulationcuda_torch.parallel import sharded

    t = checks._Inputs(SIDE, "cpu", 5)
    blocks = Blocks(3, 3, SIDE)
    x, rhs = (blocks.cut(f.to(torch.bfloat16)) for f in (t.src, t.x0))
    ops = {name: type("Ops", (), dict(jacobi=staticmethod(fn)))
           for name, fn in (("cuda", cs.fused_jacobi_block),
                            ("plain", cs.fused_jacobi_block_plain))}

    def solve(o):
        return sharded._cheby_blocks(o, blocks, t.n, 1, x, rhs, t.a_visc,
                                     1 + 4 * t.a_visc, 10, 0.9,
                                     zero_init=zero_init)

    got, counts = _run(shim, solve, ops["cuda"])
    assert counts == {"jacobi_block_sweeps_bf16": 9 * 2}
    want = solve(ops["plain"])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


@pytest.mark.parametrize("zero_init", [False, True])
def test_chunked_chebyshev_is_the_whole_solve(shim, zero_init):
    """A 10-sweep Chebyshev solve in chunks of 4, 4 and 2 sweeps on the one
    block of a (1, 1) mesh, x and x_{k-1} carried from chunk to chunk and
    the weights resumed where the last chunk stopped, equals
    ``ops.chebyshev.cheby_diffuse`` on the whole grid bit for bit."""
    t = checks._Inputs(SIDE, "cpu", 3)
    blocks, n, iters, rho = Blocks(1, 1, SIDE), t.n, 10, 0.9
    omegas = cheby_omegas(rho, iters)
    x, xm, done = [t.src], None, 0
    rhs = [t.x0]
    for s in (4, 4, 2):
        zi = zero_init and done == 0
        (pair,), counts = _run(shim, lambda: [cs.fused_jacobi_block(
            1, None if zi else blocks.ext(x, 4)[0], blocks.ext(rhs, 4)[0],
            (0, 0), n=n, m=SIDE, k=SIDE, K=4, alpha=t.a_visc,
            beta=1 + 4 * t.a_visc, sweeps=s, zero_init=zi, omegas=omegas,
            first=done, xm_ext=None if done == 0 else blocks.ext(xm, 4)[0])])
        assert counts == {"jacobi_block_sweeps": 1}
        x, xm, done = [pair[0]], [pair[1]], done + s
    guess = torch.zeros_like(t.src) if zero_init else t.src
    want = cheby_diffuse(1, guess, t.x0, t.a_visc, 1 + 4 * t.a_visc, iters,
                         rho)
    assert torch.equal(x[0], want)


MODES = {
    "parity": dict(),
    "chebyshev": dict(pressure_solver="chebyshev",
                      diffusion_solver="chebyshev", cheby_rho=0.9,
                      cheby_iters=10),
    "multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
    "cg": dict(pressure_solver="cg", cg_iters=8),
}
STEPS = [("parity", (2, 2), "exact"), ("parity", (2, 4), "windowed"),
         ("chebyshev", (2, 4), "exact"), ("multigrid", (2, 2), "windowed"),
         ("cg", (2, 4), "exact")]


@pytest.mark.parametrize("mode,shape,gather", STEPS,
                         ids=[f"{m}-{s[0]}x{s[1]}-{g}" for m, s, g in STEPS])
def test_block_step_through_the_kernels(shim, mode, shape, gather):
    """The block step on the ``cuda`` backend (the kernels through the
    shim; the multigrid's coarse grid on K1-damp) equals the
    ``reference`` backend's step bit for bit; its launches are
    ``chip_smoke.expected_launches_blocks``'s."""
    import chip_smoke

    ref = ft.SimConfig(n=30, jacobi_iters=8, max_courant=2,
                       backend="reference", device="cpu", **MODES[mode])
    cfg = ref.replace()
    object.__setattr__(cfg, "backend", "cuda")  # only the shim allows it
    state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step = make_sharded_step_fn(cfg, mesh, advect_mode=gather,
                                shard_backend="reference")
    want_step = make_sharded_step_fn(ref, mesh, advect_mode=gather,
                                     shard_backend="reference")
    state, src = shard_blocks(state, mesh), shard_blocks(src, mesh)
    got, counts = _run(shim, step, state, src)
    want = want_step(state, src)
    for g, w in zip(unshard(got, mesh), unshard(want, mesh)):
        if g is not None:
            assert torch.equal(g, w)
    expected = chip_smoke.expected_launches_blocks(cfg, *shape,
                                                   gather == "exact")
    assert counts == {k: c for k, c in expected.items() if c}


@pytest.mark.parametrize("mode,shape,gather", STEPS,
                         ids=[f"{m}-{s[0]}x{s[1]}-{g}" for m, s, g in STEPS])
def test_block_bf16_step_through_the_kernels(shim, mode, shape, gather):
    """The bf16 block step on the ``cuda`` backend (the bf16 forms through
    the shim; the multigrid's bf16 coarse grid on K1-damp's bf16-rhs
    forms) equals the step on the plain twins (``_BlockStep(...,
    plain=True)``) bit for bit and stays bf16; it launches
    ``chip_smoke.expected_launches_blocks``'s bf16 forms and no float32
    block form."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import sharded

    ref = ft.SimConfig(n=30, jacobi_iters=8, max_courant=2,
                       backend="reference", device="cpu", **MODES[mode])
    cfg = ref.replace(dtype=torch.bfloat16)
    object.__setattr__(cfg, "backend", "cuda")  # only the shim allows it
    state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
    state = ft.FluidState(*(x.to(torch.bfloat16) for x in state[:3]))
    src = ft.Sources(*(x.to(torch.bfloat16) for x in src[:3]))
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step = make_sharded_step_fn(cfg, mesh, advect_mode=gather,
                                shard_backend="reference")
    twins = sharded._BlockStep(cfg, mesh, False, gather == "exact",
                               plain=True)
    state, src = shard_blocks(state, mesh), shard_blocks(src, mesh)
    got, counts = _run(shim, step, state, src)
    want = twins(state, src)
    for g, w in zip(unshard(got, mesh), unshard(want, mesh)):
        if g is not None:
            assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    expected = chip_smoke.expected_launches_blocks(cfg, *shape,
                                                   gather == "exact")
    assert all(k.endswith("_bf16") for k in expected)
    assert counts == {k: c for k, c in expected.items() if c}


def test_a_broken_column_origin_fails(shim, tmp_path):
    """A copy of the sources whose K9-block takes every block's column
    origin as 0 (``gc0 + c`` read as ``c``) builds and runs, and the
    checks catch it on blocks with c0 > 0: the ghost columns and the
    interior mask move."""
    mod, _ = shim
    csrc = tmp_path / "csrc"
    shutil.copytree(ROOT / "fluidsimulationcuda_torch" / "csrc", csrc)
    src = (csrc / "jacobi_tiles.cu").read_text()
    broken, count = re.subn(r"const int R = gr0 \+ r, C = gc0 \+ c;",
                            "const int R = gr0 + r, C = c;", src)
    assert count == 1
    (csrc / "jacobi_tiles.cu").write_text(broken)
    saved = mod.CSRC
    mod.CSRC = csrc
    try:
        lib = mod.build_shim_library(("jacobi_tiles.cu",), tmp_path / "out")
    finally:
        mod.CSRC = saved
    cases = [c for c in checks.kernel_checks_block(
        SIDE, 22, 22, "cpu", 0, {"c0 > 0": (22, 22), "right wall": (22, 44)})
        if c.kernels == ("jacobi_block_sweeps",)]
    worst = 0.0
    for c in cases:
        got, _ = _run((mod, lib), c.run)
        worst = max(worst, checks.max_abs_diff(got, c.plain()))
    assert worst > 1e-3


def test_slab_deep_halo_chebyshev_through_the_kernels(shim):
    """The slab route's Chebyshev solves whose halo is deeper than a slab
    (10 and 12 sweeps on 8 slabs of 8 rows, fast math) run K9-block on
    the (8, 1) blocks beside the slab kernels: within 1e-4 of the
    ``reference`` backend (which ignores fast math), with the launches of
    ``chip_smoke.expected_launches_sharded``.  Their chunks take the
    grouped K9-block (``jacobi_block_group``, one launch a chunk over
    every slab) since it replaced a launch a block there, so the count
    held to be positive is the grouped form's."""
    import chip_smoke

    ref = ft.SimConfig(n=62, jacobi_iters=4, max_courant=2,
                       pressure_solver="chebyshev",
                       diffusion_solver="chebyshev", cheby_rho=0.9,
                       cheby_iters=10, cheby_press_iters=12, fast_math=True,
                       backend="reference", device="cpu")
    cfg = ref.replace()
    object.__setattr__(cfg, "backend", "cuda")  # only the shim allows it
    mesh = make_mesh([CPU] * 8)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
    state, src = shard_state(state, mesh), shard_state(src, mesh)
    step = make_sharded_step_fn(cfg, mesh)
    got, counts = _run(shim, step, state, src)
    want = make_sharded_step_fn(ref, mesh)(state, src)
    assert chip_smoke.max_diff(unshard(got), unshard(want)) < 1e-4
    expected = chip_smoke.expected_launches_sharded(cfg, 8)
    assert expected["jacobi_block_group"] > 0
    assert counts == {k: c for k, c in expected.items() if c}
