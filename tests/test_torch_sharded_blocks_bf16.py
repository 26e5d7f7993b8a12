"""bf16 storage on the block route (``make_sharded_step_fn`` with
``dtype=torch.bfloat16``) against the JAX package.

JAX runs bf16 only on its jnp block route, ``_step_local``.  Its bf16
gathers (``_advect_local``, ``_advect_local_windowed``) compute the
backtrace coordinates and the blend in bf16, which cannot resolve a
fraction of a cell past 256 cells (``test_jax_block_gather_loses_the_cell``
pins it); the port gathers in float32, as JAX's single-device
``ops.advect`` does.  So the oracle is JAX's ``_step_local`` recomposed
here under ``jax.shard_map`` on the virtual CPU mesh of
``tests/conftest.py``, with one change: its gather is JAX's single-device
``ops.advect.advect`` / ``advect_windowed`` on the all-gathered fields
(``_gather_global``), sliced to the block.  Every other piece is JAX's
own: ``_diffuse_local``, ``_cheby_diffuse_local``, ``_make_project_local``
(``_divergence_local``, ``_gradient_local``, ``_mg_local``,
``_cg_local``).  Nothing in the JAX package changes.

The ``reference`` backend rounds every operation to bf16 as XLA's CPU jit
does (per elementwise operation; reductions and ``psum`` in float32,
rounded once), so it is held to the oracle at n = 30 on (2, 2) and (2, 4)
meshes, Jacobi, Chebyshev compensated, multigrid (two cycles) and CG-10,
exact on both meshes and windowed on one, bit for bit (0 bf16 units of
each field's largest value after 2 steps).  Each operation is also held
to its JAX block counterpart on bf16 inputs.  The kernels' plain twins
(float32 arithmetic, a bf16 rounding where a kernel stores: a solve once
a chunk) composed into the same step are held to the oracle within
``TWIN_UNITS``.  ``-s`` prints every gap.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import fluidsimulationcuda_torch as ft  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    Blocks, make_mesh, make_sharded_step_fn, shard_blocks, unshard)
from fluidsimulationcuda_torch.parallel import sharded as ts  # noqa: E402
from fluidsimulationcuda_torch.parallel import solvers as tsol  # noqa: E402
from fluidsimulationcuda_tpu.parallel import mesh as jmesh  # noqa: E402
from fluidsimulationcuda_tpu.parallel import sharded as js  # noqa: E402

# The module, not the function ``fluidsimulationcuda_tpu.ops`` exports.
jadvect = importlib.import_module("fluidsimulationcuda_tpu.ops.advect")
CPU = torch.device("cpu")
BF16 = torch.bfloat16
STEPS = 2
N = 30
MODES = {
    "jacobi": dict(jacobi_iters=8),
    # 8 and 10 sweeps: chained chunks on both meshes (7 + 1 and 7 + 3 on
    # (2, 2), chunks of 3 on (2, 4)); JAX unrolls each Chebyshev sweep, so
    # its compile grows with them.
    "compensated": dict(jacobi_iters=8, pressure_solver="chebyshev",
                        diffusion_solver="chebyshev", cheby_rho=0.9,
                        cheby_iters=8, cheby_press_iters=10),
    "multigrid": dict(jacobi_iters=8, pressure_solver="multigrid",
                      mg_cycles=2),
    "cg": dict(jacobi_iters=8, pressure_solver="cg", cg_iters=10),
}
# Every mode exact on both meshes, and windowed on one of them (the two
# gathers share everything but the gather, whose forms the rehearsals and
# the card hold on every block).
RUNS = ([(mode, shape, "exact") for mode in MODES
         for shape in ((2, 2), (2, 4))]
        + [("jacobi", (2, 2), "windowed"), ("compensated", (2, 4), "windowed"),
           ("multigrid", (2, 2), "windowed"), ("cg", (2, 4), "windowed")])


def _sources(side: int):
    """reference_init's distributions, drawn with numpy."""
    rng = np.random.default_rng(side)
    dens = rng.uniform(0.0, 0.099, (side, side)).astype(np.float32)
    band = np.zeros(side, bool)
    band[side // 2 - side // 8: side // 2 + side // 8] = True
    dens[~(band[:, None] & band[None, :])] = 0.0
    u, v = (rng.uniform(0.0, 30.0, (side, side)).astype(np.float32)
            for _ in range(2))
    return dens, u, v


def _np(x) -> np.ndarray:
    """A bf16 array or tensor as float32 numpy (exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _unit(x: np.ndarray) -> float:
    """One bf16 rounding unit at ``x``'s largest magnitude."""
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 2.0 ** -133


# -- the JAX oracle -----------------------------------------------------------


def _oracle_local(cfg, px, py, advect_mode, state, src):
    """JAX's ``_step_local`` (``parallel/sharded.py:867``) with its
    gathers replaced by the single-device ``ops.advect`` on the assembled
    fields, sliced to the block."""
    n, dtim = cfg.n, cfg.dt
    it = cfg.jacobi_iters
    dt_c = jnp.asarray(dtim, state.u.dtype)

    def _advect(b, d0, uu, vv):
        full, uf, vf = (js._gather_global(x) for x in (d0, uu, vv))
        if advect_mode == "windowed":
            out = jadvect.advect_windowed(b, full, uf, vf, dtim, n,
                                          cfg.max_courant)
        else:
            out = jadvect.advect(b, full, uf, vf, dtim, n)
        m, k = d0.shape
        return jax.lax.dynamic_slice(
            out, (jax.lax.axis_index("x") * m, jax.lax.axis_index("y") * k),
            (m, k))

    def _diffusion(b, src_f, rhs, alpha, beta, dens=False):
        mode = cfg.diffusion_solver
        if mode == "chebyshev" or (dens and mode == "chebyshev-dens"):
            k = cfg.cheby_dens_iters if mode == "chebyshev-dens" \
                else cfg.cheby_iters
            return js._cheby_diffuse_local(b, src_f, rhs, alpha, beta, k,
                                           cfg.cheby_rho, n, px, py)
        return js._diffuse_local(b, src_f, rhs, alpha, beta, it, n, px, py)

    project = js._make_project_local(cfg, px, py)
    u = state.u + dt_c * src.u
    v = state.v + dt_c * src.v
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    u = _diffusion(1, src.u, u, alpha, beta)
    v = _diffusion(2, src.v, v, alpha, beta)
    u, v = project(u, v)
    u0, v0 = u, v
    u = _advect(1, u0, u0, v0)
    v = _advect(2, v0, u0, v0)
    u, v = project(u, v)
    dens = state.dens + dt_c * src.dens
    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 4.0 * alpha
    dens = _diffusion(0, src.dens, dens, alpha, beta, dens=True)
    dens = _advect(0, dens, u, v)
    return fj.FluidState(dens=dens, u=u, v=v)


def _jax_mesh(shape):
    return jmesh.make_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape)


def _sharded(fn, mesh, n_in, n_out=1):
    spec = P("x", "y")
    out = spec if n_out == 1 else (spec,) * n_out
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                                 out_specs=out))


@functools.lru_cache(maxsize=None)
def _oracle(mode: str, shape, gather: str):
    """The oracle's states after each of ``STEPS`` steps from the zero
    state (the numpy sources on step 1), float32 numpy."""
    cfg = fj.SimConfig(n=N, max_courant=2, dtype=jnp.bfloat16, **MODES[mode])
    mesh = _jax_mesh(shape)
    spec = P("x", "y")
    specs = fj.FluidState(dens=spec, u=spec, v=spec, w=None)
    src_specs = fj.Sources(dens=spec, u=spec, v=spec, w=None)
    local = functools.partial(_oracle_local, cfg, *shape, gather)
    step = jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=(specs, src_specs),
                                 out_specs=specs))
    src = fj.Sources(*(jnp.asarray(x, jnp.bfloat16)
                       for x in _sources(N + 2)))
    state, zero = fj.zero_state(cfg), fj.zero_sources(cfg)
    out = []
    for k in range(STEPS):
        state = step(state, src if k == 0 else zero)
        out.append([_np(x) for x in state[:3]])
    return out


# -- the port -----------------------------------------------------------------


def _port(mode: str, shape, gather: str, plain: bool = False):
    """The port's bf16 block step (the ``reference`` backend, or with
    ``plain`` the ``cuda`` kernels' plain twins) over the same steps."""
    backend = "cuda" if plain else "reference"
    cfg = ft.SimConfig(n=N, max_courant=2, dtype=BF16, backend="reference",
                       device="cpu", **MODES[mode])
    object.__setattr__(cfg, "backend", backend)  # twins on the CPU
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    if plain:
        step = ts._BlockStep(cfg, mesh, False, gather == "exact", plain=True)
    else:
        step = make_sharded_step_fn(cfg, mesh, advect_mode=gather,
                                    shard_backend="reference")
        assert step.layout == "blocks"
    src = ft.Sources(*(torch.from_numpy(x).to(BF16)
                       for x in _sources(N + 2)))
    zero = ft.zero_sources(cfg)
    assert zero.u.dtype == BF16
    state = shard_blocks(ft.zero_state(cfg), mesh)
    src, zero = shard_blocks(src, mesh), shard_blocks(zero, mesh)
    out = []
    for k in range(STEPS):
        state = step(state, src if k == 0 else zero)
        full = unshard(state, mesh)
        assert all(x.dtype == BF16 for x in full[:3])
        out.append([_np(x) for x in full[:3]])
    return out


def _gaps(got, want) -> list[float]:
    """max|Δ| of each field of each step in bf16 units of the oracle's
    field."""
    return [float(np.abs(g - w).max()) / _unit(w)
            for gs, ws in zip(got, want) for g, w in zip(gs, ws)]


# The plain twins' bar against the oracle, in bf16 units of each field's
# largest value, by mode: a kernel solve rounds once a chunk where JAX's
# rounds every operation of every sweep, and the gap grows with the
# sweeps and with the solver's own bf16 noise.  Measured on these runs:
# Jacobi 3.0, compensated 3.75, multigrid 23.25, CG 15.5.
TWIN_UNITS = {"jacobi": 4, "compensated": 6, "multigrid": 32, "cg": 24}


@pytest.mark.parametrize("mode,shape,gather", RUNS,
                         ids=[f"{m}-{a}x{b}-{g}" for m, (a, b), g in RUNS])
def test_reference_bf16_step_matches_jax(mode, shape, gather):
    """The ``reference`` backend's bf16 block step equals the oracle bit
    for bit (0 bf16 units, every field of both steps): each operation
    rounds where XLA's CPU jit rounds JAX's.  The kernels' plain twins
    composed into the same step lie within ``TWIN_UNITS``."""
    want = _oracle(mode, shape, gather)
    gaps = _gaps(_port(mode, shape, gather), want)
    twin = _gaps(_port(mode, shape, gather, plain=True), want)
    print(f"{mode} {shape} {gather}: max|d| to the oracle in bf16 units: "
          f"reference {max(gaps):.3f}, plain twins {max(twin):.3f} (bar "
          f"{TWIN_UNITS[mode]})")
    assert max(gaps) == 0.0
    assert max(twin) <= TWIN_UNITS[mode]


# -- each operation against its JAX block counterpart -------------------------

OP_SHAPES = [(2, 2), (2, 4)]
OPS = ["divergence", "gradient", "jacobi", "chebyshev", "cg", "multigrid",
       "disp"]


def _fields(count: int, seed: int) -> list[np.ndarray]:
    """``count`` random (side, side) fields in [-1, 1], rounded to bf16 as
    float32 numpy."""
    rng = np.random.default_rng(seed)
    side = N + 2
    return [_np(torch.from_numpy(rng.uniform(-1.0, 1.0, (side, side)).astype(
        np.float32)).to(BF16)) for _ in range(count)]


def _jax_op(op: str, shape, arrays):
    """JAX's block function of ``op`` under ``shard_map`` on bf16 inputs;
    the outputs as float32 numpy."""
    px, py = shape
    cfg = fj.SimConfig(n=N, dtype=jnp.bfloat16)
    av = cfg.diffusion_alpha_visc
    fns = {
        "divergence": (lambda u, v: js._divergence_local(u, v, N, px, py), 1),
        "gradient": (lambda u, v, p: js._gradient_local(u, v, p, N, px, py),
                     2),
        "jacobi": (lambda x, r: js._diffuse_local(1, x, r, av, 1 + 4 * av,
                                                  20, N, px, py), 1),
        "chebyshev": (lambda x, r: js._cheby_diffuse_local(
            1, x, r, av, 1 + 4 * av, 10, 0.9, N, px, py), 1),
        "cg": (lambda d: js._cg_local(d, 10, N, px, py), 1),
        "multigrid": (lambda d: js._mg_local(d, 2, N, px, py), 1),
    }
    mesh = _jax_mesh(shape)
    ins = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    if op == "disp":
        spec = P("x", "y")
        fn = jax.jit(jax.shard_map(
            lambda u, v: js._disp_global(u, v, cfg.dt * N), mesh=mesh,
            in_specs=(spec, spec), out_specs=P()))
        return [_np(fn(*ins))]
    fn, outs = fns[op]
    out = _sharded(fn, mesh, len(ins), outs)(*ins)
    return [_np(x) for x in (out if outs > 1 else (out,))]


def _port_op(op: str, shape, arrays):
    """The port's ``reference`` forms of ``op`` on the blocks of the same
    bf16 inputs, stitched; float32 numpy."""
    px, py = shape
    cfg = ft.SimConfig(n=N, dtype=BF16, backend="reference", device="cpu",
                       pressure_solver="multigrid")
    av = cfg.diffusion_alpha_visc
    blocks = Blocks(px, py, N + 2)
    ops = ts.get_block_ops(cfg)
    parts = [blocks.cut(torch.from_numpy(a).to(BF16)) for a in arrays]
    origins = blocks.origins
    if op == "divergence":
        u, v = parts
        out = [[ops.divergence(a, b, ha, hb, o, N) for a, b, ha, hb, o in
                zip(u, v, blocks.halos(u), blocks.halos(v), origins)]]
    elif op == "gradient":
        u, v, p = parts
        pairs = [ops.gradient(a, b, c, h, o, N) for a, b, c, h, o in
                 zip(u, v, p, blocks.halos(p), origins)]
        out = [[q[0] for q in pairs], [q[1] for q in pairs]]
    elif op == "jacobi":
        out = [ts._diffuse_blocks(ops, blocks, N, 1, *parts, av, 1 + 4 * av,
                                  20)]
    elif op == "chebyshev":
        out = [ts._cheby_blocks(ops, blocks, N, 1, *parts, av, 1 + 4 * av,
                                10, 0.9)]
    elif op == "cg":
        out = [tsol.cg_blocks(parts[0], 10, N, blocks)]
    elif op == "multigrid":
        out = [tsol.mg_blocks(parts[0], 2, N, blocks, ops.smooth,
                              ts.get_ops(cfg).smooth)]
    else:
        step = ts._BlockStep(cfg, make_mesh([CPU] * (px * py), shape=shape),
                             True, True)
        disp = step._disp(*parts)
        assert disp.dtype == BF16
        return [_np(disp)]
    for f in out:
        assert all(x.dtype == BF16 for x in f)
    return [_np(blocks.stitch(f)) for f in out]


@pytest.mark.parametrize("shape", OP_SHAPES,
                         ids=[f"{a}x{b}" for a, b in OP_SHAPES])
@pytest.mark.parametrize("op", OPS)
def test_reference_op_matches_jax_block_op(op, shape):
    """Each ``reference`` operation on bf16 blocks equals JAX's block
    function on the same bf16 inputs bit for bit (0 bf16 units): the
    divergence and the gradient (``_divergence_local``,
    ``_gradient_local``), a 20-sweep Jacobi solve in chunks
    (``_diffuse_local``) and a 10-sweep Chebyshev one
    (``_cheby_diffuse_local``), CG-10 (``_cg_local``: the rhs mean, the
    dot products and their psum), two multigrid cycles (``_mg_local``:
    the 2x2 block sums, their psum into the bf16 coarse grid, the classic
    cycle on it) and the audited displacement (``_disp_global``)."""
    count = {"divergence": 2, "gradient": 3, "jacobi": 2, "chebyshev": 2,
             "disp": 2}.get(op, 1)
    arrays = _fields(count, seed=OPS.index(op))
    want = _jax_op(op, shape, arrays)
    got = _port_op(op, shape, arrays)
    gaps = [float(np.abs(g - w).max()) / _unit(w) for g, w in zip(got, want)]
    print(f"{op} {shape}: max|d| to JAX's block op {max(gaps):.3f} bf16 "
          f"units")
    assert max(gaps) == 0.0


# -- JAX's bf16 block gather, and the route bf16 takes -------------------------


def _gather_fault(n: int, shape=(2, 2)):
    """One exact gather of a random [0, 1] field by random velocities that
    move the backtrace under half a cell, on ``shape`` blocks: rel-L2 of
    JAX's ``_advect_local`` in bf16 and of the port's bf16 block gather
    (``advect_block_exact_plain``, the ``reference`` backend's), each from
    JAX's gather in float32."""
    px, py = shape
    side, dt = n + 2, 0.016
    rng = np.random.default_rng(n)
    d0 = rng.uniform(0.0, 1.0, (side, side)).astype(np.float32)
    vmax = 0.5 / (dt * n)
    u, v = (rng.uniform(-vmax, vmax, (side, side)).astype(np.float32)
            for _ in range(2))
    fn = _sharded(lambda d, a, b: js._advect_local(0, d, a, b, dt, n, px, py),
                  _jax_mesh(shape), 3)
    want = _np(fn(*map(jnp.asarray, (d0, u, v))))
    jax16 = _np(fn(*(jnp.asarray(x, jnp.bfloat16) for x in (d0, u, v))))
    blocks = Blocks(px, py, side)
    parts = [blocks.cut(torch.from_numpy(x).to(BF16)) for x in (d0, u, v)]
    full = blocks.gather(parts[0])
    port = [cs.advect_block_exact_plain(
        (0,), (f,), a, b, o, dt=dt, n=n, m=blocks.m, k=blocks.k,
        self_adv=False)[0] for f, a, b, o in zip(full, parts[1], parts[2],
                                                  blocks.origins)]
    port = _np(blocks.stitch(port))

    def rl2(a):
        return float(np.linalg.norm(a - want) / np.linalg.norm(want))

    return rl2(jax16), rl2(port)


def test_jax_block_gather_loses_the_cell():
    """A recorded difference (ROADMAP §C): JAX's block route computes its
    bf16 backtrace coordinates and blend in bf16, so past 256 cells a
    coordinate cannot hold a fraction of a cell.  At n = 254 on (2, 2)
    blocks, displacements under half a cell, JAX's bf16 ``_advect_local``
    reads rel-L2 ~0.19 from its float32 gather; the port's bf16 block
    gather, float32 coordinates and blend rounded at the store, reads
    under 0.01 (one bf16 rounding of a [0, 1] field: ~0.002)."""
    jax16, port = _gather_fault(254)
    print(f"n = 254: rel-L2 from JAX's float32 gather: JAX bf16 "
          f"{jax16:.4f}, port bf16 {port:.4f}")
    assert 0.15 < jax16 < 0.25
    assert port < 0.01


def test_bf16_takes_the_block_route():
    """bf16 storage runs on the block route: ``"auto"`` takes it on a mesh
    whose slabs qualify for the slab route in float32 (as JAX's ``"auto"``,
    whose slab route is float32), ``"reference"`` too, and ``"slab"``
    refuses bf16 (JAX's ``"pallas"`` does).  The state stays bf16."""
    cfg = ft.SimConfig(n=62, jacobi_iters=8, dtype=BF16,
                       backend="reference", device="cpu")
    mesh = make_mesh([CPU] * 4)
    assert make_sharded_step_fn(cfg.replace(dtype=torch.float32),
                                mesh).layout == "slabs"
    for backend in ("auto", "reference"):
        step = make_sharded_step_fn(cfg, mesh, shard_backend=backend)
        assert (step.layout, step.shard_backend) == ("blocks", "reference")
        state = shard_blocks(ft.zero_state(cfg), step.mesh)
        src = shard_blocks(ft.Sources(*(torch.full_like(x, 0.5) for x in
                                        ft.zero_sources(cfg)[:3])),
                           step.mesh)
        out = unshard(step(state, src), step.mesh)
        assert all(x.dtype == BF16 and bool(torch.isfinite(x).all())
                   for x in out[:3])
    with pytest.raises(ValueError, match="float32"):
        make_sharded_step_fn(cfg, mesh, shard_backend="slab")
    with pytest.raises(ValueError, match="float32"):
        jax_cfg = fj.SimConfig(n=62, dtype=jnp.bfloat16, backend="pallas")
        js.make_sharded_step_fn(jax_cfg, _jax_mesh((4, 1)),
                                shard_backend="pallas",
                                advect_mode="windowed")


# The twins' diffused u against the reference's at n = 126 (seeds 0-2), in
# bf16 units of the reference's largest |u|: the recorded difference of
# one rounding a chunk against one an operation.
RECORDED_DU = 2.0


def _cg_projection(n: int, seed: int):
    """The block CG-20 step's first projection at n on (2, 4) blocks (as
    ``chip_smoke.block_projection_div`` runs it): for float32, the
    kernels' bf16 twins and the ``reference`` bf16 route, the diffused
    impulse velocity's max|div| and RMS div, the same after the
    projection, and the diffused u."""
    from fluidsimulationcuda_torch.ops.project import divergence
    from fluidsimulationcuda_torch.ops.source import add_source

    base = ft.SimConfig(n=n, jacobi_iters=20, pressure_solver="cg",
                        cg_iters=20, device="cpu")
    mesh = make_mesh([CPU] * 8, shape=(2, 4))
    state0, sources = ft.reference_init(torch.Generator().manual_seed(seed),
                                        base)
    draw16 = [ft.FluidState(*(t.to(BF16) for t in state0[:3])),
              ft.Sources(*(t.to(BF16) for t in sources[:3]))]
    draw32 = [type(t)(*(x.float() for x in t[:3])) for t in draw16]

    def stats(u, v):
        d = divergence(u.float(), v.float(), n)[1:-1, 1:-1]
        return float(d.abs().max()), float(d.pow(2).mean().sqrt())

    out = {}
    for name, dtype, backend, draw in (
            ("float32", torch.float32, "cuda", draw32),
            ("twins", BF16, "cuda", draw16),
            ("reference", BF16, "reference", draw16)):
        cfg = base.replace(dtype=dtype)
        object.__setattr__(cfg, "backend", backend)  # twins on the CPU
        run = ts._BlockStep(cfg, mesh, False, True, plain=backend == "cuda")
        state, src = (shard_blocks(t, mesh) for t in draw)
        alpha = cfg.diffusion_alpha_visc
        beta = 1.0 + 4.0 * alpha
        u, v = ([add_source(a, s, cfg.dt) for a, s in zip(f, g)]
                for f, g in ((state.u, src.u), (state.v, src.v)))
        u = run._diffusion(1, src.u, u, alpha, beta)
        v = run._diffusion(2, src.v, v, alpha, beta)
        stitch = run.blocks.stitch
        before = stats(stitch(u), stitch(v))
        uo, vo = run._project(u, v)
        out[name] = (before, stats(stitch(uo), stitch(vo)),
                     stitch(u).float())
    return out


def test_bf16_block_cg20_divergence_follows_its_diffusion():
    """The bf16 block CG-20's max|div| after the first projection, 1.060x
    the ``reference`` bf16 block step's on the card (ROADMAP §C, a
    recorded difference): the kernels' diffusions round once a chunk
    (K9-block), the reference's every operation, and the projection's
    max|div| follows its input.  At n = 126 on (2, 4), seeds 0-2, the
    twins' diffused velocity has float32's max|div| and RMS div to 0.5%
    and lies from the reference's by up to RECORDED_DU bf16 units of its
    largest value; after 20 CG iterations the twins' max|div| lies within
    15% of the reference's on either side (no fixed order: the ratio is
    below 1 on one seed and above on another) and of float32's."""
    ratios = []
    for seed in range(3):
        got = _cg_projection(126, seed)
        f32, tw, ref = got["float32"], got["twins"], got["reference"]
        for k in range(2):
            assert abs(tw[0][k] / f32[0][k] - 1) < 0.005, (seed, tw, f32)
        du = float((tw[2] - ref[2]).abs().max()) / _unit(ref[2].numpy())
        assert 0 < du <= RECORDED_DU, (seed, du)
        ratio = tw[1][0] / ref[1][0]
        assert abs(ratio - 1) < 0.15, (seed, ratio)
        assert abs(tw[1][0] / f32[1][0] - 1) < 0.15, (seed, tw, f32)
        ratios.append(ratio)
    assert min(ratios) < 1 < max(ratios), ratios
