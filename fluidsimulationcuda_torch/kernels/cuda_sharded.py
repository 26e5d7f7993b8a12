"""The kernels of the multi-device 2-D step: on row slabs, one wrapper per
TPU function of ``fluidsimulationcuda_tpu.kernels.pallas_sharded``; on the
(px, py) blocks of the block route, the four block forms (below); each
beside its plain PyTorch twin.

A slab is a band of ``m`` full-width rows of the padded global grid, global
row ``row0 + r`` at slab row ``r``.  An extended slab ``(m + 2K, side)``
adds the ``K`` rows above and below it, received from the neighbouring
slabs (zeros beyond a wall), slab row ``r`` at ext row ``K + r``.  Every
function takes ``flags = (is_top, is_bot, row0)`` as host ints: whether the
slab holds the global top or bottom ghost row, and its first global row.
The TPU kernels read the same three numbers from an SMEM vector; passed
from the host they cost no device-to-host copy per launch.

Wrappers keep the JAX names and arguments and check dtype (float32; the
block forms also bf16), shape, contiguity and device.  On CPU tensors they
return their plain twin (the ``*_plain`` function, which the ``reference``
backend of the sharded step also runs in float32, on any device); on CUDA
tensors they launch the hand-written kernels of ``csrc/`` or raise.
Nothing falls back.  Launches count in ``cuda_ops.launch_counts()``.

Eight CUDA kernels carry the seven TPU kernels, the multigrid smoother and
the exact gather (a second form of K12) of the slab route:

- K9, the sweeps of every row-slab solve: ``jacobi_slab_sweeps``, the
  slab form of the tiled K1 (``csrc/jacobi_tiles.cu``), T sweeps a launch
  in shared-memory tiles over the extended slab (``cuda_ops.slab_tiling``
  picks T and the tile by the buffer); ``jacobi_slab``
  (``csrc/jacobi_slab.cu``), one sweep a launch, the chain the tiled form
  is held against (``cuda_ops.launch_sweeps(0)``).  They make
  ``fused_jacobi_slab`` (B9a, ``pallas_sharded.py:290``);
- ``divergence_slab`` (K10) and ``gradient_slab`` (K11),
  ``csrc/project_slab.cu``: ``divergence_slab`` (B9e, ``:1357``) and
  ``gradient_slab`` (B9f, ``:1378``), and with K9 between them
  ``fused_project_slab`` (B9b, ``:700``);
- ``advect_slab`` (K12, ``csrc/advect_slab.cu``): ``advect_slab`` (B9d,
  ``:1246``), and after K9's sweeps ``fused_dens_slab`` (B9c, ``:1010``);
  ``advect_slab_exact``, K12's exact form, the gather of JAX's exact
  all-gather advection (``_advect_local``, ``parallel/sharded.py:245``,
  jnp) from the assembled fields, which the slab step takes under
  ``advect_mode="exact"``;
- ``jacobi_slab_sweeps_split`` (``csrc/jacobi_tiles.cu``), the tiled
  K9's first launch of ``fused_jacobi_slab_split`` (B13, ``:506``): T
  sweeps with its tiles read from the halo and slab operands, no
  concatenation; the tiled K9 runs the sweeps after it.  As in JAX no
  step calls it.  ``jacobi_slab_split`` (K18,
  ``csrc/jacobi_slab_split.cu``), the first sweep alone one cell a
  thread, heads the per-sweep chain it is held to;
- ``jacobi_slab_sweeps_damp_group`` (K9-damp, ``csrc/jacobi_tiles.cu``),
  the tiled K9 in K1-damp's damped form over every slab of a device in
  one launch, its halo rows read from the neighbouring slabs' arrays:
  ``smooth_slabs``, the fine-level smoother of the slab multigrid
  (``parallel/solvers.py``), which JAX writes in jnp
  (``_mg_smooth_local``, ``parallel/sharded.py:477``), a smooth in one
  launch where JAX exchanges a one-row halo a sweep.

The block route (JAX's jnp ``_step_local``; no pallas_call behind it) runs
four more, each a form of a slab kernel on an (m, k) block at global
origin (r0, c0) (the section "The block route" below):

- K9-block (``csrc/jacobi_tiles.cu``): ``jacobi_block_group``, a chunk
  of a block solve on every block of a device in one launch, each block's
  halo read from its neighbours' own arrays (``GroupBlockTiles``):
  ``fused_jacobi_blocks`` (Jacobi, fast, Chebyshev with x_{k-1} in and
  out) and ``smooth_blocks`` (the damped form), the block route's;
  ``jacobi_block_sweeps``, the same chunk on one extended block (the
  tiled K9's body on ``BlockTiles``), ``fused_jacobi_block`` and
  ``smooth_block``, which the grouped form is held against;
- ``advect_block`` and ``advect_block_exact`` (K12-block,
  ``csrc/advect_slab.cu``): the windowed gather from a ``cmax+1``-deep
  2-D halo and the exact one from the assembled fields;
- ``divergence_block`` (K10-block) and ``gradient_block`` (K11-block),
  ``csrc/project_slab.cu``, with one-cell 2-D halos.

Each block form has a bf16 form for bf16 storage (JAX runs bf16 on its
block route alone), counted as ``<kernel>_bf16``: every operand bf16, the
arithmetic float32, each output rounded to bf16 at the store (a block
solve once a chunk).  In bf16 the two roles of the plain functions split:
``*_plain`` is the kernel's twin, float32 arithmetic rounded where the
kernel stores; ``*_ref`` (the ``reference`` backend's) rounds every
operation to bf16 as JAX's jnp block route does.  In float32 they are the
same computation.  The gathers have no ``*_ref``: the ``reference``
backend gathers in float32 too (JAX's block route computes its bf16
coordinates in bf16, ROADMAP §C).

Each result equals the global operation restricted to the slab while the
halos are deep enough: ``K >= sweeps`` for the sweeps, ``K >= iters + 1``
for the projection, ``K >= iters + cmax + 1`` for the density step and
``cmax + 1`` rows for a windowed gather (the exact one reads the
assembled fields); the wrappers check these.  The sharded step
passes JAX's margins (``ceil8`` of a bit more), so that a given shape takes
the same route in both packages.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from ..ops.advect import bilinear, departure
from ..ops.chebyshev import cheby_omegas
from ..ops.diffuse import as_scalar
from ..ops.multigrid import OMEGA
from ..ops.project import _h, grid_h
from ..ops.source import add_source
from . import build
from . import cuda_ops as co

__all__ = [
    "fused_jacobi_slab", "fused_jacobi_slab_plain", "smooth_slab_plain",
    "smooth_slabs", "smooth_slabs_plain", "SMOOTH_HALO", "fused_project_slab",
    "fused_project_slab_plain", "fused_dens_slab", "fused_dens_slab_plain",
    "advect_slab", "advect_slab_plain", "advect_slab_exact",
    "advect_slab_exact_plain", "divergence_slab",
    "divergence_slab_plain", "gradient_slab", "gradient_slab_plain",
    "fused_jacobi_slab_split", "fused_jacobi_slab_split_plain",
    "jacobi_slab_split_viable", "fused_jacobi_block",
    "fused_jacobi_block_plain", "smooth_block", "smooth_block_plain",
    "advect_block", "advect_block_plain", "advect_block_exact",
    "advect_block_exact_plain", "divergence_block", "divergence_block_plain",
    "gradient_block", "gradient_block_plain", "fused_jacobi_block_ref",
    "smooth_block_ref", "divergence_block_ref", "gradient_block_ref",
    "fused_jacobi_blocks", "fused_jacobi_blocks_plain", "smooth_blocks",
    "smooth_blocks_plain", "block_group_tile", "gradient_blocks",
    "gradient_blocks_plain", "gradient_blocks_composed", "advect_blocks",
    "advect_blocks_plain", "advect_blocks_composed", "GATHER_PARTS",
]


# ---------------------------------------------------------------------------
# Checks, flags and geometry
# ---------------------------------------------------------------------------


def _on_card(*specs: tuple[torch.Tensor, tuple[int, int]]) -> bool:
    """``cuda_ops._on_device`` for (rows, side) slab arrays, each at least
    3 columns wide and below 2**31 cells (the kernels index with 32-bit
    ints)."""
    for _, (rows, side) in specs:
        if side < 3 or rows * side >= 2**31:
            raise ValueError(f"unsupported slab shape {(rows, side)}")
    return co._on_device(*specs)


def _flags(flags) -> tuple[bool, bool, int]:
    is_top, is_bot, row0 = (int(f) for f in flags)
    return bool(is_top), bool(is_bot), row0


def _wall_rows(flags, offset: int, m: int) -> tuple[int, int]:
    """Buffer rows of the global top and bottom ghost rows (-1: not in
    this slab) for a buffer whose slab row 0 is buffer row ``offset``."""
    is_top, is_bot, _ = _flags(flags)
    return (offset if is_top else -1), (offset + m - 1 if is_bot else -1)


def _shift(row: int, by: int) -> int:
    return row - by if row >= 0 else -1


def _row(t: torch.Tensor, r: int) -> int:
    """Address of row ``r`` of a contiguous 2-D tensor."""
    return t.data_ptr() + r * t.shape[-1] * t.element_size()


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise ValueError(message)


# ---------------------------------------------------------------------------
# Plain building blocks
# ---------------------------------------------------------------------------


def _signs(b: int) -> tuple[float, float]:
    return (-1.0 if b == 1 else 1.0), (-1.0 if b == 2 else 1.0)


def _slab_bnd(b: int, x: torch.Tensor, gtop: int, gbot: int) -> torch.Tensor:
    """The mode-``b`` border rule on a (rows, side) buffer, in place: ghost
    columns mirror their inner neighbour on every row, a wall ghost row
    (``gtop``/``gbot``, -1 when absent) the row next to it, corners average
    their two edge neighbours (``FluidSequential.c:62-75``), in the
    expression order of ``ops.boundary.embed_interior``."""
    sx, sy = _signs(b)
    x[:, 0] = sx * x[:, 1]
    x[:, -1] = sx * x[:, -2]
    for g, nb in ((gtop, gtop + 1), (gbot, gbot - 1)):
        if g < 0:
            continue
        x[g, 1:-1] = sy * x[nb, 1:-1]
        for col, inner in ((0, 1), (-1, -2)):
            v = x[nb, inner]
            x[g, col] = 0.5 * (sy * v + sx * v)
    return x


def _sweeps_plain(b, x, rhs, alpha, beta, sweeps, gtop, gbot, *,
                  zero_init=False, src_dt=None, fast=False, cheby_rho=None,
                  damp=None):
    """The whole (rows, side) buffer after ``sweeps`` Jacobi (or Chebyshev)
    sweeps, each over the buffer's inner rows (its edge rows keep their
    input values), with the border rule after each.  Source fold, fast form
    and Chebyshev weights as ``cuda_ops.fused_jacobi_plain``; ``damp``
    blends each sweep with x_k as ``ops.diffuse.damped_diffuse`` does."""
    if src_dt is not None:
        rhs = add_source(rhs, x, src_dt)
    if zero_init:
        x = torch.zeros_like(rhs)
    if fast:
        rhs = rhs * (1.0 / beta)
        alpha, beta = alpha / beta, 1.0
    a = as_scalar(alpha, rhs)
    bt = as_scalar(beta, rhs)
    ws = [None] * sweeps
    if cheby_rho is not None:
        ws = [None, *cheby_omegas(float(cheby_rho), sweeps)]
    rhs_in = rhs[1:-1, 1:-1]
    g_in = (_shift(gtop, 1), _shift(gbot, 1))
    if damp is not None:
        wd, omw = as_scalar(damp, rhs), as_scalar(1.0 - damp, rhs)
    xm = x
    for w in ws:
        neigh = ((x[1:-1, :-2] + x[1:-1, 2:]) + x[:-2, 1:-1]) + x[2:, 1:-1]
        val = (rhs_in + a * neigh) / bt
        if damp is not None:
            val = omw * x[1:-1, 1:-1] + wd * val
        if w is not None:
            wc = as_scalar(w, rhs)
            val = wc * val + (1.0 - wc) * xm[1:-1, 1:-1]
        new = x.clone()
        new[1:-1, 1:-1] = val
        _slab_bnd(b, new[1:-1], *g_in)
        xm, x = x, new
    return x


def _divergence_plain(u, v, vtop, vbot, n, gtop, gbot):
    """Divergence on (rows, side) slabs whose neighbour rows are the
    one-row halos ``vtop``/``vbot``: ``(-0.5*h)*(du + (v_dn - v_up))``,
    border mode 0."""
    v_up = torch.cat([vtop, v[:-1]])
    v_dn = torch.cat([v[1:], vbot])
    out = torch.empty_like(u)
    out[:, 1:-1] = (-0.5 * grid_h(n)) * ((u[:, 2:] - u[:, :-2])
                                         + (v_dn - v_up)[:, 1:-1])
    return _slab_bnd(0, out, gtop, gbot)


def _gradient_plain(u, v, p, ptop, pbot, n, gtop, gbot):
    """``u - (0.5*dp)/h``, ``v - (0.5*(p_dn - p_up))/h`` on (rows, side)
    slabs with one-row halos of ``p``; border modes 1 and 2."""
    h = as_scalar(grid_h(n), u)
    p_up = torch.cat([ptop, p[:-1]])
    p_dn = torch.cat([p[1:], pbot])
    uo = torch.empty_like(u)
    vo = torch.empty_like(v)
    uo[:, 1:-1] = u[:, 1:-1] - (0.5 * (p[:, 2:] - p[:, :-2])) / h
    vo[:, 1:-1] = v[:, 1:-1] - (0.5 * (p_dn - p_up)[:, 1:-1]) / h
    return _slab_bnd(1, uo, gtop, gbot), _slab_bnd(2, vo, gtop, gbot)


def _advect_plain(bs, exts, halo, u, v, flags, dt, n, cmax):
    """The windowed gather (``ops.advect.advect_windowed``) of each field
    of ``exts`` at the cells of an (m, side) slab, at global coordinates;
    slab row r is ext row ``halo + r``.  With ``cmax=None`` the exact
    gather (``ops.advect.advect``'s departure) from the assembled fields,
    ``halo = row0``."""
    _, _, row0 = _flags(flags)
    m, side = u.shape
    gr = torch.arange(row0, row0 + m, dtype=torch.float32,
                      device=u.device)[:, None]
    gc = torch.arange(side, dtype=torch.float32, device=u.device)[None, :]
    x, y = departure(u, v, gc, gr, dt, n, cmax)
    gtop, gbot = _wall_rows(flags, 0, m)
    return tuple(_slab_bnd(b, bilinear(ext, x, y, row0 - halo), gtop, gbot)
                 for b, ext in zip(bs, exts))


# ---------------------------------------------------------------------------
# B9a fused_jacobi_slab (K9)
# ---------------------------------------------------------------------------


def _jacobi_checks(x_ext, rhs_ext, m, K, sweeps) -> bool:
    side = rhs_ext.shape[-1]
    _require(sweeps >= 1, "sweeps must be >= 1")
    _require(K >= sweeps, f"a {K}-row halo is valid for at most {K} sweeps, "
             f"got {sweeps}")
    return _on_card((rhs_ext, (m + 2 * K, side)), (x_ext, (m + 2 * K, side)))


def fused_jacobi_slab_plain(b, x_ext, rhs_ext, flags, *, m, K, alpha, beta,
                            sweeps, zero_init=False, fast=False,
                            cheby_rho=None):
    _jacobi_checks(x_ext, rhs_ext, m, K, sweeps)
    gtop, gbot = _wall_rows(flags, K, m)
    x = _sweeps_plain(b, x_ext, rhs_ext, alpha, beta, sweeps, gtop, gbot,
                      zero_init=zero_init, fast=fast, cheby_rho=cheby_rho)
    return x[K:K + m]


def fused_jacobi_slab(b, x_ext, rhs_ext, flags, *, m, K, alpha, beta,
                      sweeps, zero_init=False, fast=False, cheby_rho=None):
    """``sweeps`` Jacobi sweeps (Chebyshev with ``cheby_rho``, the
    reciprocal form with ``fast``) on an ``(m+2K, side)`` extended slab from
    guess ``x_ext`` (zero with ``zero_init``; ``x_ext`` is then ignored)
    with rhs ``rhs_ext``; returns the (m, side) slab.  The tiled K9's
    launches of T sweeps (``_Sweeps.run_slab``); a Chebyshev solve runs
    whole in one call, its x_{k-1} handed from launch to launch."""
    if not _jacobi_checks(x_ext, rhs_ext, m, K, sweeps):
        return fused_jacobi_slab_plain(
            b, x_ext, rhs_ext, flags, m=m, K=K, alpha=alpha, beta=beta,
            sweeps=sweeps, zero_init=zero_init, fast=fast,
            cheby_rho=cheby_rho)
    gtop, gbot = _wall_rows(flags, K, m)
    with torch.cuda.device(rhs_ext.device):
        lib = build.load()
        run = co._Sweeps(b, x_ext, rhs_ext, alpha, beta, sweeps,
                         zero_init=zero_init, src_dt=None, fast=fast,
                         cheby_rho=cheby_rho, kernel="jacobi_slab")
        run.run_slab(lib, m + 2 * K, gtop, gbot)
        return run.x[K:K + m]


# ---------------------------------------------------------------------------
# The slab multigrid's smoother (K9-damp)
# ---------------------------------------------------------------------------

# The rows of the plain twin's halo (``smooth_slabs_plain``): a smooth of
# up to SMOOTH_HALO - 1 sweeps per exchange, ceil8(sweeps + 1) as the
# step's Jacobi chunks.
SMOOTH_HALO = 8


def smooth_slab_plain(p_ext, div_ext, flags, *, m, K, sweeps,
                      zero_init=False):
    """``sweeps`` damped sweeps on an ``(m+2K, side)`` extended slab from
    guess ``p_ext`` (zero with ``zero_init``) with rhs ``div_ext``; returns
    the (m, side) slab, exact while ``K >= sweeps``."""
    _jacobi_checks(p_ext, div_ext, m, K, sweeps)
    gtop, gbot = _wall_rows(flags, K, m)
    x = _sweeps_plain(0, p_ext, div_ext, 1.0, 4.0, sweeps, gtop, gbot,
                      zero_init=zero_init, damp=OMEGA)
    return x[K:K + m]


def smooth_slabs_plain(p_slabs, div_slabs, flags, *, sweeps,
                       zero_init=False):
    """``sweeps`` damped sweeps of the pressure problem (b=0, alpha=1,
    beta=4, w = ``ops.multigrid.OMEGA``; ``ops.multigrid._smooth``) on
    every row slab: chunks of at most ``SMOOTH_HALO - 1`` sweeps, each on
    slabs extended by an ``SMOOTH_HALO``-row halo (``parallel/mesh.py``'s
    ``_ext``: the neighbouring slabs' rows moved to each slab's device,
    zeros beyond a wall) through ``smooth_slab_plain``, which computes on
    the slab's rows what as many one-row exchanges and sweeps compute
    (JAX's ``_mg_smooth_local``); returns the list of (m, side) slabs.
    ``p_slabs`` is ignored with ``zero_init``."""
    from ..parallel.mesh import _ext

    m = div_slabs[0].shape[0]
    div_ext = _ext(div_slabs, SMOOTH_HALO)
    p, done = p_slabs, 0
    while done < sweeps:
        s = min(SMOOTH_HALO - 1, sweeps - done)
        zero = zero_init and done == 0
        p_ext = div_ext if zero else _ext(p, SMOOTH_HALO)
        p = [smooth_slab_plain(pe, de, fl, m=m, K=SMOOTH_HALO, sweeps=s,
                               zero_init=zero)
             for pe, de, fl in zip(p_ext, div_ext, flags)]
        done += s
    return p


def smooth_slabs(p_slabs, div_slabs, flags, *, sweeps, zero_init=False):
    """``smooth_slabs_plain`` on the card: each device's slabs in one
    grouped K9-damp launch (``fsc_jacobi_slab_sweeps_damp_group``, counted
    as ``jacobi_slab_sweeps_damp_group``) of T sweeps
    (``cuda_ops.group_smooth_tiling``), so a 2-sweep smooth is one launch
    a device, with no extended slab built: a slab's halo rows are read
    from its neighbour's own array where that lies on the same device, and
    copied over (a halo exchange) where it does not.  A smooth of more
    sweeps than a launch takes runs in several, each reading its
    neighbours' rows as the last left them.  Bit for bit
    ``smooth_slabs_plain``."""
    return _smooth_group(p_slabs, div_slabs, flags, sweeps, zero_init,
                         copy=False)


def _neighbour_rows(xs, i: int, k: int, copy: bool):
    """(top, bottom): the ``k`` rows of slab i's neighbours next to it,
    views into their own arrays where they lie on its device (unless
    ``copy``), else copies moved there; None beyond a wall."""
    dev = xs[i].device

    def rows(j, part):
        if not 0 <= j < len(xs):
            return None
        r = part(xs[j])
        return r.to(dev, copy=True) if copy or xs[j].device != dev else r

    return (rows(i - 1, lambda x: x[x.shape[0] - k:]),
            rows(i + 1, lambda x: x[:k]))


def _smooth_group(p_slabs, div_slabs, flags, sweeps, zero_init, copy):
    m, side = div_slabs[0].shape
    _require(sweeps >= 1, "sweeps must be >= 1")
    groups: dict[torch.device, list[int]] = {}
    for i, d in enumerate(div_slabs):
        groups.setdefault(d.device, []).append(i)
    on_card = {_on_card(*((t, (m, side)) for i in idx
                          for t in (div_slabs[i],) + (
                              () if zero_init else (p_slabs[i],))))
               for idx in groups.values()}
    _require(len(on_card) == 1, "slabs on the card and on the CPU at once")
    if not on_card.pop():
        return smooth_slabs_plain(p_slabs, div_slabs, flags, sweeps=sweeps,
                                  zero_init=zero_init)
    lib = build.load()
    x, done = None if zero_init else list(p_slabs), 0
    while done < sweeps:
        per_launch, tile = co.group_smooth_tiling(
            max(len(idx) for idx in groups.values()) * m * side, m,
            sweeps - done)
        count = min(per_launch, sweeps - done)
        outs = [torch.empty_like(d) for d in div_slabs]
        for dev, idx in groups.items():
            with torch.cuda.device(dev):
                for lo in range(0, len(idx), co.GROUP_SLABS):
                    _launch_group(lib, x, div_slabs, outs, flags,
                                  idx[lo:lo + co.GROUP_SLABS], count, tile,
                                  copy)
        x, done = outs, done + count
    return x


def _launch_group(lib, x, div, outs, flags, idx, count, tile, copy):
    """One grouped K9-damp launch of ``count`` sweeps over slabs ``idx``
    (all on one device): each slab's row sources and output in the
    library's table."""
    m, side = div[0].shape
    # keep: each halo copy stays alive until the launch that reads it is
    # enqueued (a copy freed before could lend its memory to the next).
    ptrs, walls, keep = [], [], []
    for i in idx:
        rhs = _neighbour_rows(div, i, count, copy)
        xs = ((None, None) if x is None
              else _neighbour_rows(x, i, count, copy))
        keep += [*rhs, *xs]
        ptrs += [co._ptr(xs[0]), None if x is None else x[i].data_ptr(),
                 co._ptr(xs[1]), co._ptr(rhs[0]), div[i].data_ptr(),
                 co._ptr(rhs[1]), outs[i].data_ptr()]
        is_top, is_bot, _ = _flags(flags[i])
        walls += [int(is_top), int(is_bot)]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    wall_table = (ctypes.c_int * len(walls))(*walls)
    co._launch("jacobi_slab_sweeps_damp_group",
               lib.fsc_jacobi_slab_sweeps_damp_group,
               ctypes.addressof(table), ctypes.addressof(wall_table),
               len(idx), m, side, 0, 1.0, 4.0, co._f32(OMEGA),
               co._f32(1.0 - OMEGA), count, tile, co._stream(div[idx[0]]))


# ---------------------------------------------------------------------------
# B13 fused_jacobi_slab_split (K18 + K9)
# ---------------------------------------------------------------------------


def jacobi_slab_split_viable(m: int, side: int, K: int) -> bool:
    """Whether K18 takes an (m, side) slab with K-row halos.  JAX's gate
    ``tm >= K`` sizes the TPU's strip DMAs and is left out."""
    return m >= 1 and K >= 1 and side >= 3 and (m + 2 * K) * side < 2**31


def _split_checks(x, x_top, x_bot, rhs, rhs_top, rhs_bot, m, K, sweeps,
                  zero_init) -> bool:
    side = rhs.shape[-1]
    _require(sweeps >= 1, "sweeps must be >= 1")
    _require(K >= sweeps, f"a {K}-row halo is valid for at most {K} sweeps, "
             f"got {sweeps}")
    _require(jacobi_slab_split_viable(m, side, K),
             f"unsupported split slab m={m}, side={side}, K={K}")
    specs = [(rhs, (m, side)), (rhs_top, (K, side)), (rhs_bot, (K, side))]
    if not zero_init:
        specs += [(x, (m, side)), (x_top, (K, side)), (x_bot, (K, side))]
    return _on_card(*specs)


def fused_jacobi_slab_split_plain(b, x, x_top, x_bot, rhs, rhs_top, rhs_bot,
                                  flags, *, m, K, alpha, beta, sweeps,
                                  zero_init=False, fast=False):
    """The concat route: the extended slabs by ``torch.cat``, then
    ``fused_jacobi_slab_plain``."""
    _split_checks(x, x_top, x_bot, rhs, rhs_top, rhs_bot, m, K, sweeps,
                  zero_init)
    rhs_ext = torch.cat([rhs_top, rhs, rhs_bot])
    x_ext = rhs_ext if zero_init else torch.cat([x_top, x, x_bot])
    return fused_jacobi_slab_plain(b, x_ext, rhs_ext, flags, m=m, K=K,
                                   alpha=alpha, beta=beta, sweeps=sweeps,
                                   zero_init=zero_init, fast=fast)


def fused_jacobi_slab_split(b, x, x_top, x_bot, rhs, rhs_top, rhs_bot, flags,
                            *, m, K, alpha, beta, sweeps, zero_init=False,
                            fast=False):
    """``fused_jacobi_slab`` on the slab ``x``/``rhs`` (m, side) and its
    (K, side) halos ``x_top``/``x_bot``, ``rhs_top``/``rhs_bot`` as they
    come from the neighbouring slabs, with no concatenated extended slab:
    the tiled K9's first launch (``jacobi_slab_sweeps_split``) runs the
    first T sweeps with its tiles read from the three operands and stores
    the extended rhs it read, the tiled K9 the sweeps after it
    (``_Sweeps.run_slab_split``).  ``zero_init`` starts from zero and
    ignores the x operands; as JAX's B13 it has no Chebyshev form.  Inside
    ``cuda_ops.launch_sweeps(0)`` it runs the per-sweep chain it is held
    to, K18's one sweep then the per-sweep K9 (``_split_k18``).  Equals
    ``fused_jacobi_slab`` on the concatenation bit for bit; returns the
    (m, side) slab."""
    if not _split_checks(x, x_top, x_bot, rhs, rhs_top, rhs_bot, m, K,
                         sweeps, zero_init):
        return fused_jacobi_slab_split_plain(
            b, x, x_top, x_bot, rhs, rhs_top, rhs_bot, flags, m=m, K=K,
            alpha=alpha, beta=beta, sweeps=sweeps, zero_init=zero_init,
            fast=fast)
    kw = dict(m=m, K=K, alpha=alpha, beta=beta, sweeps=sweeps,
              zero_init=zero_init, fast=fast)
    if co._forced == 0:
        return _split_k18(b, x, x_top, x_bot, rhs, rhs_top, rhs_bot, flags,
                          **kw)
    side, rows = rhs.shape[-1], m + 2 * K
    xs = (None, None, None) if zero_init else (x, x_top, x_bot)
    with torch.cuda.device(rhs.device):
        lib = build.load()
        run = co._Sweeps(b, None, rhs.new_empty((rows, side)), alpha, beta,
                         sweeps, zero_init=False, src_dt=None, fast=fast,
                         cheby_rho=None, kernel="jacobi_slab")
        run.run_slab_split(lib, xs, (rhs, rhs_top, rhs_bot), m, K,
                           *_wall_rows(flags, K, m))
        return run.x[K:K + m]


def _split_k18(b, x, x_top, x_bot, rhs, rhs_top, rhs_bot, flags, *, m, K,
               alpha, beta, sweeps, zero_init=False, fast=False):
    """B13 as K18's one sweep from the three operands (storing the
    extended rhs it reads) and K9 from sweep 2 on the extended buffers it
    wrote: the tiled K9's launches, or inside ``launch_sweeps(0)`` the
    per-sweep K9's, the chain ``fused_jacobi_slab_split`` is held to.
    CUDA tensors only (the caller checks)."""
    side, rows = rhs.shape[-1], m + 2 * K
    gtop, gbot = _wall_rows(flags, K, m)
    xs = (None, None, None) if zero_init else (x, x_top, x_bot)
    with torch.cuda.device(rhs.device):
        lib = build.load()
        rhs_ext = rhs.new_empty((rows, side))
        run = co._Sweeps(b, None, rhs_ext, alpha, beta, sweeps,
                         zero_init=False, src_dt=None, fast=fast,
                         cheby_rho=None, kernel="jacobi_slab")
        x1 = run._scratch()
        co._launch("jacobi_slab_split", lib.fsc_jacobi_slab_split,
                   *map(co._ptr, xs), rhs.data_ptr(), rhs_top.data_ptr(),
                   rhs_bot.data_ptr(), x1.data_ptr(), rhs_ext.data_ptr(), m,
                   K, side, b, *run.coefs[:4], co._FAST if fast else 0,
                   gtop, gbot, run.stream)
        run.ran_first_sweep(x1)
        run.run_slab(lib, rows, gtop, gbot)
        return run.x[K:K + m]


# ---------------------------------------------------------------------------
# B9b fused_project_slab (K10 + K9 + K11)
# ---------------------------------------------------------------------------


def _project_checks(u_ext, v_ext, n, iters, m, K) -> bool:
    side = u_ext.shape[-1]
    _require(side == n + 2, f"slab width {side} != n+2 = {n + 2}")
    _require(iters >= 1, "iters must be >= 1")
    _require(K >= iters + 1, f"the projection of {iters} sweeps needs a "
             f"halo of at least {iters + 1} rows, got {K}")
    shape = (m + 2 * K, side)
    return _on_card((u_ext, shape), (v_ext, shape))


def fused_project_slab_plain(u_ext, v_ext, flags, *, n, iters, m, K,
                             cheby_rho=None):
    _project_checks(u_ext, v_ext, n, iters, m, K)
    gtop, gbot = _wall_rows(flags, K, m)
    rhs = torch.zeros_like(u_ext)
    rhs[1:-1] = _divergence_plain(u_ext[1:-1], v_ext[1:-1], v_ext[:1],
                                  v_ext[-1:], n, _shift(gtop, 1),
                                  _shift(gbot, 1))
    p = _sweeps_plain(0, rhs, rhs, 1.0, 4.0, iters, gtop, gbot,
                      zero_init=True, cheby_rho=cheby_rho)
    return _gradient_plain(u_ext[K:K + m], v_ext[K:K + m], p[K:K + m],
                           p[K - 1:K], p[K + m:K + m + 1], n,
                           *_wall_rows(flags, 0, m))


def fused_project_slab(u_ext, v_ext, flags, *, n, iters, m, K,
                       cheby_rho=None):
    """Projection of an (m, side) slab from its ``(m+2K, side)`` extended
    velocities: the divergence over the buffer's inner rows (K10),
    ``iters`` pressure sweeps from zero with alpha=1, beta=4 (K9, Jacobi or
    Chebyshev; never the fast form, as in JAX), the gradient over the m
    slab rows (K11).  Returns the (u, v) slabs."""
    if not _project_checks(u_ext, v_ext, n, iters, m, K):
        return fused_project_slab_plain(u_ext, v_ext, flags, n=n,
                                        iters=iters, m=m, K=K,
                                        cheby_rho=cheby_rho)
    side, rows = n + 2, m + 2 * K
    gtop, gbot = _wall_rows(flags, K, m)
    with torch.cuda.device(u_ext.device):
        lib = build.load()
        stream = co._stream(u_ext)
        rhs = torch.empty_like(u_ext)
        co._launch("divergence_slab", lib.fsc_divergence_slab,
                   _row(u_ext, 1), _row(v_ext, 1), _row(v_ext, 0),
                   _row(v_ext, rows - 1), _row(rhs, 1), rows - 2, side,
                   _shift(gtop, 1), _shift(gbot, 1), -0.5 * grid_h(n),
                   stream)
        run = co._Sweeps(0, rhs, rhs, 1.0, 4.0, iters, zero_init=True,
                         src_dt=None, fast=False, cheby_rho=cheby_rho,
                         kernel="jacobi_slab")
        run.run_slab(lib, rows, gtop, gbot)
        p = run.x
        uo = u_ext.new_empty((m, side))
        vo = u_ext.new_empty((m, side))
        co._launch("gradient_slab", lib.fsc_gradient_slab, _row(u_ext, K),
                   _row(v_ext, K), _row(p, K), _row(p, K - 1),
                   _row(p, K + m), uo.data_ptr(), vo.data_ptr(), m, side,
                   *_wall_rows(flags, 0, m), grid_h(n), stream)
        return uo, vo


# ---------------------------------------------------------------------------
# B9c fused_dens_slab (K9 + K12)
# ---------------------------------------------------------------------------


def _dens_checks(src_ext, base_ext, u_slab, v_slab, iters, n, cmax, m,
                 K) -> bool:
    side = base_ext.shape[-1]
    _require(side == n + 2, f"slab width {side} != n+2 = {n + 2}")
    _require(iters >= 1 and cmax >= 0, "need iters >= 1 and cmax >= 0")
    _require(K >= iters + cmax + 1, f"the density step of {iters} sweeps "
             f"and cmax={cmax} needs a halo of at least {iters + cmax + 1} "
             f"rows, got {K}")
    ext = (m + 2 * K, side)
    return _on_card((src_ext, ext), (base_ext, ext), (u_slab, (m, side)),
                    (v_slab, (m, side)))


def fused_dens_slab_plain(b, src_ext, base_ext, u_slab, v_slab, flags, *,
                          alpha, beta, iters, dt, n, cmax, m, K, fast=False):
    _dens_checks(src_ext, base_ext, u_slab, v_slab, iters, n, cmax, m, K)
    gtop, gbot = _wall_rows(flags, K, m)
    window = _sweeps_plain(b, src_ext, base_ext, alpha, beta, iters, gtop,
                           gbot, src_dt=dt, fast=fast)
    return _advect_plain((b,), (window,), K, u_slab, v_slab, flags, dt, n,
                         cmax)[0]


def fused_dens_slab(b, src_ext, base_ext, u_slab, v_slab, flags, *, alpha,
                    beta, iters, dt, n, cmax, m, K, fast=False):
    """``advect(b, diffuse_src(b, src, base, ...), u, v)`` on a slab: K9
    runs the ``iters`` sweeps of the density diffusion on the extended
    slab, its rhs ``base + dt*src`` built by the first sweep, then K12
    gathers the slab's cells straight from the swept buffer.  Returns the
    (m, side) density slab."""
    if not _dens_checks(src_ext, base_ext, u_slab, v_slab, iters, n, cmax,
                        m, K):
        return fused_dens_slab_plain(
            b, src_ext, base_ext, u_slab, v_slab, flags, alpha=alpha,
            beta=beta, iters=iters, dt=dt, n=n, cmax=cmax, m=m, K=K,
            fast=fast)
    side = n + 2
    gtop, gbot = _wall_rows(flags, K, m)
    with torch.cuda.device(base_ext.device):
        lib = build.load()
        run = co._Sweeps(b, src_ext, base_ext, alpha, beta, iters,
                         zero_init=False, src_dt=dt, fast=fast,
                         cheby_rho=None, kernel="jacobi_slab")
        run.run_slab(lib, m + 2 * K, gtop, gbot)
        window = run.x
        out = base_ext.new_empty((m, side))
        co._launch("advect_slab", lib.fsc_advect_slab, window.data_ptr(),
                   None, u_slab.data_ptr(), v_slab.data_ptr(),
                   out.data_ptr(), None, m, side, K, b, 0, co._dt0(dt, n),
                   _flags(flags)[2], cmax, *_wall_rows(flags, 0, m),
                   run.stream)
        return out


# ---------------------------------------------------------------------------
# B9d advect_slab (K12)
# ---------------------------------------------------------------------------


def _advect_args(bs, exts, u_slab, v_slab, n, cmax, m, self_adv):
    """(bs, exts, halo, u, v, on_card) after the checks; with
    ``self_adv`` the velocities are the slab rows of the two fields."""
    bs, exts = tuple(bs), tuple(exts)
    _require(len(bs) == len(exts) and len(bs) in (1, 2),
             "advect_slab takes one or two fields")
    rows, side = exts[0].shape
    halo = (rows - m) // 2
    _require(side == n + 2, f"slab width {side} != n+2 = {n + 2}")
    _require(rows - m == 2 * halo and halo >= cmax + 1 and cmax >= 0,
             f"the gather needs an extended slab of m + 2*halo rows with "
             f"halo >= cmax+1 = {cmax + 1}; got {rows} rows for m={m}")
    if self_adv:
        _require(len(bs) == 2, "self_adv advects the (u, v) pair")
        u_slab, v_slab = exts[0][halo:halo + m], exts[1][halo:halo + m]
    on_card = _on_card(*((e, (rows, side)) for e in exts),
                       (u_slab, (m, side)), (v_slab, (m, side)))
    return bs, exts, halo, u_slab, v_slab, on_card


def advect_slab_plain(bs, exts, u_slab, v_slab, flags, *, dt, n, cmax, m,
                      self_adv):
    bs, exts, halo, u, v, _ = _advect_args(bs, exts, u_slab, v_slab, n, cmax,
                                           m, self_adv)
    return _advect_plain(bs, exts, halo, u, v, flags, dt, n, cmax)


def advect_slab(bs, exts, u_slab, v_slab, flags, *, dt, n, cmax, m,
                self_adv):
    """Windowed advection of one or two fields of an (m, side) slab from
    their extended copies ``exts`` (``m + 2*halo`` rows, ``halo >=
    cmax+1``; JAX pads the halo to a TPU block, the port needs none).
    ``u_slab``/``v_slab`` are the (m, side) velocity slabs, ignored with
    ``self_adv``: the two fields are the velocities (the u/v
    self-advection pair, one shared backtrace).  One K12 launch; returns a
    tuple of (m, side) slabs."""
    bs, exts, halo, u, v, on_card = _advect_args(bs, exts, u_slab, v_slab,
                                                 n, cmax, m, self_adv)
    if not on_card:
        return _advect_plain(bs, exts, halo, u, v, flags, dt, n, cmax)
    side = n + 2
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(u.new_empty((m, side)) for _ in bs)
        d2, o2, b2 = ((exts[1], outs[1], bs[1]) if len(bs) == 2
                      else (None, None, 0))
        co._launch("advect_slab", lib.fsc_advect_slab, exts[0].data_ptr(),
                   co._ptr(d2), u.data_ptr(), v.data_ptr(),
                   outs[0].data_ptr(), co._ptr(o2), m, side, halo, bs[0], b2,
                   co._dt0(dt, n), _flags(flags)[2], cmax,
                   *_wall_rows(flags, 0, m), co._stream(u))
        return outs


def _advect_exact_args(bs, fulls, u_slab, v_slab, flags, n, m, self_adv):
    """(bs, fulls, u, v, on_card) after the checks; with ``self_adv`` the
    velocities are the slab's rows of the two assembled fields."""
    bs, fulls = tuple(bs), tuple(fulls)
    _require(len(bs) == len(fulls) and len(bs) in (1, 2),
             "advect_slab_exact takes one or two fields")
    side, row0 = n + 2, _flags(flags)[2]
    _require(0 <= row0 and row0 + m <= side and m >= 1,
             f"an {m}-row slab at row {row0} is not inside the {side}-row "
             f"grid")
    if self_adv:
        _require(len(bs) == 2, "self_adv advects the (u, v) pair")
        u_slab, v_slab = (f[row0:row0 + m] for f in fulls)
    on_card = _on_card(*((f, (side, side)) for f in fulls),
                       (u_slab, (m, side)), (v_slab, (m, side)))
    return bs, fulls, u_slab, v_slab, on_card


def advect_slab_exact_plain(bs, fulls, u_slab, v_slab, flags, *, dt, n, m,
                            self_adv):
    bs, fulls, u, v, _ = _advect_exact_args(bs, fulls, u_slab, v_slab, flags,
                                            n, m, self_adv)
    return _advect_plain(bs, fulls, _flags(flags)[2], u, v, flags, dt, n,
                         None)


def advect_slab_exact(bs, fulls, u_slab, v_slab, flags, *, dt, n, m,
                      self_adv):
    """Exact advection of one or two fields of an (m, side) slab, gathered
    from the assembled (side, side) fields ``fulls`` (JAX's
    ``_advect_local``, which all-gathers the field first): the departure
    point takes the global clamp alone, so any displacement gathers as the
    single-device step does.  ``u_slab``/``v_slab`` as ``advect_slab``'s;
    with ``self_adv`` they are the slab's rows of the two fields.  One
    launch of K12's exact form; returns a tuple of (m, side) slabs."""
    bs, fulls, u, v, on_card = _advect_exact_args(bs, fulls, u_slab, v_slab,
                                                  flags, n, m, self_adv)
    if not on_card:
        return _advect_plain(bs, fulls, _flags(flags)[2], u, v, flags, dt, n,
                             None)
    side = n + 2
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(u.new_empty((m, side)) for _ in bs)
        d2, o2, b2 = ((fulls[1], outs[1], bs[1]) if len(bs) == 2
                      else (None, None, 0))
        co._launch("advect_slab_exact", lib.fsc_advect_slab_exact,
                   fulls[0].data_ptr(), co._ptr(d2), u.data_ptr(),
                   v.data_ptr(), outs[0].data_ptr(), co._ptr(o2), m, side,
                   bs[0], b2, co._dt0(dt, n), _flags(flags)[2],
                   *_wall_rows(flags, 0, m), co._stream(u))
        return outs


# ---------------------------------------------------------------------------
# B9e divergence_slab (K10), B9f gradient_slab (K11)
# ---------------------------------------------------------------------------


def _halo_checks(n, m, side, *halos) -> None:
    _require(side == n + 2, f"slab width {side} != n+2 = {n + 2}")
    for h in halos:
        _require(h.dim() == 2 and h.shape[0] >= 1 and h.shape[1] == side,
                 f"a halo is (k >= 1, {side}) rows, got {tuple(h.shape)}")


def divergence_slab_plain(u, v, vtop, vbot, flags, n):
    m, side = u.shape
    _halo_checks(n, m, side, vtop, vbot)
    return _divergence_plain(u, v, vtop[-1:], vbot[:1], n,
                             *_wall_rows(flags, 0, m))


def divergence_slab(u, v, vtop, vbot, flags, n):
    """Divergence (border mode 0) on (m, side) slabs; ``vtop``/``vbot``
    hold rows of the neighbouring slabs (any number >= 1; the row next to
    the slab is the last of ``vtop`` and the first of ``vbot``, as in JAX's
    (8, side) blocks).  One K10 launch."""
    m, side = u.shape
    _halo_checks(n, m, side, vtop, vbot)
    vtop, vbot = vtop[-1:], vbot[:1]
    if not _on_card((u, (m, side)), (v, (m, side)), (vtop, (1, side)),
                    (vbot, (1, side))):
        return divergence_slab_plain(u, v, vtop, vbot, flags, n)
    with torch.cuda.device(u.device):
        lib = build.load()
        out = torch.empty_like(u)
        co._launch("divergence_slab", lib.fsc_divergence_slab, u.data_ptr(),
                   v.data_ptr(), vtop.data_ptr(), vbot.data_ptr(),
                   out.data_ptr(), m, side, *_wall_rows(flags, 0, m),
                   -0.5 * grid_h(n), co._stream(u))
        return out


def gradient_slab_plain(u, v, p, ptop, pbot, flags, n):
    m, side = u.shape
    _halo_checks(n, m, side, ptop, pbot)
    return _gradient_plain(u, v, p, ptop[-1:], pbot[:1], n,
                           *_wall_rows(flags, 0, m))


def gradient_slab(u, v, p, ptop, pbot, flags, n):
    """Pressure-gradient subtraction (border modes 1 and 2) on (m, side)
    slabs, ``ptop``/``pbot`` as ``divergence_slab``'s halos.  One K11
    launch; returns the (u, v) slabs."""
    m, side = u.shape
    _halo_checks(n, m, side, ptop, pbot)
    ptop, pbot = ptop[-1:], pbot[:1]
    if not _on_card((u, (m, side)), (v, (m, side)), (p, (m, side)),
                    (ptop, (1, side)), (pbot, (1, side))):
        return gradient_slab_plain(u, v, p, ptop, pbot, flags, n)
    with torch.cuda.device(u.device):
        lib = build.load()
        uo = torch.empty_like(u)
        vo = torch.empty_like(v)
        co._launch("gradient_slab", lib.fsc_gradient_slab, u.data_ptr(),
                   v.data_ptr(), p.data_ptr(), ptop.data_ptr(),
                   pbot.data_ptr(), uo.data_ptr(), vo.data_ptr(), m, side,
                   *_wall_rows(flags, 0, m), grid_h(n), co._stream(u))
        return uo, vo


# ---------------------------------------------------------------------------
# The block route: K9-block, K12-block, K10-block, K11-block
# ---------------------------------------------------------------------------
#
# A block is the (m, k) part of the padded global grid at global origin
# ``origin = (r0, c0)``: block cell (r, c) is global cell (r0 + r, c0 + c).
# An extended block (m + 2K, k + 2K) adds K rows and columns on every side
# (``parallel.mesh.Blocks.ext``: the neighbours' cells, corners included,
# zeros beyond a wall), block cell (r, c) at ext cell (K + r, K + c).  A
# global ghost cell inside a block takes the border rule of its interior
# neighbour, which lies in the same block (blocks are at least 2 x 2), and
# the corners of the grid the rule of the edges just written (JAX's
# ``_apply_bnd_coords``).  JAX computes the block route in jnp
# (``parallel/sharded.py:45-595`` there); no pallas_call stands behind
# these four kernels.


def _block_bnd(b: int, x: torch.Tensor, r0: int, c0: int,
               n: int) -> torch.Tensor:
    """JAX's ``_apply_bnd_coords`` on a buffer whose cell (0, 0) is global
    cell (r0, c0), in place: the ghost columns and rows of the grid that
    fall inside it mirror their interior neighbour on the interior rows
    and columns, then each grid corner inside it averages the two edge
    cells next to it.  A ghost line on the buffer's rim, whose neighbour
    lies outside, is left as it is (a halo cell no kept cell reads)."""
    rows, cols = x.shape
    sx, sy = _signs(b)

    def at(g: int, lo: int, size: int) -> int | None:
        i = g - lo
        return i if 0 <= i < size else None

    ri = slice(min(max(1 - r0, 0), rows), max(min(n + 1 - r0, rows), 0))
    ci = slice(min(max(1 - c0, 0), cols), max(min(n + 1 - c0, cols), 0))
    for g, d in ((0, 1), (n + 1, -1)):
        c = at(g, c0, cols)
        if c is not None and 0 <= c + d < cols:
            x[ri, c] = sx * x[ri, c + d]
    for g, d in ((0, 1), (n + 1, -1)):
        r = at(g, r0, rows)
        if r is not None and 0 <= r + d < rows:
            x[r, ci] = sy * x[r + d, ci]
    for gr, dr in ((0, 1), (n + 1, -1)):
        for gc, dc in ((0, 1), (n + 1, -1)):
            r, c = at(gr, r0, rows), at(gc, c0, cols)
            if (r is not None and c is not None and 0 <= r + dr < rows
                    and 0 <= c + dc < cols):
                x[r, c] = 0.5 * (x[r, c + dc] + x[r + dr, c])
    return x


def _block_interior(rows: int, cols: int, r0: int, c0: int, n: int,
                    device) -> torch.Tensor:
    """The cells of a (rows, cols) buffer at global origin (r0, c0) that
    are global interior cells, rows and columns 1..n."""
    gr = torch.arange(r0, r0 + rows, device=device)[:, None]
    gc = torch.arange(c0, c0 + cols, device=device)[None, :]
    return (gr >= 1) & (gr <= n) & (gc >= 1) & (gc <= n)


def _block_sweeps_plain(b, x, rhs, r0, c0, n, alpha, beta, sweeps, *,
                        zero_init=False, fast=False, omegas=None, first=0,
                        xm=None, damp=None, stored=None):
    """JAX's ``_diffuse_local`` / ``_cheby_diffuse_local`` chunk on an
    extended block buffer at global origin (r0, c0): ``sweeps`` sweeps of
    the buffer's inner cells, each kept at the global interior cells, then
    the border rule (``_block_bnd``), every operation in the operands'
    dtype.  ``omegas`` (the whole solve's ``cheby_omegas``) makes the
    sweeps Chebyshev sweeps ``first`` to ``first + sweeps - 1`` of their
    solve, combined with x_{k-1} (``xm``; sweep 0 of the solve is plain and
    sweep 1 reads x_0), ``fast`` the reciprocal form with one rounding as
    ``fmaf`` (``cuda_ops._fma_diffuse``), ``damp`` damped Jacobi
    (``ops.multigrid._smooth``).  ``stored``, the storage dtype of the
    kernel a float32 run stands for (bf16), rounds the pre-scaled rhs and
    the damped weights to it, as K9-block's bf16 forms take them.  Returns
    (x, x_{k-1})."""
    rows, cols = rhs.shape
    if zero_init:
        x = torch.zeros_like(rhs)
    keep = _block_interior(rows, cols, r0, c0, n, rhs.device)[1:-1, 1:-1]
    if fast:
        rhs = rhs * (1.0 / beta)
        if stored is not None:
            rhs = rhs.to(stored).to(rhs.dtype)
        ab = co._f32(alpha / beta)
    a, bt = as_scalar(alpha, rhs), as_scalar(beta, rhs)
    rhs_in = rhs[1:-1, 1:-1]
    if damp is not None:
        wdt = rhs.dtype if stored is None else stored
        wd, omw = (as_scalar(co._round(w, wdt), rhs)
                   for w in (damp, 1.0 - damp))
    if first == 0:
        xm = x
    for j in range(first, first + sweeps):
        neigh = ((x[1:-1, :-2] + x[1:-1, 2:]) + x[:-2, 1:-1]) + x[2:, 1:-1]
        if fast:
            val = (rhs_in.double() + ab * neigh.double()).to(rhs.dtype)
        else:
            val = (rhs_in + a * neigh) / bt
        if damp is not None:
            val = omw * x[1:-1, 1:-1] + wd * val
        if omegas is not None and j >= 1:
            wc = as_scalar(omegas[j - 1], rhs)
            val = wc * val + (1.0 - wc) * xm[1:-1, 1:-1]
        new = x.clone()
        new[1:-1, 1:-1] = torch.where(keep, val, x[1:-1, 1:-1])
        _block_bnd(b, new, r0, c0, n)
        xm, x = x, new
    return x, xm


def _storage(*tensors) -> torch.dtype:
    """The one storage dtype of the given operands (None skipped): float32
    or bf16, the block forms' two.  Any other dtype or a mix raises
    ``TypeError``."""
    dtypes = {t.dtype for t in tensors if t is not None}
    if len(dtypes) > 1:
        raise TypeError(f"mixed dtypes {sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    if dtype not in co._F32_BF16:
        raise TypeError(f"expected torch.float32 or torch.bfloat16, got "
                        f"{dtype}")
    return dtype


def _wide(t):
    """A storage operand widened to float32 (itself in float32), None
    kept: a kernel's loads."""
    return None if t is None else t.float()


def _block_checks(x_ext, rhs_ext, xm_ext, origin, n, m, k, K,
                  sweeps) -> bool:
    r0, c0 = origin
    _require(sweeps >= 1, "sweeps must be >= 1")
    _require(K >= sweeps, f"a {K}-deep halo is valid for at most {K} "
             f"sweeps, got {sweeps}")
    _require(m >= 2 and k >= 2 and 0 <= r0 and r0 + m <= n + 2
             and 0 <= c0 and c0 + k <= n + 2,
             f"an {m} x {k} block at {origin} is not inside the "
             f"{n + 2}-cell grid (blocks are at least 2 x 2)")
    ext = (m + 2 * K, k + 2 * K)
    if ext[0] * ext[1] >= 2**31:
        raise ValueError(f"unsupported block buffer {ext}")
    dtype = _storage(rhs_ext, x_ext, xm_ext)
    return co._on_device(*((t, ext, (dtype,)) for t in (rhs_ext, x_ext,
                                                        xm_ext)
                           if t is not None))


def fused_jacobi_block_ref(b, x_ext, rhs_ext, origin, *, n, m, k, K, alpha,
                           beta, sweeps, zero_init=False, fast=False,
                           omegas=None, first=0, xm_ext=None):
    """The ``reference`` backend's chunk (JAX's jnp ``_diffuse_local`` /
    ``_cheby_diffuse_local`` chunk): every operation in the storage dtype,
    so in bf16 each one rounds to bf16 as JAX's do; in float32
    ``fused_jacobi_block_plain`` to the bit."""
    _block_checks(None if zero_init else x_ext, rhs_ext, xm_ext, origin, n,
                  m, k, K, sweeps)
    r0, c0 = origin
    x, xm = _block_sweeps_plain(b, x_ext, rhs_ext, r0 - K, c0 - K, n, alpha,
                                beta, sweeps, zero_init=zero_init, fast=fast,
                                omegas=omegas, first=first, xm=xm_ext)
    x = x[K:K + m, K:K + k]
    return x if omegas is None else (x, xm[K:K + m, K:K + k])


def fused_jacobi_block_plain(b, x_ext, rhs_ext, origin, *, n, m, k, K, alpha,
                             beta, sweeps, zero_init=False, fast=False,
                             omegas=None, first=0, xm_ext=None):
    """Plain twin of ``fused_jacobi_block``: its arithmetic in float32
    torch ops, and in bf16 storage its roundings: the operands widened, the
    pre-scaled rhs of the fast form rounded to bf16, the sweeps in float32
    and x_k (and x_{k-1}) rounded to bf16 at the chunk's end."""
    _block_checks(None if zero_init else x_ext, rhs_ext, xm_ext, origin, n,
                  m, k, K, sweeps)
    dtype = rhs_ext.dtype
    r0, c0 = origin
    x, xm = _block_sweeps_plain(
        b, _wide(x_ext), _wide(rhs_ext), r0 - K, c0 - K, n, alpha, beta,
        sweeps, zero_init=zero_init, fast=fast, omegas=omegas, first=first,
        xm=_wide(xm_ext), stored=dtype)
    x = x[K:K + m, K:K + k].to(dtype)
    return x if omegas is None else (x, xm[K:K + m, K:K + k].to(dtype))


def fused_jacobi_block(b, x_ext, rhs_ext, origin, *, n, m, k, K, alpha, beta,
                       sweeps, zero_init=False, fast=False, omegas=None,
                       first=0, xm_ext=None):
    """``sweeps`` Jacobi sweeps of one chunk of a block solve (JAX's
    ``_diffuse_local`` chunk) on the ``(m+2K, k+2K)`` extended block
    ``x_ext`` (ignored with ``zero_init``: the zero guess) with the
    extended rhs ``rhs_ext``, at global origin ``origin`` of the block;
    ``fast`` takes the reciprocal form (the rhs pre-scaled in the launch).
    With ``omegas`` (the solve's ``cheby_omegas``) the chunk runs sweeps
    ``first`` .. ``first + sweeps - 1`` of a Chebyshev solve (JAX's
    ``_cheby_diffuse_local``): sweep 0 is plain and its x_0 is x_{-1}, a
    later chunk combines with ``xm_ext``, the extended x_{k-1} the chunk
    before it returned.  Every operand float32, or every one bf16 (the
    bf16 form: the iterate float32 in the tile, x_k and x_{k-1} rounded to
    bf16 at the store).  One K9-block launch (``jacobi_block_sweeps``, in
    bf16 ``jacobi_block_sweeps_bf16``); returns the (m, k) block, with
    ``omegas`` (x_k, x_{k-1})."""
    _require(omegas is None or first == 0 or xm_ext is not None,
             "a Chebyshev chunk after the first takes x_{k-1} (xm_ext)")
    if not _block_checks(None if zero_init else x_ext, rhs_ext, xm_ext,
                         origin, n, m, k, K, sweeps):
        return fused_jacobi_block_plain(
            b, x_ext, rhs_ext, origin, n=n, m=m, k=k, K=K, alpha=alpha,
            beta=beta, sweeps=sweeps, zero_init=zero_init, fast=fast,
            omegas=omegas, first=first, xm_ext=xm_ext)
    flags = ((co._PREP | co._FAST) if fast else 0) | (
        co._CHEBY if omegas is not None else 0)
    ws = [co._f32(omegas[j - 1]) if omegas is not None and j >= 1 else 0.0
          for j in range(first, first + sweeps)]
    out = _launch_block(b, None if zero_init else x_ext, rhs_ext,
                        xm_ext if first > 0 else None, origin, n, m, k, K,
                        alpha, beta, sweeps, flags, first, ws,
                        omegas is not None)
    return out if omegas is not None else out[0]


def smooth_block_ref(p_ext, div_ext, origin, *, n, m, k, K, sweeps,
                     zero_init=False):
    """The ``reference`` backend's damped chunk (JAX's ``_mg_smooth_local``
    sweeps): every operation in the storage dtype, w and 1-w in it; in
    float32 ``smooth_block_plain`` to the bit."""
    _block_checks(None if zero_init else p_ext, div_ext, None, origin, n, m,
                  k, K, sweeps)
    r0, c0 = origin
    x, _ = _block_sweeps_plain(0, p_ext, div_ext, r0 - K, c0 - K, n, 1.0, 4.0,
                               sweeps, zero_init=zero_init, damp=OMEGA)
    return x[K:K + m, K:K + k]


def smooth_block_plain(p_ext, div_ext, origin, *, n, m, k, K, sweeps,
                       zero_init=False):
    """Plain twin of ``smooth_block``: float32 sweeps, and in bf16
    storage w and 1-w rounded to bf16 and the result rounded once, at the
    chunk's end."""
    _block_checks(None if zero_init else p_ext, div_ext, None, origin, n, m,
                  k, K, sweeps)
    dtype = div_ext.dtype
    r0, c0 = origin
    x, _ = _block_sweeps_plain(0, _wide(p_ext), _wide(div_ext), r0 - K,
                               c0 - K, n, 1.0, 4.0, sweeps,
                               zero_init=zero_init, damp=OMEGA, stored=dtype)
    return x[K:K + m, K:K + k].to(dtype)


def smooth_block(p_ext, div_ext, origin, *, n, m, k, K, sweeps,
                 zero_init=False):
    """``sweeps`` damped sweeps of the pressure problem (b=0, alpha=1,
    beta=4, w = ``ops.multigrid.OMEGA``; JAX's ``_mg_smooth_local``, one
    one-cell exchange a sweep there) on the ``(m+2K, k+2K)`` extended
    block ``p_ext`` (ignored with ``zero_init``) with rhs ``div_ext``:
    K9-block's damped form, one launch; returns the (m, k) block.  In bf16
    storage (both operands) w and 1-w are taken in bf16, as JAX takes
    them in p's dtype, and the result is rounded to bf16 once, at the
    store."""
    if not _block_checks(None if zero_init else p_ext, div_ext, None,
                         origin, n, m, k, K, sweeps):
        return smooth_block_plain(p_ext, div_ext, origin, n=n, m=m, k=k, K=K,
                                  sweeps=sweeps, zero_init=zero_init)
    return _launch_block(0, None if zero_init else p_ext, div_ext, None,
                         origin, n, m, k, K, 1.0, 4.0, sweeps, co._DAMP, 0,
                         [0.0] * sweeps, False)[0]


def _block_tile(rows: int, cols: int) -> int:
    """The tiled K9's tile rows for a block buffer: ``cuda_ops``'s
    ``SLAB_TILINGS`` by the buffer's cells (64 rows from 2 M cells, else
    32), or what ``launch_sweeps(t, tile_rows=h)`` forces."""
    if co._forced_tile is not None:
        return co._forced_tile
    return next(tile for least, _, tile in co.SLAB_TILINGS
                if rows * cols >= least)


def _launch_block(b, x_ext, rhs_ext, xm_ext, origin, n, m, k, K, alpha,
                  beta, sweeps, flags, first, ws, cheby):
    """One K9-block launch: (x, x_{k-1} or None) of the (m, k) block, in
    the operands' storage dtype (bf16: the bf16 form, whose damped weights
    are rounded to bf16 here)."""
    r0, c0 = origin
    rows, cols = m + 2 * K, k + 2 * K
    bf16 = rhs_ext.dtype == torch.bfloat16
    name = "jacobi_block_sweeps_bf16" if bf16 else "jacobi_block_sweeps"
    wdt = torch.bfloat16 if bf16 else torch.float32
    with torch.cuda.device(rhs_ext.device):
        lib = build.load()
        out = rhs_ext.new_empty((m, k))
        xm_out = rhs_ext.new_empty((m, k)) if cheby else None
        omegas = (ctypes.c_float * sweeps)(*ws)
        damp = flags & co._DAMP
        co._launch(name, getattr(lib, f"fsc_{name}"),
                   co._ptr(x_ext), rhs_ext.data_ptr(), co._ptr(xm_ext),
                   out.data_ptr(), co._ptr(xm_out), rows, cols, K, m, k,
                   r0 - K, c0 - K, n, b, co._f32(alpha), co._f32(beta),
                   co._f32(alpha / beta), co._f32(1.0 / beta),
                   co._round(OMEGA, wdt) if damp else 0.0,
                   co._round(1.0 - OMEGA, wdt) if damp else 0.0,
                   ctypes.addressof(omegas), flags, first, sweeps,
                   _block_tile(rows, cols), co._stream(rhs_ext))
        return out, xm_out


# The grouped K9-block: a chunk over every block of a device in one launch
# (``jacobi_block_group``), its halo read from the neighbours' own arrays.


def _groups(xs) -> dict:
    """The indices of the parts ``xs`` by device, in mesh order."""
    out: dict[torch.device, list[int]] = {}
    for i, x in enumerate(xs):
        out.setdefault(x.device, []).append(i)
    return out


def _blocks_checks(blocks, xs, rhs, xms, K, sweeps, n) -> bool:
    """The grouped chunk's operands: a list of ``blocks``' (m, k) blocks
    each (x none for the zero guess, x_{k-1} none outside a chained
    Chebyshev chunk), one storage dtype, a halo no deeper than a block and
    at least the chunk's sweeps.  True where every block lies on a card,
    False where every one lies on the CPU; a mix raises."""
    m, k = blocks.m, blocks.k
    _require(sweeps >= 1, "sweeps must be >= 1")
    _require(K >= sweeps, f"a {K}-deep halo is valid for at most {K} "
             f"sweeps, got {sweeps}")
    _require(m >= 2 and k >= 2 and K <= m and K <= k,
             f"a {K}-deep halo on {m} x {k} blocks (blocks are at least "
             f"2 x 2, the halo no deeper than a block)")
    _require(blocks.side == n + 2, f"blocks of a {blocks.side}-cell grid "
             f"for n = {n}")
    parts = [p for p in (xs, rhs, xms) if p is not None]
    _require(all(len(p) == blocks.px * blocks.py for p in parts),
             f"expected {blocks.px * blocks.py} blocks an operand")
    dtype = _storage(*(t for p in parts for t in p))
    on_card = {co._on_device(*((p[i], (m, k), (dtype,)) for p in parts
                               for i in idx))
               for idx in _groups(rhs).values()}
    _require(len(on_card) == 1, "blocks on the card and on the CPU at once")
    return on_card.pop()


def fused_jacobi_blocks_plain(blocks, b, xs, rhs, *, n, K, alpha, beta,
                              sweeps, zero_init=False, fast=False,
                              omegas=None, first=0, xms=None):
    """Plain twin of ``fused_jacobi_blocks``: JAX's composition, every
    block extended by ``blocks.ext`` (x, the rhs and x_{k-1}), then
    ``fused_jacobi_block_plain`` on each."""
    _blocks_checks(blocks, None if zero_init else xs, rhs,
                   xms if omegas is not None and first > 0 else None, K,
                   sweeps, n)
    none = [None] * len(rhs)
    x_ext = none if zero_init else blocks.ext(xs, K)
    xm_ext = (blocks.ext(xms, K) if omegas is not None and first > 0
              else none)
    out = [fused_jacobi_block_plain(
        b, xe, re, o, n=n, m=blocks.m, k=blocks.k, K=K, alpha=alpha,
        beta=beta, sweeps=sweeps, zero_init=zero_init, fast=fast,
        omegas=omegas, first=first, xm_ext=xme)
        for xe, re, xme, o in zip(x_ext, blocks.ext(rhs, K), xm_ext,
                                  blocks.origins)]
    if omegas is None:
        return out
    return [q[0] for q in out], [q[1] for q in out]


def fused_jacobi_blocks(blocks, b, xs, rhs, *, n, K, alpha, beta, sweeps,
                        zero_init=False, fast=False, omegas=None, first=0,
                        xms=None):
    """``fused_jacobi_block``'s chunk on every block of ``blocks`` at once
    (JAX's ``_diffuse_local`` / ``_cheby_diffuse_local`` chunk after its
    ``_extend_deep``): ``xs`` and ``rhs`` the lists of (m, k) blocks (``xs``
    ignored with ``zero_init``), ``K`` the halo the chunk's exchange would
    build, ``xms`` the x_{k-1} the chunk before returned (read where
    ``first > 0`` with ``omegas``).  One grouped K9-block launch a device
    (``jacobi_block_group``, in bf16 ``jacobi_block_group_bf16``; at most
    ``cuda_ops.GROUP_BLOCKS`` blocks a launch), each block's halo read from
    its neighbours' own arrays (or copies of their strips where they lie
    on another device): no extended block is built.  Every output is a
    fresh tensor, so each block reads its neighbours as the chunk before
    left them.  Returns the list of x blocks, with ``omegas`` (x_k blocks,
    x_{k-1} blocks).  Bit for bit ``fused_jacobi_blocks_plain``."""
    _require(omegas is None or first == 0 or xms is not None,
             "a Chebyshev chunk after the first takes x_{k-1} (xms)")
    chained = omegas is not None and first > 0
    if not _blocks_checks(blocks, None if zero_init else xs, rhs,
                          xms if chained else None, K, sweeps, n):
        return fused_jacobi_blocks_plain(
            blocks, b, xs, rhs, n=n, K=K, alpha=alpha, beta=beta,
            sweeps=sweeps, zero_init=zero_init, fast=fast, omegas=omegas,
            first=first, xms=xms)
    flags = ((co._PREP | co._FAST) if fast else 0) | (
        co._CHEBY if omegas is not None else 0)
    ws = [co._f32(omegas[j - 1]) if omegas is not None and j >= 1 else 0.0
          for j in range(first, first + sweeps)]
    out, xm_out = _launch_groups(
        blocks, b, None if zero_init else xs, rhs,
        xms if chained else None, n, K, alpha, beta, sweeps, flags, first,
        ws, omegas is not None)
    return out if omegas is None else (out, xm_out)


def smooth_blocks_plain(blocks, ps, divs, *, n, K, sweeps, zero_init=False):
    """Plain twin of ``smooth_blocks``: ``blocks.ext`` of p and div, then
    ``smooth_block_plain`` on each block."""
    _blocks_checks(blocks, None if zero_init else ps, divs, None, K, sweeps,
                   n)
    p_ext = [None] * len(divs) if zero_init else blocks.ext(ps, K)
    return [smooth_block_plain(pe, de, o, n=n, m=blocks.m, k=blocks.k, K=K,
                               sweeps=sweeps, zero_init=zero_init)
            for pe, de, o in zip(p_ext, blocks.ext(divs, K), blocks.origins)]


def smooth_blocks(blocks, ps, divs, *, n, K, sweeps, zero_init=False):
    """``smooth_block``'s damped chunk on every block of ``blocks`` at once
    (JAX's ``_mg_smooth_local`` sweeps): one grouped K9-block launch a
    device in its damped form, as ``fused_jacobi_blocks``.  Bit for bit
    ``smooth_blocks_plain``."""
    if not _blocks_checks(blocks, None if zero_init else ps, divs, None, K,
                          sweeps, n):
        return smooth_blocks_plain(blocks, ps, divs, n=n, K=K, sweeps=sweeps,
                                   zero_init=zero_init)
    return _launch_groups(blocks, 0, None if zero_init else ps, divs, None,
                          n, K, 1.0, 4.0, sweeps, co._DAMP, 0,
                          [0.0] * sweeps, False)[0]


def block_group_tile(cells: int) -> int:
    """The tile rows of a grouped K9-block launch over ``cells`` block
    cells: ``cuda_ops.BLOCK_GROUP_TILES``' first whose cells the launch
    reaches; ``launch_sweeps(t, tile_rows=h)`` forces ``h``."""
    return co._forced_tile or next(tile for least, tile in
                                   co.BLOCK_GROUP_TILES if cells >= least)


def _regions(blocks, xs, i: int, K: int, copy: bool = False):
    """The nine region sources of block i's extended buffer in the blocks
    ``xs`` (``csrc/jacobi_tiles.cu``'s GroupBlock): (address, copied,
    tensor to keep alive) each, region ``3*di + dj`` for the rows and
    columns before (0), in (1) and after (2) the block; the neighbour's own
    array where it lies on block i's device (unless ``copy``), else a copy
    of its cells there; None beyond a wall."""
    m, k = blocks.m, blocks.k
    bi, bj = divmod(i, blocks.py)
    dev = xs[i].device
    rows = (slice(m - K, m), slice(0, m), slice(0, K))
    cols = (slice(k - K, k), slice(0, k), slice(0, K))
    out = []
    for di in range(3):
        for dj in range(3):
            nb = blocks._at(bi + di - 1, bj + dj - 1)
            if nb is None:
                out.append((None, False, None))
                continue
            x = xs[nb]
            if nb == i or (x.device == dev and not copy):
                out.append((x.data_ptr() + (rows[di].start * k
                                            + cols[dj].start)
                            * x.element_size(), False, None))
                continue
            strip = x[rows[di], cols[dj]].to(dev, copy=True).contiguous()
            out.append((strip.data_ptr(), True, strip))
    return out


def _launch_groups(blocks, b, xs, rhs, xms, n, K, alpha, beta, sweeps, flags,
                   first, ws, cheby):
    """The grouped chunk on every device's blocks: (x blocks, x_{k-1}
    blocks or None), in the operands' storage dtype (bf16: the bf16 form,
    its damped weights rounded to bf16 here)."""
    bf16 = rhs[0].dtype == torch.bfloat16
    name = "jacobi_block_group_bf16" if bf16 else "jacobi_block_group"
    wdt = torch.bfloat16 if bf16 else torch.float32
    damp = flags & co._DAMP
    outs = [torch.empty_like(r) for r in rhs]
    xm_outs = [torch.empty_like(r) for r in rhs] if cheby else None
    lib = build.load()
    omegas = (ctypes.c_float * sweeps)(*ws)
    for dev, idx in _groups(rhs).items():
        with torch.cuda.device(dev):
            for lo in range(0, len(idx), co.GROUP_BLOCKS):
                group = idx[lo:lo + co.GROUP_BLOCKS]
                # keep: each copy stays alive until the launch that reads
                # it is enqueued (a copy freed before could lend its memory
                # to the next).
                ptrs, ints, keep = [], [], []
                for i in group:
                    srcs = [_regions(blocks, part, i, K)
                            if part is not None else [(None, False, None)] * 9
                            for part in (xs, rhs, xms)]
                    for src in srcs:
                        ptrs += [a for a, _, _ in src]
                        keep += [t for _, _, t in src if t is not None]
                    ptrs += [outs[i].data_ptr(),
                             None if xm_outs is None
                             else xm_outs[i].data_ptr()]
                    r0, c0 = blocks.origins[i]
                    ints += [r0, c0, sum(1 << r for r, (_, c, _) in
                                         enumerate(srcs[1]) if c)]
                table = (ctypes.c_void_p * len(ptrs))(*ptrs)
                int_table = (ctypes.c_int * len(ints))(*ints)
                co._launch(name, getattr(lib, f"fsc_{name}"),
                           ctypes.addressof(table),
                           ctypes.addressof(int_table), len(ints) // 3,
                           blocks.m, blocks.k, K, n, b, co._f32(alpha),
                           co._f32(beta), co._f32(alpha / beta),
                           co._f32(1.0 / beta),
                           co._round(OMEGA, wdt) if damp else 0.0,
                           co._round(1.0 - OMEGA, wdt) if damp else 0.0,
                           ctypes.addressof(omegas), flags, first, sweeps,
                           block_group_tile(len(group) * blocks.m * blocks.k),
                           co._stream(rhs[idx[0]]))
    return outs, xm_outs


def _advect_block_plain(bs, bufs, buf_origin, u, v, origin, dt, n, cmax):
    """The gather (windowed with ``cmax``, exact with None) of each field
    of ``bufs`` (cell (0, 0) at global ``buf_origin``) at the cells of the
    (m, k) block at ``origin``, then the border rule.  The backtrace and
    the blend are float32 whatever the fields store, and each result is
    rounded to its field's dtype (``ops.advect.departure``, ``bilinear``);
    the border rule after that rounding moves, negates or averages equal
    values and rounds nothing more."""
    r0, c0 = origin
    m, k = u.shape
    gr = torch.arange(r0, r0 + m, dtype=torch.float32,
                      device=u.device)[:, None]
    gc = torch.arange(c0, c0 + k, dtype=torch.float32, device=u.device)[None]
    x, y = departure(u, v, gc, gr, dt, n, cmax)
    return tuple(_block_bnd(b, bilinear(f, x, y, *buf_origin), r0, c0, n)
                 for b, f in zip(bs, bufs))


def _advect_block_args(bs, bufs, u, v, origin, n, m, k, halo, self_adv):
    """(bs, bufs, u, v, on_card) after the checks; ``halo`` None for the
    assembled (side, side) fields.  With ``self_adv`` u and v are the
    block's cells of the two fields, views into them (row stride the
    buffer's width).  Every field and velocity float32, or every one
    bf16."""
    bs, bufs = tuple(bs), tuple(bufs)
    r0, c0 = origin
    _require(len(bs) == len(bufs) and len(bs) in (1, 2),
             "a block gather takes one or two fields")
    _require(m >= 2 and k >= 2 and 0 <= r0 and r0 + m <= n + 2
             and 0 <= c0 and c0 + k <= n + 2,
             f"an {m} x {k} block at {origin} is not inside the "
             f"{n + 2}-cell grid (blocks are at least 2 x 2)")
    shape = ((n + 2, n + 2) if halo is None
             else (m + 2 * halo, k + 2 * halo))
    if shape[0] * shape[1] >= 2**31:
        raise ValueError(f"unsupported block buffer {shape}")
    dtype = (_storage(*bufs) if self_adv
             else _storage(*bufs, u, v))
    specs = [(f, shape, (dtype,)) for f in bufs]
    if self_adv:
        _require(len(bs) == 2, "self_adv advects the (u, v) pair")
        at = (r0, c0) if halo is None else (halo, halo)
        u, v = (f[at[0]:at[0] + m, at[1]:at[1] + k] for f in bufs)
    else:
        specs += [(u, (m, k), (dtype,)), (v, (m, k), (dtype,))]
    return bs, bufs, u, v, co._on_device(*specs)


def advect_block_plain(bs, exts, u_block, v_block, origin, *, dt, n, cmax,
                       m, k, self_adv):
    """Plain twin of ``advect_block``, and the ``reference`` backend's
    windowed gather: in bf16 the coordinates and the blend are float32 as
    the kernel computes them, as JAX's single-device ``advect_windowed``
    does; JAX's block route computes them in bf16 (ROADMAP §C)."""
    halo = (exts[0].shape[0] - m) // 2
    bs, exts, u, v, _ = _advect_block_args(bs, exts, u_block, v_block,
                                           origin, n, m, k, halo, self_adv)
    _require(halo >= cmax + 1, f"the gather needs a halo of cmax+1 = "
             f"{cmax + 1}, got {halo}")
    r0, c0 = origin
    return _advect_block_plain(bs, exts, (r0 - halo, c0 - halo), u, v,
                               origin, dt, n, cmax)


def advect_block(bs, exts, u_block, v_block, origin, *, dt, n, cmax, m, k,
                 self_adv):
    """Windowed advection of one or two fields of the (m, k) block at
    ``origin`` from their extended copies ``exts`` (``(m + 2*halo, k +
    2*halo)``, ``halo >= cmax+1``; JAX's ``_advect_local_windowed``, whose
    (2*cmax+1)² masked shifts read what one gather reads after the window
    clamp).  ``u_block``/``v_block`` are the (m, k) velocity blocks,
    ignored with ``self_adv`` (the u/v pair, one shared backtrace).
    Float32, or bf16 fields and velocities (the bf16 form: the backtrace
    and the blend float32, each result rounded to bf16).  One K12-block
    launch (``advect_block``, ``advect_block_bf16``); returns a tuple of
    (m, k) blocks."""
    halo = (exts[0].shape[0] - m) // 2
    bs, exts, u, v, on_card = _advect_block_args(
        bs, exts, u_block, v_block, origin, n, m, k, halo, self_adv)
    _require(halo >= cmax + 1 and exts[0].shape[0] == m + 2 * halo,
             f"the gather needs a halo of cmax+1 = {cmax + 1}, got {halo}")
    r0, c0 = origin
    if not on_card:
        return _advect_block_plain(bs, exts, (r0 - halo, c0 - halo), u, v,
                                   origin, dt, n, cmax)
    return _launch_advect_block("advect_block", bs, exts, u, v, origin, n, m,
                                k, halo, dt, cmax)


def advect_block_exact_plain(bs, fulls, u_block, v_block, origin, *, dt, n,
                             m, k, self_adv):
    """Plain twin of ``advect_block_exact``, and the ``reference``
    backend's exact gather: float32 coordinates and blend in bf16 too
    (``advect_block_plain``)."""
    bs, fulls, u, v, _ = _advect_block_args(bs, fulls, u_block, v_block,
                                            origin, n, m, k, None, self_adv)
    return _advect_block_plain(bs, fulls, (0, 0), u, v, origin, dt, n, None)


def advect_block_exact(bs, fulls, u_block, v_block, origin, *, dt, n, m, k,
                       self_adv):
    """Exact advection of one or two fields of the (m, k) block at
    ``origin``, gathered from the assembled (side, side) fields ``fulls``
    at global coordinates (JAX's ``_advect_local``, after its all-gather):
    any displacement gathers as the single-device step does.
    ``u_block``/``v_block`` and the dtypes as ``advect_block``'s.  One
    launch of K12-block's exact form (``advect_block_exact``,
    ``advect_block_exact_bf16``); returns a tuple of (m, k) blocks."""
    bs, fulls, u, v, on_card = _advect_block_args(
        bs, fulls, u_block, v_block, origin, n, m, k, None, self_adv)
    if not on_card:
        return _advect_block_plain(bs, fulls, (0, 0), u, v, origin, dt, n,
                                   None)
    return _launch_advect_block("advect_block_exact", bs, fulls, u, v,
                                origin, n, m, k, 0, dt, 0)


def _launch_advect_block(name, bs, bufs, u, v, origin, n, m, k, halo, dt,
                         cmax):
    """One K12-block launch; u and v may be views with a row stride (the
    u/v pair's own cells in its buffers).  bf16 fields take the bf16
    form."""
    r0, c0 = origin
    count = f"{name}_bf16" if u.dtype == torch.bfloat16 else name
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(u.new_empty((m, k)) for _ in bs)
        d2, o2, b2 = ((bufs[1], outs[1], bs[1]) if len(bs) == 2
                      else (None, None, 0))
        exact = name == "advect_block_exact"
        co._launch(count, getattr(lib, f"fsc_{count}"), bufs[0].data_ptr(),
                   co._ptr(d2), u.data_ptr(), v.data_ptr(), u.stride(0),
                   outs[0].data_ptr(), co._ptr(o2), m, k, n, r0, c0,
                   *(() if exact else (halo, cmax)), bs[0], b2,
                   co._dt0(dt, n), co._stream(u))
        return outs


def _ext1(x: torch.Tensor, halos) -> torch.Tensor:
    """JAX's ``_extend``: the (m+2, k+2) block with its one-deep halos
    (zeros where None and at the four corner cells, which the 5-point
    stencil never reads)."""
    top, bot, left, right = halos
    m, k = x.shape
    out = x.new_zeros((m + 2, k + 2))
    out[1:-1, 1:-1] = x
    for sl, h in (((0, slice(1, -1)), top), ((-1, slice(1, -1)), bot),
                  ((slice(1, -1), 0), left), ((slice(1, -1), -1), right)):
        if h is not None:
            out[sl] = h.reshape(-1)
    return out


def _halo_checks_block(x, halos, origin, n) -> list:
    """Each halo of a block (top, bottom: (1, k); left, right: (m,)), None
    only beyond a global wall; returns the specs of those given, each in
    ``x``'s dtype."""
    m, k = x.shape
    r0, c0 = origin
    walls = (r0 == 0, r0 + m == n + 2, c0 == 0, c0 + k == n + 2)
    shapes = ((1, k), (1, k), (m,), (m,))
    specs = []
    for h, wall, shape in zip(halos, walls, shapes):
        _require(h is not None or wall,
                 "a block's halo may be None only beyond a wall")
        if h is not None:
            specs.append((h, shape, (x.dtype,)))
    return specs


def _wides(halos) -> tuple:
    return tuple(map(_wide, halos))


def _divergence_block(u, v, u_halos, v_halos, origin, n):
    """JAX's ``_divergence_local`` in the operands' dtype: h and
    ``-0.5*h`` taken in it (``ops.project._h``)."""
    ue, ve = _ext1(u, u_halos), _ext1(v, v_halos)
    d = (as_scalar(-0.5, u) * _h(n, u)) * ((ue[1:-1, 2:] - ue[1:-1, :-2])
                                           + (ve[2:, 1:-1] - ve[:-2, 1:-1]))
    return _block_bnd(0, d, *origin, n)


def divergence_block_ref(u, v, u_halos, v_halos, origin, n):
    """The ``reference`` backend's divergence: every operation in the
    storage dtype, as JAX's; in float32 ``divergence_block_plain``."""
    _storage(u, v, *u_halos, *v_halos)
    return _divergence_block(u, v, u_halos, v_halos, origin, n)


def divergence_block_plain(u, v, u_halos, v_halos, origin, n):
    """Plain twin of ``divergence_block``: float32 arithmetic, the result
    rounded to the storage dtype once."""
    _storage(u, v, *u_halos, *v_halos)
    return _divergence_block(_wide(u), _wide(v), _wides(u_halos),
                             _wides(v_halos), origin, n).to(u.dtype)


def divergence_block(u, v, u_halos, v_halos, origin, n):
    """JAX's ``_divergence_local`` on the (m, k) block at ``origin``:
    ``(-0.5*h)*((u_r - u_l) + (v_dn - v_up))``, border mode 0, its
    neighbour cells from the one-deep halos (``parallel.mesh.Blocks.halos``:
    (top, bottom, left, right); the divergence reads u's columns and v's
    rows).  Float32, or bf16 u, v and halos (the bf16 form: float32
    arithmetic, a bf16 divergence as JAX's block route writes).  One
    K10-block launch (``divergence_block``, ``divergence_block_bf16``)."""
    m, k = u.shape
    dtype = _storage(u, v)
    specs = (_halo_checks_block(u, u_halos, origin, n)[2:]
             + _halo_checks_block(v, v_halos, origin, n)[:2])
    if not co._on_device((u, (m, k), (dtype,)), (v, (m, k), (dtype,)),
                         *specs):
        return divergence_block_plain(u, v, u_halos, v_halos, origin, n)
    name = ("divergence_block_bf16" if u.dtype == torch.bfloat16
            else "divergence_block")
    with torch.cuda.device(u.device):
        lib = build.load()
        out = torch.empty_like(u)
        co._launch(name, getattr(lib, f"fsc_{name}"),
                   u.data_ptr(), v.data_ptr(), co._ptr(u_halos[2]),
                   co._ptr(u_halos[3]), co._ptr(v_halos[0]),
                   co._ptr(v_halos[1]), out.data_ptr(), m, k, n, *origin,
                   -0.5 * grid_h(n), co._stream(u))
        return out


def _gradient_block(u, v, p, p_halos, origin, n):
    """JAX's ``_gradient_local`` in the operands' dtype (h in it)."""
    pe = _ext1(p, p_halos)
    h = _h(n, u)
    uo = u - (0.5 * (pe[1:-1, 2:] - pe[1:-1, :-2])) / h
    vo = v - (0.5 * (pe[2:, 1:-1] - pe[:-2, 1:-1])) / h
    return _block_bnd(1, uo, *origin, n), _block_bnd(2, vo, *origin, n)


def gradient_block_ref(u, v, p, p_halos, origin, n):
    """The ``reference`` backend's gradient: every operation in the
    storage dtype, as JAX's; in float32 ``gradient_block_plain``."""
    _storage(u, v, p, *p_halos)
    return _gradient_block(u, v, p, p_halos, origin, n)


def gradient_block_plain(u, v, p, p_halos, origin, n):
    """Plain twin of ``gradient_block``: float32 arithmetic, u and v
    rounded to the storage dtype once."""
    _storage(u, v, p, *p_halos)
    uo, vo = _gradient_block(_wide(u), _wide(v), _wide(p), _wides(p_halos),
                             origin, n)
    return uo.to(u.dtype), vo.to(u.dtype)


def gradient_block(u, v, p, p_halos, origin, n):
    """JAX's ``_gradient_local`` on the (m, k) block at ``origin``: ``u -
    (0.5*dp/dx)/h``, ``v - (0.5*dp/dy)/h``, border modes 1 and 2, p's
    neighbour cells from its one-deep halos.  Float32, or bf16 u, v, p
    and halos (the bf16 form: float32 arithmetic, bf16 u and v).  One
    K11-block launch (``gradient_block``, ``gradient_block_bf16``);
    returns the (u, v) blocks."""
    m, k = u.shape
    dtype = _storage(u, v, p)
    specs = _halo_checks_block(p, p_halos, origin, n)
    if not co._on_device((u, (m, k), (dtype,)), (v, (m, k), (dtype,)),
                         (p, (m, k), (dtype,)), *specs):
        return gradient_block_plain(u, v, p, p_halos, origin, n)
    name = ("gradient_block_bf16" if u.dtype == torch.bfloat16
            else "gradient_block")
    with torch.cuda.device(u.device):
        lib = build.load()
        uo = torch.empty_like(u)
        vo = torch.empty_like(v)
        co._launch(name, getattr(lib, f"fsc_{name}"), u.data_ptr(),
                   v.data_ptr(), p.data_ptr(), *map(co._ptr, p_halos),
                   uo.data_ptr(), vo.data_ptr(), m, k, n, *origin,
                   grid_h(n), co._stream(u))
        return uo, vo


# ---------------------------------------------------------------------------
# K11-block grouped and K12-block grouped: gradient_blocks, advect_blocks
# ---------------------------------------------------------------------------
# One launch over every block of a device, each block's neighbours read
# from their own arrays (``csrc/block_group.cuh``).

# The most blocks of a field a grouped gather's table holds (the
# library's kGatherParts).
GATHER_PARTS = 256


def _grouped_parts(blocks, *lists) -> dict:
    """``_groups`` of the block lists ``lists`` (each ``blocks``' px·py
    blocks), checked: one storage dtype, contiguous (m, k) blocks, each
    block's operands on one device, every device a card or every one the
    CPU (a mix raises).  Returns {device: block indices} and whether the
    blocks lie on a card."""
    m, k = blocks.m, blocks.k
    _require(m >= 2 and k >= 2, f"{m} x {k} blocks (blocks are at least "
             f"2 x 2)")
    _require(all(len(p) == blocks.px * blocks.py for p in lists),
             f"expected {blocks.px * blocks.py} blocks an operand")
    dtype = _storage(*(t for p in lists for t in p))
    groups = _groups(lists[0])
    on_card = {co._on_device(*((p[i], (m, k), (dtype,)) for p in lists
                               for i in idx))
               for idx in groups.values()}
    _require(len(on_card) == 1, "blocks on the card and on the CPU at once")
    return groups, on_card.pop()


def gradient_blocks_composed(gradient, blocks, us, vs, ps, n):
    """JAX's composition of the block route's gradient (``_gradient_local``
    after ``_neighbor_halos``): ``blocks.halos(ps)``, then ``gradient`` on
    each block.  Returns (u blocks, v blocks)."""
    pairs = [gradient(u, v, p, h, o, n) for u, v, p, h, o in
             zip(us, vs, ps, blocks.halos(ps), blocks.origins)]
    return [q[0] for q in pairs], [q[1] for q in pairs]


def gradient_blocks_plain(blocks, us, vs, ps, n):
    """Plain twin of ``gradient_blocks``: ``gradient_blocks_composed`` on
    ``gradient_block_plain``."""
    _grouped_parts(blocks, us, vs, ps)
    return gradient_blocks_composed(gradient_block_plain, blocks, us, vs, ps,
                                    n)


def _grad_sources(blocks, ps, i: int, copy: bool = False):
    """p's one-cell neighbours of block i (``csrc/block_group.cuh``'s
    GradBlock): (top, bottom, left, right) addresses, the left and right
    columns' strides, and the copies to keep alive.  A neighbour on block
    i's device is its own array (unless ``copy``), one on another device a
    copy of its row or column there; None beyond a wall."""
    m, k = blocks.m, blocks.k
    dev, esz = ps[i].device, ps[i].element_size()
    up, dn, lt, rt = blocks.neighbours(i)
    ptrs, strides, keep = [], [], []
    for nb, row, col in ((up, m - 1, None), (dn, 0, None),
                         (lt, None, k - 1), (rt, None, 0)):
        if nb is None:
            ptrs.append(None)
            strides.append(1)
        elif ps[nb].device == dev and not copy:
            ptrs.append(ps[nb].data_ptr()
                        + (row * k if col is None else col) * esz)
            strides.append(1 if col is None else k)
        else:
            part = ps[nb][row] if col is None else ps[nb][:, col]
            t = part.to(dev, copy=True).contiguous()
            keep.append(t)
            ptrs.append(t.data_ptr())
            strides.append(1)
    return ptrs, strides[2:], keep


def gradient_blocks(blocks, us, vs, ps, n):
    """JAX's ``_gradient_local`` on every block of ``blocks`` at once:
    ``u - (0.5*dp/dx)/h``, ``v - (0.5*dp/dy)/h``, border modes 1 and 2,
    from the lists of (m, k) u, v and p blocks.  Float32, or bf16 (the
    bf16 form: float32 arithmetic, bf16 u and v).  One grouped K11-block
    launch a device (``gradient_block_group``, ``gradient_block_group_bf16``;
    at most ``cuda_ops.GROUP_BLOCKS`` blocks a launch), ``cuda_ops.
    VECTOR_WIDTHS``' first width that divides k with every operand
    aligned: p's neighbour rows and columns read from the neighbours' own
    arrays (copies where they lie on another device), no ``Blocks.halos``.
    Returns (u blocks, v blocks), fresh tensors.  Bit for bit
    ``gradient_blocks_plain``, which CPU blocks take."""
    groups, on_card = _grouped_parts(blocks, us, vs, ps)
    if not on_card:
        return gradient_blocks_plain(blocks, us, vs, ps, n)
    _require(blocks.side == n + 2, f"blocks of a {blocks.side}-cell grid "
             f"for n = {n}")
    name = "gradient_block_group" + ("_bf16" if us[0].dtype == torch.bfloat16
                                     else "")
    m, k = blocks.m, blocks.k
    uo = [torch.empty_like(u) for u in us]
    vo = [torch.empty_like(v) for v in vs]
    for dev, idx in groups.items():
        with torch.cuda.device(dev):
            lib = build.load()
            width = co.vector_width(name, k, *(t[i] for t in (us, vs, ps, uo,
                                                              vo)
                                               for i in idx))
            for lo in range(0, len(idx), co.GROUP_BLOCKS):
                ptrs, ints, keep = [], [], []
                for i in idx[lo:lo + co.GROUP_BLOCKS]:
                    nbs, strides, copies = _grad_sources(blocks, ps, i)
                    keep += copies
                    ptrs += [us[i].data_ptr(), vs[i].data_ptr(),
                             ps[i].data_ptr(), uo[i].data_ptr(),
                             vo[i].data_ptr(), *nbs]
                    ints += [*blocks.origins[i], *strides]
                table = (ctypes.c_void_p * len(ptrs))(*ptrs)
                int_table = (ctypes.c_int * len(ints))(*ints)
                co._launch_vector(name, width, getattr(lib, f"fsc_{name}"),
                                  ctypes.addressof(table),
                                  ctypes.addressof(int_table), len(ints) // 4,
                                  m, k, n, grid_h(n), width,
                                  co._stream(us[idx[0]]))
                del keep
    return uo, vo


def advect_blocks_composed(advect, advect_exact, blocks, bs, fields, us,
                           vs, *, dt, n, cmax, self_adv):
    """JAX's composition of a block-route gather: exact (``cmax`` None,
    ``_advect_local``: ``blocks.gather`` of each field, then
    ``advect_exact`` on each block) or windowed (``_advect_local_windowed``:
    ``blocks.ext`` of each field by ``cmax + 1``, then ``advect``).  A list
    of each block's tuple of results."""
    kw = dict(dt=dt, n=n, m=blocks.m, k=blocks.k, self_adv=self_adv)
    if cmax is None:
        bufs = [blocks.gather(f) for f in fields]
        return [advect_exact(bs, fs, u, v, o, **kw)
                for fs, u, v, o in zip(zip(*bufs), us, vs, blocks.origins)]
    bufs = [blocks.ext(f, cmax + 1) for f in fields]
    return [advect(bs, es, u, v, o, cmax=cmax, **kw)
            for es, u, v, o in zip(zip(*bufs), us, vs, blocks.origins)]


def _advect_blocks_args(blocks, bs, fields, us, vs, n, cmax, self_adv):
    """(bs, fields, velocity lists, {device: indices}, on_card) after the
    checks: one or two fields, each the list of ``blocks``' blocks, the
    velocity blocks ``us``/``vs`` (the u/v pair's own cells with
    ``self_adv``, where they are ignored), a window no deeper than a
    block less one cell."""
    bs, fields = tuple(bs), tuple(fields)
    _require(len(bs) == len(fields) and len(bs) in (1, 2),
             "a block gather takes one or two fields")
    _require(blocks.side == n + 2, f"blocks of a {blocks.side}-cell grid "
             f"for n = {n}")
    if self_adv:
        _require(len(bs) == 2, "self_adv advects the (u, v) pair")
        us, vs = fields
    _require(cmax is None or (cmax >= 0 and cmax + 1 <= min(blocks.m,
                                                             blocks.k)),
             f"a {cmax}-cell window needs blocks of at least cmax+1 cells, "
             f"got {blocks.m} x {blocks.k}")
    groups, on_card = _grouped_parts(blocks, *fields, us, vs)
    return bs, fields, list(us), list(vs), groups, on_card


def advect_blocks_plain(blocks, bs, fields, us, vs, *, dt, n, cmax,
                        self_adv):
    """Plain twin of ``advect_blocks``: ``advect_blocks_composed`` on
    ``advect_block_plain`` and ``advect_block_exact_plain``."""
    bs, fields, us, vs, _, _ = _advect_blocks_args(blocks, bs, fields, us,
                                                   vs, n, cmax, self_adv)
    none = [None] * len(us)
    return advect_blocks_composed(
        advect_block_plain, advect_block_exact_plain, blocks, bs, fields,
        none if self_adv else us, none if self_adv else vs, dt=dt, n=n,
        cmax=cmax, self_adv=self_adv)


def _gather_parts(blocks, fields, local, dev, K, copy: bool = False):
    """The grouped gather's table of the field's blocks as the launch of
    the blocks ``local`` on ``dev`` sees them (``csrc/block_group.cuh``'s
    GatherPart): (2 addresses a part, 3 ints a part, the copies to keep
    alive).  A block of the launch is its own array (unless ``copy``);
    any other lies on another device and is a copy moved to ``dev`` of
    the cells the launch reads: the whole block for the exact gather (K
    None), for the windowed one the bounding box of its ``K``-deep strips
    and corners next to the launch's blocks, none where it is next to
    none."""
    m, k = blocks.m, blocks.k
    ptrs, ints, keep = [], [], []
    for j in range(blocks.px * blocks.py):
        bi, bj = divmod(j, blocks.py)
        r0, c0 = blocks.origins[j]
        if j in local and not copy:
            ptrs += [f[j].data_ptr() for f in fields] + [None] * (
                2 - len(fields))
            ints += [r0, c0, k]
            continue
        rows, cols = (0, m), (0, k)
        if K is not None:
            near = [divmod(i, blocks.py) for i in local]
            near = [(ii - bi, jj - bj) for ii, jj in near
                    if abs(ii - bi) <= 1 and abs(jj - bj) <= 1]
            if not near:
                ptrs += [None, None]
                ints += [0, 0, 0]
                continue

            def span(ds, size):
                lo = min(size - K if d > 0 else 0 for d in ds)
                hi = max(K if d < 0 else size for d in ds)
                return lo, hi

            rows = span([d for d, _ in near], m)
            cols = span([d for _, d in near], k)
        parts = [f[j][rows[0]:rows[1], cols[0]:cols[1]].to(
            dev, copy=True).contiguous() for f in fields]
        keep += parts
        ptrs += [t.data_ptr() for t in parts] + [None] * (2 - len(fields))
        ints += [r0 + rows[0], c0 + cols[0], cols[1] - cols[0]]
    return ptrs, ints, keep


def advect_blocks(blocks, bs, fields, us, vs, *, dt, n, cmax, self_adv):
    """The gather of one or two fields (border modes ``bs``; each field
    the list of ``blocks``' (m, k) blocks) at every block's cells, in the
    window of ``cmax`` cells (JAX's ``_advect_local_windowed``) or exactly
    (``cmax=None``, ``_advect_local``), by the velocity blocks ``us``,
    ``vs`` (ignored with ``self_adv``: the u/v pair's own cells).
    Float32, or bf16 fields and velocities (the backtrace and the blend
    float32, each result rounded to bf16).  On the card one grouped
    K12-block launch a device (``advect_block_group``,
    ``advect_block_group_exact`` and their ``_bf16`` forms; at most
    ``cuda_ops.GROUP_BLOCKS`` blocks a launch, ``VECTOR_WIDTHS``' first
    width that divides k with every velocity and output aligned), with no
    ``Blocks.ext`` and no ``Blocks.gather``: each corner is read from the
    array of the block that owns it, a copy of the cells the launch reads
    only where that block lies on another device.  Outputs are fresh
    tensors, so the u/v pair reads the velocity from before the gather.
    A list of each block's tuple of results; bit for bit
    ``advect_blocks_plain``, which CPU blocks take."""
    bs, fields, us, vs, groups, on_card = _advect_blocks_args(
        blocks, bs, fields, us, vs, n, cmax, self_adv)
    if not on_card:
        return advect_blocks_plain(blocks, bs, fields, us, vs, dt=dt, n=n,
                                   cmax=cmax, self_adv=self_adv)
    _require(blocks.px * blocks.py <= GATHER_PARTS,
             f"a grouped gather reads at most {GATHER_PARTS} blocks")
    name = ("advect_block_group" + ("_exact" if cmax is None else "")
            + ("_bf16" if us[0].dtype == torch.bfloat16 else ""))
    m, k = blocks.m, blocks.k
    outs: list = [None] * len(us)
    for dev, idx in groups.items():
        with torch.cuda.device(dev):
            lib = build.load()
            for i in idx:
                outs[i] = tuple(torch.empty_like(us[i]) for _ in bs)
            parts, part_ints, keep = _gather_parts(
                blocks, fields, set(idx), dev,
                None if cmax is None else cmax + 1)
            part_table = (ctypes.c_void_p * len(parts))(*parts)
            part_int_table = (ctypes.c_int * len(part_ints))(*part_ints)
            width = co.vector_width(name, k, *(t for i in idx for t in
                                               (us[i], vs[i], *outs[i])))
            for lo in range(0, len(idx), co.GROUP_BLOCKS):
                ptrs, ints = [], []
                for i in idx[lo:lo + co.GROUP_BLOCKS]:
                    ptrs += [us[i].data_ptr(), vs[i].data_ptr(),
                             *(o.data_ptr() for o in outs[i]),
                             *[None] * (2 - len(bs))]
                    ints += list(blocks.origins[i])
                table = (ctypes.c_void_p * len(ptrs))(*ptrs)
                int_table = (ctypes.c_int * len(ints))(*ints)
                co._launch_vector(
                    name, width, getattr(lib, f"fsc_{name}"),
                    ctypes.addressof(part_table),
                    ctypes.addressof(part_int_table), len(part_ints) // 3,
                    ctypes.addressof(table), ctypes.addressof(int_table),
                    len(ints) // 2, m, k, n, blocks.py, len(bs), bs[0],
                    bs[1] if len(bs) == 2 else 0, co._dt0(dt, n), cmax or 0,
                    width, co._stream(us[idx[0]]))
            del keep
    return outs
