"""The z-slab kernels of the 3-D multi-device step: one wrapper per TPU
function of ``fluidsimulationcuda_tpu.kernels.pallas_sharded_3d`` (and per
jnp stencil of its step), each beside its plain PyTorch twin.

A z-slab is a band of ``mz`` whole (y, x) planes of the padded global
volume, global plane ``plane0 + k`` at slab plane ``k``.  An extended slab
``(mz + 2H, side, side)`` adds the ``H`` planes above and below it,
received from the neighbouring slabs (zeros beyond a wall), slab plane
``k`` at ext plane ``H + k``.  Every function takes ``flags = (is_top,
is_bot, plane0)`` as host ints, as ``cuda_sharded`` does for row slabs.

Wrappers keep the JAX names and arguments minus the TPU knobs and check
dtype (float32, or bf16 storage), shape, contiguity, device and 32-bit
indexing.  On CPU tensors they return their plain twin (the ``*_plain``
function); on CUDA tensors they launch the hand-written kernels of
``csrc/`` or raise.  Nothing falls back.  Launches count in
``cuda_ops.launch_counts()``.  Unlike the TPU functions, every output
carries its full ghost layer.

Four CUDA kernels carry the three TPU kernels, the step's two stencils and
its exact gather (a second form of K14), and K14 has a grouped form:

- K13, ``fused_jacobi3_slab`` (B10a, ``pallas_sharded_3d.py:349``) and
  ``fused_cheby3_slab`` (B10b, ``:442``), a Chebyshev chain segment that
  resumes at global sweep ``start`` with x_{k-1} carried in and out, in
  K5's two forms over the buffer's plane range: the per-sweep
  ``jacobi3_slab`` (``csrc/jacobi3_slab.cu``) and the tiled
  ``jacobi3_slab_sweeps`` (``csrc/jacobi3_tiles.cu``, T3 sweeps a launch),
  which a Chebyshev segment in fast mode takes on a buffer of at least
  5*T3 planes (``cuda_ops.tiled3``);
- ``advect3_slab`` (K14, ``csrc/advect3_slab.cu``): ``advect3_flat_slab``
  (B10c, ``:530``), one field or the (u, v, w) triple per launch;
  ``advect3_flat_slab_exact``, K14's exact form, the gather of JAX's exact
  all-gather advection (``_advect3_local_exact``,
  ``parallel/sharded3d.py:288``, jnp) from the assembled fields;
- ``advect3_group`` (K14 grouped, ``csrc/advect3_slab.cu`` on the gather
  body of ``csrc/advect3_body.cuh``): the windowed or exact gather of
  every z-slab of a device in one launch, each corner read from the array
  of the slab that owns its plane (a copy of the planes read where that
  slab lies on another device), so no extended slab and no assembled
  volume is built; bit for bit the per-slab forms above on ``mesh._ext``'s
  or ``mesh._gather``'s buffers, which it replaces on the ``cuda`` z-slab
  step (``Slab3OpSet.advect_group``);
- ``divergence3_slab`` (K15) and ``gradient3_slab`` (K16),
  ``csrc/project3_slab.cu``: the step's ``_divergence3_fast`` and
  ``_gradient3_fast`` (``parallel/sharded3d.py:567-597``).

Each result equals the global operation restricted to the slab while the
halos are deep enough: ``H >= sweeps + 1`` for a solve segment (JAX's
margin) and ``cmax + 1`` planes for a windowed gather (the exact one reads
the assembled fields); the wrappers check these.

Each kernel also has a bf16 storage form (JAX's bf16 z-slab step, which
runs its jnp ``_step3_local``), counted apart (``*_bf16``), with the rules
of the single-device bf16 forms (``cuda_ops_3d``): a solve's rhs is bf16,
built in float32 and rounded once by the caller (``solve_rhs3``; in fast
mode already times 1/beta, so no sweep scales it); its iterate, and x_{k-1}
for Chebyshev, stay float32 from the solve's first sweep to its last,
across the segments and the halo exchanges between them, so a segment that
does not end the solve (``ends_solve=False``, or ``carry_out``) returns
float32 and only the last rounds to bf16; K15 writes a float32 divergence
from bf16 velocities, the pressure solve is the float32 K13, and K16 reads
bf16 velocities and a float32 pressure and writes bf16; K14 gathers bf16
fields by bf16 velocities in float32 and rounds at the store.  Each plain
twin (``*_plain``) widens its bf16 operands, runs the float32 plain version
(fast sweeps with an ``fmaf``, as the kernels) and rounds where its kernel
stores, so it equals the kernel bit for bit.

The ``reference`` backend of the z-slab step runs the ``*_ref`` forms:
JAX's jnp slab operations (``_diffuse3_local``, ``_cheby_diffuse3_local``,
``_apply_bnd3_coords``, ``_divergence3_local``, ``_gradient3_local``),
every operation rounded to the fields' dtype as JAX rounds it, so in bf16
a solve rounds every sweep.  In float32 they are the plain twins.  Its
gathers are the twins (float32, rounded once in bf16): JAX's own bf16
gather cannot resolve a fraction of a cell at these sides.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.chebyshev import cheby_omegas
from ..ops.diffuse import as_scalar
from ..ops.project import _h, grid_h
from ..ops.three_d import _neigh3, departure3, trilinear
from . import build
from . import cuda_ops as co
from .cuda_sharded import _flags, _require, _shift, _wall_rows

__all__ = [
    "fused_jacobi3_slab", "fused_jacobi3_slab_plain", "fused_jacobi3_slab_ref",
    "fused_cheby3_slab", "fused_cheby3_slab_plain", "fused_cheby3_slab_ref",
    "advect3_flat_slab", "advect3_flat_slab_plain",
    "advect3_flat_slab_exact", "advect3_flat_slab_exact_plain",
    "advect3_group", "advect3_group_plain", "advect3_composed",
    "GATHER_SLABS",
    "GATHER_SOURCES",
    "divergence3_slab", "divergence3_slab_plain", "divergence3_slab_ref",
    "gradient3_slab", "gradient3_slab_plain", "gradient3_slab_ref",
    "solve_rhs3",
]

BF16 = torch.bfloat16
_F32 = (torch.float32,)


# ---------------------------------------------------------------------------
# Checks and geometry
# ---------------------------------------------------------------------------


def _on_card(*specs: tuple) -> bool:
    """``cuda_ops._on_device`` for (planes, side, side) slab arrays, each
    spec ``(tensor, shape)`` (float32) or ``(tensor, shape, dtypes)``, each
    array at least 3 cells wide and below 2**31 cells (the kernels index
    with 32-bit ints)."""
    for _, (planes, side, _), *_ in specs:
        if side < 3 or planes * side * side >= 2**31:
            raise ValueError(f"unsupported slab shape {(planes, side, side)}")
    return co._on_device(*specs)


def _dtypes(storage: torch.dtype) -> tuple[torch.dtype, ...]:
    """The dtypes a solve's iterate may take beside a rhs of ``storage``:
    float32 on a float32 rhs; on a bf16 rhs the caller's bf16 guess or the
    float32 iterate a segment before handed on."""
    return co._F32_BF16 if storage == BF16 else _F32


def _one_dtype(*tensors: torch.Tensor) -> tuple[torch.dtype, ...]:
    """The one storage dtype of ``tensors`` (float32 or bf16), as a spec's
    dtypes; mixed dtypes raise ``TypeError``."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) > 1:
        raise TypeError(f"mixed dtypes {sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    return (dtype,) if dtype in co._F32_BF16 else _F32


# ---------------------------------------------------------------------------
# Plain building blocks
# ---------------------------------------------------------------------------


def _signs3(b: int) -> tuple[float, float, float]:
    return (-1.0 if b == 1 else 1.0), (-1.0 if b == 2 else 1.0), \
        (-1.0 if b == 3 else 1.0)


def _slab_bnd3(b: int, x: torch.Tensor, gtop: int, gbot: int) -> torch.Tensor:
    """The mode-``b`` ghost layer on a (planes, side, side) buffer, in
    place: ghost rows and columns on every plane, a wall ghost plane
    (``gtop``/``gbot``, -1 when absent) from the plane next to it; edges
    average their two face neighbours, corners their three edge neighbours,
    in the expression order of ``ops.three_d.set_bnd3`` (and of JAX's
    ``_apply_bnd3_direct``, ``sharded3d.py:516-564``), each operation in
    ``x``'s dtype with 1/3 taken in it (``_apply_bnd3_coords``,
    ``:74-125``)."""
    sx, sy, sz = _signs3(b)
    third = as_scalar(1.0 / 3.0, x)
    x[:, 1:-1, 0] = sx * x[:, 1:-1, 1]
    x[:, 1:-1, -1] = sx * x[:, 1:-1, -2]
    x[:, 0, 1:-1] = sy * x[:, 1, 1:-1]
    x[:, -1, 1:-1] = sy * x[:, -2, 1:-1]
    walls = [(g, nb) for g, nb in ((gtop, gtop + 1), (gbot, gbot - 1))
             if g >= 0]
    for g, nb in walls:
        x[g, 1:-1, 1:-1] = sz * x[nb, 1:-1, 1:-1]
    ends = ((0, 1), (-1, -2))  # (ghost index, its inner neighbour)
    for yi, yn in ends:
        for xi, xn in ends:
            x[:, yi, xi] = 0.5 * (x[:, yn, xi] + x[:, yi, xn])
    for g, nb in walls:
        for yi, yn in ends:
            x[g, yi, 1:-1] = 0.5 * (x[nb, yi, 1:-1] + x[g, yn, 1:-1])
        for xi, xn in ends:
            x[g, 1:-1, xi] = 0.5 * (x[nb, 1:-1, xi] + x[g, 1:-1, xn])
        for yi, yn in ends:
            for xi, xn in ends:
                x[g, yi, xi] = third * ((x[nb, yi, xi] + x[g, yn, xi])
                                     + x[g, yi, xn])
    return x


def _sweeps3_plain(b, x, rhs, alpha, beta, sweeps, gtop, gbot, *,
                   zero_init=False, fast=False, cheby_rho=None, start=0,
                   xm=None, prescaled=False, fma=False):
    """The whole (planes, side, side) buffers x and x_{k-1} after
    ``sweeps`` Jacobi (or Chebyshev, from global sweep ``start``) sweeps,
    each over the buffer's inner planes (its edge planes keep their input
    values), with the ghost layer after each, every operation in the
    buffers' dtype.  Fast form and Chebyshev weights as
    ``cuda_ops.fused_jacobi_plain`` (``prescaled``: the rhs is already
    times 1/beta); ``fma``: each fast sweep rounds its product and sum once,
    as the kernels' ``fmaf`` (``cuda_ops_3d._fma_diffuse3``)."""
    if zero_init:
        x = torch.zeros_like(rhs)
    if fast:
        if not prescaled:
            rhs = rhs * (1.0 / beta)
        alpha, beta = alpha / beta, 1.0
    a = as_scalar(alpha, rhs)
    bt = as_scalar(beta, rhs)
    ws = [None] * sweeps
    if cheby_rho is not None:
        ws = [None, *cheby_omegas(float(cheby_rho), start + sweeps)]
        ws = ws[start:start + sweeps]
    rhs_in = rhs[1:-1, 1:-1, 1:-1]
    g_in = (_shift(gtop, 1), _shift(gbot, 1))
    xm = x if xm is None else xm
    for w in ws:
        if fast and fma:
            val = (rhs_in.double() + co._f32(alpha) * _neigh3(x).double()
                   ).to(rhs.dtype)
        else:
            val = (rhs_in + a * _neigh3(x)) / bt
        if w is not None:
            wc = as_scalar(w, rhs)
            val = wc * val + (1.0 - wc) * xm[1:-1, 1:-1, 1:-1]
        new = x.clone()
        new[1:-1, 1:-1, 1:-1] = val
        _slab_bnd3(b, new[1:-1], *g_in)
        xm, x = x, new
    return x, xm


def _advect3_plain(bs, exts, halo, u, v, w, flags, dt, n, cmax):
    """The windowed gather (``ops.three_d.advect3_windowed``) of each field
    of ``exts`` at the cells of an (mz, side, side) slab, at global
    coordinates; slab plane k is ext plane ``halo + k``.  With
    ``cmax=None`` the exact gather (``ops.three_d.advect3``'s departure)
    from the assembled fields, ``halo = plane0``.  bf16 fields and
    velocities are gathered in float32 (``departure3``, ``trilinear``), the
    ghost layer derived in float32 and each result rounded to bf16 once."""
    _, _, plane0 = _flags(flags)
    mz, side, _ = u.shape

    def coords(lo, count):
        return torch.arange(lo, lo + count, dtype=torch.float32,
                            device=u.device)

    x, y, z = departure3(u, v, w, coords(0, side)[None, None, :],
                         coords(0, side)[None, :, None],
                         coords(plane0, mz)[:, None, None], dt, n, cmax)
    gtop, gbot = _wall_rows(flags, 0, mz)
    return tuple(_slab_bnd3(b, trilinear(ext, x, y, z, plane0 - halo), gtop,
                            gbot).to(ext.dtype)
                 for b, ext in zip(bs, exts))


def _divergence3_plain(u, v, w, wtop, wbot, n, gtop, gbot):
    """``(-0.5*h)*((du + dv) + (w_dn - w_up))`` on (planes, side, side)
    slabs whose neighbour planes are the one-plane halos ``wtop``/``wbot``;
    border mode 0; in the fields' dtype, -0.5 and h = 1/n taken in it
    (``_divergence3_local``, ``sharded3d.py:405-416``)."""
    w_up = torch.cat([wtop, w[:-1]])
    w_dn = torch.cat([w[1:], wbot])
    out = torch.empty_like(u)
    out[:, 1:-1, 1:-1] = (as_scalar(-0.5, u) * _h(n, u)) * (
        (u[:, 1:-1, 2:] - u[:, 1:-1, :-2]) + (v[:, 2:, 1:-1] - v[:, :-2, 1:-1])
        + (w_dn - w_up)[:, 1:-1, 1:-1])
    return _slab_bnd3(0, out, gtop, gbot)


def _gradient3_plain(u, v, w, p, ptop, pbot, n, gtop, gbot):
    """``u - (0.5*dp)/h`` per axis on (planes, side, side) slabs with
    one-plane halos of ``p``; border modes 1, 2 and 3; in the fields'
    dtype, h = 1/n taken in it (``_gradient3_local``, ``:419-434``)."""
    h = _h(n, u)
    p_up = torch.cat([ptop, p[:-1]])
    p_dn = torch.cat([p[1:], pbot])
    uo, vo, wo = (torch.empty_like(t) for t in (u, v, w))
    inner = (slice(None), slice(1, -1), slice(1, -1))
    uo[inner] = u[inner] - (0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2])) / h
    vo[inner] = v[inner] - (0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1])) / h
    wo[inner] = w[inner] - (0.5 * (p_dn - p_up)[inner]) / h
    return (_slab_bnd3(1, uo, gtop, gbot), _slab_bnd3(2, vo, gtop, gbot),
            _slab_bnd3(3, wo, gtop, gbot))


# ---------------------------------------------------------------------------
# B10a fused_jacobi3_slab, B10b fused_cheby3_slab (K13)
# ---------------------------------------------------------------------------


def solve_rhs3(x0, src, dt, beta, fast):
    """The rhs of a bf16 z-slab diffusion on the kernels: ``x0 + dt*src``
    in float32, times 1/beta in fast mode, rounded to bf16 once, as K5's
    bf16 form builds it in its first sweep (``cuda_ops._plain_rhs``).  A
    z-slab solve reads its rhs across halo exchanges, so it is built once,
    and in fast mode its segments take a bf16 rhs as already scaled."""
    return co._plain_rhs(src.float(), x0.float(), beta, dt, fast).to(BF16)


def _solve_checks(x_ext, rhs_ext, mz, H, sweeps, xm_ext=None) -> bool:
    side = rhs_ext.shape[-1]
    _require(sweeps >= 1, "sweeps must be >= 1")
    _require(H >= sweeps + 1, f"a {H}-plane halo is valid for at most "
             f"{H - 1} sweeps, got {sweeps}")
    ext = (mz + 2 * H, side, side)
    iterate = _dtypes(rhs_ext.dtype)
    specs = [(rhs_ext, ext, co._F32_BF16), (x_ext, ext, iterate)]
    if xm_ext is not None:
        specs.append((xm_ext, ext, iterate))
    return _on_card(*specs)


def _launch_sweeps(b, x_ext, rhs_ext, flags, mz, H, alpha, beta, sweeps, *,
                   zero_init, fast, final, cheby_rho=None,
                   start=0, xm_ext=None, carry_out=False):
    """The segment's K13 launches (``cuda_ops._Sweeps.run3``); returns the
    final (x, x_{k-1}) buffers, x_{k-1} valid with ``carry_out``.  On a
    bf16 rhs the bf16 forms, bf16 written only by a ``final`` segment, the
    rhs in fast mode already times 1/beta (``solve_rhs3``)."""
    gtop, gbot = _wall_rows(flags, H, mz)
    with torch.cuda.device(rhs_ext.device):
        lib = build.load()
        run = co._Sweeps(b, x_ext, rhs_ext, alpha, beta, sweeps,
                         zero_init=zero_init, src_dt=None, fast=fast,
                         cheby_rho=cheby_rho, kernel="jacobi3_slab",
                         start=start, xm=xm_ext, final=final,
                         prescaled=fast and rhs_ext.dtype == BF16)
        run.run3(lib, (mz + 2 * H, gtop, gbot), carry_out=carry_out)
        return run.x, run.xm


def _twin_sweeps(b, x_ext, rhs_ext, alpha, beta, sweeps, gtop, gbot, *,
                 xm=None, **kw):
    """``_sweeps3_plain`` as the kernels compute it: in float32 (bf16
    operands widened), each fast sweep's product and sum rounded once, as
    their ``fmaf`` (so a z-slab solve's twin equals the single-device
    twin, ``cuda_ops_3d._fma_diffuse3``); a bf16 rhs in fast mode is
    already times 1/beta (``solve_rhs3``)."""
    def wide(t):
        return None if t is None else t.float()

    prescaled = kw.get("fast", False) and rhs_ext.dtype == BF16
    return _sweeps3_plain(b, wide(x_ext), wide(rhs_ext), alpha, beta, sweeps,
                          gtop, gbot, xm=wide(xm), fma=True,
                          prescaled=prescaled, **kw)


def _stored(slab: torch.Tensor, rhs_ext: torch.Tensor,
            ends_solve: bool) -> torch.Tensor:
    """A segment's result as its kernel stores it: bf16 where a bf16 solve
    ends, the float32 iterate otherwise."""
    return slab.to(BF16) if rhs_ext.dtype == BF16 and ends_solve else slab


def fused_jacobi3_slab_plain(b, x_ext, rhs_ext, flags, *, mz, H, alpha, beta,
                             sweeps, zero_init=False, fast=False,
                             ends_solve=True):
    _solve_checks(x_ext, rhs_ext, mz, H, sweeps)
    x, _ = _twin_sweeps(b, x_ext, rhs_ext, alpha, beta, sweeps,
                        *_wall_rows(flags, H, mz), zero_init=zero_init,
                        fast=fast)
    return _stored(x[H:H + mz], rhs_ext, ends_solve)


def fused_jacobi3_slab_ref(b, x_ext, rhs_ext, flags, *, mz, H, alpha, beta,
                           sweeps, zero_init=False, fast=False,
                           ends_solve=True):
    """JAX's jnp segment (``_diffuse3_local``'s chunk,
    ``sharded3d.py:164-207``): every operation in the fields' dtype, so a
    bf16 solve rounds every sweep and ``ends_solve`` changes nothing; in
    float32 the plain twin."""
    _solve_checks(x_ext, rhs_ext, mz, H, sweeps)
    x, _ = _sweeps3_plain(b, x_ext, rhs_ext, alpha, beta, sweeps,
                          *_wall_rows(flags, H, mz), zero_init=zero_init,
                          fast=fast)
    return x[H:H + mz]


def fused_jacobi3_slab(b, x_ext, rhs_ext, flags, *, mz, H, alpha, beta,
                       sweeps, zero_init=False, fast=False, ends_solve=True):
    """``sweeps`` 7-point Jacobi sweeps (the reciprocal form with ``fast``)
    on an ``(mz+2H, side, side)`` extended slab from guess ``x_ext`` (zero
    with ``zero_init``; ``x_ext`` is then ignored) with rhs ``rhs_ext``;
    requires ``H >= sweeps + 1``.  Returns the (mz, side, side) slab.  One
    launch of the per-sweep K13 a sweep (``cuda_ops.tiled3``).  On a bf16
    rhs (``solve_rhs3``) the bf16 form (in fast mode the rhs already times
    1/beta): a bf16 or float32 guess, the slab bf16 where the segment
    ``ends_solve``, the float32 iterate for the next segment otherwise."""
    if not _solve_checks(x_ext, rhs_ext, mz, H, sweeps):
        return fused_jacobi3_slab_plain(
            b, x_ext, rhs_ext, flags, mz=mz, H=H, alpha=alpha, beta=beta,
            sweeps=sweeps, zero_init=zero_init, fast=fast,
            ends_solve=ends_solve)
    x, _ = _launch_sweeps(b, x_ext, rhs_ext, flags, mz, H, alpha, beta,
                          sweeps, zero_init=zero_init, fast=fast,
                          final=ends_solve)
    return x[H:H + mz]


def _cheby_checks(x_ext, xm_ext, rhs_ext, mz, H, sweeps, start,
                  carry_in) -> bool:
    _require(carry_in == (xm_ext is not None),
             "carry_in says whether xm_ext is given")
    _require(carry_in == (start > 0), "a segment after the first (start > "
             "0) carries x_{k-1} in, and only such a segment does")
    return _solve_checks(x_ext, rhs_ext, mz, H, sweeps, xm_ext)


def _cheby_result(x, xm, H, mz, carry_out):
    return (x[H:H + mz], xm[H:H + mz]) if carry_out else x[H:H + mz]


def fused_cheby3_slab_plain(b, x_ext, xm_ext, rhs_ext, flags, *, mz, H, alpha,
                            beta, cheby_rho, start, sweeps, zero_init=False,
                            fast=False, carry_in=False, carry_out=False):
    _cheby_checks(x_ext, xm_ext, rhs_ext, mz, H, sweeps, start, carry_in)
    x, xm = _twin_sweeps(b, x_ext, rhs_ext, alpha, beta, sweeps,
                         *_wall_rows(flags, H, mz), zero_init=zero_init,
                         fast=fast, cheby_rho=cheby_rho, start=start,
                         xm=xm_ext)
    if carry_out:
        return _cheby_result(x, xm, H, mz, True)
    return _stored(x[H:H + mz], rhs_ext, True)


def fused_cheby3_slab_ref(b, x_ext, xm_ext, rhs_ext, flags, *, mz, H, alpha,
                          beta, cheby_rho, start, sweeps, zero_init=False,
                          fast=False, carry_in=False, carry_out=False):
    """JAX's jnp Chebyshev segment (``_cheby_diffuse3_local``'s chunk,
    ``sharded3d.py:210-269``): every operation in the fields' dtype, ω and
    1 - ω too; in float32 the plain twin."""
    _cheby_checks(x_ext, xm_ext, rhs_ext, mz, H, sweeps, start, carry_in)
    x, xm = _sweeps3_plain(b, x_ext, rhs_ext, alpha, beta, sweeps,
                           *_wall_rows(flags, H, mz), zero_init=zero_init,
                           fast=fast, cheby_rho=cheby_rho, start=start,
                           xm=xm_ext)
    return _cheby_result(x, xm, H, mz, carry_out)


def fused_cheby3_slab(b, x_ext, xm_ext, rhs_ext, flags, *, mz, H, alpha, beta,
                      cheby_rho, start, sweeps, zero_init=False, fast=False,
                      carry_in=False, carry_out=False):
    """One segment of a Chebyshev chain: global sweeps ``[start, start +
    sweeps)`` on ``(mz+2H, side, side)`` extended slabs, ω from
    ``cheby_omegas(cheby_rho)`` at the segment's position (sweep 0 is the
    chain's plain first sweep).  ``carry_in``: ``xm_ext`` is the extended
    x_{k-1} of the previous segment (required exactly when ``start > 0``);
    ``carry_out``: also return the slab of the previous iterate, for the
    next segment.  Returns the (mz, side, side) slab, or (x, x_{k-1}).
    ceil(sweeps / T3) launches of the tiled K13 in fast mode on a buffer
    of at least 5*T3 planes, one of the per-sweep K13 a sweep otherwise
    (``cuda_ops.tiled3``).  On a bf16 rhs (in fast mode already times
    1/beta) the bf16 forms of either: the slab bf16 where the chain ends,
    and with ``carry_out`` both iterates float32 (the chain's iterate
    never rounds before its end)."""
    if not _cheby_checks(x_ext, xm_ext, rhs_ext, mz, H, sweeps, start,
                         carry_in):
        return fused_cheby3_slab_plain(
            b, x_ext, xm_ext, rhs_ext, flags, mz=mz, H=H, alpha=alpha,
            beta=beta, cheby_rho=cheby_rho, start=start, sweeps=sweeps,
            zero_init=zero_init, fast=fast, carry_in=carry_in,
            carry_out=carry_out)
    x, xm = _launch_sweeps(b, x_ext, rhs_ext, flags, mz, H, alpha, beta,
                           sweeps, zero_init=zero_init, fast=fast,
                           final=not carry_out,
                           cheby_rho=cheby_rho, start=start, xm_ext=xm_ext,
                           carry_out=carry_out)
    if carry_out and xm.dtype == BF16:
        # A 1-sweep first segment's x_{k-1} is the caller's bf16 guess.
        xm = xm.float()
    return _cheby_result(x, xm, H, mz, carry_out)


# ---------------------------------------------------------------------------
# B10c advect3_flat_slab (K14)
# ---------------------------------------------------------------------------


def _advect_args(bs, exts, u_slab, v_slab, w_slab, n, cmax, mz):
    """(bs, exts, halo, on_card) after the checks."""
    bs, exts = tuple(bs), tuple(exts)
    _require(len(bs) == len(exts) and len(bs) in (1, 2, 3),
             "advect3_flat_slab takes one to three fields")
    planes, side, _ = exts[0].shape
    halo = (planes - mz) // 2
    _require(side == n + 2, f"slab width {side} != n+2 = {n + 2}")
    _require(planes - mz == 2 * halo and halo >= cmax + 1 and cmax >= 0,
             f"the gather needs an extended slab of mz + 2*halo planes with "
             f"halo >= cmax+1 = {cmax + 1}; got {planes} planes for mz={mz}")
    slab = (mz, side, side)
    dt = _one_dtype(*exts, u_slab, v_slab, w_slab)
    on_card = _on_card(*((e, (planes, side, side), dt) for e in exts),
                       (u_slab, slab, dt), (v_slab, slab, dt),
                       (w_slab, slab, dt))
    return bs, exts, halo, on_card


def advect3_flat_slab_plain(bs, exts, u_slab, v_slab, w_slab, flags, *, dt, n,
                            cmax, mz):
    bs, exts, halo, _ = _advect_args(bs, exts, u_slab, v_slab, w_slab, n,
                                     cmax, mz)
    return _advect3_plain(bs, exts, halo, u_slab, v_slab, w_slab, flags, dt,
                          n, cmax)


def _suffix(t: torch.Tensor) -> str:
    """The count and symbol suffix of a kernel's form on ``t``'s dtype."""
    return "_bf16" if t.dtype == BF16 else ""


def advect3_flat_slab(bs, exts, u_slab, v_slab, w_slab, flags, *, dt, n, cmax,
                      mz):
    """Windowed trilinear advection of one to three fields (border modes
    ``bs``) of an (mz, side, side) slab from their extended copies ``exts``
    (``mz + 2*halo`` planes, ``halo >= cmax+1``; any ``cmax`` the halo
    holds, where the TPU kernel takes ``cmax <= 2``) by the velocity slabs
    ``u_slab``, ``v_slab``, ``w_slab``, with one shared backtrace.  Outputs
    are fresh tensors with their full ghost layer, so the (u, v, w)
    self-advection reads the pre-advection velocity.  One K14 launch (its
    bf16 form on bf16 fields and velocities); returns a tuple of (mz,
    side, side) slabs."""
    bs, exts, halo, on_card = _advect_args(bs, exts, u_slab, v_slab, w_slab,
                                           n, cmax, mz)
    if not on_card:
        return _advect3_plain(bs, exts, halo, u_slab, v_slab, w_slab, flags,
                              dt, n, cmax)
    side, name = n + 2, "advect3_slab" + _suffix(u_slab)
    with torch.cuda.device(u_slab.device):
        lib = build.load()
        outs = tuple(u_slab.new_empty((mz, side, side)) for _ in bs)
        pad = 3 - len(bs)  # null pointers for the fields not given
        co._launch(name, getattr(lib, f"fsc_{name}"),
                   *(e.data_ptr() for e in exts), *[None] * pad,
                   u_slab.data_ptr(), v_slab.data_ptr(), w_slab.data_ptr(),
                   *(o.data_ptr() for o in outs), *[None] * pad, mz, side,
                   halo, *bs, *[0] * pad, co._dt0(dt, n), _flags(flags)[2],
                   cmax, *_wall_rows(flags, 0, mz), co._stream(u_slab))
        return outs


def _advect_exact_args(bs, fulls, u_slab, v_slab, w_slab, flags, n, mz):
    """(bs, fulls, on_card) after the checks."""
    bs, fulls = tuple(bs), tuple(fulls)
    _require(len(bs) == len(fulls) and len(bs) in (1, 2, 3),
             "advect3_flat_slab_exact takes one to three fields")
    side, plane0 = n + 2, _flags(flags)[2]
    _require(0 <= plane0 and plane0 + mz <= side and mz >= 1,
             f"an {mz}-plane slab at plane {plane0} is not inside the "
             f"{side}-plane volume")
    slab = (mz, side, side)
    dt = _one_dtype(*fulls, u_slab, v_slab, w_slab)
    on_card = _on_card(*((f, (side,) * 3, dt) for f in fulls),
                       (u_slab, slab, dt), (v_slab, slab, dt),
                       (w_slab, slab, dt))
    return bs, fulls, on_card


def advect3_flat_slab_exact_plain(bs, fulls, u_slab, v_slab, w_slab, flags,
                                  *, dt, n, mz):
    bs, fulls, _ = _advect_exact_args(bs, fulls, u_slab, v_slab, w_slab,
                                      flags, n, mz)
    return _advect3_plain(bs, fulls, _flags(flags)[2], u_slab, v_slab,
                          w_slab, flags, dt, n, None)


def advect3_flat_slab_exact(bs, fulls, u_slab, v_slab, w_slab, flags, *, dt,
                            n, mz):
    """Exact trilinear advection of one to three fields of an (mz, side,
    side) slab, gathered from the assembled (side, side, side) fields
    ``fulls`` (JAX's ``_advect3_local_exact``, which all-gathers the volume
    over z first): each coordinate takes the global clamp alone, so any
    displacement gathers as the single-device step does, at any slab
    thickness.  Velocities and outputs as ``advect3_flat_slab``'s.  One
    launch of K14's exact form (its bf16 form on bf16 fields and
    velocities); returns a tuple of (mz, side, side) slabs."""
    bs, fulls, on_card = _advect_exact_args(bs, fulls, u_slab, v_slab,
                                            w_slab, flags, n, mz)
    plane0 = _flags(flags)[2]
    if not on_card:
        return _advect3_plain(bs, fulls, plane0, u_slab, v_slab, w_slab,
                              flags, dt, n, None)
    side, name = n + 2, "advect3_slab_exact" + _suffix(u_slab)
    with torch.cuda.device(u_slab.device):
        lib = build.load()
        outs = tuple(u_slab.new_empty((mz, side, side)) for _ in bs)
        pad = 3 - len(bs)  # null pointers for the fields not given
        co._launch(name, getattr(lib, f"fsc_{name}"),
                   *(f.data_ptr() for f in fulls), *[None] * pad,
                   u_slab.data_ptr(), v_slab.data_ptr(), w_slab.data_ptr(),
                   *(o.data_ptr() for o in outs), *[None] * pad, mz, side,
                   *bs, *[0] * pad, co._dt0(dt, n), plane0,
                   *_wall_rows(flags, 0, mz), co._stream(u_slab))
        return outs


# ---------------------------------------------------------------------------
# K14 grouped: advect3_group
# ---------------------------------------------------------------------------

# The library's fsc::kGatherSlabs and fsc::kGatherSources
# (csrc/advect3_body.cuh): the most slabs one grouped launch writes, and
# the most slabs of the volume its table holds.
GATHER_SLABS = 128
GATHER_SOURCES = 256


def _group_args(bs, fields, u, v, w, flags, n, cmax, mz):
    """(bs, fields) after the checks of a grouped gather: one to three
    fields, each a list of the volume's ``pz`` slabs as ``u``, ``v`` and
    ``w`` are, every slab (mz, side, side) of one storage dtype, the slabs
    stacking into the volume, and a window the adjacent slabs hold."""
    bs, fields = tuple(bs), tuple(tuple(f) for f in fields)
    pz, side = len(u), n + 2
    _require(len(bs) == len(fields) and len(bs) in (1, 2, 3),
             "advect3_group takes one to three fields")
    _require(all(len(x) == pz for x in (v, w, flags, *fields)),
             "advect3_group takes every slab of each field, velocity and "
             "flag list")
    _require(pz * mz == side and mz >= 1,
             f"{pz} slabs of {mz} planes do not stack into {side} planes")
    _require(cmax is None or 1 <= cmax <= mz - 1,
             f"the {cmax}-cell window needs slabs of at least cmax+1 "
             f"planes; got {mz}")
    _require(all(_flags(f)[2] == i * mz for i, f in enumerate(flags)),
             "slab i must start at global plane i*mz")
    _one_dtype(*u, *v, *w, *(x for f in fields for x in f))
    return bs, fields


def advect3_composed(advect, advect_exact, bs, fields, u, v, w, flags, *,
                     dt, n, cmax, mz):
    """JAX's composition of a z-slab gather: each field's slabs extended by
    ``cmax+1`` planes (``mesh._ext``), or assembled once per device
    (``mesh._gather``) for the exact gather (``cmax=None``), then a per-slab
    form on each slab (``advect`` windowed, ``advect_exact`` exact; the
    kernels, their twins or the ``reference`` forms).  A list of each
    slab's tuple of results."""
    from ..parallel.mesh import _ext, _gather

    if cmax is None:
        fulls = [_gather(f) for f in fields]
        return [advect_exact(bs, fs, ui, vi, wi, fl, dt=dt, n=n, mz=mz)
                for fs, ui, vi, wi, fl in zip(zip(*fulls), u, v, w, flags)]
    exts = [_ext(f, cmax + 1) for f in fields]
    return [advect(bs, es, ui, vi, wi, fl, dt=dt, n=n, cmax=cmax, mz=mz)
            for es, ui, vi, wi, fl in zip(zip(*exts), u, v, w, flags)]


def advect3_group_plain(bs, fields, u, v, w, flags, *, dt, n, cmax, mz):
    """The twin of ``advect3_group``: JAX's composition
    (``advect3_composed``) on the per-slab twins."""
    bs, fields = _group_args(bs, fields, u, v, w, flags, n, cmax, mz)
    return advect3_composed(advect3_flat_slab_plain,
                            advect3_flat_slab_exact_plain, bs, fields, u, v,
                            w, flags, dt=dt, n=n, cmax=cmax, mz=mz)


def _device_groups(slabs) -> list[tuple[torch.device, list[int]]]:
    """The slabs of each device, in slab order: one grouped launch each."""
    groups: dict[torch.device, list[int]] = {}
    for i, x in enumerate(slabs):
        groups.setdefault(x.device, []).append(i)
    return list(groups.items())


def _group_sources(fields, local: set[int], dev, mz: int, cmax):
    """The grouped launch's table of the volume's slabs as the launch of
    the slabs ``local`` on ``dev`` sees them: (3 pointers a slab, the
    global plane of each array's first plane, the copies to keep alive
    until the launch is enqueued).  A slab of the launch is its own array;
    any other lies on another device and is a copy moved to ``dev`` of the
    planes the launch reads: its whole slab for the exact gather, its
    ``cmax+1`` planes next to a slab of the launch for the windowed one
    (the whole slab where slabs of the launch lie on both sides), none
    where the launch reads none of its planes."""
    ptrs, starts, keep = [], [], []
    for j in range(len(fields[0])):
        lo, hi = 0, mz  # the planes of slab j the launch reads
        if j in local:
            parts = [f[j] for f in fields]
        else:
            if cmax is not None:
                above, below = j + 1 in local, j - 1 in local
                lo = 0 if below or not above else mz - (cmax + 1)
                hi = mz if above or not below else cmax + 1
                if not (above or below):
                    lo = hi = 0
            parts = [f[j][lo:hi].to(dev, copy=True) if hi > lo else None
                     for f in fields]
            keep += parts
        ptrs += [co._ptr(x) for x in parts] + [None] * (3 - len(parts))
        starts.append(j * mz + lo)
    return ptrs, starts, keep


def advect3_group(bs, fields, u, v, w, flags, *, dt, n, cmax, mz):
    """The gather of one to three fields (border modes ``bs``; each field
    the list of the volume's ``pz`` z-slabs, as the velocity slabs ``u``,
    ``v``, ``w`` and the slabs' ``flags`` are) at every slab's cells, in
    the window of ``cmax`` cells or exactly (``cmax=None``): on the card
    one grouped K14 launch a device (``fsc_advect3_group``, counted as
    ``advect3_group``, ``advect3_group_exact`` and their ``_bf16``
    forms), at most ``GATHER_SLABS`` slabs a launch, with no extended slab
    and no assembled volume built: a corner is read from the array of the
    slab that owns its plane, copied over only where that slab lies on
    another device.  Outputs are fresh tensors, so the (u, v, w)
    self-advection reads the pre-advection velocity.  Bit for bit
    ``advect3_group_plain``, which CPU tensors take.  A list of each
    slab's tuple of (mz, side, side) results."""
    bs, fields = _group_args(bs, fields, u, v, w, flags, n, cmax, mz)
    side = n + 2
    slab = (mz, side, side)
    dt_ = _one_dtype(*u)
    groups = _device_groups(u)
    on_card = {_on_card(*((t, slab, dt_) for i in idx
                          for t in (u[i], v[i], w[i],
                                    *(f[i] for f in fields))))
               for _, idx in groups}
    _require(len(on_card) == 1, "slabs on the card and on the CPU at once")
    if not on_card.pop():
        return advect3_group_plain(bs, fields, u, v, w, flags, dt=dt, n=n,
                                   cmax=cmax, mz=mz)
    _require(len(u) <= GATHER_SOURCES,
             f"a grouped gather reads at most {GATHER_SOURCES} slabs")
    name = ("advect3_group" + ("_exact" if cmax is None else "")
            + _suffix(u[0]))
    pad = 3 - len(bs)
    outs: list = [None] * len(u)
    for dev, idx in groups:
        with torch.cuda.device(dev):
            lib = build.load()
            srcs, starts, keep = _group_sources(fields, set(idx), dev, mz,
                                                cmax)
            src_table = (ctypes.c_void_p * len(srcs))(*srcs)
            start_table = (ctypes.c_int * len(starts))(*starts)
            for lo in range(0, len(idx), GATHER_SLABS):
                part = idx[lo:lo + GATHER_SLABS]
                ptrs, walls = [], []
                for i in part:
                    outs[i] = tuple(u[i].new_empty(slab) for _ in bs)
                    ptrs += [u[i].data_ptr(), v[i].data_ptr(),
                             w[i].data_ptr(),
                             *(o.data_ptr() for o in outs[i]), *[None] * pad]
                    walls += [i * mz, *_wall_rows(flags[i], 0, mz)]
                table = (ctypes.c_void_p * len(ptrs))(*ptrs)
                wall_table = (ctypes.c_int * len(walls))(*walls)
                co._launch(name, getattr(lib, f"fsc_{name}"),
                           ctypes.addressof(src_table),
                           ctypes.addressof(start_table), len(u),
                           ctypes.addressof(table),
                           ctypes.addressof(wall_table), len(part), mz, side,
                           len(bs), *bs, *[0] * pad, co._dt0(dt, n),
                           cmax or 0, co._stream(u[part[0]]))
            del keep
    return outs


# ---------------------------------------------------------------------------
# The step's stencils: divergence3_slab (K15), gradient3_slab (K16)
# ---------------------------------------------------------------------------


def _halo_checks(n, side, *halos) -> None:
    _require(side == n + 2, f"slab width {side} != n+2 = {n + 2}")
    for h in halos:
        _require(h.dim() == 3 and h.shape[0] >= 1
                 and tuple(h.shape[1:]) == (side, side),
                 f"a halo is (k >= 1, {side}, {side}) planes, got "
                 f"{tuple(h.shape)}")


def divergence3_slab_plain(u, v, w, wtop, wbot, flags, n):
    """K15's twin: bf16 fields are widened, the divergence float32."""
    mz, side, _ = u.shape
    _halo_checks(n, side, wtop, wbot)
    return _divergence3_plain(*(t.float() for t in (u, v, w, wtop[-1:],
                                                    wbot[:1])),
                              n, *_wall_rows(flags, 0, mz))


def divergence3_slab_ref(u, v, w, wtop, wbot, flags, n):
    """JAX's ``_divergence3_local``: in the fields' dtype (a bf16
    divergence from bf16 fields); in float32 the plain twin."""
    mz, side, _ = u.shape
    _halo_checks(n, side, wtop, wbot)
    return _divergence3_plain(u, v, w, wtop[-1:], wbot[:1], n,
                              *_wall_rows(flags, 0, mz))


def divergence3_slab(u, v, w, wtop, wbot, flags, n):
    """Divergence (border mode 0) on (mz, side, side) slabs; ``wtop``/
    ``wbot`` hold planes of the neighbouring slabs' w (any number >= 1; the
    plane next to the slab is the last of ``wtop`` and the first of
    ``wbot``).  One K15 launch; float32 whatever u, v, w store (bf16 ones
    take the bf16 form, which writes the float32 divergence of the bf16
    step's projection)."""
    mz, side, _ = u.shape
    _halo_checks(n, side, wtop, wbot)
    wtop, wbot = wtop[-1:], wbot[:1]
    slab, one = (mz, side, side), (1, side, side)
    dt = _one_dtype(u, v, w, wtop, wbot)
    if not _on_card((u, slab, dt), (v, slab, dt), (w, slab, dt),
                    (wtop, one, dt), (wbot, one, dt)):
        return divergence3_slab_plain(u, v, w, wtop, wbot, flags, n)
    name = "divergence3_slab" + _suffix(u)
    with torch.cuda.device(u.device):
        lib = build.load()
        out = torch.empty_like(u, dtype=torch.float32)
        co._launch(name, getattr(lib, f"fsc_{name}"), u.data_ptr(),
                   v.data_ptr(), w.data_ptr(), wtop.data_ptr(),
                   wbot.data_ptr(), out.data_ptr(), mz, side,
                   *_wall_rows(flags, 0, mz), -0.5 * grid_h(n),
                   co._stream(u))
        return out


def gradient3_slab_plain(u, v, w, p, ptop, pbot, flags, n):
    """K16's twin: bf16 u, v, w are widened beside the float32 pressure,
    the results rounded to u's dtype once."""
    mz, side, _ = u.shape
    _halo_checks(n, side, ptop, pbot)
    out = _gradient3_plain(*(t.float() for t in (u, v, w, p, ptop[-1:],
                                                 pbot[:1])),
                           n, *_wall_rows(flags, 0, mz))
    return tuple(t.to(u.dtype) for t in out)


def gradient3_slab_ref(u, v, w, p, ptop, pbot, flags, n):
    """JAX's ``_gradient3_local``: in the fields' dtype (bf16 u, v, w and
    a bf16 pressure in bf16); in float32 the plain twin."""
    mz, side, _ = u.shape
    _halo_checks(n, side, ptop, pbot)
    return _gradient3_plain(u, v, w, p, ptop[-1:], pbot[:1], n,
                            *_wall_rows(flags, 0, mz))


def gradient3_slab(u, v, w, p, ptop, pbot, flags, n):
    """Pressure-gradient subtraction (border modes 1, 2 and 3) on (mz,
    side, side) slabs, ``ptop``/``pbot`` as ``divergence3_slab``'s halos.
    One K16 launch; returns the (u, v, w) slabs.  The pressure is float32;
    bf16 u, v, w take the bf16 form, which writes bf16."""
    mz, side, _ = u.shape
    _halo_checks(n, side, ptop, pbot)
    ptop, pbot = ptop[-1:], pbot[:1]
    slab, one = (mz, side, side), (1, side, side)
    dt = _one_dtype(u, v, w)
    if not _on_card((u, slab, dt), (v, slab, dt), (w, slab, dt), (p, slab),
                    (ptop, one), (pbot, one)):
        return gradient3_slab_plain(u, v, w, p, ptop, pbot, flags, n)
    name = "gradient3_slab" + _suffix(u)
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(torch.empty_like(t) for t in (u, v, w))
        co._launch(name, getattr(lib, f"fsc_{name}"), u.data_ptr(),
                   v.data_ptr(), w.data_ptr(), p.data_ptr(), ptop.data_ptr(),
                   pbot.data_ptr(), *(o.data_ptr() for o in outs), mz, side,
                   *_wall_rows(flags, 0, mz), grid_h(n), co._stream(u))
        return outs
