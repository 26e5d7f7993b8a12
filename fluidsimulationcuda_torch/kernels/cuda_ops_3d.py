"""The CUDA backend of the 3-D solver: one wrapper per 3-D TPU kernel
function, each beside its plain PyTorch version (twin of
``fluidsimulationcuda_tpu.kernels.pallas_ops_3d``).

Wrappers keep the names and signatures of ``pallas_ops_3d`` minus the TPU
knobs (``max_fused``, ``self_advect``); the gathers take JAX's ``cmax``
(the gather window in cells; None gathers exactly).  Each checks dtype
(float32, or bf16 storage), shape ``(side, side, side)``, contiguity and
device, and raises if ``side**3`` does not fit a 32-bit index.  On CPU
tensors it returns its plain version, built from ``ops/three_d.py``; on
CUDA tensors it launches
the hand-written kernels of ``csrc/`` or raises.  Nothing falls back.
Unlike the TPU functions, every output carries its full ghost layer: no
``set_bnd3`` pass follows a kernel.

Four CUDA kernels carry the three 3-D TPU kernel families:

- K5, the 7-point sweeps of ``fused_jacobi3`` (TPU ``pallas_ops_3d.py:458``,
  and ``:522`` for Chebyshev), the solves of the step and the pressure
  solve between K7 and K8, in two forms that compute the same bits: the
  per-sweep ``jacobi3_sweep`` (``csrc/jacobi3.cu``, one launch a sweep)
  and the tiled ``jacobi3_sweeps`` (``csrc/jacobi3_tiles.cu``: up to T3
  sweeps of a solve a launch, each block walking a (y, x) tile along z in
  shared memory; ``cuda_ops.sweep_plan``, ``SWEEPS_PER_LAUNCH_3D``).  A
  Chebyshev solve in fast mode takes the tiled form, the others the
  per-sweep one, as measured (``cuda_ops.tiled3``);
  ``cuda_ops.launch_sweeps`` forces either.
- ``advect3`` (K6, ``csrc/advect3.cu``): ``advect3_shift`` (``:971``) and
  ``advect3_shift_fused`` (``:728``), a trilinear gather of one to three
  fields with one backtrace, exact or in the window of ``cmax`` cells
  (launches in the window count as ``advect3_windowed``).
- ``divergence3`` (K7) and ``gradient3`` (K8), ``csrc/project3.cu``:
  ``divergence3_p`` (``:1085``) and ``gradient3_p`` (``:1101``).

Each also has a bf16 storage form (JAX's bf16 mode, whose 3-D step runs
its jnp ops): fields are stored in bf16, the kernels read bf16 and compute
in float32.  A solve's iterate stays float32 from its first sweep to its
last (shared memory within a tiled launch, float32 scratch between
launches, the per-sweep K1's bf16 rule) and is rounded to bf16 once, at
the solve's end, so the per-sweep and the tiled K5 compute the same bits;
the folded or prescaled rhs is rounded to bf16 before any sweep reads it
(``jacobi3_sweep_bf16``, ``jacobi3_sweeps_bf16``).  K6 reads bf16 fields
and velocities, finds each departure and blends in float32 and rounds at
the store (``advect3_bf16``, ``advect3_windowed_bf16``); its bf16 form
runs the gather body it shares with the grouped K14
(``csrc/advect3_body.cuh``: 2 cells a thread on bricks of 2 planes, the
velocities loaded as vectors), its float32 form a brick of two planes
of one cell a thread.  The projection
keeps a float32 divergence and pressure, as the 2-D bf16 step does: K7's
bf16 form writes float32 (``divergence3_bf16``), the pressure solve is
the float32 K5, and K8's bf16 form reads bf16 u, v, w and a float32 p and
writes bf16 (``gradient3_bf16``).  Each bf16 form is a template
instantiation of its kernel, chosen at launch, and counts apart.  Its
plain twin (``*_plain``) widens the inputs to float32, runs the float32
plain version and rounds where the kernel stores; the fast forms' twins
call an ``fmaf`` as the kernels do (``_fma_diffuse3``), so every twin
equals its kernel bit for bit.  The twins are not the ``reference``
backend's ops, which round every operation to bf16 as JAX's jnp ops do
(``ops/three_d.py``); the gathers are the one place the two agree.

Launches count in ``cuda_ops.launch_counts()``.
"""
from __future__ import annotations

import types

import torch

from ..ops.chebyshev import cheby_diffuse3, cheby_omegas
from ..ops.project import grid_h
from ..ops.three_d import (_neigh3, advect3, advect3_windowed,
                           apply_pressure_gradient3, diffuse3, divergence3,
                           embed_faces3, embed_interior3)
from . import build
from .cuda_ops import (_F32_BF16, _Sweeps, _cmax_arg, _dt0, _f32, _launch,
                       _on_card, _on_device, _plain_rhs, _stream)

BF16 = torch.bfloat16

__all__ = [
    "fused_jacobi3", "fused_jacobi3_plain", "advect3_shift",
    "advect3_shift_plain", "advect3_shift_fused", "advect3_shift_fused_plain",
    "divergence3_p", "divergence3_p_plain", "gradient3_p", "gradient3_p_plain",
    "PLAIN_TWINS",
]


# ---------------------------------------------------------------------------
# B6 / B6c fused_jacobi3 (K5)
# ---------------------------------------------------------------------------


def _fma_diffuse3(b, x_init, rhs, ab, iters, cheby_rho=None):
    """The 3-D twin of ``cuda_ops._fma_diffuse``: ``iters`` sweeps of the
    reciprocal form ``x' = rhs + ab*neigh`` (rhs already scaled by 1/beta)
    with the product and the sum rounded once, as K5's ``fmaf`` rounds
    them: in float64, where the product of two float32 values is exact,
    then back to float32.  With ``cheby_rho`` each sweep after the first is
    combined with x_{k-1} in float32 as K5 combines it.  Ghost faces are
    derived every sweep, the full ghost layer at the end
    (``ops.three_d.diffuse3``)."""
    ab = _f32(ab)
    rhs_int = rhs[1:-1, 1:-1, 1:-1].double()

    def sweep(x):
        return (rhs_int + ab * _neigh3(x).double()).to(x.dtype)

    xm, x = x_init, embed_faces3(b, sweep(x_init))
    omegas = () if cheby_rho is None else cheby_omegas(cheby_rho, iters)
    for k in range(1, iters):
        val = sweep(x)
        if omegas:
            w = torch.full((), omegas[k - 1], dtype=x.dtype, device=x.device)
            val = w * val + (1.0 - w) * xm[1:-1, 1:-1, 1:-1]
        xm, x = x, embed_faces3(b, val)
    return embed_interior3(b, x[1:-1, 1:-1, 1:-1])


def _plain_sweeps3(b, x_init, rhs, alpha, beta, iters, fast, cheby_rho):
    """The sweeps of ``fused_jacobi3_plain`` on a built rhs."""
    if fast:
        return _fma_diffuse3(b, x_init, rhs, alpha / beta, iters, cheby_rho)
    if cheby_rho is not None:
        return cheby_diffuse3(b, x_init, rhs, alpha, beta, iters, cheby_rho)
    return diffuse3(b, x_init, rhs, alpha, beta, iters)


def fused_jacobi3_plain(b, x_init, x0, alpha, beta, iters, *, zero_init=False,
                        src_dt=None, fast=False, cheby_rho=None):
    """Plain form of ``fused_jacobi3``: ``ops.three_d.diffuse3`` or
    ``ops.chebyshev.cheby_diffuse3`` on the rhs ``x0 + dt*x_init`` (times
    1/beta in fast mode, whose sweeps call an ``fmaf`` as K5's do,
    ``_fma_diffuse3``).  bf16 fields are widened to float32, the rhs built
    in float32 and rounded to bf16 once, the sweeps run in float32 and the
    result is rounded to bf16: K5's bf16 form."""
    if zero_init:
        x_init = torch.zeros_like(x0)
    if x0.dtype == BF16:
        x_init = x_init.float()
        rhs = _plain_rhs(x_init, x0.float(), beta, src_dt, fast)
        return _plain_sweeps3(b, x_init, rhs.to(BF16).float(), alpha, beta,
                              iters, fast, cheby_rho).to(BF16)
    return _plain_sweeps3(b, x_init, _plain_rhs(x_init, x0, beta, src_dt,
                                                fast),
                          alpha, beta, iters, fast, cheby_rho)


def fused_jacobi3(b, x_init, x0, alpha, beta, iters, *, zero_init=False,
                  src_dt=None, fast=False, cheby_rho=None):
    """``iters`` 7-point Jacobi sweeps (semantics of ``ops.three_d.diffuse3``)
    from guess ``x_init`` with rhs ``x0``.  ``zero_init`` starts from zero
    (pressure solve); ``src_dt`` folds the source ``x_init`` into the rhs as
    ``x0 + src_dt*x_init`` (the step's ``add_source``); ``fast`` uses the
    reciprocal form (``pallas_ops_3d.py:239-302``); ``cheby_rho`` switches
    to Chebyshev sweeps (``ops/chebyshev.py``), with x_{k-1} carried from
    launch to launch.  ceil(iters / T3) launches of the tiled K5 for a
    Chebyshev solve in fast mode, one launch of the per-sweep K5 a sweep
    otherwise (``cuda_ops.tiled3``).  On bf16 fields, the bf16 forms of
    either (the iterate float32, the result rounded once)."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if not _on_card(x0.shape[-1], x_init, x0, ndim=3, dtypes=_F32_BF16):
        return fused_jacobi3_plain(b, x_init, x0, alpha, beta, iters,
                                   zero_init=zero_init, src_dt=src_dt,
                                   fast=fast, cheby_rho=cheby_rho)
    with torch.cuda.device(x0.device):
        lib = build.load()
        sweeps = _Sweeps(b, x_init, x0, alpha, beta, iters,
                         zero_init=zero_init, src_dt=src_dt, fast=fast,
                         cheby_rho=cheby_rho, kernel="jacobi3_sweep")
        sweeps.run3(lib)
        return sweeps.x


# ---------------------------------------------------------------------------
# B7 / B7f advect3_shift, advect3_shift_fused (K6)
# ---------------------------------------------------------------------------


def advect3_shift_plain(b, d0, u, v, w, dt, n, cmax=None):
    """``ops.three_d.advect3`` (or ``advect3_windowed``): on bf16 fields
    already K6's bf16 form, a float32 gather rounded once."""
    if cmax is None:
        return advect3(b, d0, u, v, w, dt, n)
    return advect3_windowed(b, d0, u, v, w, dt, n, cmax)


def advect3_shift_fused_plain(bs, d0s, u, v, w, dt, n, cmax=None):
    return tuple(advect3_shift_plain(b, d0, u, v, w, dt, n, cmax)
                 for b, d0 in zip(bs, d0s))


def advect3_shift_fused(bs, d0s, u, v, w, dt, n, cmax=None):
    """Advect one to three fields by the same velocity with one shared
    backtrace (the (u, v, w) self-advection triple).  Exact at any
    displacement, or with ``cmax`` each departure coordinate clamped to
    ``cmax`` cells around its cell (``ops.three_d.advect3_windowed``, the
    TPU kernel's window); outputs are fresh tensors, so advecting the
    velocities by themselves reads the pre-advection velocity.  bf16
    fields and velocities take the bf16 form."""
    bs, d0s = tuple(bs), tuple(d0s)
    if len(bs) != len(d0s) or len(d0s) not in (1, 2, 3):
        raise ValueError("advect3_shift_fused takes one to three fields")
    window = _cmax_arg(cmax)
    if not _on_card(n + 2, u, v, w, *d0s, ndim=3, dtypes=_F32_BF16):
        return advect3_shift_fused_plain(bs, d0s, u, v, w, dt, n, cmax)
    bf16 = "_bf16" if u.dtype == BF16 else ""
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(torch.empty_like(d) for d in d0s)
        pad = 3 - len(d0s)  # null pointers for the fields not given
        fields = [d.data_ptr() for d in d0s] + [None] * pad
        results = [o.data_ptr() for o in outs] + [None] * pad
        modes = list(bs) + [0] * pad
        _launch(("advect3_windowed" if window else "advect3") + bf16,
                getattr(lib, f"fsc_advect3{bf16}"), *fields, u.data_ptr(),
                v.data_ptr(), w.data_ptr(), *results, n + 2, *modes,
                _dt0(dt, n), window, _stream(u))
        return outs


def advect3_shift(b, d0, u, v, w, dt, n, cmax=None):
    """Semi-Lagrangian advection of one field (``ops.three_d.advect3``, or
    ``advect3_windowed`` with ``cmax``)."""
    return advect3_shift_fused((b,), (d0,), u, v, w, dt, n, cmax)[0]


# ---------------------------------------------------------------------------
# B8a divergence3_p (K7), B8b gradient3_p (K8)
# ---------------------------------------------------------------------------


def divergence3_p_plain(u, v, w, n):
    """``ops.three_d.divergence3`` in float32: bf16 fields are widened."""
    return divergence3(u.float(), v.float(), w.float(), n)


def divergence3_p(u, v, w, n):
    """Divergence with the b=0 ghost layer (``ops.three_d.divergence3``),
    float32 whatever u, v, w store: bf16 fields take the bf16 form, which
    writes the float32 divergence of the bf16 step's projection."""
    if not _on_card(n + 2, u, v, w, ndim=3, dtypes=_F32_BF16):
        return divergence3_p_plain(u, v, w, n)
    name = "divergence3_bf16" if u.dtype == BF16 else "divergence3"
    with torch.cuda.device(u.device):
        lib = build.load()
        out = torch.empty_like(u, dtype=torch.float32)
        _launch(name, getattr(lib, f"fsc_{name}"), u.data_ptr(),
                v.data_ptr(), w.data_ptr(), out.data_ptr(), n + 2,
                -0.5 * grid_h(n), _stream(u))
        return out


def gradient3_p_plain(u, v, w, p, n):
    """``ops.three_d.apply_pressure_gradient3`` in float32, each result in
    u's dtype: bf16 fields are widened, the results rounded once."""
    return tuple(t.to(u.dtype) for t in apply_pressure_gradient3(
        u.float(), v.float(), w.float(), p.float(), n))


def gradient3_p(u, v, w, p, n):
    """Pressure-gradient subtraction with the b=1 (u), b=2 (v) and b=3 (w)
    ghost layers (``ops.three_d.apply_pressure_gradient3``).  The pressure
    is float32; bf16 u, v, w take the bf16 form, which writes bf16."""
    card = _on_card(n + 2, u, v, w, ndim=3, dtypes=_F32_BF16)
    _on_device((u, u.shape, _F32_BF16), (p, u.shape))
    if not card:
        return gradient3_p_plain(u, v, w, p, n)
    name = "gradient3_bf16" if u.dtype == BF16 else "gradient3"
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(torch.empty_like(t) for t in (u, v, w))
        _launch(name, getattr(lib, f"fsc_{name}"), u.data_ptr(), v.data_ptr(),
                w.data_ptr(), p.data_ptr(), *(o.data_ptr() for o in outs),
                n + 2, grid_h(n), _stream(u))
        return outs


# The plain twins under the wrappers' names: ``_Ops3(cfg, plain=True)``
# composes the 3-D step from them.
PLAIN_TWINS = types.SimpleNamespace(
    fused_jacobi3=fused_jacobi3_plain, advect3_shift=advect3_shift_plain,
    advect3_shift_fused=advect3_shift_fused_plain,
    divergence3_p=divergence3_p_plain, gradient3_p=gradient3_p_plain)
