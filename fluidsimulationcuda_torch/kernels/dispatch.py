"""Backend dispatch (twin of ``fluidsimulationcuda_tpu.kernels.dispatch``).

- ``reference``: the plain torch ops of ``ops/``, on any device.
- ``cuda``: the hand-written kernels (``kernels/cuda_ops.py``).
- ``auto``: decided by ``SimConfig.resolved_backend`` from the config's
  device alone.

Both gather exactly under ``advect_mode="auto"`` or ``"exact"``, and under
the window of ``max_courant`` cells with ``"windowed"`` (JAX's reference
backend takes ``ops.advect.advect_windowed`` then, and its Pallas backend
always gathers so).  The multigrid smoother is ``ops.multigrid._smooth`` on
``reference`` and K1's damped sweep on ``cuda``.

``get_ops`` returns the single-device step's ``OpSet``, ``get_block_ops``
the block route's ``BlockOpSet`` (``kernels/cuda_sharded.py``: K9-block,
K12-block, K10-block and K11-block, or the ``reference`` forms, which in
bf16 round every operation as JAX's jnp block route does, or the kernels'
plain twins), ``get_slab_ops``
the multi-device step's ``SlabOpSet`` (``kernels/cuda_sharded.py``: the
row-slab kernels or their plain twins; the slab multigrid smooths its fine
level with the SlabOpSet's ``smooth``, the grouped K9-damp or its plain
twin, and its replicated coarse level with the OpSet's), ``get_slab3_ops`` the 3-D
multi-device step's ``Slab3OpSet`` (``kernels/cuda_sharded_3d.py``: the
z-slab kernels, or the ``reference`` forms, which in bf16 round every
operation as JAX's jnp z-slab route does, or the kernels' plain twins).

The backend is chosen once, explicitly, from the config: callers never
infer it from which OpSet fields are set, and no path catches an error to
fall back to another backend.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from ..core.config import SimConfig
from ..ops.advect import advect as _advect_ref
from ..ops.advect import advect_windowed as _advect_windowed_ref
from ..ops.chebyshev import cheby_diffuse as _cheby_diffuse_ref
from ..ops.chebyshev import cheby_pressure_solve as _cheby_pressure_ref
from ..ops.diffuse import diffuse as _diffuse_plain
from ..ops.multigrid import _smooth as _smooth_ref
from ..ops.project import (
    apply_pressure_gradient as _apg_ref,
    divergence as _divergence_ref,
    pressure_solve as _pressure_plain,
)
from ..ops.source import add_source

__all__ = ["OpSet", "SlabOpSet", "Slab3OpSet", "BlockOpSet", "get_ops",
           "get_slab_ops", "get_slab3_ops", "get_block_ops"]


class OpSet(NamedTuple):
    """The five-op compute surface plus the fused forms the step uses: the
    u/v pair advection (shared backtrace), the projection, the diffusion
    with its source folded in, the multigrid smoother (``smooth(p, div,
    sweeps, zero_init=False)``, damped Jacobi; ``ops/multigrid.py``), and
    optionally the whole density pair ``diffuse_src -> advect``
    (``FluidSequential.c:176-186``) in one op (None: the step composes the
    two)."""

    diffuse: Callable
    advect: Callable
    divergence: Callable
    pressure_solve: Callable
    apply_pressure_gradient: Callable
    advect_pair: Callable
    project: Callable
    diffuse_src: Callable
    smooth: Callable
    diffuse_advect: Callable | None = None


def _diffuse_ref(b, x_init, x0, alpha, beta, iters, cheby_rho=None):
    if cheby_rho is not None:
        return _cheby_diffuse_ref(b, x_init, x0, alpha, beta, iters, cheby_rho)
    return _diffuse_plain(b, x_init, x0, alpha, beta, iters)


def _pressure_ref(div, iters, cheby_rho=None):
    if cheby_rho is not None:
        return _cheby_pressure_ref(div, iters, cheby_rho)
    return _pressure_plain(div, iters)


def _advect_pair_ref(b1, b2, d1, d2, u, v, dt, n):
    return _advect_ref(b1, d1, u, v, dt, n), _advect_ref(b2, d2, u, v, dt, n)


def _project_ref(u, v, n, iters, cheby_rho=None):
    div = _divergence_ref(u, v, n)
    p = _pressure_ref(div, iters, cheby_rho=cheby_rho)
    return _apg_ref(u, v, p, n)


def _diffuse_src_ref(b, src, base, alpha, beta, iters, dt, cheby_rho=None):
    return _diffuse_ref(b, src, add_source(base, src, dt), alpha, beta, iters,
                        cheby_rho=cheby_rho)


_REFERENCE_OPS = OpSet(
    diffuse=_diffuse_ref,
    advect=_advect_ref,
    divergence=_divergence_ref,
    pressure_solve=_pressure_ref,
    apply_pressure_gradient=_apg_ref,
    advect_pair=_advect_pair_ref,
    project=_project_ref,
    diffuse_src=_diffuse_src_ref,
    smooth=_smooth_ref,
)


def get_ops(cfg: SimConfig) -> OpSet:
    backend = cfg.resolved_backend
    if backend == "reference":
        if cfg.advect_mode != "windowed":
            return _REFERENCE_OPS
        cmax = cfg.max_courant

        def adv(b, d0, u, v, dt, n):
            return _advect_windowed_ref(b, d0, u, v, dt, n, cmax)

        def adv_pair(b1, b2, d1, d2, u, v, dt, n):
            return adv(b1, d1, u, v, dt, n), adv(b2, d2, u, v, dt, n)

        return _REFERENCE_OPS._replace(advect=adv, advect_pair=adv_pair)
    if backend == "cuda":
        from . import cuda_ops

        return cuda_ops.make_opset(cfg)
    raise ValueError(f"unknown backend {backend!r}")


class SlabOpSet(NamedTuple):
    """The per-slab operations of the multi-device step
    (``parallel/sharded.py``), with the JAX slab functions' signatures
    (``kernels/cuda_sharded.py``; ``advect`` the windowed gather,
    ``advect_exact`` the exact one from the assembled fields) and the slab
    multigrid's smoother (``smooth(p_slabs, div_slabs, flags, *, sweeps,
    zero_init)``, the list of every slab in and out), and
    whether this backend honours ``fast_math`` (the ``reference`` backend
    ignores it, as the JAX package's does)."""

    jacobi: Callable
    project: Callable
    dens: Callable
    advect: Callable
    advect_exact: Callable
    divergence: Callable
    gradient: Callable
    smooth: Callable
    fast: bool


def get_slab_ops(cfg: SimConfig) -> SlabOpSet:
    """The slab kernels (``cuda``) or their plain twins (``reference``),
    chosen once from ``cfg.resolved_backend``."""
    from . import cuda_sharded as cs

    backend = cfg.resolved_backend
    if backend == "reference":
        return SlabOpSet(cs.fused_jacobi_slab_plain,
                         cs.fused_project_slab_plain,
                         cs.fused_dens_slab_plain, cs.advect_slab_plain,
                         cs.advect_slab_exact_plain,
                         cs.divergence_slab_plain, cs.gradient_slab_plain,
                         cs.smooth_slabs_plain, fast=False)
    if backend == "cuda":
        return SlabOpSet(cs.fused_jacobi_slab, cs.fused_project_slab,
                         cs.fused_dens_slab, cs.advect_slab,
                         cs.advect_slab_exact, cs.divergence_slab,
                         cs.gradient_slab, cs.smooth_slabs,
                         fast=cfg.fast_math)
    raise ValueError(f"unknown backend {backend!r}")


class BlockOpSet(NamedTuple):
    """The per-block operations of the block route (``parallel/sharded.py``,
    ``_BlockStep``), with the signatures of ``kernels/cuda_sharded.py``:
    ``jacobi`` a chunk of a Jacobi or Chebyshev block solve, ``smooth``
    the multigrid's damped chunk, ``advect`` the windowed gather,
    ``advect_exact`` the exact one from the assembled fields, and whether
    this backend honours ``fast_math`` (the ``reference`` backend ignores
    it, as the JAX package's does).  ``jacobi_group`` and ``smooth_group``,
    on the ``cuda`` backend, run a chunk of ``jacobi`` or ``smooth`` on
    every block at once from the lists of blocks (the grouped K9-block,
    no extended block built); None elsewhere, where a chunk extends every
    block (``Blocks.ext``) and runs ``jacobi`` or ``smooth`` on each, as
    JAX composes it.  So too ``gradient_group`` (the grouped K11-block, no
    ``Blocks.halos`` of p) and ``advect_group`` (the grouped K12-block,
    windowed or exact, no ``Blocks.ext`` and no ``Blocks.gather``) for
    ``gradient`` and ``advect``/``advect_exact``."""

    jacobi: Callable
    smooth: Callable
    advect: Callable
    advect_exact: Callable
    divergence: Callable
    gradient: Callable
    fast: bool
    jacobi_group: Callable | None = None
    smooth_group: Callable | None = None
    gradient_group: Callable | None = None
    advect_group: Callable | None = None


def get_block_ops(cfg: SimConfig, plain: bool = False) -> BlockOpSet:
    """The block kernels (``cuda``) or the ``reference`` backend's forms,
    chosen once from ``cfg.resolved_backend``.  In float32 the
    ``reference`` forms are the kernels' plain twins; in bf16 they split:
    the ``reference`` forms round every operation to bf16 as JAX's jnp
    block route does (``*_ref``), a twin rounds where its kernel stores
    (``*_plain``; the gathers are float32 in both).  ``plain`` (a ``cuda``
    config) binds the kernels' plain twins on any device, fast math
    included: what a block step on the card is held to bit for bit."""
    from . import cuda_sharded as cs

    backend = cfg.resolved_backend
    if backend == "reference":
        return BlockOpSet(cs.fused_jacobi_block_ref, cs.smooth_block_ref,
                          cs.advect_block_plain, cs.advect_block_exact_plain,
                          cs.divergence_block_ref, cs.gradient_block_ref,
                          fast=False)
    if backend == "cuda" and plain:
        return BlockOpSet(cs.fused_jacobi_block_plain, cs.smooth_block_plain,
                          cs.advect_block_plain, cs.advect_block_exact_plain,
                          cs.divergence_block_plain, cs.gradient_block_plain,
                          fast=cfg.fast_math)
    if backend == "cuda":
        return BlockOpSet(cs.fused_jacobi_block, cs.smooth_block,
                          cs.advect_block, cs.advect_block_exact,
                          cs.divergence_block, cs.gradient_block,
                          fast=cfg.fast_math,
                          jacobi_group=cs.fused_jacobi_blocks,
                          smooth_group=cs.smooth_blocks,
                          gradient_group=cs.gradient_blocks,
                          advect_group=cs.advect_blocks)
    raise ValueError(f"unknown backend {backend!r}")


class Slab3OpSet(NamedTuple):
    """The per-slab operations of the 3-D multi-device step
    (``parallel/sharded3d.py``), with the signatures of
    ``kernels/cuda_sharded_3d.py`` (``advect`` the windowed gather,
    ``advect_exact`` the exact one from the assembled fields), and whether
    this backend honours ``fast_math`` (the ``reference`` backend ignores
    it, as the JAX package's does).  ``advect_group``, on the ``cuda``
    backend, gathers every slab at once from the lists of slabs, windowed
    or exact (the grouped K14, one launch a device, no extended slab and
    no assembled volume built); None elsewhere, where a gather extends
    (``_ext``) or assembles (``_gather``) each field and runs ``advect``
    or ``advect_exact`` on each slab, as JAX composes it."""

    jacobi: Callable
    cheby: Callable
    advect: Callable
    advect_exact: Callable
    divergence: Callable
    gradient: Callable
    fast: bool
    advect_group: Callable | None = None


def get_slab3_ops(cfg: SimConfig, plain: bool = False) -> Slab3OpSet:
    """The z-slab kernels (``cuda``) or the ``reference`` backend's forms,
    chosen once from ``cfg.resolved_backend``.  In float32 the
    ``reference`` forms are the kernels' plain twins; in bf16 they split,
    as ``get_block_ops``' do: the ``reference`` forms round every
    operation to bf16 as JAX's jnp z-slab route does (``*_ref``), a twin
    rounds where its kernel stores (``*_plain``; the gathers are float32 in
    both).  ``plain`` (a ``cuda`` config) binds the kernels' plain twins
    on any device, fast math included: what a z-slab step on the card is
    held to bit for bit."""
    from . import cuda_sharded_3d as cs3

    backend = cfg.resolved_backend
    if backend == "reference":
        return Slab3OpSet(cs3.fused_jacobi3_slab_ref,
                          cs3.fused_cheby3_slab_ref,
                          cs3.advect3_flat_slab_plain,
                          cs3.advect3_flat_slab_exact_plain,
                          cs3.divergence3_slab_ref,
                          cs3.gradient3_slab_ref, fast=False)
    if backend == "cuda" and plain:
        return Slab3OpSet(cs3.fused_jacobi3_slab_plain,
                          cs3.fused_cheby3_slab_plain,
                          cs3.advect3_flat_slab_plain,
                          cs3.advect3_flat_slab_exact_plain,
                          cs3.divergence3_slab_plain,
                          cs3.gradient3_slab_plain, fast=cfg.fast_math)
    if backend == "cuda":
        return Slab3OpSet(cs3.fused_jacobi3_slab, cs3.fused_cheby3_slab,
                          cs3.advect3_flat_slab, cs3.advect3_flat_slab_exact,
                          cs3.divergence3_slab, cs3.gradient3_slab,
                          fast=cfg.fast_math, advect_group=cs3.advect3_group)
    raise ValueError(f"unknown backend {backend!r}")
