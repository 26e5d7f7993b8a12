"""The port's z-slab operations against the JAX package's z-slab kernels.

``advect3_windowed`` is held against JAX's ``ops.three_d.advect3_windowed``;
each wrapper of ``kernels/cuda_sharded_3d.py``, given CPU tensors (so it
runs its plain twin), against the JAX function of
``kernels/pallas_sharded_3d.py`` in interpret mode, as
``tests/test_sharded_3d.py`` runs it, and the two stencils against JAX's
global ``divergence3`` / ``apply_pressure_gradient3`` cut to the slab.  The
same numpy extended slabs go in, cut from one global volume for a top, an
interior and a bottom slab of a 4-slab 16³ volume.

The JAX slab kernels leave ghost edges and corners raw (the step derives
them afterwards, ``sharded3d.py:692-702``); the port's derive the full
layer.  So every JAX output goes through JAX's own ``_apply_bnd3_direct``
first, with the slab's wall flags.  Tolerance atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fluidsimulationcuda_torch.kernels import cuda_sharded_3d as cs3  # noqa: E402
from fluidsimulationcuda_torch.ops.chebyshev import (  # noqa: E402
    cheby_diffuse3, cheby_omegas)
from fluidsimulationcuda_torch.ops.three_d import (  # noqa: E402
    advect3, advect3_windowed, set_bnd3)
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_sharded_3d as p3  # noqa: E402
from fluidsimulationcuda_tpu.ops import three_d as j3  # noqa: E402
from fluidsimulationcuda_tpu.parallel.sharded3d import (  # noqa: E402
    _apply_bnd3_direct)

N, SIDE, P = 14, 16, 4
M = SIDE // P
DT = 0.016
SLABS = {"top": 0, "interior": 1, "bottom": P - 1}
ATOL = 1e-6
ALPHA = DT * 0.0025 * N * N


@pytest.fixture(autouse=True)
def _interpret_mode():
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    yield
    pallas_ops.INTERPRET = prev


def _field(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, (SIDE,) * 3) * scale).astype(np.float32)


def _velocity(seed, cells):
    """A velocity whose backtrace moves up to ``cells`` cells per axis."""
    return _field(seed, cells / (DT * N))


def _flags(i):
    return (int(i == 0), int(i == P - 1), i * M)


def _jflags(i):
    return jnp.asarray(_flags(i), jnp.int32)


def _slab(g, i):
    return g[i * M:(i + 1) * M]


def _ext(g, i, k):
    """Planes [i*M - k, (i+1)*M + k) of g, zeros outside the volume."""
    pad = np.pad(g, ((k, k), (0, 0), (0, 0)))
    return pad[i * M:(i + 1) * M + 2 * k]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bnd(b, out, i):
    """JAX's slab output with its ghost layer derived by JAX's own rule."""
    fl = _flags(i)
    return np.asarray(_apply_bnd3_direct(b, out, bool(fl[0]), bool(fl[1])))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# advect3_windowed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cmax,cells", [(1, 0.8), (2, 1.5), (2, 5.0)])
@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_advect3_windowed_matches_jax(b, cmax, cells):
    """Displacements under and over the window."""
    d0 = _field(1)
    u, v, w = (_velocity(s, cells) for s in (2, 3, 4))
    got = advect3_windowed(b, *map(_t, (d0, u, v, w)), DT, N, cmax)
    want = j3.advect3_windowed(b, *map(jnp.asarray, (d0, u, v, w)), DT, N,
                               cmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_advect3_windowed_is_exact_under_the_window():
    d0 = _t(_field(5))
    u, v, w = (_t(_velocity(s, 1.9)) for s in (6, 7, 8))
    assert torch.equal(advect3_windowed(0, d0, u, v, w, DT, N, 2),
                       advect3(0, d0, u, v, w, DT, N))
    # ...and clamps above it: the same inputs with a 1-cell window differ.
    assert not torch.equal(advect3_windowed(0, d0, u, v, w, DT, N, 1),
                           advect3(0, d0, u, v, w, DT, N))


# ---------------------------------------------------------------------------
# B10a fused_jacobi3_slab
# ---------------------------------------------------------------------------

JACOBI_MODES = {"jacobi": dict(), "zero_init": dict(zero_init=True),
                "fast": dict(fast=True)}


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("mode", list(JACOBI_MODES))
def test_jacobi3_slab_matches_jax(mode, slab):
    """The step's largest segment at this slab height: K = M-1 sweeps over
    an H = K+1 halo."""
    i, b, K = SLABS[slab], 1, M - 1
    H = K + 1
    x, rhs = _ext(_field(10), i, H), _ext(_field(11), i, H)
    args = dict(mz=M, H=H, alpha=ALPHA, beta=1 + 6 * ALPHA, sweeps=K,
                **JACOBI_MODES[mode])
    got = cs3.fused_jacobi3_slab(b, _t(x), _t(rhs), _flags(i), **args)
    want = p3.fused_jacobi3_slab(b, jnp.asarray(x), jnp.asarray(rhs),
                                 _jflags(i), **args)
    _close(got, _bnd(b, want, i))


# ---------------------------------------------------------------------------
# B10b fused_cheby3_slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("segment", ["first", "chained"])
def test_cheby3_slab_matches_jax(segment, slab):
    """A chain's first segment (sweeps 0-2, the first plain) and a chained
    one (sweeps 3-5, x_{k-1} carried in); both hand both iterates on.  A
    chained segment's iterate carries its derived ghost layer, as every
    segment's output does: JAX's kernel folds the border rule into its
    reads there instead of reading the ghost cells."""
    i, b, rho, H = SLABS[slab], 2, 0.85, M
    start, sweeps = (0, 3) if segment == "first" else (3, 3)
    x = _field(20)
    if start > 0:
        x = set_bnd3(b, _t(x)).numpy()
    x, xm, rhs = _ext(x, i, H), _ext(_field(21), i, H), _ext(_field(22), i, H)
    carry_in = start > 0
    ws = tuple([None, *cheby_omegas(rho, start + sweeps)][start:])
    common = dict(mz=M, H=H, alpha=ALPHA, beta=1 + 6 * ALPHA,
                  carry_in=carry_in, carry_out=True)
    got = cs3.fused_cheby3_slab(b, _t(x), _t(xm) if carry_in else None,
                                _t(rhs), _flags(i), cheby_rho=rho,
                                start=start, sweeps=sweeps, **common)
    want = p3.fused_cheby3_slab(b, jnp.asarray(x),
                                jnp.asarray(xm) if carry_in else None,
                                jnp.asarray(rhs), _jflags(i), ws=ws, **common)
    for g, w in zip(got, want):
        _close(g, _bnd(b, w, i))


def test_cheby3_segments_chain_to_the_unsegmented_solve():
    """A 6-sweep chain run on every slab of the volume in segments of 1, 2
    and 3 sweeps, each fed the previous one's exchanged iterates (x and
    x_{k-1}), equals the unsegmented ``cheby_diffuse3`` on the whole
    volume: a segment that restarted ω or dropped x_{k-1} would not."""
    b, rho, H, iters = 3, 0.9, M, 6
    x0, rhs = _field(30), _field(31)
    common = dict(mz=M, H=H, alpha=1.0, beta=6.0, cheby_rho=rho)
    x, xm, done = x0, None, 0
    for s in (1, 2, 3):
        last = done + s == iters
        res = [cs3.fused_cheby3_slab(
            b, _t(_ext(x, k, H)), None if xm is None else _t(_ext(xm, k, H)),
            _t(_ext(rhs, k, H)), _flags(k), start=done, sweeps=s,
            carry_in=xm is not None, carry_out=not last, **common)
            for k in range(P)]
        if last:
            x = np.concatenate([r.numpy() for r in res])
        else:
            x = np.concatenate([r[0].numpy() for r in res])
            xm = np.concatenate([r[1].numpy() for r in res])
        done += s
    want = cheby_diffuse3(b, _t(x0), _t(rhs), 1.0, 6.0, iters, rho)
    np.testing.assert_array_equal(x, want.numpy())


# ---------------------------------------------------------------------------
# B10c advect3_flat_slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("cmax", [1, 2])
def test_advect3_slab_matches_jax(cmax, slab):
    """One field under and over the window (displacements up to 1.5 cells
    per axis against windows of 1 and 2), and the port's (u, v, w) triple
    against three JAX calls.  The port equals JAX's jnp specification
    (``advect3_windowed`` on the whole volume, cut to the slab) to the bit.
    JAX's slab kernel in interpret mode rounds the backtrace differently
    from that spec (up to 6e-6 on these 6.7-unit velocities, one ulp of a
    departure coordinate times the field's cell-to-cell jump); it is held
    at 2e-6 times the advected field's magnitude, the tolerance JAX's own
    tests hold its slab route to against its jnp route."""
    i, C = SLABS[slab], cmax + 1
    d0 = _field(40)
    u, v, w = (_velocity(s, 1.5) for s in (41, 42, 43))
    uvw = [_slab(f, i) for f in (u, v, w)]
    args = dict(dt=DT, n=N, cmax=cmax, mz=M)
    got = (cs3.advect3_flat_slab((0,), [_t(_ext(d0, i, C))], *map(_t, uvw),
                                 _flags(i), **args)
           + cs3.advect3_flat_slab((1, 2, 3),
                                   [_t(_ext(f, i, C)) for f in (u, v, w)],
                                   *map(_t, uvw), _flags(i), **args))
    for b, g, f in zip((0, 1, 2, 3), got, (d0, u, v, w)):
        want = p3.advect3_flat_slab(jnp.asarray(_ext(f, i, C)),
                                    *map(jnp.asarray, uvw), _jflags(i),
                                    **args)
        scale = max(1.0, float(np.abs(f).max()))
        np.testing.assert_allclose(g.numpy(), _bnd(b, want, i), rtol=0,
                                   atol=2e-6 * scale)
        spec = j3.advect3_windowed(b, *map(jnp.asarray, (f, u, v, w)), DT,
                                   N, cmax)
        np.testing.assert_array_equal(g.numpy(), _slab(np.asarray(spec), i))


# ---------------------------------------------------------------------------
# The stencils: divergence3_slab, gradient3_slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slab", list(SLABS))
def test_divergence3_slab_is_the_global_divergence(slab):
    i = SLABS[slab]
    u, v, w = (_field(s) for s in (50, 51, 52))
    wx = _ext(w, i, 1)
    got = cs3.divergence3_slab(*(_t(_slab(f, i)) for f in (u, v, w)),
                               _t(wx[:1]), _t(wx[-1:]), _flags(i), N)
    want = j3.divergence3(*map(jnp.asarray, (u, v, w)), N)
    np.testing.assert_array_equal(got.numpy(), _slab(np.asarray(want), i))


@pytest.mark.parametrize("slab", list(SLABS))
def test_gradient3_slab_is_the_global_gradient(slab):
    i = SLABS[slab]
    u, v, w, p = (_field(s) for s in (60, 61, 62, 63))
    px = _ext(p, i, 1)
    got = cs3.gradient3_slab(*(_t(_slab(f, i)) for f in (u, v, w, p)),
                             _t(px[:1]), _t(px[-1:]), _flags(i), N)
    want = j3.apply_pressure_gradient3(*map(jnp.asarray, (u, v, w, p)), N)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _slab(np.asarray(wv), i))


# ---------------------------------------------------------------------------
# Wrappers on CPU tensors, and their checks
# ---------------------------------------------------------------------------


def _wrapper_cases():
    i, H, fl = 1, M, _flags(1)
    x, y, z = (_t(_ext(_field(s), i, H)) for s in (70, 71, 72))
    u, v, w = (_t(_slab(_velocity(s, 1.5), i)) for s in (73, 74, 75))
    h = _t(np.ones((1, SIDE, SIDE), np.float32))
    return {
        "jacobi": (cs3.fused_jacobi3_slab, cs3.fused_jacobi3_slab_plain,
                   (1, x, y, fl), dict(mz=M, H=H, alpha=0.3, beta=2.8,
                                       sweeps=3, fast=True)),
        "cheby": (cs3.fused_cheby3_slab, cs3.fused_cheby3_slab_plain,
                  (2, x, z, y, fl), dict(mz=M, H=H, alpha=0.3, beta=2.8,
                                         cheby_rho=0.9, start=2, sweeps=3,
                                         carry_in=True, carry_out=True)),
        "advect": (cs3.advect3_flat_slab, cs3.advect3_flat_slab_plain,
                   ((1, 2, 3), (x, y, z), u, v, w, fl),
                   dict(dt=DT, n=N, cmax=3, mz=M)),
        "divergence": (cs3.divergence3_slab, cs3.divergence3_slab_plain,
                       (u, v, w, h, h, fl, N), {}),
        "gradient": (cs3.gradient3_slab, cs3.gradient3_slab_plain,
                     (u, v, w, u, h, h, fl, N), {}),
    }


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_wrapper_on_cpu_is_its_plain_twin(name):
    wrapper, plain, args, kw = _wrapper_cases()[name]
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool(torch.isfinite(g).all())


def test_wrapper_checks():
    x = torch.zeros(M + 8, SIDE, SIDE)
    fl = _flags(1)
    with pytest.raises(ValueError, match="halo"):  # H=4 < 4 sweeps + 1
        cs3.fused_jacobi3_slab(0, x, x, fl, mz=M, H=4, alpha=1.0, beta=6.0,
                               sweeps=4)
    with pytest.raises(ValueError, match="shape"):
        cs3.fused_jacobi3_slab(0, x, x, fl, mz=M, H=3, alpha=1.0, beta=6.0,
                               sweeps=2)
    with pytest.raises(TypeError):
        cs3.fused_jacobi3_slab(0, x.double(), x.double(), fl, mz=M, H=4,
                               alpha=1.0, beta=6.0, sweeps=2)
    with pytest.raises(ValueError, match="carries"):  # start > 0, no carry
        cs3.fused_cheby3_slab(0, x, None, x, fl, mz=M, H=4, alpha=1.0,
                              beta=6.0, cheby_rho=0.9, start=2, sweeps=2)
    with pytest.raises(ValueError, match="cmax"):  # a 2-plane halo, cmax 2
        cs3.advect3_flat_slab((0,), (torch.zeros(M + 4, SIDE, SIDE),),
                              x[:M], x[:M], x[:M], fl, dt=DT, n=N, cmax=2,
                              mz=M)
