"""The port's slab operations against the JAX package's slab kernels.

``advect_windowed`` is held against JAX's ``ops.advect.advect_windowed``;
each wrapper of ``kernels/cuda_sharded.py``, given CPU tensors (so it runs
its plain twin), against the JAX function of ``kernels/pallas_sharded.py``
in interpret mode, as ``tests/test_sharded_pallas.py`` runs it.  The same
numpy extended slabs go in, cut from one global field for a top, an
interior and a bottom slab of a 4-slab 64² grid.  Tolerance atol 1e-5; the
outputs agree bit for bit except the Chebyshev weights' last bits (the JAX
slab kernel runs the weight recurrence in float32, the port in float64).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.ops.advect import advect_windowed  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_sharded as ps  # noqa: E402
from fluidsimulationcuda_tpu.ops.advect import (  # noqa: E402
    advect_windowed as jax_advect_windowed)

N, SIDE, P = 62, 64, 4
M = SIDE // P
DT = 0.016
SLABS = {"top": 0, "interior": 1, "bottom": P - 1}
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    prev = pallas_ops.INTERPRET
    pallas_ops.INTERPRET = True
    yield
    pallas_ops.INTERPRET = prev


def _field(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, (SIDE, SIDE)) * scale).astype(np.float32)


def _velocity(seed, cells):
    """A velocity whose backtrace moves up to ``cells`` cells."""
    return _field(seed, cells / (DT * N))


def _flags(i):
    return (int(i == 0), int(i == P - 1), i * M)


def _slab(g, i):
    return g[i * M:(i + 1) * M]


def _ext(g, i, k):
    """Rows [i*M - k, (i+1)*M + k) of g, zeros outside the grid."""
    pad = np.pad(g, ((k, k), (0, 0)))
    return pad[i * M:(i + 1) * M + 2 * k]


def _both(a):
    """(torch CPU tensor, jax array) of one numpy array."""
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a)


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# advect_windowed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cmax,cells", [(1, 0.8), (2, 1.5), (2, 5.0),
                                        (4, 9.0)])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_advect_windowed_matches_jax(b, cmax, cells):
    """Displacements under and over the window."""
    d0, u, v = _field(1), _velocity(2, cells), _velocity(3, cells)
    got = advect_windowed(b, *(torch.from_numpy(a) for a in (d0, u, v)), DT,
                          N, cmax)
    want = jax_advect_windowed(b, *(jnp.asarray(a) for a in (d0, u, v)),
                               DT, N, cmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_advect_windowed_is_exact_under_the_window():
    from fluidsimulationcuda_torch.ops.advect import advect

    d0, u, v = (torch.from_numpy(a) for a in (_field(4), _velocity(5, 1.9),
                                              _velocity(6, 1.9)))
    assert torch.equal(advect_windowed(0, d0, u, v, DT, N, 2),
                       advect(0, d0, u, v, DT, N))
    # ...and clamps above it: the same inputs with a 1-cell window differ.
    assert not torch.equal(advect_windowed(0, d0, u, v, DT, N, 1),
                           advect(0, d0, u, v, DT, N))


# ---------------------------------------------------------------------------
# B9a fused_jacobi_slab
# ---------------------------------------------------------------------------

JACOBI_MODES = {
    "jacobi": dict(),
    "zero_init": dict(zero_init=True),
    "fast": dict(fast=True),
    "chebyshev": dict(cheby_rho=0.9),
}


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("mode", list(JACOBI_MODES))
def test_jacobi_slab_matches_jax(mode, slab):
    i, kw, b, sweeps, K = SLABS[slab], JACOBI_MODES[mode], 1, 6, 8
    alpha = DT * 0.0025 * N * N
    x, rhs = _field(10), _field(11)
    (tx, jx), (tr, jr) = _both(_ext(x, i, K)), _both(_ext(rhs, i, K))
    args = dict(m=M, K=K, alpha=alpha, beta=1 + 4 * alpha, sweeps=sweeps,
                **kw)
    got = cs.fused_jacobi_slab(b, tx, tr, _flags(i), **args)
    want = ps.fused_jacobi_slab(b, jx, jr, jnp.asarray(_flags(i), jnp.int32),
                                **args)
    _close(got, want)


# ---------------------------------------------------------------------------
# B9b fused_project_slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("rho", [None, 0.9], ids=["jacobi", "chebyshev"])
def test_project_slab_matches_jax(rho, slab):
    i, iters = SLABS[slab], 6
    K = ps.project_slab_margin(iters)
    u, v = _field(20), _field(21)
    (tu, ju), (tv, jv) = _both(_ext(u, i, K)), _both(_ext(v, i, K))
    args = dict(n=N, iters=iters, m=M, K=K, cheby_rho=rho)
    got = cs.fused_project_slab(tu, tv, _flags(i), **args)
    want = ps.fused_project_slab(ju, jv, jnp.asarray(_flags(i), jnp.int32),
                                 **args)
    _close(got, want)


# ---------------------------------------------------------------------------
# B9c fused_dens_slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("fast", [False, True], ids=["jacobi", "fast"])
def test_dens_slab_matches_jax(fast, slab):
    i, iters, cmax = SLABS[slab], 6, 2
    K = ps.dens_slab_margin(iters, cmax)
    alpha = DT * 0.1 * N * N
    src, base = _field(30), _field(31)
    u, v = _velocity(32, 1.5), _velocity(33, 1.5)
    (ts, js), (tb, jb) = _both(_ext(src, i, K)), _both(_ext(base, i, K))
    (tu, ju), (tv, jv) = _both(_slab(u, i)), _both(_slab(v, i))
    args = dict(alpha=alpha, beta=1 + 4 * alpha, iters=iters, dt=DT, n=N,
                cmax=cmax, m=M, K=K, fast=fast)
    got = cs.fused_dens_slab(0, ts, tb, tu, tv, _flags(i), **args)
    want = ps.fused_dens_slab(0, js, jb, ju, jv,
                              jnp.asarray(_flags(i), jnp.int32), **args)
    _close(got, want)


# ---------------------------------------------------------------------------
# B9d advect_slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("cells", [1.5, 5.0], ids=["under_cmax", "over_cmax"])
@pytest.mark.parametrize("pair", [False, True], ids=["single", "uv_pair"])
def test_advect_slab_matches_jax(pair, cells, slab):
    """The JAX slab pads the halo to its strip height; the port takes any
    halo of at least cmax+1 rows, so both get the same padded slabs.

    The port equals JAX's jnp specification (``advect_windowed`` on the
    whole grid, cut to the slab) to the bit.  JAX's slab kernel in
    interpret mode rounds the backtrace differently from that spec: 1.3e-5
    on the pair of 5-cell random velocities, one ulp of a departure
    coordinate times the field's cell-to-cell jump.  It is held at atol
    1e-5 times the advected fields' magnitude."""
    i, cmax, nf = SLABS[slab], 2, 2 if pair else 1
    tm = ps.advect_slab_tm(M, SIDE, nf)
    u, v, d = _velocity(40, cells), _velocity(41, cells), _field(42)
    fields = (u, v) if pair else (d,)
    bs = (1, 2) if pair else (0,)
    exts = [_both(_ext(f, i, tm)) for f in fields]
    (tu, ju), (tv, jv) = _both(_slab(u, i)), _both(_slab(v, i))
    args = dict(dt=DT, n=N, cmax=cmax, m=M, self_adv=pair)
    got = cs.advect_slab(bs, [e[0] for e in exts], None if pair else tu,
                         None if pair else tv, _flags(i), **args)
    want = ps.advect_slab(bs, tuple(e[1] for e in exts),
                          None if pair else ju, None if pair else jv,
                          jnp.asarray(_flags(i), jnp.int32), **args)
    scale = max(1.0, max(float(np.abs(f).max()) for f in fields))
    for g, w, b, f in zip(got, want, bs, fields):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL * scale)
        spec = jax_advect_windowed(b, jnp.asarray(f), jnp.asarray(u),
                                   jnp.asarray(v), DT, N, cmax)
        np.testing.assert_array_equal(g.numpy(), _slab(np.asarray(spec), i))


# ---------------------------------------------------------------------------
# B9e divergence_slab, B9f gradient_slab
# ---------------------------------------------------------------------------


def _halo8(g, i):
    """JAX's (8, side) neighbour blocks: the 8 rows above and below."""
    ext = _ext(g, i, 8)
    return ext[:8], ext[-8:]


@pytest.mark.parametrize("slab", list(SLABS))
def test_divergence_slab_matches_jax(slab):
    i = SLABS[slab]
    u, v = _field(50), _field(51)
    top, bot = _halo8(v, i)
    t = [_both(a) for a in (_slab(u, i), _slab(v, i), top, bot)]
    got = cs.divergence_slab(*(a[0] for a in t), _flags(i), N)
    want = ps.divergence_slab(*(a[1] for a in t),
                              jnp.asarray(_flags(i), jnp.int32), N)
    _close(got, want)


@pytest.mark.parametrize("slab", list(SLABS))
def test_gradient_slab_matches_jax(slab):
    i = SLABS[slab]
    u, v, p = _field(60), _field(61), _field(62)
    top, bot = _halo8(p, i)
    t = [_both(a) for a in (_slab(u, i), _slab(v, i), _slab(p, i), top, bot)]
    got = cs.gradient_slab(*(a[0] for a in t), _flags(i), N)
    want = ps.gradient_slab(*(a[1] for a in t),
                            jnp.asarray(_flags(i), jnp.int32), N)
    _close(got, want)


# ---------------------------------------------------------------------------
# Wrappers on CPU tensors, and their checks
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wrapper_cases():
    i, K, fl = 1, 16, _flags(1)
    x, y = _t(_ext(_field(70), i, K)), _t(_ext(_field(71), i, K))
    u, v = _t(_slab(_velocity(72, 1.5), i)), _t(_slab(_velocity(73, 1.5), i))
    h = _t(np.ones((1, SIDE), np.float32))
    return {
        "jacobi": (cs.fused_jacobi_slab, cs.fused_jacobi_slab_plain,
                   (1, x, y, fl), dict(m=M, K=K, alpha=0.3, beta=2.2,
                                       sweeps=7, cheby_rho=0.9)),
        "project": (cs.fused_project_slab, cs.fused_project_slab_plain,
                    (x, y, fl), dict(n=N, iters=9, m=M, K=K)),
        "dens": (cs.fused_dens_slab, cs.fused_dens_slab_plain,
                 (0, x, y, u, v, fl), dict(alpha=0.3, beta=2.2, iters=9,
                                           dt=DT, n=N, cmax=3, m=M, K=K,
                                           fast=True)),
        "advect": (cs.advect_slab, cs.advect_slab_plain,
                   ((1, 2), (x, y), None, None, fl),
                   dict(dt=DT, n=N, cmax=4, m=M, self_adv=True)),
        "divergence": (cs.divergence_slab, cs.divergence_slab_plain,
                       (u, v, h, h, fl, N), {}),
        "gradient": (cs.gradient_slab, cs.gradient_slab_plain,
                     (u, v, u, h, h, fl, N), {}),
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
    x = torch.zeros(M + 16, SIDE)
    fl = _flags(1)
    with pytest.raises(ValueError, match="halo"):  # K=8 < 9 sweeps
        cs.fused_jacobi_slab(0, x, x, fl, m=M, K=8, alpha=1.0, beta=4.0,
                             sweeps=9)
    with pytest.raises(ValueError, match="shape"):
        cs.fused_jacobi_slab(0, x, x, fl, m=M, K=4, alpha=1.0, beta=4.0,
                             sweeps=2)
    with pytest.raises(TypeError):
        cs.fused_jacobi_slab(0, x.double(), x.double(), fl, m=M, K=8,
                             alpha=1.0, beta=4.0, sweeps=2)
    with pytest.raises(ValueError, match="cmax"):  # a 2-row halo, cmax 2
        cs.advect_slab((0,), (torch.zeros(M + 4, SIDE),), x[:M], x[:M], fl,
                       dt=DT, n=N, cmax=2, m=M, self_adv=False)
    with pytest.raises(ValueError, match="halo"):
        cs.fused_project_slab(x, x, fl, n=N, iters=8, m=M, K=8)
