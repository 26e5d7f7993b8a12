"""The port's split-operand slab Jacobi (``cuda_sharded.
fused_jacobi_slab_split``, K18 + K9) against its concat route and against
the JAX package's ``fused_jacobi_slab_split`` (B13) in interpret mode, as
tests/test_sharded_fused.py:62-87 runs it.

On CPU tensors the wrapper returns its plain version, the concat route
(``torch.cat`` of the halos and the slab, then ``fused_jacobi_slab``),
which the GPU tests and chip_smoke.py hold K18 against.  The operands are
cut from numpy global fields for a top, an interior and a bottom slab of a
4-slab 128² grid: m=32 rows, K=16-row halos (zeros beyond a wall), 6
sweeps.  JAX's own contract for B13 is bit-for-bit equality with its
concat route; against JAX the tolerance is that of
tests/test_torch_sharded_ops.py for ``fused_jacobi_slab`` (atol 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fluidsimulationcuda_torch.kernels import cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_ops  # noqa: E402
from fluidsimulationcuda_tpu.kernels import pallas_sharded as ps  # noqa: E402

N, SIDE, P = 126, 128, 4
M, K, SWEEPS = SIDE // P, 16, 6
SLABS = {"top": 0, "interior": 1, "bottom": P - 1}
MODES = {"jacobi": dict(), "zero_init": dict(zero_init=True),
         "fast": dict(fast=True)}
ALPHA = 0.016 * 0.0025 * N * N
ARGS = dict(m=M, K=K, alpha=ALPHA, beta=1 + 4 * ALPHA, sweeps=SWEEPS)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_ops, "INTERPRET", True)


def _field(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (SIDE, SIDE)).astype(np.float32)


def _operands(g, i):
    """(slab, top halo, bottom halo) of slab i: K rows of the neighbours,
    zeros beyond a wall."""
    pad = np.pad(g, ((K, K), (0, 0)))
    ext = pad[i * M:(i + 1) * M + 2 * K]
    return (np.ascontiguousarray(ext[K:K + M]), np.ascontiguousarray(ext[:K]),
            np.ascontiguousarray(ext[K + M:]))


def _flags(i):
    return (int(i == 0), int(i == P - 1), i * M)


def _torch_args(i):
    x, rhs = _operands(_field(10), i), _operands(_field(11), i)
    return tuple(torch.from_numpy(a) for a in (*x, *rhs))


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("mode", list(MODES))
def test_split_equals_concat_route(mode, slab):
    i = SLABS[slab]
    x, xt, xb, r, rt, rb = _torch_args(i)
    got = cs.fused_jacobi_slab_split(1, x, xt, xb, r, rt, rb, _flags(i),
                                     **ARGS, **MODES[mode])
    want = cs.fused_jacobi_slab(1, torch.cat([xt, x, xb]),
                                torch.cat([rt, r, rb]), _flags(i), **ARGS,
                                **MODES[mode])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("slab", list(SLABS))
@pytest.mark.parametrize("mode", list(MODES))
def test_split_matches_jax(mode, slab):
    i = SLABS[slab]
    args = _torch_args(i)
    got = cs.fused_jacobi_slab_split(1, *args, _flags(i), **ARGS,
                                     **MODES[mode])
    want = ps.fused_jacobi_slab_split(
        1, *(jnp.asarray(a.numpy()) for a in args),
        jnp.asarray(_flags(i), jnp.int32), **ARGS, **MODES[mode])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_zero_init_ignores_the_x_operands():
    x, xt, xb, r, rt, rb = _torch_args(1)
    want = cs.fused_jacobi_slab_split(1, x, xt, xb, r, rt, rb, _flags(1),
                                      zero_init=True, **ARGS)
    got = cs.fused_jacobi_slab_split(1, None, None, None, r, rt, rb,
                                     _flags(1), zero_init=True, **ARGS)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_split_viable_drops_the_tpu_strip_gate():
    """JAX needs a strip of at least K rows (its three-DMA window); the
    port takes any slab its halos and indices fit."""
    assert not ps.jacobi_slab_split_viable(8, 128, 16)
    assert cs.jacobi_slab_split_viable(8, 128, 16)
    assert ps.jacobi_slab_split_viable(M, SIDE, K)
    assert cs.jacobi_slab_split_viable(M, SIDE, K)
    for m, side, k in ((0, 128, 16), (32, 128, 0), (32, 2, 16),
                       (2**20, 2**11, 8)):
        assert not cs.jacobi_slab_split_viable(m, side, k)


@pytest.mark.parametrize("bad", ["halo_rows", "halo_width", "deep_sweeps",
                                 "slab_rows"])
def test_split_rejects(bad):
    x, xt, xb, r, rt, rb = _torch_args(1)
    kw = dict(ARGS)
    if bad == "halo_rows":
        xt = xt[1:]
    elif bad == "halo_width":
        rb = torch.zeros(K, SIDE + 2)
    elif bad == "deep_sweeps":
        kw["sweeps"] = K + 1
    else:
        r = r[1:]
    with pytest.raises(ValueError):
        cs.fused_jacobi_slab_split(1, x, xt, xb, r, rt, rb, _flags(1), **kw)


def test_cpu_tensors_launch_nothing():
    cuda_ops.reset_launch_counts()
    cs.fused_jacobi_slab_split(1, *_torch_args(0), _flags(0), **ARGS)
    assert cuda_ops.launch_counts() == dict.fromkeys(cuda_ops.KERNELS, 0)
