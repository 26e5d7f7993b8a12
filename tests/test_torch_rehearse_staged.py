"""K4 (``csrc/dens_advect.cu``) stages each block's departure footprint in
shared memory; K6 (``csrc/advect3.cu``) gathers a brick of two planes per
thread.  A CUDA kernel has no interpret mode, so this file compiles them
with ``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py``, in which a block's threads run together
and ``__syncthreads()`` is a barrier, and holds them bit for bit against
their plain versions on CPU tensors: smooth velocities, random ones over
the 4-cell window and a shear layer, exact and in windows of 1 and 4
cells.  The shim counts K4's blocks that staged their box and those that
took the direct path (a box past the cap); the counts must equal what
``checks.footprint_boxes`` predicts from the plain departure, so both
paths are covered: the shear's jump puts some blocks past the cap, and one
case puts one block's box exactly on the cap and another's past it.  The
fast mode's sweep takes K4's direct kernel, which counts no block.  K1 (its
tiled and per-sweep sources) and K3 are built too: the wrapper of K4 runs
the tiled K1 for the first sweeps, and the
plain Chebyshev fast twin rounds a few ulp apart from K1, so K4 in
Chebyshev+fast mode is held bit for bit to K1 followed by K3 (the same
sweep and blend expressions) and to the plain version within
``checks.TOL``.  Skips only without ``g++``.
"""
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fluidsimulationcuda_torch.core.config import PERF_POINTS_2D  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks, cuda_ops, cuda_ops_3d  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("dens_advect.cu", "advect3.cu", "jacobi.cu", "jacobi_tiles.cu",
           "advect.cu")
DT = checks.DT
RHO, K_D, _ = PERF_POINTS_2D[2048]
VELOCITIES = ("smooth", "random", "shear")
WINDOWS = (None, 1, 4)


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "staged")
    return mod, lib


def _run(shim, fn, *args, **kw):
    """fn through the shim library: (result, (staged, direct) blocks)."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib) as handle:
        mod.block_paths(handle)  # reset
        out = fn(*args, **kw)
        return out, mod.block_paths(handle)


def _predicted(boxes: torch.Tensor, cap: int, launches: int = 1):
    fit = int((boxes <= cap).sum())
    return launches * fit, launches * (boxes.numel() - fit)


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


MODES = {"jacobi": (20, {}), "chebyshev": (K_D, dict(cheby_rho=RHO)),
         "cheby_fast": (K_D, dict(fast=True, cheby_rho=RHO))}


def _dens_args(t, vel, mode="jacobi"):
    iters, kw = MODES[mode]
    return (0, t.src, t.x0, *vel, t.a_diff, 1 + 4 * t.a_diff, iters, DT,
            t.n), kw


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cmax", WINDOWS, ids=["exact", "cmax1", "cmax4"])
@pytest.mark.parametrize("velocity", VELOCITIES)
@pytest.mark.parametrize("batch", [1, 3])
def test_k4_staged_matches_plain(shim, batch, velocity, cmax, mode):
    """Jacobi and Chebyshev sweeps stage; the fast mode's takes the direct
    kernel, which counts no block."""
    t = checks._Inputs(34, "cpu", 0, batch=batch)
    vel = checks.gather_velocities(t)[velocity]
    args, kw = _dens_args(t, vel, mode)
    got, paths = _run(shim, cuda_ops.fused_dens_advect, *args, cmax=cmax,
                      **kw)
    want = cuda_ops.fused_dens_advect_plain(*args, cmax=cmax, **kw)
    if mode != "cheby_fast":
        assert paths == _predicted(checks.footprint_boxes(vel, t.n, cmax),
                                   checks.K4_BOX_CAP)
        if velocity == "shear" and cmax is None:
            assert paths[1] > 0, "no block took the direct path"
        assert torch.equal(got, want)
        return
    assert paths == (0, 0)
    b, src, base, u, v, alpha, beta, iters, dt, n = args

    def k1_then_k3():
        d = cuda_ops.fused_jacobi(b, src, base, alpha, beta, iters,
                                  src_dt=dt, **kw)
        return cuda_ops.advect_shift(b, d, u, v, dt, n, cmax)

    composed, _ = _run(shim, k1_then_k3)
    assert torch.equal(got, composed)
    assert checks.max_abs_diff(got, want) <= checks.TOL


@pytest.mark.parametrize("fields", ["one", "triple"])
@pytest.mark.parametrize("cmax", WINDOWS, ids=["exact", "cmax1", "cmax4"])
@pytest.mark.parametrize("velocity", VELOCITIES)
def test_k6_brick_matches_plain(shim, velocity, cmax, fields):
    t = checks._Inputs(24, "cpu", 0, ndim=3)
    vel = checks.gather_velocities(t)[velocity]
    if fields == "one":
        args = ((0,), (t.x,), *vel, DT, t.n, cmax)
    else:
        args = ((1, 2, 3), vel, *vel, DT, t.n, cmax)
    got, _ = _run(shim, cuda_ops_3d.advect3_shift_fused, *args)
    assert _same(got, cuda_ops_3d.advect3_shift_fused_plain(*args))


def _displace(vel, cell, target, n):
    """Set the velocity of ``cell`` (row, column) so that its departure
    lands at ``target`` (x, y), each coordinate well inside a cell
    whatever the rounding."""
    dt0 = float(np.float32(DT) * np.float32(n))
    for comp, own, to in zip(vel, reversed(cell), target):
        comp[cell] = (own - to) / dt0


def test_k4_box_on_the_cap_and_past_it(shim):
    """Block (0, 0) of a 34² grid gathers from a box of exactly 32 x 32 =
    ``K4_BOX_CAP`` cells and stages it; block (1, 0) from 34 x 32 and
    takes the direct path."""
    t = checks._Inputs(34, "cpu", 0)
    u, v = torch.zeros_like(t.u), torch.zeros_like(t.v)
    _displace((u, v), (1, 1), (1.5, 31.5), t.n)   # rows 1..32
    _displace((u, v), (9, 1), (1.5, 32.4), t.n)   # rows .. 33
    _displace((u, v), (9, 2), (2.5, 0.5), t.n)    # rows 0 ..
    boxes = checks.footprint_boxes((u, v), t.n)
    assert int(boxes[0, 0]) == checks.K4_BOX_CAP
    assert int(boxes[1, 0]) > checks.K4_BOX_CAP
    args, _ = _dens_args(t, (u, v))
    got, paths = _run(shim, cuda_ops.fused_dens_advect, *args)
    assert paths == _predicted(boxes, checks.K4_BOX_CAP)
    assert paths[1] == 1
    assert torch.equal(got, cuda_ops.fused_dens_advect_plain(*args))
