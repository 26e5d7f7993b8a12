"""K12's and K14's exact forms (``csrc/advect_slab.cu``,
``csrc/advect3_slab.cu``), the gathers of the multi-device steps'
``advect_mode="exact"``, behind the host shim of
``dev/rehearse_kernels_cpu.py`` (a CUDA kernel has no interpret mode, so
this file compiles the sources with ``g++ -ffp-contract=off``).

Each exact form reads the whole assembled field at global rows or planes:
on a slab whose first row or plane is not 0 (``row0 > 0``) a wrong offset
would read another slab's rows.  The forms are held bit for bit against
their plain versions on the top, interior and bottom slabs of a 64² grid
(16-row slabs) and a 24³ volume (8- and 3-plane slabs), at displacements
up to 2, 6 and 24 cells; and the slabs' results, stacked, against the
single-device gathers K3 and K6 on the whole grid, exact at any
displacement, bit for bit.  Skips only without ``g++``.
"""
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fluidsimulationcuda_torch.kernels import checks, cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops_3d  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402
from fluidsimulationcuda_torch.kernels import (  # noqa: E402
    cuda_sharded_3d as cs3)

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("advect_slab.cu", "advect3_slab.cu", "advect.cu", "advect3.cu")
DT = checks.DT


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "exact_gather")
    return mod, lib


def _run(shim, fn, *args, **kw):
    """fn through the shim library: (result, launch counts)."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib):
        cuda_ops.reset_launch_counts()
        out = fn(*args, **kw)
        return out, cuda_ops.launch_counts()


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


POSITIONS = ["top", "interior", "bottom"]
REACHES = list(checks.EXACT_REACH)


@pytest.mark.parametrize("reach", REACHES)
@pytest.mark.parametrize("position", POSITIONS)
def test_k12_exact_matches_plain(shim, position, reach):
    cases = [c for c in checks.kernel_checks_slab(64, 16, "cpu")
             if "advect_slab_exact" in c.kernels and f" {position} " in c.label
             and c.label.endswith(reach)]
    assert len(cases) == 2  # one field and the u/v pair
    for c in cases:
        got, counts = _run(shim, c.run)
        assert counts["advect_slab_exact"] == 1, c.label
        assert _same(got, c.plain()), c.label


@pytest.mark.parametrize("mz", [8, 3])
@pytest.mark.parametrize("reach", REACHES)
@pytest.mark.parametrize("position", POSITIONS)
def test_k14_exact_matches_plain(shim, position, reach, mz):
    cases = [c for c in checks.kernel_checks_slab3(24, mz, "cpu")
             if "advect3_slab_exact" in c.kernels
             and f" {position} " in c.label and c.label.endswith(reach)]
    assert len(cases) == 2  # one field and the u/v/w triple
    for c in cases:
        got, counts = _run(shim, c.run)
        assert counts["advect3_slab_exact"] == 1, c.label
        assert _same(got, c.plain()), c.label


@pytest.mark.parametrize("reach", REACHES)
@pytest.mark.parametrize("slabs", [2, 4, 8])
def test_k12_exact_slabs_stack_into_k3(shim, slabs, reach):
    """Every slab's u/v pair from the assembled fields, stacked, equals K3's
    exact pair on the whole grid: the single-device gather."""
    t = checks._SlabInputs(64, 64 // slabs, "cpu", 0)
    u, v = (checks.EXACT_REACH[reach] * f for f in (t.u, t.v))
    pieces = []
    for i in range(slabs):
        pair, counts = _run(shim, cs.advect_slab_exact, (1, 2), (u, v), None,
                            None, t.flags(i), dt=DT, n=t.n, m=t.m,
                            self_adv=True)
        assert counts["advect_slab_exact"] == 1
        pieces.append(pair)
    whole, counts = _run(shim, cuda_ops.advect_shift_fused, (1, 2), (u, v),
                         u, v, DT, t.n)
    assert counts["advect"] == 1
    for k in range(2):
        assert torch.equal(torch.cat([p[k] for p in pieces]), whole[k])


@pytest.mark.parametrize("reach", REACHES)
@pytest.mark.parametrize("slabs", [3, 8])
def test_k14_exact_slabs_stack_into_k6(shim, slabs, reach):
    """Every z-slab's (u, v, w) triple from the assembled volumes, stacked,
    equals K6's exact triple on the whole volume."""
    t = checks._Slab3Inputs(24, 24 // slabs, "cpu", 0)
    vel = tuple(checks.EXACT_REACH[reach] * f for f in (t.u, t.v, t.w))
    pieces = []
    for i in range(slabs):
        slab = tuple(t.slab(f, i).contiguous() for f in vel)
        triple, counts = _run(shim, cs3.advect3_flat_slab_exact, (1, 2, 3),
                              vel, *slab, t.flags(i), dt=DT, n=t.n, mz=t.mz)
        assert counts["advect3_slab_exact"] == 1
        pieces.append(triple)
    whole, counts = _run(shim, cuda_ops_3d.advect3_shift_fused, (1, 2, 3),
                         vel, *vel, DT, t.n)
    assert counts["advect3"] == 1
    for k in range(3):
        assert torch.equal(torch.cat([p[k] for p in pieces]), whole[k])
