"""K14 (``csrc/advect3_slab.cu``), the z-slab gather, on the flows K6 is
held on; K17 (``csrc/advect_project.cu``) runs its cooperative launch in a
resident form, the pressure iterate held in shared memory one band of rows
a block with the band edges exchanged across grid barriers, or in a
streaming form.  A CUDA kernel has no interpret mode, so this file compiles both
with ``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py``, in which every thread of a cooperative
launch runs together, ``__syncthreads()`` is a barrier of the block and
``grid.sync()`` one of the launch, and holds them bit for bit against their
plain versions on CPU tensors.

K14: top, interior and bottom z-slabs of odd and even plane counts (3 and
4 of a 24³ volume), smooth, random and shear velocities, windows of 1 and
2 cells, one field and the (u, v, w) triple.  K17: both forms, counted,
on a 34² grid cut into bands of 12, 12 and 10 rows (the shim reports 3
SMs): 20 sweeps in windows of 1 and 4, 14 Chebyshev sweeps, a batch of
two grids; bands that ``band_start`` moves so that no band parts a ghost
row from its interior row (two 8² grids on 6 SMs); and the launch's
choice: the streaming form where a band would not fit, a resident form
asked for there refused.  Skips only without ``g++``.
"""
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fluidsimulationcuda_torch.core.config import PERF_POINTS_2D  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks, cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_step as cst  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("advect3_slab.cu", "advect_project.cu")
DT = checks.DT
RHO, _, K_P = PERF_POINTS_2D[2048]
SMS = 3  # the shim's SM count: 34 rows cut into bands of 12, 12, 10


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "slab_tail")
    return mod, lib


def _run(shim, sms, fn, *args, **kw):
    """fn through the shim library on ``sms`` SMs: (result, launch counts,
    K17's form counts)."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib) as handle:
        mod.set_device(handle, sms)
        cuda_ops.reset_launch_counts()
        cst.reset_form_counts()
        out = fn(*args, **kw)
        return out, cuda_ops.launch_counts(), cst.form_counts()


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("position", ["top", "interior", "bottom"])
@pytest.mark.parametrize("velocity", ["smooth", "random", "shear"])
@pytest.mark.parametrize("mz", [3, 4])
def test_k14_matches_plain_on_flows(shim, mz, velocity, position):
    found = 0
    for c in checks.kernel_checks_slab3_flows(24, mz, "cpu"):
        if f" {position} " not in c.label or velocity not in c.label:
            continue
        found += 1
        got, counts, _ = _run(shim, SMS, c.run)
        assert counts["advect3_slab"] == 1, c.label
        assert _same(got, c.plain()), c.label
    assert found == 4  # one field and the triple, windows of 1 and 2


def _tail_cases():
    t = checks._Inputs(34, "cpu", 0)
    two = (torch.stack([t.u, t.uf]), torch.stack([t.v, t.vf]))
    return {
        "20it_cmax1": ((t.u, t.v, t.n, 20, DT), dict(cmax=1)),
        "20it_cmax4": ((t.uf, t.vf, t.n, 20, DT), dict(cmax=4)),
        "chebyshev14": ((t.uf, t.vf, t.n, K_P, DT),
                        dict(cmax=4, cheby_rho=RHO)),
        "batch_of_2": ((*two, t.n, 20, DT), dict(cmax=2)),
    }


@pytest.mark.parametrize("case", ["20it_cmax1", "20it_cmax4", "chebyshev14",
                                  "batch_of_2"])
@pytest.mark.parametrize("form", ["resident", "streaming"])
def test_k17_forms_match_plain(shim, form, case):
    args, kw = _tail_cases()[case]
    got, counts, forms = _run(shim, SMS, cst.fused_advect_project, *args,
                              form=form, **kw)
    assert counts["advect_project"] == 1
    assert forms == {f: int(f == form) for f in cst.FORMS}
    assert _same(got, cst.fused_advect_project_plain(*args, **kw))


@pytest.mark.parametrize("cheby", [False, True], ids=["jacobi20",
                                                      "chebyshev14"])
def test_k17_bands_keep_ghost_rows_with_their_interior(shim, cheby):
    """Two 8² grids (16 stacked rows) on 6 SMs: bands of 3 rows would end
    after row 8 (a grid's row 0 apart from its row 1) and after row 14 (row
    6 apart from the ghost row 7); band_start moves both."""
    t = checks._Inputs(8, "cpu", 0, batch=2)
    iters, kw = (K_P, dict(cheby_rho=RHO)) if cheby else (20, {})
    args = (t.uf, t.vf, t.n, iters, DT)
    got, _, forms = _run(shim, 6, cst.fused_advect_project, *args, cmax=1,
                         **kw)
    assert forms["resident"] == 1
    assert _same(got, cst.fused_advect_project_plain(*args, cmax=1, **kw))


def test_k17_chooses_the_form_that_fits_and_refuses_one_that_does_not(shim):
    """A 242² grid on one SM is a band of 242 rows, whose 244 rows with
    their halos (236 KB) pass the 227 KB of shared memory a block: the
    launch takes the streaming form, and a resident form asked for raises;
    on 3 SMs (bands of 81 rows) the launch takes the resident form."""
    t = checks._Inputs(242, "cpu", 0)
    args = (t.u, t.v, t.n, 4, DT)
    got, _, forms = _run(shim, 1, cst.fused_advect_project, *args, cmax=1)
    assert forms == {"streaming": 1, "resident": 0}
    assert _same(got, cst.fused_advect_project_plain(*args, cmax=1))
    with pytest.raises(RuntimeError, match="resident"):
        _run(shim, 1, cst.fused_advect_project, *args, cmax=1,
             form="resident")
    got, _, forms = _run(shim, SMS, cst.fused_advect_project, *args, cmax=1)
    assert forms == {"streaming": 0, "resident": 1}
    assert _same(got, cst.fused_advect_project_plain(*args, cmax=1))
    mod, lib = shim
    with mod.kernels_on_cpu(lib) as handle:
        mod.set_device(handle, SMS)
        assert cst.advect_project_form(242) == "resident"
        assert cst.advect_project_form(242, form="streaming") == "streaming"
