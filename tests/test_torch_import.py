"""The port imports torch and never jax, and imports without a CUDA toolkit;
chip_smoke.py refuses to run, and prints no result, without a CUDA device."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "fluidsimulationcuda_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|fluidsimulationcuda_tpu)\b",
                       re.M)


def _run(code_or_args, cwd=ROOT):
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_import_leaves_jax_out():
    res = _run(
        "import sys\n"
        "import fluidsimulationcuda_torch\n"
        "from fluidsimulationcuda_torch.kernels import build, checks, cuda_ops, dispatch\n"
        "from fluidsimulationcuda_torch.kernels import cuda_ops_3d, cuda_sharded\n"
        "from fluidsimulationcuda_torch.kernels import cuda_sharded_3d\n"
        "from fluidsimulationcuda_torch.models import stable_fluids_3d\n"
        "from fluidsimulationcuda_torch.parallel import mesh, sharded\n"
        "from fluidsimulationcuda_torch.parallel import sharded3d\n"
        "from fluidsimulationcuda_torch import __main__\n"
        "from fluidsimulationcuda_torch.models import scenarios\n"
        "from fluidsimulationcuda_torch.utils import (checkpoint, stability,\n"
        "                                             timing, validate, viz)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'fluidsimulationcuda_tpu'))\n"
        "assert not bad, bad\n"
        "assert cuda_ops.launch_counts() == dict.fromkeys(cuda_ops.KERNELS, 0)\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in
                                        [*PACKAGE.rglob("*.py"),
                                         ROOT / "chip_smoke.py"]))
def test_no_jax_import_statement(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


def test_kernel_sources_ship_with_the_package():
    names = sorted(p.name for p in (PACKAGE / "csrc").iterdir())
    assert {"jacobi.cu", "project.cu", "advect.cu", "dens_advect.cu",
            "jacobi3.cu", "project3.cu", "advect3.cu", "jacobi_slab.cu",
            "project_slab.cu", "advect_slab.cu", "jacobi3_slab.cu",
            "project3_slab.cu", "advect3_slab.cu",
            "fsc_common.cuh"} <= set(names)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "script_alone"])
def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = _run(["chip_smoke.py"], cwd=cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
