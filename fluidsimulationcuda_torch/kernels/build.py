"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all started
together) and links the objects into one shared library with a plain C
interface, which ``ctypes`` loads: no PyTorch headers are compiled, so a
cold build takes seconds.  The library goes to ``build/fluidsimulationcuda_torch/``
at the repository root and is named by a hash of the sources, the compiler
flags and the ``nvcc --version`` text, so it is rebuilt exactly when one of
those changes.  The build happens at first use, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "nvcc_path", "library_path", "build",
           "open_library", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fluidsimulationcuda_torch"
# --fmad=false keeps each expression's rounding as the reference writes it;
# fast mode calls fmaf where it fuses on purpose.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point of the library (all return int: the
# cudaError_t of the launch).
_SIGNATURES = {
    "fsc_jacobi_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F,
                         _F, _I, _I, _I, _I, _F, _P],
    "fsc_jacobi_sweep_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                              _F, _F, _I, _I, _I, _I, _F, _I, _P],
    "fsc_jacobi_sweeps": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                          _F, _P, _I, _I, _I, _I, _I, _I, _P],
    "fsc_jacobi_sweeps_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                               _F, _F, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fsc_jacobi_sweeps_damp": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _I,
                               _I, _I, _I, _I, _P],
    "fsc_jacobi_sweeps_damp_bf16": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _I,
                                    _I, _I, _I, _I, _I, _I, _P],
    "fsc_jacobi_slab_sweeps_damp_group": [_P, _P, _I, _I, _I, _I, _F, _F,
                                          _F, _F, _I, _I, _P],
    "fsc_jacobi_slab_sweeps_split": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _F, _F, _F, _F, _I, _I, _I, _I, _I, _I,
                                     _I, _P],
    "fsc_jacobi_block_sweeps": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _F, _F, _F, _F, _F, _P, _I,
                                _I, _I, _I, _P],
    "fsc_jacobi_block_group": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                               _F, _F, _F, _P, _I, _I, _I, _I, _P],
    "fsc_advect_block": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _F, _P],
    "fsc_advect_block_exact": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _F, _P],
    "fsc_divergence_block": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _P],
    "fsc_gradient_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _F, _P],
    "fsc_gradient_block_group": [_P, _P, _I, _I, _I, _I, _F, _I, _P],
    "fsc_advect_block_group": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _I, _I, _P],
    "fsc_divergence": [_P, _P, _P, _I, _I, _F, _P],
    "fsc_divergence_bf16": [_P, _P, _P, _I, _I, _F, _I, _P],
    "fsc_gradient": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    "fsc_gradient_bf16": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "fsc_advect": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "fsc_advect_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                        _P],
    "fsc_dens_advect": [_P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _I, _P, _P,
                        _P, _I, _I, _I, _F, _I, _P],
    "fsc_advect_project": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _I, _F, _F, _F, _P, _I, _I, _P],
    "fsc_advect_project_form": [_I, _I, _I, _P, _P],
    "fsc_jacobi_slab_split": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _F, _F, _F, _F, _I, _I, _I, _P],
    "fsc_jacobi3_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F,
                          _F, _I, _I, _I, _P],
    "fsc_jacobi3_sweeps": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                           _F, _P, _I, _I, _I, _P],
    "fsc_jacobi3_slab_sweeps": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                                _F, _F, _F, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P],
    "fsc_jacobi_slab_sweeps": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                               _F, _F, _F, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P],
    "fsc_jacobi3_sweep_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                               _F, _F, _F, _I, _I, _I, _I, _P],
    "fsc_jacobi3_sweeps_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                                _F, _F, _F, _P, _I, _I, _I, _I, _P],
    "fsc_divergence3": [_P, _P, _P, _P, _I, _F, _P],
    "fsc_gradient3": [_P, _P, _P, _P, _P, _P, _P, _I, _F, _P],
    "fsc_advect3": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                    _I, _P],
    "fsc_jacobi_slab": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F,
                        _F, _I, _I, _I, _I, _I, _P],
    "fsc_divergence_slab": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "fsc_gradient_slab": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                          _P],
    "fsc_advect_slab": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                        _I, _I, _I, _P],
    "fsc_advect_slab_exact": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                              _I, _I, _I, _P],
    "fsc_jacobi3_slab": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F,
                         _F, _I, _I, _I, _I, _I, _I, _I, _P],
    "fsc_advect3_slab": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _F, _I, _I, _I, _I, _P],
    "fsc_advect3_slab_exact": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _F, _I, _I, _I, _P],
    "fsc_advect3_group": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _F, _I, _P],
    "fsc_divergence3_slab": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "fsc_gradient3_slab": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _F, _P],
}
# The bf16 forms of the block kernels, of K6-K8 and of K14-K16 (K14
# grouped too) take their
# float32 forms' arguments; K13's, those and the operand types (the
# per-sweep K13's before the width and the walk, which both forms take).
_SIGNATURES.update({f"{name}_bf16": _SIGNATURES[name] for name in (
    "fsc_jacobi_block_sweeps", "fsc_jacobi_block_group", "fsc_advect_block",
    "fsc_advect_block_exact",
    "fsc_divergence_block", "fsc_gradient_block",
    "fsc_gradient_block_group", "fsc_advect_block_group", "fsc_advect3",
    "fsc_divergence3", "fsc_gradient3", "fsc_advect3_slab",
    "fsc_advect3_slab_exact", "fsc_divergence3_slab", "fsc_gradient3_slab",
    "fsc_advect3_group")})
# K14 grouped's and K12-block grouped's exact forms take their windowed
# forms' arguments.
_SIGNATURES.update({f"fsc_{name}_exact{tag}": _SIGNATURES[f"fsc_{name}"]
                    for name in ("advect3_group", "advect_block_group")
                    for tag in ("", "_bf16")})
_SIGNATURES["fsc_jacobi3_slab_sweeps_bf16"] = [
    *_SIGNATURES["fsc_jacobi3_slab_sweeps"][:-1], _I, _P]
_SIGNATURES["fsc_jacobi3_slab_bf16"] = [*_SIGNATURES["fsc_jacobi3_slab"][:-3],
                                        _I, _I, _I, _P]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put "
                           "nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(csrc: Path = CSRC) -> Path:
    """Where ``build`` puts the library of ``csrc``'s sources for the
    ``nvcc`` found, built or not: the name hashes the sources, the flags
    and the ``nvcc --version`` text."""
    digest = hashlib.sha256()
    digest.update(subprocess.run([nvcc_path(), "--version"], check=True,
                                 capture_output=True, text=True).stdout.encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libfsc_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False, csrc: Path = CSRC) -> Path:
    """Compile the kernels if no library matches the current sources and
    compiler; return the library's path.  ``verbose`` adds ``-Xptxas -v``
    (registers and spills of each kernel) to a fresh build and prints the
    compiler's output.  ``csrc`` builds another tree's sources (the dev
    scripts time a parent commit's kernels that way)."""
    nvcc = nvcc_path()
    sources = sorted(csrc.glob("*.cu"))
    lib = library_path(csrc)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    compiles = [
        [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c",
         "-o", str(obj), str(src)]
        for src, obj in zip(sources, objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        # Wait for every compile before reporting one that failed.
        results = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, proc in zip(compiles, procs)]
        for cmd, output, returncode in results:
            _finish(cmd, output, returncode, verbose)
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        _finish(link, res.stdout + res.stderr, res.returncode, verbose)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: a process building at the same time never sees half a file
    return lib


def _finish(cmd: list[str], output: str, returncode: int,
            verbose: bool) -> None:
    """Print a step's compiler output when asked or when it failed; raise
    if it failed."""
    if verbose or returncode != 0:
        print(output)
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}")


def open_library(path: Path) -> ctypes.CDLL:
    """The kernel library at ``path``, with the argument types of every
    entry point declared; a library built from another tree may lack some
    of them."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib
