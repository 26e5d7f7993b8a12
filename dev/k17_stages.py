#!/usr/bin/env python3
"""Where K17's time goes, stage by stage, on the card.

    python3 dev/k17_stages.py [--parent build/parent] [--side 2048]

Builds ``csrc/advect_project.cu`` of this tree (and of ``--parent``) alone
into a library whose kernels stamp the time: thread 0 of block 0 records
``%globaltimer`` and ``clock64()`` when the kernel starts, after each grid
barrier and, after one more barrier, when every block has finished (the
source is rewritten on the fly: a stamp object after ``cg::this_grid()``,
a stamp after each ``grid.sync()``, the last one from the object's
destructor).  Block 0 leaves a
barrier when every block has reached it, so the stamps split the launch
into its stages: the gather, the divergence (with this tree's first sweep
folded in), each further pressure sweep, the gradient.  Each case is a
CUDA graph of 20 launches replayed between CUDA events, as
``checks.device_ms`` times a kernel; the launch's time outside the stamps
is the graph's time a launch less the first-to-last stamp span.  Cases:
20 sweeps in the 4-cell window (velocities over it), 20 in the 1-cell
window, 14 Chebyshev sweeps, at ``--side``, in each form of this tree and
in the parent's, and in the resident form of each ``--variant`` (this
tree's source with some of its ``constexpr int`` constants set otherwise,
as ``kRowsPerSync=4,kAhead=1``).  Prints µs per stage (the mean over the 20 launches) and
the card's name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
REPS = 20

STRIDE = 512  # stamp slots a launch
MAX_LAUNCHES = 64

# Thread 0 of block 0 takes each stamp; a stamp stores and never loads, so
# it holds block 0 back by a few instructions, not a memory round trip
# (only the slot of the launch, taken once at its start, is loaded).
STAMPED = r"""#include <cooperative_groups.h>
__device__ unsigned long long fsc_dev_ns[%(n)d];
__device__ long long fsc_dev_cycles[%(n)d];
__device__ int fsc_dev_counts[%(launches)d];
__device__ int fsc_dev_launches;
struct FscDevStamps {
  cooperative_groups::grid_group& g;
  int at = 0, end = 0, launch = 0;
  __device__ static bool leader() {
    return blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0;
  }
  __device__ explicit FscDevStamps(cooperative_groups::grid_group& grid)
      : g(grid) {
    if (leader()) {
      launch = atomicAdd(&fsc_dev_launches, 1) %% %(launches)d;
      at = launch * %(stride)d;
      end = at + %(stride)d;
      stamp();
    }
  }
  __device__ void stamp() {
    if (leader() && at < end) {
      unsigned long long t;
      asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
      fsc_dev_ns[at] = t;
      fsc_dev_cycles[at] = clock64();
      ++at;
    }
  }
  __device__ ~FscDevStamps() {
    g.sync();
    stamp();
    if (leader()) fsc_dev_counts[launch] = at - launch * %(stride)d;
  }
};
#include "%(source)s"
extern "C" int fsc_dev_read(unsigned long long* ns, long long* cycles,
                            int* counts) {
  int err = static_cast<int>(cudaMemcpyFromSymbol(counts, fsc_dev_counts,
                                                  sizeof(fsc_dev_counts)));
  if (err == 0)
    err = static_cast<int>(cudaMemcpyFromSymbol(ns, fsc_dev_ns,
                                                sizeof(fsc_dev_ns)));
  if (err == 0)
    err = static_cast<int>(cudaMemcpyFromSymbol(cycles, fsc_dev_cycles,
                                                sizeof(fsc_dev_cycles)));
  const int zero = 0;
  if (err == 0)
    err = static_cast<int>(cudaMemcpyToSymbol(fsc_dev_launches, &zero,
                                              sizeof(int)));
  return err;
}
"""


def stamped_library(csrc: Path, out: Path, consts: dict[str, int] = {}):
    """``csrc/advect_project.cu`` with stamps (and each ``constexpr int``
    of ``consts`` set to its value), built alone into ``out``."""
    from fluidsimulationcuda_torch.kernels import build

    out.mkdir(parents=True, exist_ok=True)
    text = (csrc / "advect_project.cu").read_text()
    for name, value in consts.items():
        text, found = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if found != 1:
            raise SystemExit(f"k17_stages: no constexpr int {name} in {csrc}")
    text, starts = re.subn(
        r"cg::grid_group grid = cg::this_grid\(\);",
        "cg::grid_group grid = cg::this_grid(); FscDevStamps fsc_dev{grid};",
        text)
    text, syncs = re.subn(r"grid\.sync\(\);", "grid.sync(); fsc_dev.stamp();",
                          text)
    if not starts or not syncs:
        raise SystemExit(f"k17_stages: no grid barrier to stamp in {csrc}")
    (out / "advect_project_stamped.cu").write_text(text)
    main = out / "k17_stamped.cu"
    main.write_text(STAMPED % {"n": STRIDE * MAX_LAUNCHES,
                               "launches": MAX_LAUNCHES, "stride": STRIDE,
                               "source": "advect_project_stamped.cu"})
    lib = out / "libk17_stamped.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-shared", f"-I{csrc}", f"-I{out}", "-o",
                          str(lib), str(main)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"k17_stages: nvcc failed\n{res.stdout}"
                         f"{res.stderr}")
    # Registers and spills of the stamped kernels, beside the library's.
    for line in (res.stdout + res.stderr).splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"  {csrc.parent.parent.name or csrc}: {line.strip()}")
    handle = build.open_library(lib)
    handle.fsc_dev_read.argtypes = [ctypes.c_void_p] * 3
    handle.fsc_dev_read.restype = ctypes.c_int
    return handle


def stages(lib, run) -> tuple[np.ndarray, float]:
    """(µs of each stage, the mean over REPS launches; the graph's µs a
    launch) of ``run`` on the stamped library ``lib``."""
    from fluidsimulationcuda_torch.kernels import build

    build._lib = lib
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            run()
    graph.replay()
    torch.cuda.synchronize()
    ns = (ctypes.c_ulonglong * (STRIDE * MAX_LAUNCHES))()
    cycles = (ctypes.c_longlong * (STRIDE * MAX_LAUNCHES))()
    counts = (ctypes.c_int * MAX_LAUNCHES)()
    lib.fsc_dev_read(ns, cycles, counts)  # resets the launch count
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    if lib.fsc_dev_read(ns, cycles, counts) != 0:
        raise SystemExit("k17_stages: reading the stamps failed")
    per = counts[0]
    if any(counts[r] != per for r in range(REPS)) or not 2 < per < STRIDE:
        raise SystemExit(f"k17_stages: stamps per launch "
                         f"{list(counts[:REPS])}")
    t = np.array([[ns[r * STRIDE + k] for k in range(per)]
                  for r in range(REPS)], dtype=np.float64)
    c = np.array([[cycles[r * STRIDE + k] for k in range(per)]
                  for r in range(REPS)], dtype=np.float64)
    # Cycles of block 0's SM, scaled to the globaltimer span of the launch:
    # finer than the timer's own steps.
    scale = (t[:, -1] - t[:, 0]) / (c[:, -1] - c[:, 0])
    us = np.diff(c, axis=1) * scale[:, None] / 1e3
    return us.mean(axis=0), start.elapsed_time(stop) * 1e3 / REPS


def report(label: str, us: np.ndarray, graph_us: float, iters: int) -> None:
    """One line: gather, divergence (+ the first sweep where it is folded
    in), the sweeps, the gradient, outside the stamps."""
    span = float(us.sum())
    folded = len(us) == iters + 2  # gather, div+sweep 0, iters-1, gradient
    sweeps = us[2:-1]
    print(f"  {label:48s} gather {us[0]:7.2f}  divergence"
          f"{' + sweep 0' if folded else '          '} {us[1]:7.2f}  "
          f"{len(sweeps)} sweeps {sweeps.sum():8.2f} "
          f"({sweeps.mean():6.2f} each)  gradient {us[-1]:7.2f}  span "
          f"{span:8.2f}  launch {graph_us:8.2f}  outside "
          f"{graph_us - span:7.2f} µs", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--side", type=int, default=2048)
    ap.add_argument("--variant", action="append", default=[],
                    help="this tree's resident form with constants set, "
                         "e.g. kRowsPerSync=4,kAhead=1 (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k17_stages: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "dev"))
    os.chdir(ROOT)
    from bench_gathers import ParentTail
    from fluidsimulationcuda_torch.core.config import PERF_POINTS_2D
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_step as cst

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    out = ROOT / "build" / "k17_stages"
    trees = {"this": stamped_library(build.CSRC, out / "this")}
    forms = {"this": ("resident", "streaming")}
    for variant in args.variant:
        consts = {k: int(v) for k, v in
                  (item.split("=") for item in variant.split(","))}
        trees[variant] = stamped_library(build.CSRC, out / variant, consts)
        forms[variant] = ("resident",)
    if args.parent:
        lib = stamped_library(
            args.parent / "fluidsimulationcuda_torch" / "csrc",
            out / "parent")
        trees["parent"] = (lib if hasattr(lib, "fsc_advect_project_form")
                           else ParentTail(lib))
        forms["parent"] = ((None,) if isinstance(trees["parent"], ParentTail)
                           else ("resident", "streaming"))
    t = checks._Inputs(args.side, "cuda", 0)
    rho, _, k_p = PERF_POINTS_2D[2048]
    cases = ((f"20it cmax={checks.CMAX}", t.uf, t.vf, checks.CMAX, 20, None),
             ("20it cmax=1", t.u, t.v, 1, 20, None),
             (f"chebyshev {k_p}it cmax={checks.CMAX}", t.uf, t.vf,
              checks.CMAX, k_p, rho))
    print(f"K17 stages at {args.side}², µs a launch, the mean of {REPS} "
          f"launches in a CUDA graph ({card})")
    for label, u, v, cmax, iters, cheby in cases:
        for tree, lib in trees.items():
            for form in forms[tree]:
                def run():
                    return cst.fused_advect_project(
                        u, v, t.n, iters, checks.DT, cmax=cmax,
                        cheby_rho=cheby, form=form)
                us, graph_us = stages(lib, run)
                report(f"{label}, {tree}{f' {form}' if form else ''}", us,
                       graph_us, iters)


if __name__ == "__main__":
    main()
