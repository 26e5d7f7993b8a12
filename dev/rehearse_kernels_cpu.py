#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, behind a host shim, against their
plain PyTorch versions.

    python3 dev/rehearse_kernels_cpu.py [--side2 34] [--side3 24] [--slab-side 64]
                                        [--slab3-side 24] [--mg-side 130]

A CUDA kernel has no interpret mode, and a machine without ``nvcc`` cannot
build one.  This script compiles ``fluidsimulationcuda_torch/csrc`` with
``g++ -ffp-contract=off`` instead: a shim header defines ``__global__``,
``__device__``, ``dim3``, ``blockIdx``/``threadIdx``, and every launch
``k<<<grid, block, 0, stream>>>(args);`` becomes a loop over the grid, one
thread after another.  A source that calls ``__syncthreads()`` (K4, which
stages a block's footprint in shared memory) launches instead with the
block's threads running together as fibers on the launching thread (each
with its own stack, switched by a few lines of assembly on x86-64 and
by ``swapcontext`` elsewhere), the
blocks one after another: ``__shared__`` storage is static, which is the
running block's, as is the launch's dynamic ``extern __shared__`` buffer
(the tiled K1, ``csrc/jacobi_tiles.cu``, and the tiled 3-D Jacobi,
``csrc/jacobi3_tiles.cu``, which K5's solves and K13's z-slab segments
take); a fiber runs until it waits at ``__syncthreads()``, which lets the
block's fibers go on once all wait there, or at ``__reduce_max_sync`` or a
shuffle, which lets its warp's go on; a block whose threads passed
different numbers of barriers aborts the run.  The shim counts the blocks
of K4 that stage their footprint and those that take the direct path
(``csrc/dens_advect.cu``'s ``FSC_BLOCK_PATH``; ``block_paths`` reads
them).  The one cooperative launch, K17 (``csrc/advect_project.cu``), runs
every thread of every block together, a ``std::thread`` each: a block's
dynamic ``extern __shared__`` array is its own buffer of the launch's
size, ``__syncthreads()`` a barrier of the block, a warp shuffle one of the
warp's threads, and ``grid.sync()`` (a stub ``cooperative_groups.h``) one
of all the launch's threads; a thread
that returns drops out of both, and a launch whose threads passed
different numbers of grid barriers aborts the run.  The device the shim
reports has ``shim_sms`` SMs (1 unless ``set_device`` says otherwise) and
227 KB of shared memory a block, and takes one block of any size an SM, so
K17's resident form cuts a grid into bands, one per SM, and its streaming
form runs one block an SM.  The wrappers of ``kernels/cuda_ops.py``,
``kernels/cuda_ops_3d.py``, ``kernels/cuda_step.py``,
``kernels/cuda_sharded.py`` and ``kernels/cuda_sharded_3d.py`` then run
against that library on CPU tensors (their device checks, stream and
loader patched), and:

- every check of ``kernels/checks.py`` (``kernel_checks``, ``k1_checks``
  against the plain version and the per-sweep K1 chain, one grid and a
  batch of three, float32 and bf16, and, on a batch of three grids,
  ``kernel_checks_flows`` at ``--side2``,
  ``kernel_checks3``, ``kernel_checks3_bf16`` (each tiled call also
  against the per-sweep K5's bf16 form, bit for bit) and
  ``kernel_checks_flows`` at ``--side3``,
  ``kernel_checks_slab`` and ``kernel_checks_group_smooth`` (K9-damp; B13
  also against K18 then K9) for
  slabs of ``--slab-side``/4 rows at ``--slab-side``,
  ``kernel_checks_block`` (the block route's forms, float32 and bf16) for
  blocks of ``--slab-side``/2 x ``--slab-side``/4 there,
  ``kernel_checks_slab3``,
  ``kernel_checks_slab3_flows`` and ``kernel_checks_slab3_bf16`` (each
  tiled call also against the per-sweep K13's bf16 form, bit for bit) for
  z-slabs of ``--slab3-side``/3 planes at ``--slab3-side``) compares kernel and plain version, on a shim device of
  3 SMs; each row-slab call whose solve takes the tiled K9 is held bit for
  bit against the same call on the per-sweep K9
  (``checks.slab_per_sweep_checks``);
- one 2-D and one 3-D step per mode go through the ``cuda`` backend, their
  launch counts against ``chip_smoke.expected_launches(3)``, their state
  against the ``reference`` backend; both also in windowed mode, each
  windowed 2-D step's velocity tail again through K17 against the step's
  own; the 2-D and 3-D steps in bf16, parity and compensated, held to
  the plain twins; and 2-D steps at ``--mg-side`` with the multigrid
  (two cycles; one with fast math) and CG pressure solves, in float32 and
  in bf16 (held to the plain twins); K1-damp
  (``kernel_checks_damp`` at ``--mg-side`` and on a batch of three 16²
  grids, whole-grid launches; its bf16-rhs forms there too) and K6's
  window
  (``kernel_checks3_windowed``) against their plain versions, and K1-damp
  against the same calls on the per-sweep damped K1, bit for bit;
- one multi-device step per mode and route goes through the ``cuda``
  backend on a virtual CPU mesh (4 and 8 slabs at ``--slab-side``; the
  multigrid and CG projections too; the block route on (2, 4), (4, 2)
  and (2, 2) blocks, against ``chip_smoke.expected_launches_blocks``, and
  in bf16, held to the plain twins' step), its launch counts against
  ``chip_smoke.expected_launches_sharded``, its state against the
  ``reference`` backend of the same sharded step; and one 3-D
  multi-device step per mode on 3 and 8 z-slabs at ``--slab3-side``
  (chained segments included) against
  ``chip_smoke.expected_launches_sharded3`` and the ``reference`` backend.

It prints max|d| per check and exits non-zero on a difference above
``checks.TOL`` or a wrong launch count.  The build goes to
``build/cpu_shim/`` (gitignored).  It says nothing about speed, and the
card's compiler may still refuse what g++ accepts.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "fluidsimulationcuda_torch" / "csrc"
OUT = ROOT / "build" / "cpu_shim"

SHIM = r"""#pragma once
#include <barrier>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
#include <cstring>
#include <type_traits>
#include <ucontext.h>
#include <utility>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __shared__ static
#define __launch_bounds__(...)
#define __grid_constant__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
typedef void* cudaStream_t;
inline thread_local dim3 blockIdx, threadIdx;
inline dim3 blockDim, gridDim;
inline int cudaGetLastError() { return 0; }
using std::fmaf; using std::fmaxf; using std::fminf;
template <class F> void shim_launch(dim3 g, dim3 b, size_t, F f) {
  gridDim = g; blockDim = b;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx)
        for (unsigned tz = 0; tz < b.z; ++tz)
          for (unsigned ty = 0; ty < b.y; ++ty)
            for (unsigned tx = 0; tx < b.x; ++tx) {
              blockIdx = dim3(bx, by, bz); threadIdx = dim3(tx, ty, tz);
              f();
            }
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorCooperativeLaunchTooLarge = 82 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
// The device the shim reports (see the module docstring).
inline int shim_sms = 1, shim_smem_optin = 232448;
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? shim_sms : shim_smem_optin;
  return 0;
}
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                                    size_t smem) {
  *n = smem <= size_t(shim_smem_optin) ? 1 : 0; return 0;
}
// A block's threads run together (see the module docstring).
struct ShimBlock {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<int> lanes;  // one slot per thread, for the warp reductions
  std::vector<float> flanes;  // and for the shuffles
  explicit ShimBlock(int threads) : all(threads), lanes(threads), flanes(threads) {
    for (int t = 0; t < threads; t += 32)
      warps.push_back(std::make_unique<std::barrier<>>(threads - t < 32 ? threads - t : 32));
  }
};
inline thread_local ShimBlock* shim_block;
inline thread_local int shim_tid, shim_syncs;
// A block launch runs the block's threads as fibers on the launching
// thread (shim_launch_block): a fiber runs until it waits at a barrier of
// the block or of its warp, and a barrier lets its fibers go on once all
// of them wait at it.  A cooperative launch runs OS threads instead, and
// the same barriers are std::barriers.
enum { SHIM_RUN, SHIM_WAIT_BLOCK, SHIM_WAIT_WARP, SHIM_DONE };
// A context switch saves the running context to *save and resumes load.
// On x86-64 it is a few lines of assembly (shim_switch, 2.5x faster for
// these launches than swapcontext, which asks the kernel for the signal
// mask each time); elsewhere it is swapcontext.
extern "C" __attribute__((visibility("hidden"))) void shim_fiber_start();
#if defined(__x86_64__)
struct ShimContext { void* sp; };
extern "C" __attribute__((visibility("hidden"))) void shim_switch(void** save, void* load);
inline void shim_swap(ShimContext* save, ShimContext* load) { shim_switch(&save->sp, load->sp); }
// A fiber that starts in shim_fiber_start on stack [base, base + size).
inline void shim_make_fiber(ShimContext* c, char* base, size_t size) {
  // Six callee-saved registers, then shim_fiber_start as the address
  // shim_switch returns to, 16-byte aligned after it.
  void** sp = reinterpret_cast<void**>(base + size) - 8;
  for (int r = 0; r < 8; ++r) sp[r] = nullptr;
  sp[6] = reinterpret_cast<void*>(&shim_fiber_start);
  c->sp = sp;
}
#else
struct ShimContext { ucontext_t uc; };
inline void shim_swap(ShimContext* save, ShimContext* load) { swapcontext(&save->uc, &load->uc); }
inline void shim_make_fiber(ShimContext* c, char* base, size_t size) {
  getcontext(&c->uc);
  c->uc.uc_stack.ss_sp = base;
  c->uc.uc_stack.ss_size = size;
  c->uc.uc_link = nullptr;
  makecontext(&c->uc, shim_fiber_start, 0);
}
#endif
struct ShimFiber { ShimContext ctx; int state; int syncs; };
inline thread_local ShimFiber* shim_fiber;  // the running fiber; null in a thread
inline thread_local ShimContext shim_sched;  // the launching thread's context
inline thread_local void (*shim_body)(void*);
inline thread_local void* shim_body_arg;
inline void shim_wait(int state) {
  shim_fiber->state = state;
  shim_swap(&shim_fiber->ctx, &shim_sched);
}
inline void __syncthreads() {
  ++shim_syncs;
  if (shim_fiber) shim_wait(SHIM_WAIT_BLOCK);
  else shim_block->all.arrive_and_wait();
}
inline void shim_warp_sync() {
  if (shim_fiber) shim_wait(SHIM_WAIT_WARP);
  else shim_block->warps[shim_tid / 32]->arrive_and_wait();
}
inline int __reduce_max_sync(unsigned, int v) {
  ShimBlock& blk = *shim_block;
  const int w = shim_tid / 32;
  blk.lanes[shim_tid] = v;
  shim_warp_sync();
  int m = v;
  for (int l = 32 * w; l < 32 * w + 32 && l < int(blk.lanes.size()); ++l)
    m = blk.lanes[l] > m ? blk.lanes[l] : m;
  shim_warp_sync();
  return m;
}
// A shuffle within a warp: lane l takes lane l+delta's v (its own where
// that lane is past the warp).
inline float shim_shfl(float v, int delta) {
  ShimBlock& blk = *shim_block;
  const int w = shim_tid / 32, lane = shim_tid % 32;
  const int size = int(blk.flanes.size()) - 32 * w < 32 ? int(blk.flanes.size()) - 32 * w : 32;
  blk.flanes[shim_tid] = v;
  shim_warp_sync();
  const float r = lane + delta >= 0 && lane + delta < size ? blk.flanes[shim_tid + delta] : v;
  shim_warp_sync();
  return r;
}
inline float __shfl_up_sync(unsigned, float v, unsigned d) { return shim_shfl(v, -int(d)); }
inline float __shfl_down_sync(unsigned, float v, unsigned d) { return shim_shfl(v, int(d)); }
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
// The vector types and reads of the bf16 forms' vector kernels.
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
template <class T> T __ldg(const T* p) { return *p; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline long long shim_paths[2];  // blocks that staged, blocks that did not
inline void shim_block_path(bool direct) {
  if (shim_tid == 0) ++shim_paths[direct];
}
#define FSC_BLOCK_PATH(direct) shim_block_path(direct)
// The block's dynamic shared memory (smem bytes) is one buffer, which the
// blocks take in turn.
inline thread_local char* shim_smem;
[[noreturn]] inline void shim_fail(const char* what) {
  std::fprintf(stderr, "shim: %s\n", what);
  std::abort();
}
template <class F> void shim_launch_block(dim3 g, dim3 b, size_t smem, F f) {
  gridDim = g; blockDim = b;
  const int nt = b.x * b.y * b.z;
  constexpr size_t kStack = size_t(1) << 18;  // each fiber's stack
  ShimBlock blk(nt);
  std::vector<char> mem(smem + 1);
  std::unique_ptr<char[]> stacks(new char[nt * kStack]);
  std::vector<ShimFiber> fibers(nt);
  shim_block = &blk;
  shim_smem = mem.data();
  shim_body = [](void* arg) { (*static_cast<F*>(arg))(); };
  shim_body_arg = &f;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        for (int t = 0; t < nt; ++t) {
          shim_make_fiber(&fibers[t].ctx, stacks.get() + t * kStack, kStack);
          fibers[t].state = SHIM_RUN;
          fibers[t].syncs = 0;
        }
        for (int done = 0; done < nt;) {
          for (int t = 0; t < nt; ++t) {
            if (fibers[t].state != SHIM_RUN) continue;
            shim_fiber = &fibers[t];
            shim_tid = t;
            shim_syncs = fibers[t].syncs;
            threadIdx = dim3(t % b.x, t / b.x % b.y, t / (b.x * b.y));
            shim_swap(&shim_sched, &fibers[t].ctx);
            fibers[t].syncs = shim_syncs;
            done += fibers[t].state == SHIM_DONE;
          }
          bool go = false;  // a warp whose every thread waits goes on
          for (int w = 0; w < nt; w += 32) {
            bool all = true;
            for (int t = w; t < nt && t < w + 32; ++t)
              all = all && fibers[t].state == SHIM_WAIT_WARP;
            for (int t = w; all && t < nt && t < w + 32; ++t)
              fibers[t].state = SHIM_RUN;
            go = go || all;
          }
          if (go || done == nt) continue;
          for (int t = 0; t < nt; ++t)
            if (fibers[t].state != SHIM_WAIT_BLOCK)
              shim_fail(fibers[t].state == SHIM_DONE
                            ? "the threads of a block passed different "
                              "numbers of __syncthreads()"
                            : "a warp barrier that not every thread reached");
          for (int t = 0; t < nt; ++t) fibers[t].state = SHIM_RUN;
        }
        for (int t = 0; t < nt; ++t)
          if (fibers[t].syncs != fibers[0].syncs)
            shim_fail("the threads of a block passed different numbers of "
                      "__syncthreads()");
      }
  shim_fiber = nullptr;
}
// A cooperative launch runs all its blocks' threads together (see the
// module docstring).
inline std::barrier<>* shim_grid;
inline thread_local int shim_grid_syncs;
inline void shim_grid_sync() { ++shim_grid_syncs; shim_grid->arrive_and_wait(); }
template <class T> T* shim_dynamic_smem() { return reinterpret_cast<T*>(shim_smem); }
template <class... A, size_t... I>
void shim_call(void (*fn)(A...), void** args, std::index_sequence<I...>) {
  fn(*static_cast<std::remove_cv_t<std::remove_reference_t<A>>*>(args[I])...);
}
template <class... A> int cudaLaunchCooperativeKernel(void (*fn)(A...), dim3 g, dim3 b,
                                                      void** args, size_t smem,
                                                      cudaStream_t) {
  gridDim = g; blockDim = b;
  const int nt = b.x * b.y * b.z, nb = g.x * g.y * g.z;
  std::barrier<> grid(nt * nb);
  shim_grid = &grid;
  std::vector<std::unique_ptr<ShimBlock>> blocks;
  std::vector<std::vector<char>> mem;
  for (int k = 0; k < nb; ++k) {
    blocks.push_back(std::make_unique<ShimBlock>(nt));
    mem.emplace_back(smem + 1);
  }
  std::vector<int> syncs(nt * nb);
  std::vector<std::thread> threads;
  for (int k = 0; k < nb; ++k)
    for (int t = 0; t < nt; ++t)
      threads.emplace_back([&, k, t] {
        shim_block = blocks[k].get();
        shim_tid = t;
        shim_smem = mem[k].data();
        shim_grid_syncs = 0;
        blockIdx = dim3(k % g.x, k / g.x % g.y, k / (g.x * g.y));
        threadIdx = dim3(t % b.x, t / b.x % b.y, t / (b.x * b.y));
        shim_call(fn, args, std::index_sequence_for<A...>());
        syncs[k * nt + t] = shim_grid_syncs;
        shim_block->all.arrive_and_drop();
        grid.arrive_and_drop();
      });
  for (auto& th : threads) th.join();
  for (int s : syncs)
    if (s != syncs[0]) {
      std::fprintf(stderr, "shim: the threads of a cooperative launch passed "
                           "different numbers of grid barriers\n");
      std::abort();
    }
  return 0;
}
"""
PATHS = r"""#include "cuda_runtime.h"
#if defined(__x86_64__)
// Save the callee-saved registers and the stack pointer to *save, load
// another context's from load (x86-64 System V).
asm(R"(
  .text
  .globl shim_switch
  .hidden shim_switch
  .type shim_switch, @function
shim_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size shim_switch, .-shim_switch
)");
#endif
extern "C" void shim_fiber_start() {
  shim_body(shim_body_arg);
  shim_fiber->state = SHIM_DONE;
  shim_swap(&shim_fiber->ctx, &shim_sched);
  shim_fail("a finished fiber ran again");
}
extern "C" void fsc_shim_block_paths(long long* out) {
  out[0] = shim_paths[0];
  out[1] = shim_paths[1];
  shim_paths[0] = shim_paths[1] = 0;
}
extern "C" void fsc_shim_set_device(int sms) { shim_sms = sms; }
"""
# The bf16 storage type, its two conversions, as cuda_bf16.h defines them
# for the host (round to nearest even, NaN kept quiet), and its bits.
BF16 = r"""#pragma once
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
inline float __bfloat162float(__nv_bfloat16 h) {
  unsigned u = unsigned(h.x) << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u; std::memcpy(&u, &f, 4);
  __nv_bfloat16 h;
  if ((u & 0x7fffffffu) > 0x7f800000u) { h.x = (u >> 16) | 0x40; return h; }
  u += 0x7fffu + ((u >> 16) & 1u);
  h.x = u >> 16;
  return h;
}
"""
COOPERATIVE_GROUPS = r"""#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group { void sync() const { shim_grid_sync(); } };
inline grid_group this_grid() { return grid_group(); }
}
"""
LAUNCH = re.compile(r"(\w+)<<<(.*?)>>>\((.*?)\);", re.S)
# A block's dynamic shared memory is its own buffer in the shim.
DYNAMIC_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")
# The shim's cudaLaunchCooperativeKernel takes the kernel with its type.
COOPERATIVE = re.compile(r"cudaLaunchCooperativeKernel\(\s*\(void\s*\*\)\s*")


def _top_level_args(text: str) -> list[str]:
    args, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            args.append(cur)
            cur = ""
        else:
            cur += ch
    return args + [cur]


def build_shim_library(names: tuple[str, ...] | None = None,
                       out: Path = OUT) -> Path:
    """Compile the sources of ``csrc`` (only the ``.cu`` files ``names``,
    if given) behind the shim into ``out/libfsc_shim.so``."""
    gen = out / "gen"
    gen.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(SHIM)
    (out / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
    (out / "cuda_bf16.h").write_text(BF16)
    (gen / "shim_paths.cpp").write_text(PATHS)
    sources = [str(gen / "shim_paths.cpp")]
    for path in sorted(CSRC.glob("*.cu*")):
        if path.suffix == ".cu" and names is not None and path.name not in names:
            continue
        text = COOPERATIVE.sub("cudaLaunchCooperativeKernel(",
                               path.read_text())
        text = DYNAMIC_SMEM.sub(r"\1* \2 = shim_dynamic_smem<\1>();", text)
        shim = "shim_launch_block" if "__syncthreads" in text else "shim_launch"

        def launch(m):
            grid, block, *rest = _top_level_args(m.group(2))
            smem = rest[0] if rest else "0"
            return (f"{shim}({grid}, {block}, {smem}, "
                    f"[&] {{ {m.group(1)}({m.group(3)}); }});")

        target = gen / (path.stem + ".cpp" if path.suffix == ".cu" else path.name)
        target.write_text(LAUNCH.sub(launch, text))
        if path.suffix == ".cu":
            sources.append(str(target))
    lib = out / "libfsc_shim.so"
    subprocess.run(["g++", "-O2", "-std=c++20", "-pthread", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{out}", f"-I{gen}", "-o", str(lib),
                    *sources], check=True)
    return lib


def set_device(lib, sms: int) -> None:
    """Make the shim library ``lib`` report ``sms`` SMs."""
    lib.fsc_shim_set_device(sms)


def block_paths(lib) -> tuple[int, int]:
    """(staged, direct): the blocks of K4 that staged their footprint and
    those that took the direct path since the last call."""
    counts = (ctypes.c_longlong * 2)()
    lib.fsc_shim_block_paths(counts)
    return counts[0], counts[1]


@contextlib.contextmanager
def kernels_on_cpu(lib_path: Path):
    """Make the wrappers launch the shim library at ``lib_path`` on CPU
    tensors; yields the library."""
    from fluidsimulationcuda_torch.kernels import build, cuda_ops, cuda_ops_3d

    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in build._SIGNATURES.items():
        if not hasattr(lib, name):  # a library of some sources only
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    check = cuda_ops._on_device

    def on_device(*specs):
        check(*specs)
        return True

    saved = (build.load, cuda_ops._on_device, cuda_ops._stream,
             cuda_ops_3d._stream, torch.cuda.device)
    build.load = lambda: lib
    cuda_ops._on_device = on_device
    cuda_ops._stream = cuda_ops_3d._stream = lambda t: 0
    torch.cuda.device = lambda d: contextlib.nullcontext()
    try:
        yield lib
    finally:
        (build.load, cuda_ops._on_device, cuda_ops._stream,
         cuda_ops_3d._stream, torch.cuda.device) = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side2", type=int, default=34)
    ap.add_argument("--side3", type=int, default=24)
    ap.add_argument("--slab-side", type=int, default=64)
    ap.add_argument("--slab3-side", type=int, default=24)
    ap.add_argument("--mg-side", type=int, default=130)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import chip_smoke
    import fluidsimulationcuda_torch as ft
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.models.stable_fluids_3d import _Ops3

    lib = build_shim_library()
    with kernels_on_cpu(lib) as handle:
        set_device(handle, 3)  # K17's resident form in three bands
    failures = 0
    check_list = (checks.kernel_checks(args.side2, "cpu", 1)
                  + checks.kernel_checks_damp(args.mg_side, "cpu", 1)
                  + checks.kernel_checks_damp(16, "cpu", 1, batch=3)
                  + checks.kernel_checks_damp(args.mg_side, "cpu", 1,
                                              bf16=True)
                  + checks.kernel_checks_damp(16, "cpu", 1, batch=3,
                                              bf16=True)
                  + checks.kernel_checks3(args.side3, "cpu", 1)
                  + checks.kernel_checks3_windowed(args.side3, "cpu", 1)
                  + checks.kernel_checks3_bf16(args.side3, "cpu", 1)
                  + checks.kernel_checks_slab(args.slab_side,
                                              args.slab_side // 4, "cpu", 1)
                  + checks.kernel_checks_group_smooth(args.slab_side,
                                                      args.slab_side // 4,
                                                      "cpu", 1)
                  + checks.kernel_checks_block(args.slab_side,
                                               args.slab_side // 2,
                                               args.slab_side // 4, "cpu",
                                               1)
                  + checks.kernel_checks_block(args.slab_side,
                                               args.slab_side // 2,
                                               args.slab_side // 4, "cpu",
                                               1, bf16=True)
                  + checks.kernel_checks_slab3(args.slab3_side,
                                               args.slab3_side // 3, "cpu",
                                               1)
                  + checks.kernel_checks_slab3_flows(args.slab3_side,
                                                     args.slab3_side // 3,
                                                     "cpu", 1)
                  + checks.kernel_checks_slab3_bf16(args.slab3_side,
                                                    args.slab3_side // 3,
                                                    "cpu", 1)
                  + checks.kernel_checks_flows(args.side2, "cpu", 1,
                                                batch=3)
                  + checks.kernel_checks_flows(args.side3, "cpu", 1,
                                                ndim=3)
                  + checks.kernel_checks_bf16(args.side2, "cpu", 1)
                  + checks.kernel_checks_bf16(args.side2, "cpu", 1,
                                              batch=3)
                  + [c for batch in (0, 3) for bf16 in (False, True)
                     for chain in (False, True)
                     for c in checks.k1_checks(args.side2, "cpu", 1, batch,
                                               bf16, chain)])
    for c in check_list:
        with kernels_on_cpu(lib):
            cuda_ops.reset_launch_counts()
            got = c.run()
            counts = cuda_ops.launch_counts()
        want = c.plain()
        err = checks.max_abs_diff(got, want)
        bad = err > checks.TOL or not all(counts[k] for k in c.kernels)
        failures += bad
        print(f"  {c.label:45s} max|d| {err:.3e}{'  FAIL' if bad else ''}")
    # The tiled K9 against the per-sweep K9 on the same calls: bit for bit.
    for c in checks.slab_per_sweep_checks(checks.kernel_checks_slab(
            args.slab_side, args.slab_side // 4, "cpu", 1)):
        with kernels_on_cpu(lib):
            err = checks.max_abs_diff(c.run(), c.plain())
        failures += err > 0.0
        print(f"  {c.label:45s} max|d| {err:.3e}"
              f"{'  FAIL' if err > 0.0 else ''}")
    # The tiled 3-D kernel's bf16 forms against the per-sweep K5's and
    # K13's on the same calls: bit for bit.
    for c in checks.per_sweep_checks(
            checks.kernel_checks3_bf16(args.side3, "cpu", 1)
            + checks.kernel_checks_slab3_bf16(args.slab3_side,
                                              args.slab3_side // 3, "cpu",
                                              1)):
        with kernels_on_cpu(lib):
            err = checks.max_abs_diff(c.run(), c.plain())
        failures += err > 0.0
        print(f"  {c.label:45s} max|d| {err:.3e}"
              f"{'  FAIL' if err > 0.0 else ''}")
    # K1-damp against the per-sweep damped K1 on the same calls: bit for
    # bit.
    for c in (checks.kernel_checks_damp(args.mg_side, "cpu", 1)
              + checks.kernel_checks_damp(16, "cpu", 1, batch=3)):
        with kernels_on_cpu(lib):
            err = checks.max_abs_diff(c.run(), c.chain())
        failures += err > 0.0
        print(f"  {c.label + ' vs per-sweep':45s} max|d| {err:.3e}"
              f"{'  FAIL' if err > 0.0 else ''}")
    # B13 against K9 on the concatenated operands and against K18 then K9:
    # bit for bit.
    for c in (checks.split_against_concat(args.slab_side,
                                          args.slab_side // 4, "cpu", 1)
              + checks.split_against_k18(args.slab_side,
                                         args.slab_side // 4, "cpu", 1)):
        with kernels_on_cpu(lib):
            err = checks.max_abs_diff(c.run(), c.plain())
        failures += err > 0.0
        label = c.label if " vs " in c.label else c.label + " vs concat"
        print(f"  {label:45s} max|d| {err:.3e}"
              f"{'  FAIL' if err > 0.0 else ''}")

    modes = {"parity": {},
             "compensated": dict(pressure_solver="chebyshev",
                                 diffusion_solver="chebyshev",
                                 cheby_rho=0.85, cheby_iters=10,
                                 cheby_press_iters=12, fast_math=True),
             "chebyshev-dens": dict(diffusion_solver="chebyshev-dens",
                                    cheby_rho=0.85)}
    modes["windowed parity"] = modes["parity"]
    modes["windowed compensated"] = modes["compensated"]
    bf16 = {"bf16 parity": dict(dtype=torch.bfloat16),
            "bf16 compensated": dict(modes["compensated"],
                                     dtype=torch.bfloat16)}
    solvers = {"multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
               "multigrid fast": dict(pressure_solver="multigrid",
                                      mg_cycles=1, fast_math=True),
               "cg": dict(pressure_solver="cg", cg_iters=20)}
    solvers.update({f"bf16 {m}": dict(solvers[m], dtype=torch.bfloat16)
                    for m in ("multigrid", "cg")})
    for ndim, side, mode, kw in (
            [(2, args.side2, m, kw) for m, kw in modes.items()]
            + [(2, args.side2, m, kw) for m, kw in bf16.items()]
            + [(2, args.mg_side, m, kw) for m, kw in solvers.items()]
            + [(3, args.side3, m, kw) for m, kw in modes.items()]
            + [(3, args.side3, m, kw) for m, kw in bf16.items()]):
        step = ft.step3 if ndim == 3 else ft.step
        design = (chip_smoke.expected_launches3 if ndim == 3
                  else chip_smoke.expected_launches)
        if ndim == 2 and mode.endswith("compensated"):
            kw = dict(kw, cheby_rho=0.9, cheby_press_iters=14)
        if mode.startswith("windowed"):
            kw = dict(kw, advect_mode="windowed", max_courant=1)
        ref = ft.SimConfig(n=side - 2, ndim=ndim, backend="reference",
                           device="cpu", **kw)
        cfg = ref.replace()
        # The cuda backend on CPU tensors, which only the shim allows.
        object.__setattr__(cfg, "backend", "cuda")
        state, src = ft.reference_init(torch.Generator().manual_seed(0),
                                       ref)
        with kernels_on_cpu(lib):
            cuda_ops.reset_launch_counts()
            got = step(cfg, state, src)
            counts = cuda_ops.launch_counts()
        # The multigrid fast line is held, as phase 14 holds it, to the
        # cuda OpSet's plain twins, which take fast_math and round as the
        # kernels do, and so are the bf16 steps (the reference backend
        # rounds its bf16 solves every sweep); the other fast modes to the
        # reference at 1e-4.
        exact_twins = mode == "multigrid fast" or mode.startswith("bf16")
        twins = (_Ops3(cfg, plain=True) if ndim == 3
                 else cuda_ops.make_opset(ref, plain=True))
        want = (step(ref, state, src, twins) if exact_twins
                else step(ref, state, src))
        per_step = design(cfg)
        launches_ok = counts == {k: per_step.get(k, 0)
                                 for k in cuda_ops.KERNELS}
        err = chip_smoke.max_diff(got, want)
        tol = 1e-4 if cfg.fast_math and mode != "multigrid fast" else 0.0
        bad = err > tol or not launches_ok
        failures += bad
        print(f"  {ndim}-D step {mode:15s} max|d| vs "
              f"{'plain twins' if exact_twins else 'reference'} "
              f"{err:.3e}, launches "
              f"{'as designed' if launches_ok else counts}"
              f"{'  FAIL' if bad else ''}")
        if ndim == 2 and mode.startswith("windowed"):
            with kernels_on_cpu(lib):
                cuda_ops.reset_launch_counts()
                tail = chip_smoke.windowed_tail(cfg, state, src)
                counts = cuda_ops.launch_counts()
            err = max(float((a - b).abs().max())
                      for a, b in zip(tail, (got.u, got.v)))
            bad = err > 0.0 or counts["advect_project"] != 1
            failures += bad
            print(f"  2-D {mode} velocity tail through K17 max|d| vs "
                  f"the step's {err:.3e}, K17 launches "
                  f"{counts['advect_project']}{'  FAIL' if bad else ''}")
    failures += rehearse_sharded(lib, args.slab_side)
    failures += rehearse_sharded3(lib, args.slab3_side)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


def rehearse_sharded(lib, side: int) -> int:
    """One multi-device step per mode and route (row slabs and 2-D blocks)
    through the ``cuda`` backend on a virtual CPU mesh against the
    ``reference`` backend of the same step (a bf16 block step against the
    plain twins' step, ``_BlockStep(..., plain=True)``, bit for bit);
    returns the number of failures."""
    import chip_smoke
    import fluidsimulationcuda_torch as ft
    from fluidsimulationcuda_torch.kernels import cuda_ops
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_blocks,
                                                    shard_state, unshard)
    from fluidsimulationcuda_torch.parallel.sharded import _BlockStep

    base = dict(n=side - 2, jacobi_iters=6, max_courant=2)
    modes = {
        "parity": dict(),
        "compensated": dict(pressure_solver="chebyshev",
                            diffusion_solver="chebyshev", cheby_rho=0.9,
                            cheby_iters=6, cheby_press_iters=6,
                            fast_math=True),
        "chebyshev-dens": dict(diffusion_solver="chebyshev-dens",
                               cheby_rho=0.9, cheby_dens_iters=6),
        "multi-chunk": dict(jacobi_iters=9, fuse_sweeps=4),
        "multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
        "cg": dict(pressure_solver="cg", cg_iters=12),
    }
    failures = 0
    # (mode, slabs, advect_mode, velocity source scale): the exact parity
    # steps' sources move the backtrace past the window; fast math's
    # roundings, which the reference ignores, stay within the bar at the
    # unscaled draw.
    # The block route: (px, py) blocks (shard_backend="reference"), and
    # the slab route's Chebyshev solves whose halo is deeper than a slab
    # (compensated on 8 slabs of 8 rows: on the (8, 1) blocks).
    f32, bf16 = torch.float32, torch.bfloat16
    for mode, slabs, gather, scale, dtype in (
            ("parity", 4, "auto", 1, f32), ("parity", 8, "auto", 1, f32),
            ("compensated", 4, "auto", 1, f32),
            ("chebyshev-dens", 4, "auto", 1, f32),
            ("multi-chunk", 4, "auto", 1, f32),
            ("multigrid", 4, "auto", 1, f32),
            ("multigrid", 8, "auto", 1, f32), ("cg", 8, "auto", 1, f32),
            ("parity", 4, "exact", 400, f32), ("parity", 8, "exact", 400, f32),
            ("compensated", 4, "exact", 1, f32),
            ("compensated", 8, "auto", 1, f32),
            ("parity", (2, 4), "exact", 400, f32),
            ("parity", (4, 2), "windowed", 1, f32),
            ("compensated", (2, 2), "exact", 1, f32),
            ("multigrid", (2, 4), "exact", 1, f32),
            ("cg", (2, 2), "exact", 1, f32),
            ("parity", (2, 4), "exact", 400, bf16),
            ("parity", (4, 2), "windowed", 1, bf16),
            ("compensated", (2, 2), "exact", 1, bf16),
            ("multigrid", (2, 4), "exact", 1, bf16),
            ("cg", (2, 2), "exact", 1, bf16)):
        ref = ft.SimConfig(backend="reference", device="cpu",
                           **{**base, **modes[mode]})
        cfg = ref.replace(dtype=dtype)
        # The cuda backend on CPU tensors, which only the shim allows.
        object.__setattr__(cfg, "backend", "cuda")
        shape = slabs if isinstance(slabs, tuple) else (slabs, 1)
        blocks = isinstance(slabs, tuple)
        mesh = make_mesh([torch.device("cpu")] * (shape[0] * shape[1]),
                         shape=shape)
        state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
        src = src._replace(u=src.u * scale, v=src.v * scale)
        state, src = (type(t)(*(x.to(dtype) for x in t[:3]))
                      for t in (state, src))
        cut = shard_blocks if blocks else shard_state
        state, src = cut(state, mesh), cut(src, mesh)
        backend = "reference" if blocks else "auto"
        step = make_sharded_step_fn(cfg, mesh, advect_mode=gather,
                                    shard_backend=backend)
        with kernels_on_cpu(lib):
            cuda_ops.reset_launch_counts()
            got = unshard(step(state, src), mesh)
            counts = cuda_ops.launch_counts()
        if dtype == bf16:
            want = unshard(_BlockStep(cfg, mesh, False, step.advect_mode ==
                                      "exact", plain=True)(state, src), mesh)
        else:
            want = unshard(make_sharded_step_fn(
                ref, mesh, advect_mode=gather, shard_backend=backend)(
                    state, src), mesh)
        exact = step.advect_mode == "exact"
        per_step = (chip_smoke.expected_launches_blocks(cfg, *shape, exact)
                    if blocks else chip_smoke.expected_launches_sharded(
                        cfg, slabs, exact))
        launches_ok = counts == {k: per_step.get(k, 0)
                                 for k in cuda_ops.KERNELS}
        err = chip_smoke.max_diff(got, want)
        tol = 1e-4 if cfg.fast_math and dtype == f32 else 0.0
        bad = err > tol or not launches_ok
        failures += bad
        print(f"  sharded {mode:15s} {slabs} {str(dtype)[6:]} {step.layout} "
              f"{step.advect_mode} "
              f"{step.routes} max|d| vs "
              f"reference {err:.3e}, launches "
              f"{'as designed' if launches_ok else counts}"
              f"{'  FAIL' if bad else ''}")
    return failures


def rehearse_sharded3(lib, side: int) -> int:
    """One 3-D multi-device step per mode through the ``cuda`` backend on
    a virtual CPU mesh against the ``reference`` backend of the same step;
    returns the number of failures."""
    import chip_smoke
    import fluidsimulationcuda_torch as ft
    from fluidsimulationcuda_torch.kernels import cuda_ops
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn_3d,
                                                    shard_state_3d, unshard)

    base = dict(n=side - 2, ndim=3, jacobi_iters=10, max_courant=2)
    modes = {
        "parity": dict(),
        "compensated": dict(pressure_solver="chebyshev",
                            diffusion_solver="chebyshev", cheby_rho=0.85,
                            cheby_iters=10, cheby_press_iters=12,
                            fast_math=True),
        "chebyshev-dens": dict(diffusion_solver="chebyshev-dens",
                               cheby_rho=0.85, cheby_dens_iters=6),
    }
    failures = 0
    # As rehearse_sharded's cases; "thin" is "auto" on slabs thinner than
    # the window.
    for mode, slabs, gather, scale in (
            ("parity", 3, "auto", 1), ("parity", 8, "auto", 1),
            ("compensated", 3, "auto", 1), ("compensated", 8, "auto", 1),
            ("chebyshev-dens", 8, "auto", 1), ("parity", 3, "exact", 400),
            ("compensated", 8, "exact", 1), ("parity", 8, "thin", 400)):
        kw = {**base, **modes[mode]}
        if slabs == 8:
            kw["max_courant"] = 1  # 3-plane slabs: the window must fit
        if gather == "thin":
            kw["max_courant"], gather = 3, "auto"
        ref = ft.SimConfig(backend="reference", device="cpu", **kw)
        cfg = ref.replace()
        # The cuda backend on CPU tensors, which only the shim allows.
        object.__setattr__(cfg, "backend", "cuda")
        mesh = make_mesh([torch.device("cpu")] * slabs)
        state, src = ft.reference_init(torch.Generator().manual_seed(0), ref)
        src = src._replace(u=src.u * scale, v=src.v * scale,
                           w=src.w * scale)
        state, src = shard_state_3d(state, mesh), shard_state_3d(src, mesh)
        step = make_sharded_step_fn_3d(cfg, mesh, advect_mode=gather)
        with kernels_on_cpu(lib):
            cuda_ops.reset_launch_counts()
            got = unshard(step(state, src))
            counts = cuda_ops.launch_counts()
        want = unshard(make_sharded_step_fn_3d(ref, mesh,
                                               advect_mode=gather)(state, src))
        per_step = chip_smoke.expected_launches_sharded3(
            cfg, slabs, step.advect_mode == "exact")
        launches_ok = counts == {k: per_step.get(k, 0)
                                 for k in cuda_ops.KERNELS}
        err = chip_smoke.max_diff(got, want)
        tol = 1e-4 if cfg.fast_math else 0.0
        bad = err > tol or not launches_ok
        failures += bad
        print(f"  sharded 3-D {mode:15s} {slabs} slabs {step.advect_mode} "
              f"{step.chunks} max|d| "
              f"vs reference {err:.3e}, launches "
              f"{'as designed' if launches_ok else counts}"
              f"{'  FAIL' if bad else ''}")
    return failures


if __name__ == "__main__":
    sys.exit(main())
