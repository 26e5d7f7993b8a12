// K17 advect_project: the tail of vel_step (FluidSequential.c:232-240) in
// one cooperative launch: the u/v self-advection pair under the gather
// window, then the second projection (divergence, pressure sweeps from
// zero, gradient).
//
// Replaces the TPU kernel _ap_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_step.py:95, pallas_call at :299;
// wrapper fused_advect_project :264).  The TPU kernel runs the whole tail
// strip by strip in VMEM, each strip recomputing an iters+3-row margin, so
// that the advected pair, the divergence and the pressure iterates never
// reach HBM.  Here one cooperative launch walks the whole grid (or batch of
// grids) stage by stage, with a grid-wide barrier (cooperative_groups
// grid.sync()) between the gather, the divergence, each pressure sweep and
// the gradient.  The intermediates live in device memory that the wrapper
// allocates (the advected pair, the rhs and the pressure ping-pong, three
// buffers for Chebyshev); at 2048^2 the rhs and the live pressure iterates
// (3 x 16.8 MB) fit the 50 MB L2 across sweeps, so the sweeps mostly hit
// L2.  Recomputing margins instead (the TPU design, tiles in shared memory)
// would redo about 6x the cells at 20 sweeps.
//
// Every stage evaluates the expressions of the kernels it fuses, in their
// order: the gather of K3 (fsc::departure, fsc::blend; border modes 1 and
// 2), the divergence of K2 (mode 0), the sweep of K1 (alpha=1, beta=4 from
// the zero guess; Chebyshev: the first sweep plain, then w from
// cheby_omegas), the gradient of K2 (modes 1 and 2, corners derived).  So
// in parity mode the result equals advect_windowed on the pair followed by
// fused_project bit for bit.
//
// Bound: device memory.  The function reads u and v once and writes the
// projected pair once (4 field passes); everything between is the launch's
// own traffic, which the roofline does not count.
//
// The grid is sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// the SM count, so that every block is resident, as a grid barrier needs;
// the launch is refused, never shrunk to a non-cooperative one, if no
// block fits.
#include <cooperative_groups.h>

#include "fsc_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxSweeps = 256;  // weights passed by value in the params

struct ApParams {
  const float* u;  // pre-advection velocity, nb (side, side) grids
  const float* v;
  float* uo;       // the projected pair
  float* vo;
  float* au;       // the advected pair
  float* av;
  float* rhs;      // the divergence
  float* p[3];     // pressure iterates; p[2] only for Chebyshev
  int side, cells, iters, cmax, nbuf, cheby;
  float dt0, coef, h;
  float w[kMaxSweeps];  // Chebyshev weight of sweep k >= 1 at w[k-1]
};

// A flat cell index of the batch: the offset of its grid, its row and
// column.
struct Cell {
  int base, i, j;
};

__device__ __forceinline__ Cell cell_at(int idx, int side) {
  const int plane = side * side;
  Cell c;
  c.base = (idx / plane) * plane;
  const int r = idx - c.base;
  c.i = r / side;
  c.j = r - c.i * side;
  return c;
}

// Stage 1: the self-advected pair; one backtrace from the pre-advection
// velocity for both fields (FluidSequential.c:232,237).
__device__ __forceinline__ void gather_at(const ApParams& P, int idx) {
  const Cell c = cell_at(idx, P.side);
  const int side = P.side, n = side - 2;
  const float* u = P.u + c.base;
  const float* v = P.v + c.base;
  const fsc::Departure d =
      fsc::departure(u, v, fsc::clampi(c.i, 1, n), fsc::clampi(c.j, 1, n),
                     side, P.dt0, P.cmax);
  const int g = d.i0 * side + d.j0;
  const float a = fsc::blend(d, u[g], u[g + side], u[g + 1], u[g + side + 1]);
  const float e = fsc::blend(d, v[g], v[g + side], v[g + 1], v[g + side + 1]);
  P.au[idx] = fsc::border_value(a, c.i, c.j, side, 1);
  P.av[idx] = fsc::border_value(e, c.i, c.j, side, 2);
}

// Stage 2: the divergence of the advected pair, border mode 0.
__device__ __forceinline__ void divergence_at(const ApParams& P, int idx) {
  const Cell c = cell_at(idx, P.side);
  const int side = P.side;
  const float* u = P.au + c.base;
  const float* v = P.av + c.base;
  const int k = fsc::interior_of(c.i, c.j, side);
  const float d =
      P.coef * ((u[k + 1] - u[k - 1]) + (v[k + side] - v[k - side]));
  P.rhs[idx] = fsc::border_value(d, c.i, c.j, side, 0);
}

// Stage 3 + k: pressure sweep k (0-based) from the zero guess, into
// p[k % nbuf]; x_k is p[(k-1) % nbuf], x_{k-1} p[(k-2) % nbuf].
__device__ __forceinline__ void sweep_at(const ApParams& P, int k, int idx) {
  const Cell c = cell_at(idx, P.side);
  const int side = P.side;
  const bool combine = P.cheby && k >= 1;
  fsc::SweepParams sp;
  sp.x = k >= 1 ? P.p[(k - 1) % P.nbuf] + c.base : nullptr;
  sp.rhs = P.rhs + c.base;
  sp.src = nullptr;
  sp.xm = (combine && k >= 2) ? P.p[(k - 2) % P.nbuf] + c.base : nullptr;
  sp.alpha = 1.0f;
  sp.beta = 4.0f;
  sp.ab = 0.25f;
  sp.inv_b = 0.25f;
  sp.src_dt = 0.0f;
  sp.w = combine ? P.w[k - 1] : 0.0f;
  sp.flags = combine ? fsc::kCheby : 0;
  const int q = fsc::interior_of(c.i, c.j, side);
  const float val = fsc::sweep_at(sp, q, side, sp.rhs[q]);
  P.p[k % P.nbuf][idx] = fsc::border_value(val, c.i, c.j, side, 0);
}

// Last stage: the pressure gradient subtracted from the advected pair,
// border modes 1 and 2.
__device__ __forceinline__ void gradient_at(const ApParams& P, int idx) {
  const Cell c = cell_at(idx, P.side);
  const int side = P.side;
  const float* u = P.au + c.base;
  const float* v = P.av + c.base;
  const float* p = P.p[(P.iters - 1) % P.nbuf] + c.base;
  const int k = fsc::interior_of(c.i, c.j, side);
  const float un = u[k] - (0.5f * (p[k + 1] - p[k - 1])) / P.h;
  const float vn = v[k] - (0.5f * (p[k + side] - p[k - side])) / P.h;
  P.uo[idx] = fsc::border_value(un, c.i, c.j, side, 1);
  P.vo[idx] = fsc::border_value(vn, c.i, c.j, side, 2);
}

// Intermediates are written and read back within the launch, so no
// pointer here is __restrict__ (which would allow the non-coherent read
// path); grid.sync() orders each stage's writes before the next stage's
// reads.
__global__ void advect_project_kernel(ApParams P) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int idx = first; idx < P.cells; idx += stride) gather_at(P, idx);
  grid.sync();
  for (int idx = first; idx < P.cells; idx += stride) divergence_at(P, idx);
  grid.sync();
  for (int k = 0; k < P.iters; ++k) {
    for (int idx = first; idx < P.cells; idx += stride) sweep_at(P, k, idx);
    grid.sync();
  }
  for (int idx = first; idx < P.cells; idx += stride) gradient_at(P, idx);
}

}  // namespace

// u, v: nb pre-advection (side, side) velocity grids; uo, vo: the result;
// au, av, rhs, p0, p1 (and p2 with cheby): scratch of the same shape, none
// aliasing another.  dt0 = dt*n, coef = -0.5*h and h = 1/n in float32;
// cmax <= 0 gathers exactly.  omegas: the iters-1 Chebyshev weights
// (cheby_omegas) on the host, read only with cheby.  Returns the
// cudaError_t of the launch.
extern "C" int fsc_advect_project(const float* u, const float* v, float* uo,
                                  float* vo, float* au, float* av, float* rhs,
                                  float* p0, float* p1, float* p2, int side,
                                  int nb, int iters, int cmax, float dt0,
                                  float coef, float h, const float* omegas,
                                  int cheby, void* stream) {
  if (iters < 1 || iters > kMaxSweeps || nb < 1 || (cheby && p2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ApParams P;
  P.u = u;
  P.v = v;
  P.uo = uo;
  P.vo = vo;
  P.au = au;
  P.av = av;
  P.rhs = rhs;
  P.p[0] = p0;
  P.p[1] = p1;
  P.p[2] = p2;
  P.side = side;
  P.cells = nb * side * side;
  P.iters = iters;
  P.cmax = cmax;
  P.nbuf = cheby ? 3 : 2;
  P.cheby = cheby;
  P.dt0 = dt0;
  P.coef = coef;
  P.h = h;
  for (int k = 0; k < kMaxSweeps; ++k)
    P.w[k] = (cheby && k < iters - 1) ? omegas[k] : 0.0f;

  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, advect_project_kernel, kThreads, 0));
  if (err != 0) return err;
  if (per_sm < 1 || sms < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int needed = (P.cells + kThreads - 1) / kThreads;
  const int blocks = needed < per_sm * sms ? needed : per_sm * sms;
  void* args[] = {&P};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      (void*)advect_project_kernel, dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
