#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fluidsimulationcuda_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. environment: torch, CUDA and nvcc versions, the card's name and power limit;
2. build of the CUDA kernels from ``fluidsimulationcuda_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. every 2-D kernel against its plain PyTorch version on the card at the
   2048² shapes of the main path (max|Δ| <= 1e-5), plus device times of
   both beside the bound; every call with a K1 solve in it
   (``checks.k1_checks``) at 2048² and on the datagen batch against
   its plain version and against the same call on the per-sweep K1
   (``cuda_ops.launch_sweeps(0)``), bit for bit, and each timed call with
   a K1 solve beside that per-sweep chain in the same CUDA-graph turns
   (the tiled K1's one launch of T sweeps labelled ``jacobi_sweeps``, the
   per-sweep K1's one sweep ``jacobi_sweep``); then K1-K4 on a batch of
   1024 grids of 258² (the
   batched datagen step's shapes: one sweep, the 20-sweep and 10-sweep
   Chebyshev+fast solves, the zero-guess solve, ``fused_project`` at 20
   and Chebyshev 14 sweeps, K2's stencils, K3's u/v pair exact and at the
   window ``select_cmax_batched`` probes, K4 in that window), each against
   its plain version (max|Δ| <= 1e-5) and timed beside its bound; and
   ``fused_jacobi_pair`` (B12, the u/v diffusion stacked on the batch axis)
   against two ``fused_jacobi`` calls, bit for bit, on a stack of two 258²
   grids and of two 2048² grids, timed beside them;
3b. every 3-D kernel the same way at 256³; every 3-D solve check in the
   tiled K5's one mode (the fast Chebyshev solves, which the per-sweep
   K5's vector walk takes at 256³, ``cuda_ops.tiled3``) run on the tiled
   K5 against the same call on the per-sweep K5
   (``checks.per_sweep_checks``) bit for bit; each solve timed on the
   kernel its path takes, each fast Chebyshev call on the tiled K5 beside
   the per-sweep chain and held to it and to its plain version (the tiled
   K5's one launch of T3 sweeps labelled ``jacobi3_sweeps``, the per-sweep
   K5's one sweep ``jacobi3_sweep``); the per-sweep K5's timed calls (one
   sweep, the 20-sweep u and pressure solves) in its vector walk and its
   one-cell form, each bit for bit with the twin, timed in turns, with
   their launches by width (``sweep3_forms``); K6, exact and windowed, one
   field and the triple, bit for bit the grouped K14 over one slab of the
   volume and the one-cell K14 on the volume
   (``checks.kernel_checks_k6_body``);
3c. every row-slab kernel of the multi-device step against its plain twin
   for a top, an interior and a bottom slab of 256 rows at 2048²
   (max|Δ| <= 1e-5), in its Jacobi, Chebyshev and fast forms, the gathers
   under and over the 4-cell window, K12's exact form from the assembled
   fields up to 24 cells (bit for bit; timed beside K12 and
   ``grid_sample``); every call whose solve takes the
   tiled K9 (``slab_against_both``) there and on top, interior and bottom
   slabs of 2048 rows of 8192² against its plain twin (bit for bit; fast
   mode within 1e-5) and against the same call on the per-sweep K9
   (``cuda_ops.launch_sweeps(0)``), bit for bit; plus device times beside
   the bound there (where a slab's fields sit in the 50 MB L2, so the
   launch floor, a one-element kernel's time in a CUDA graph, is printed
   beside it) and on an interior slab of 2048 rows of 8192² (the 4-slab
   run's shape, whose working set exceeds the L2), each call with a tiled
   K9 solve beside the per-sweep chain (the tiled K9's one launch of T
   sweeps labelled ``jacobi_slab_sweeps``, the per-sweep K9's one sweep
   ``jacobi_slab``); then K9-damp, the slab multigrid's smoother
   (``smooth_slabs``, every slab in one launch, its halo rows read from
   the neighbouring slabs' arrays), on 8 slabs of 2048² (2 sweeps from a
   guess and from zero, 7, and 40 in several launches) against its plain
   twin, bit for bit, and its 2-sweep smooths so held and timed beside
   the plain twin and the bound on 8 slabs of 2048², one slab, 4 slabs of
   8192² and 128 slabs of 16 rows; and K1-damp at 1025², the slab
   multigrid's odd coarse grid at 2048², against ``_smooth`` and the
   per-sweep damped K1 as in phase 3f, timed on its route
   (``cuda_ops.damped_plan``: the 2-sweep smooths on 16-row tiles at T =
   5, the 40-sweep solve on 64-row tiles at T = 10, both clear of the
   deeper halo);
3d. every z-slab kernel of the 3-D multi-device step against its plain twin
   for a top, an interior and a bottom slab of 32 planes of 256³
   (max|Δ| <= 1e-5): Jacobi, zero guess, fast, a Chebyshev chain's first
   and chained segments (x_{k-1} carried in and out), the gathers under and
   over the 4-cell window, K14's exact form from the assembled volumes up
   to 24 cells (bit for bit; timed beside K14 and ``grid_sample``), the
   two stencils; K14 also on smooth, random and
   shear velocities in windows of 1 and 2, one field and the triple, bit
   for bit; every segment in the tiled K13's mode run on it against the
   same segment on the per-sweep K13 bit for bit; timed beside bound and
   launch floor (the segments as in 3b, the per-sweep K13's in both its
   forms, ``sweep3_forms``; K14 also on one field and on smooth and shear
   velocities, beside ``grid_sample``); the grouped K14 (one launch over
   every z-slab, ``advect3_group_checks``) over the 8 slabs of 32 planes
   and the 64 of 4, windowed and exact, one field and the triple, against
   its plain twin and the per-slab K14 on ``_ext``'s or ``_gather``'s
   buffers, bit for bit, and the path's three gathers timed beside bound,
   twin, ``grid_sample`` and the per-slab route they replace;
3e. the two fused kernels no step calls (as in the JAX package): B13, the
   split-operand slab Jacobi (the tiled K9's first launch reading its
   tiles from the halo and slab operands, then the tiled K9), against K9
   on the ``torch.cat`` of its operands bit for bit on top, interior and
   bottom 256-row slabs of 2048² and on 2048-row slabs of 8192² (K = 24,
   20 sweeps; Jacobi, zero guess, fast) and against the route before it
   (K18's one sweep, then K9) on the 2048² slabs; K17, the fused velocity tail, against its plain version bit for
   bit at 2048² in both its forms (resident, which the launch takes there,
   and streaming) and on a batch of two 2048² grids (streaming), each
   check printing the form that ran; then K17 at 2048² (20 parity sweeps
   with windows of 4 and 1 cells, the 14-sweep Chebyshev pressure solve,
   then the first and the last in the streaming form) and on the datagen
   batch of 1024 × 256² (streaming; 20 sweeps and Chebyshev 14, window 1),
   and B13 on an interior slab (the split-source launch, the 20-sweep
   solve, and K18's launch and solve before it), each timed beside its
   bound, the launch floor, its plain version and the composition it
   replaces (K3's windowed pair and ``fused_project``; two ``torch.cat``
   and K9).  B13 against its plain version runs in phase 3c;
3f. K1-damp (the multigrid smoother) against ``ops.multigrid._smooth``
   at 2048², 128², 16² and on a batch of 64 × 16² (2 sweeps from a guess
   and from zero, 40 from zero; bit for bit expected, max|Δ| <= 1e-6
   required) and against the same call on the per-sweep damped K1 (bit
   for bit required), and K6 in the gather window against
   ``ops.three_d.advect3_windowed`` at 256³ (constant displacements inside,
   across and far over a 2-cell window, random velocities up to 6 cells in
   windows of 2 and 4, one field and the self-advected triple; max|Δ| <=
   1e-5); each timed beside its bound and plain version (K1-damp also
   beside the per-sweep damped K1, at all four sizes, and at 16² beside
   the launch floor), K6 in the window on the inputs phase 3b times exact
   K6 on;
4. the six golden fixtures ``tests/golden/*.npz`` through the ``cuda``
   backend (atol 1e-5);
5. the 2-D main path, ``StableFluids2D.step`` at 2048² (n=2046), 20 Jacobi
   iterations, parity mode: one impulse step plus 20, launch counts checked
   against the design, state held against the ``reference`` backend on the
   same CUDA tensors, ms/step and Mcell-updates/s;
6. the same in the compensated perf mode (Chebyshev, fast math);
7. 8192² (n=8190), 40 iterations, parity mode: three steps, finite state;
8. the 3-D main path, ``StableFluids3D.step`` at 256³ (n=254), 20 Jacobi
   iterations, parity mode: as phase 5, plus a forced trajectory (sources
   scaled by 0.05 every step) held against the ``reference`` backend after
   20 steps;
9. the same in the 3-D compensated mode (``PERF_POINT_3D``), without and
   with fast math;
10. the multi-device step, ``make_sharded_step_fn`` with ``audited=True`` on
   one card (a mesh that lists it once per slab): 2048² parity on the 1×1
   mesh and on 8 slabs, the 2048² compensated perf mode on 8 slabs, 8192²
   (40 iterations) on 4 slabs, and 2048² with ``fuse_sweeps=8`` on 128 slabs
   of 16 rows (the composed projection), the 2048² multigrid step (two
   cycles, Jacobi-20 diffusion) on 1 and on 8 slabs and the 2048² CG-20 step
   on 8 slabs (``parallel/solvers.py``); launch counts checked against
   ``expected_launches_sharded`` (the tiled K9's launches of each solve,
   chunk by chunk, as ``cuda_ops.slab_tiling`` plans them; for multigrid
   K9-damp's on every slab and K1-damp's on the replicated coarse grid,
   ``slab_mg_launches``), every
   run's state held against the ``reference`` backend of the same sharded
   step and, where the audited displacement stays under the window, against
   ``StableFluids2D.step`` (the impulse moves the 2048² backtrace ~20
   cells, so a forced trajectory, sources × 0.05 every step, is held
   against it too; not for multigrid, whose slab route runs the classic
   cycle and the single-device step the graded one); ms/step eager and as
   a CUDA graph; the multigrid and CG slab projections' max|div| beside
   the single-device step's and Jacobi-20's; the 2048² multigrid step also
   on 128 slabs of 16 rows (``fuse_sweeps=8``; every slab's smooth in one
   K9-damp launch); then the 8-slab
   step's first velocity-diffusion chunk again through B13, each slab's
   halos as the step exchanges them, against the step's own route (bit for
   bit), launch counts checked, timed beside it and K18 + K9; then the
   exact all-gather advection (``advect_mode="exact"``: each gathered
   field assembled once on the card, K12's exact form) at 2048² on 8
   slabs and 8192² on 4, past the window, held to ``StableFluids2D.step``
   and the ``reference`` backend bit for bit over every step, the windowed
   step's max|d| to the single-device step printed beside it, both steps'
   ms/step eager and as a graph with their launches, and the all-gather
   copies' share of the exact step's device time;
11. the 3-D multi-device step, ``make_sharded_step_fn_3d`` with
   ``audited=True`` on one card: 256³ parity on 1 and on 8 z-slabs, the
   compensated mode (``PERF_POINT_3D``) with fast math on 8 slabs, and the
   compensated mode on 32 slabs of 8 planes (every solve chained across
   halo exchanges: 7+3 velocity sweeps, 7+5 pressure sweeps); checked as
   phase 10 checks the row slabs (against ``StableFluids3D.step`` where
   the audited displacement stays under the window); then the exact
   all-gather advection (K14's exact form) on 8 z-slabs and, taken by
   ``"auto"``, on 64 slabs of 4 planes, too thin for the 4-cell window,
   held to ``StableFluids3D.step`` and checked as phase 10's exact runs;
   every run's step also on the per-slab K14 (``per_slab_route``: bit for
   bit the grouped step's, both timed eager and as a CUDA graph);
12. the windowed 2-D step, ``StableFluids2D`` at 2048² with
   ``advect_mode="windowed"`` (4-cell window), parity and the compensated
   perf mode with fast math: checked as phases 5-6 (launch counts, the
   ``reference`` backend, which gathers windowed too), the audited
   displacement printed beside the window, and the step's velocity tail
   computed again through K17 from the step's own post-projection velocity
   and held against the step's result (max|Δ| <= 1e-5), the form K17 took
   printed (the resident one on an H100 SXM);
13. batched datagen, ``models/batched.py`` at BASELINE config 4 (1024
   grids of 256², n=254, 20 iterations), parity and the compensated mode
   (0.9, 10, 14) with fast math: ``select_cmax_batched`` probes the gather
   window, ``generate_trajectories`` runs 20 windowed steps with a density
   snapshot every 5 (launch counts checked: those of one grid, 16 parity
   / 13 compensated a step; the audited displacement finite and within the
   window; the last snapshot equal to the final density); grids 0, 1, 511
   and 1023 run again alone through ``StableFluids2D.step`` and equal the
   batch bit for bit (snapshots and final state); the batch is held against
   the ``reference`` backend (step 1: rtol 1e-5 / atol 2e-5, or atol 1e-4
   with fast math, which the reference ignores; the last step: max|Δ| <=
   1e-4); then ms/step eager and as a CUDA graph, Mcell-updates/s, and one
   step traced with ``torch.profiler`` (device ms per kernel, busy share);
14. the multigrid 2-D step at 2048²: ``pressure_solver="multigrid"`` with
   two cycles and Jacobi-20 diffusion, one cycle, and the JAX bench's line
   (one cycle, fast math): the launches of ``expected_launches`` (15
   K1-damp launches a cycle, ``cuda_ops.damped_plan``), the first two held
   to the ``reference``
   backend as phase 5, the bench line at the same bars to the ``cuda``
   OpSet's plain twins, which take fast_math and round as the kernels do
   (``make_opset(cfg, plain=True)``; the reference ignores fast_math: its
   gap is printed beside the plain twins' own), float32 matmuls checked
   to run without TF32, the first projection's max|div| beside the
   Jacobi-20 projection's on the same velocity (at most it for
   multigrid), one step traced (the transfers' GEMM time beside K1-damp's
   and K1's), and each step's ms/step eager and as a CUDA graph beside
   the same step with its smoother on the per-sweep damped K1
   (``cuda_ops.smooth_launches(0)``, the route before K1-damp);
15. the CG-20 2-D step at 2048², checked the same way (its step captured as
   a CUDA graph: no host sync inside the loop), with max|div|;
16. the windowed 3-D step at 256³ (4-cell window), parity and the
   compensated mode with fast math: checked as phases 8-9, then the
   impulse step's audited displacement beside the window and a forced
   trajectory (sources × 0.05 every step) windowed and exact, equal bit for
   bit while the displacement stays under the window;
17. the command line on the card, ``fluidsimulationcuda_torch.__main__.main``
   called in this process with the launch counters reset before each call
   and read after it: ``run`` at 2048² (20 parity steps saved, resumed for
   20 more and held bit for bit against a straight 40-step run; 16
   launches a step), ``run --perf --validate`` at 2048² (the bars print and
   pass; the audits' launches plus 13 a step), ``run --ndim 3`` at 256³
   (the reference impulse, 126 a step, finite), ``datagen`` at 1024 ×
   256² (the probe's 8 steps and the run's 20 at 16 a step; the file's
   ``dens_final`` (1024, 256, 256), the audit exact, equal bit for bit to
   ``generate_trajectories`` with the seed and the probed window),
   ``profile --trace`` at 2048² (the table and a trace file) and ``info``;
   each run's ms/step beside the eager step of phases 5, 6 and 8;
18. bf16 storage on the 2-D step (``SimConfig(dtype=torch.bfloat16)``):
   every bf16 form of K1-K3 against its plain version at 2048² and on the
   datagen batch (1024 × 256²), bit for bit; every form of the bf16
   vector kernels of K3 and K2's gradient (``checks.BF16_FORMS``: K3's
   V = 4 and 2, the gradient's 8, 4 and 2, and the one-cell kernel) on
   every call of
   ``checks.kernel_checks_bf16_forms``
   (K3 on one field with each border mode and on the u/v pair, exact and
   in windows of 1 and 4 cells, on random, smooth, shear and clamped
   velocities; the gradient of a float32 and of a bf16 pressure) at 2048²,
   8192² and on the batch, bit for bit, each launch in the width it was
   given; every bf16 call with a K1
   solve in it at 2048² and on the batch against its plain version
   and the per-sweep K1 chain, bit for bit, and at 8192² each call phase
   18 times with a K1 solve in it, bf16 and float32, the same way on the
   inputs it is timed on; each timed beside the same call in float32, its bound, its plain version and, with a K1 solve in
   it, the per-sweep chain, at 2048², 8192² (past the L2) and on the
   batch; ``StableFluids2D`` in bf16 at 2048² (20
   iterations, parity and the compensated mode with fast math) and 8192²
   (40 iterations), and ``generate_trajectories`` in bf16 on the datagen
   batch: launch counts (K1 then K3 for the density, no K4; the bf16 forms
   counted apart) and the width each K3 and K2 gradient launch took
   (``cuda_ops.width_counts``), each run held to the ``cuda`` OpSet's plain twins in
   bf16 (bit for bit, fast math's fmaf included) and to the float32
   run from the same rounded draw (rel-L2 under 0.15 for density,
   tests/test_pallas_ops.py:384, and no farther from it than the
   ``reference`` backend's bf16 run, whose rel-L2 is printed), every field
   finite; JAX's bar against the ``reference`` bf16 run (rel-L2 0.01 for
   density, 0.02 for u, :382-383) at JAX's own point (128², 8 iterations,
   a 2-cell window, 3 steps); ms/step in bf16 beside float32; then the
   multigrid and CG steps on a batch of 64
   grids of 256² (the batched solves of ROADMAP §C 1): the launches of one
   grid (K1-damp takes the batch), every grid within the parity
   bar of its own one-grid step (max|Δ| printed, and how many grids equal
   it bit for bit), the batch held to the ``reference`` backend; the
   multigrid step's ms/step eager and as a CUDA graph beside the per-sweep
   damped K1's, as in phase 14; then the multigrid and CG projections in
   bf16: K1-damp's bf16-rhs forms (``checks.kernel_checks_damp(...,
   bf16=True)``: 2-sweep smooths from zero and from a float32 guess,
   40-sweep solves from zero and from a bf16 guess) against their plain
   twin at 2048² and on 64 × 256², bit for bit, and timed beside the
   bound; the multigrid (two cycles) and CG-20 steps in bf16 at 2048²
   through ``bf16_path`` (launch counts: 8 of the bf16-rhs forms and 52
   of K1-damp's float32 form a multigrid step; the state bf16;
   ``bf16_bars``; ms/step eager and as a graph beside float32), the
   projection's max|div| in float32 and bf16 beside Jacobi-20's, and
   both steps in bf16 on the 64 × 256² batch (``solver_batch_path``:
   each grid within 4 bf16 units of its own step, the batch to
   ``bf16_bars``);
19. the block route (``block_phase``): K9-block, K12-block, K10-block and
   K11-block against their plain twins on a corner, an edge, an interior
   and the far corner block of (2, 4) blocks at 2048² (every mode the
   step gives them; bit for bit, the fast forms within 1e-5), each timed
   beside its bound, its slab counterpart on as many cells and, for the
   gathers, ``grid_sample``; the grouped K9-block (``group_checks``: a
   chunk over every block in one launch, its halo read from the
   neighbours' own arrays) over the (2, 4) blocks of 2048² and the
   (64, 1) blocks of 512² in every form, against the per-block K9-block on
   ``Blocks.ext``'s buffers and its plain twin bit for bit (the fast
   forms to the twin within 1e-5), and its 8-sweep chunk, fast chained
   Chebyshev chunk and damped smooth over 2048² timed beside their bound
   and the route they replace (``Blocks.ext`` and 8 per-block launches);
   the grouped K11-block and K12-block (``group_checks`` too: the
   gradient and the windowed and exact gathers over every block in one
   launch, each block's neighbours read from their own arrays) over the
   (2, 4) blocks of 2048² and the (64, 1) blocks of 256² in every form,
   against the per-block kernels on ``Blocks.halos``', ``ext``'s or
   ``gather``'s buffers and their plain twins bit for bit, and the
   gradient, pair and density over 2048² timed beside their bound,
   ``grid_sample`` and the route they replace (``halos``, ``ext`` or
   ``gather`` and 8 per-block launches);
   then ``make_sharded_step_fn(...,
   shard_backend="reference")`` on (2, 4) blocks of one card at 2048², 20
   iterations (``block_path``): exact, held to ``StableFluids2D.step``
   bit for bit past the window; windowed, to the slab route's windowed
   step on 8 slabs bit for bit; compensated with fast math, to the
   ``reference`` backend within 1e-4; multigrid (two cycles) and CG-20,
   to the ``reference`` backend bit for bit, each with its max|Δ| to the
   slab route's solver on 8 slabs printed; 8192² at 40 iterations on
   (2, 2) blocks, exact, to ``StableFluids2D.step`` bit for bit; each
   with its launches a step against ``expected_launches_blocks``, eager
   and graph ms/step and one step traced with the share of its device
   time the halo and gather copies take; and ``"auto"`` on 64 slabs of 4
   rows of 256² (the block route, exact) and the slab route's deep-halo
   Chebyshev (512² compensated fast on 64 slabs of 8 rows: its solves on
   the (64, 1) blocks), each against ``StableFluids2D.step``;
20. bf16 storage on the block route (``bf16_block_phase``): the bf16 forms
   of K9-block, K12-block, K10-block and K11-block against their plain
   twins (which round where the kernels store) on a corner, an edge, an
   interior and the far corner block of (2, 4) blocks at 2048², in every
   mode the step gives them (bit for bit; fast forms within 1e-5), each
   timed beside its bound in 2-byte storage and its float32 form (the
   gathers beside ``grid_sample`` on bf16), and the grouped K9-block's,
   K11-block's and K12-block's bf16 forms as phase 19 holds and times
   their float32 ones; then the bf16
   block step
   (``bf16_block_path``) on (2, 4) blocks of one card at 2048², 20
   iterations: exact, windowed, compensated with fast math, multigrid
   (two cycles) and CG-20, and ``"auto"`` at 8192² on (2, 2), exact, 40
   iterations, which must take blocks; each held to the plain twins' step
   (``_BlockStep(..., plain=True)``) bit for bit and to the float32 block
   step by ``bf16_bars``, with its rel-L2 to the ``reference`` backend's
   bf16 block step printed, its state bf16 and finite, its launches a step
   against ``expected_launches_blocks`` (the bf16 forms; the float32 block
   forms at 0), eager and graph ms/step beside the float32 block step's,
   and for multigrid and CG max|div| after the first projection beside
   float32's and the ``reference`` backend's bf16 block step's;
21. bf16 storage on the 3-D step (``bf16_3d_phase``): the bf16 forms of
   K5 (per-sweep and tiled), K6 (exact and windowed, one field and the
   triple), K7 (into float32) and K8 (from a float32 pressure) against
   their plain twins at 256³ (``checks.kernel_checks3_bf16``, bit for
   bit), every call in the tiled kernel's mode also on it against the
   same call on the per-sweep
   K5's bf16 form; K6's bf16 form (the gather body of
   ``csrc/advect3_body.cuh``) also against the grouped K14's bf16 form
   over one slab of the volume and the one-cell K14's bf16 form on the
   volume, bit for bit (``checks.kernel_checks_k6_body``); each form timed
   beside its bound in 2-byte storage, its
   float32 form on the same values, its plain twin and, for K6,
   ``grid_sample`` on bf16; the per-sweep K5's timed calls (one sweep,
   the 20-sweep u solve) in its vector form and its one-cell form, each
   bit for bit with the twin, timed in turns beside the float32 form,
   with their launches by width (``sweep3_forms``); then
   ``StableFluids3D`` in bf16 at 256³
   (``bf16_3d_path``), parity (20 iterations), compensated with fast math
   and windowed parity (4 cells), three steps each from the
   reference draw rounded to bf16: launches against
   ``expected_launches3`` (bf16 forms wherever a bf16 operand enters, the
   float32 K5 for the pressure solves on the float32 divergence; every
   per-sweep launch in the vector form, ``require_walk``), the
   state bf16, held to the plain twins' step (``_Ops3(cfg, plain=True)``)
   bit for bit and to the float32 step by ``bf16_bars``, max|div| after
   the first projection bf16 beside float32, eager and graph ms/step
   beside the float32 step.
22. bf16 on the 3-D z-slab step (``bf16_zslab_phase``): the bf16 forms of
   K13 (per-sweep and the tiled slab walk), K14 (windowed and exact), K15
   (into float32) and K16 (from a float32 pressure) against their plain
   twins on top, interior and bottom 32-plane slabs of 256³
   (``checks.kernel_checks_slab3_bf16``, bit for bit), every tiled call
   also against the same call on the per-sweep K13's bf16 form; each form
   timed beside its bound in 2-byte storage, its float32 form on the same
   values, its plain twin and, for K14, ``grid_sample`` on bf16; the
   per-sweep K13's timed calls in both its forms (``sweep3_forms``); the
   grouped K14's bf16 form as phase 3d's float32 one
   (``advect3_group_checks``); then
   ``make_sharded_step_fn_3d`` in bf16 at 256³ (``bf16_zslab_path``) on 8
   z-slabs (parity windowed by ``"auto"``, parity exact, compensated with
   fast math) and 32 of 8 planes (compensated with fast math), two steps
   each from the reference draw rounded to bf16: launches against
   ``expected_launches_sharded3`` (the bf16 forms, the float32 K13 for the
   pressure solves and no other float32 form; every per-sweep launch in
   the vector form, ``require_walk``), the state bf16, held to
   the plain twins' z-slab step (``_ZSlabStep(..., plain=True)``) bit for
   bit and to the float32 z-slab step by ``bf16_bars``, the exact run to
   the single-device bf16 step bit for bit, eager and graph ms/step
   beside the float32 z-slab step, and on the per-slab K14
   (``per_slab_route``).

The line before the last is ``{"kernels": [...]}``: per kernel its launches
in its main path's run (phase 5, phase 13's two trajectories, phases 14-15
and phase 17's CLI calls for the 2-D kernels, phases 8, 16 and 17 for the
3-D ones, the 8-slab
2048² parity run of phase 10 for the row-slab kernels (K9-damp and the
slab K1-damp from its 8-slab multigrid and CG runs; K12's exact form,
``advect_slab_exact``, from phase 10's 8-slab 2048² exact run), the
8-slab 256³ parity run of phase 11 for the z-slab kernels (the grouped
K14's exact form, ``advect3_group_exact``, from its 8-slab and 64-slab
exact runs), phase 12's tail
runs for K17, phase 10's chunk run for B13's split-source K9, phases 14 and
18 for K1-damp (its bf16-rhs forms, ``jacobi_sweeps_damp_bf16``, from
phase 18's bf16 multigrid runs) and
phase 16 for K6's window, phase 19's runs for the block forms, phase
20's for their bf16 forms, phase 21's for K5-K8's bf16 forms, phase 22's
for K13-K16's), its max|Δ|
from phase 3, 3b, 3c, 3d, 3e, 3f, 19, 20, 21 or 22,
its device time beside its plain version's, and its bound; the bf16 forms
are entries of their own (``jacobi_sweeps_bf16``, ``divergence_bf16``,
``gradient_bf16``, ``advect_bf16``: launches from phase 18's 2048² parity
run and its datagen run, max|Δ| and times from phase 18; the tiled K9's
``jacobi_slab_sweeps`` from phase 10's 8-slab 2048² parity run).  The
per-sweep K1's forms (``jacobi_sweep``, ``jacobi_sweep_bf16``,
``jacobi_sweep_damp``), the per-sweep K9 (``jacobi_slab``) and K18's one
sweep (``jacobi_slab_split``), which the tiled K1, K1-damp, the tiled K9
and its split-source first launch replaced on every path, and the tiled
3-D kernel's four forms (``jacobi3_sweeps``, ``jacobi3_slab_sweeps`` and
their bf16 forms), whose fast Chebyshev solves the per-sweep K5's and
K13's vector walk took at 256³, the per-block K9-block, K11-block and
K12-block and the per-slab K14's four forms, which the grouped K9-block,
K11-block, K12-block and K14 took over, run on
none and are left out of the line
(``OFF_PATH``): every path's launch counts hold them at 0.  Each timing
times a plain version in a CUDA graph of ``PLAIN_REPS`` calls, once.  The last line
is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero before any phase.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# When the script started: each phase's header says how far in it is.
START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
TPU_KERNELS = "fluidsimulationcuda_tpu/kernels/pallas_ops.py"
TPU_KERNELS_3D = "fluidsimulationcuda_tpu/kernels/pallas_ops_3d.py"
TPU_SLABS = "fluidsimulationcuda_tpu/kernels/pallas_sharded.py"
TPU_SLABS_3D = "fluidsimulationcuda_tpu/kernels/pallas_sharded_3d.py"
TPU_STEP = "fluidsimulationcuda_tpu/parallel/sharded.py"
TPU_STEP_3D = "fluidsimulationcuda_tpu/parallel/sharded3d.py"
TPU_TAIL = "fluidsimulationcuda_tpu/kernels/pallas_step.py"
# BASELINE config 4 (BASELINE.json:10): 1024 independent sims of 256²; the
# grids phase 13 runs again one by one.
DATAGEN_BATCH, DATAGEN_N = 1024, 254
DATAGEN_GRIDS = (0, 1, 511, 1023)
# Phase 17: the CLI's 2-D and 3-D interiors (2048², 256³) and its files
# (gitignored, removed after the phase).
CLI_N, CLI_N3 = 2046, 254
CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_cli")
# Each main_path run's eager ms/step, by label (phase 17 prints the CLI's
# beside them).
EAGER_MS: dict[str, float] = {}
CSRC = "fluidsimulationcuda_torch/csrc"
# CUDA kernel -> (its source, the pallas_call it replaces on the main path).
KERNEL_SOURCES = {
    "jacobi_sweep": (f"{CSRC}/jacobi.cu", f"{TPU_KERNELS}:645"),
    "divergence": (f"{CSRC}/project.cu", f"{TPU_KERNELS}:899"),
    "gradient": (f"{CSRC}/project.cu", f"{TPU_KERNELS}:899"),
    "advect": (f"{CSRC}/advect.cu", f"{TPU_KERNELS}:1182"),
    "dens_advect": (f"{CSRC}/dens_advect.cu", f"{TPU_KERNELS}:1480"),
    "jacobi3_sweep": (f"{CSRC}/jacobi3.cu", f"{TPU_KERNELS_3D}:458"),
    "divergence3": (f"{CSRC}/project3.cu", f"{TPU_KERNELS_3D}:1085"),
    "gradient3": (f"{CSRC}/project3.cu", f"{TPU_KERNELS_3D}:1101"),
    "advect3": (f"{CSRC}/advect3.cu", f"{TPU_KERNELS_3D}:728"),
    "jacobi_slab": (f"{CSRC}/jacobi_slab.cu", f"{TPU_SLABS}:290"),
    "divergence_slab": (f"{CSRC}/project_slab.cu", f"{TPU_SLABS}:1357"),
    "gradient_slab": (f"{CSRC}/project_slab.cu", f"{TPU_SLABS}:1378"),
    "advect_slab": (f"{CSRC}/advect_slab.cu", f"{TPU_SLABS}:1246"),
    "jacobi3_slab": (f"{CSRC}/jacobi3_slab.cu", f"{TPU_SLABS_3D}:349"),
    # The TPU step computes these two stencils in jnp (no pallas_call).
    "divergence3_slab": (f"{CSRC}/project3_slab.cu", f"{TPU_STEP_3D}:567"),
    "gradient3_slab": (f"{CSRC}/project3_slab.cu", f"{TPU_STEP_3D}:582"),
    "advect3_slab": (f"{CSRC}/advect3_slab.cu", f"{TPU_SLABS_3D}:530"),
    # The exact forms of K12 and K14: the TPU steps gather exactly in jnp
    # (_advect_local, _advect3_local_exact; no pallas_call).
    "advect_slab_exact": (f"{CSRC}/advect_slab.cu", f"{TPU_STEP}:245"),
    "advect3_slab_exact": (f"{CSRC}/advect3_slab.cu", f"{TPU_STEP_3D}:288"),
    "advect_project": (f"{CSRC}/advect_project.cu", f"{TPU_TAIL}:299"),
    "jacobi_slab_split": (f"{CSRC}/jacobi_slab_split.cu", f"{TPU_SLABS}:506"),
    # B13 as the tiled K9's first launch, its tiles read from the split
    # operands.
    "jacobi_slab_sweeps_split": (f"{CSRC}/jacobi_tiles.cu",
                                 f"{TPU_SLABS}:506"),
    # The slab multigrid's smoother, every slab of a device in one launch:
    # the TPU step smooths in jnp (_mg_smooth_local, no pallas_call).
    "jacobi_slab_sweeps_damp_group": (f"{CSRC}/jacobi_tiles.cu",
                                      f"{TPU_STEP}:477"),
    # The tiled K9, T sweeps a launch on a row slab's buffer.
    "jacobi_slab_sweeps": (f"{CSRC}/jacobi_tiles.cu", f"{TPU_SLABS}:290"),
    # The damped mode of the same pallas_call (fused_jacobi's damp), per
    # sweep and as K1-damp, and the window of the 3-D gather
    # (advect3_shift(_fused)'s cmax).
    "jacobi_sweep_damp": (f"{CSRC}/jacobi.cu", f"{TPU_KERNELS}:645"),
    "jacobi_sweeps_damp": (f"{CSRC}/jacobi_tiles.cu", f"{TPU_KERNELS}:645"),
    # K1-damp's bf16-rhs forms, the finest level of a bf16 multigrid
    # solve: JAX smooths that level in jnp (its Pallas smoother takes
    # float32 only, ops/multigrid.py:266 there).
    "jacobi_sweeps_damp_bf16": (f"{CSRC}/jacobi_tiles.cu",
                                f"{TPU_KERNELS}:645"),
    "advect3_windowed": (f"{CSRC}/advect3.cu", f"{TPU_KERNELS_3D}:728"),
    # The bf16 storage forms of the same pallas_calls (JAX's bf16 mode).
    "jacobi_sweep_bf16": (f"{CSRC}/jacobi.cu", f"{TPU_KERNELS}:645"),
    # The tiled K1, T sweeps a launch, in float32 and bf16 storage.
    "jacobi_sweeps": (f"{CSRC}/jacobi_tiles.cu", f"{TPU_KERNELS}:645"),
    "jacobi_sweeps_bf16": (f"{CSRC}/jacobi_tiles.cu", f"{TPU_KERNELS}:645"),
    # The tiled 3-D Jacobi, T3 sweeps a launch, on a volume (K5) and on the
    # plane range of a z-slab (K13).
    "jacobi3_sweeps": (f"{CSRC}/jacobi3_tiles.cu", f"{TPU_KERNELS_3D}:458"),
    "jacobi3_slab_sweeps": (f"{CSRC}/jacobi3_tiles.cu",
                            f"{TPU_SLABS_3D}:349"),
    # The block route's forms: the TPU step computes them in jnp
    # (_diffuse_local and its Chebyshev and damped twins, the gathers,
    # the two stencils; no pallas_call).
    "jacobi_block_sweeps": (f"{CSRC}/jacobi_tiles.cu", f"{TPU_STEP}:195"),
    "advect_block": (f"{CSRC}/advect_slab.cu", f"{TPU_STEP}:274"),
    "advect_block_exact": (f"{CSRC}/advect_slab.cu", f"{TPU_STEP}:245"),
    "divergence_block": (f"{CSRC}/project_slab.cu", f"{TPU_STEP}:317"),
    "gradient_block": (f"{CSRC}/project_slab.cu", f"{TPU_STEP}:329"),
    # Their bf16 forms: the TPU step's bf16 storage runs its jnp block
    # route (no pallas_call; its slab route is float32).
    "jacobi_block_sweeps_bf16": (f"{CSRC}/jacobi_tiles.cu",
                                 f"{TPU_STEP}:195"),
    # K9-block grouped: a chunk over every block of a device in one launch.
    "jacobi_block_group": (f"{CSRC}/jacobi_tiles.cu", f"{TPU_STEP}:195"),
    "jacobi_block_group_bf16": (f"{CSRC}/jacobi_tiles.cu",
                                f"{TPU_STEP}:195"),
    # K11-block and K12-block grouped: every block of a device in one
    # launch.
    "gradient_block_group": (f"{CSRC}/project_slab.cu", f"{TPU_STEP}:329"),
    "gradient_block_group_bf16": (f"{CSRC}/project_slab.cu",
                                  f"{TPU_STEP}:329"),
    "advect_block_group": (f"{CSRC}/advect_slab.cu", f"{TPU_STEP}:274"),
    "advect_block_group_exact": (f"{CSRC}/advect_slab.cu",
                                 f"{TPU_STEP}:245"),
    "advect_block_group_bf16": (f"{CSRC}/advect_slab.cu", f"{TPU_STEP}:274"),
    "advect_block_group_exact_bf16": (f"{CSRC}/advect_slab.cu",
                                      f"{TPU_STEP}:245"),
    "advect_block_bf16": (f"{CSRC}/advect_slab.cu", f"{TPU_STEP}:274"),
    "advect_block_exact_bf16": (f"{CSRC}/advect_slab.cu", f"{TPU_STEP}:245"),
    "divergence_block_bf16": (f"{CSRC}/project_slab.cu", f"{TPU_STEP}:317"),
    "gradient_block_bf16": (f"{CSRC}/project_slab.cu", f"{TPU_STEP}:329"),
    "divergence_bf16": (f"{CSRC}/project.cu", f"{TPU_KERNELS}:899"),
    "gradient_bf16": (f"{CSRC}/project.cu", f"{TPU_KERNELS}:899"),
    "advect_bf16": (f"{CSRC}/advect.cu", f"{TPU_KERNELS}:1182"),
    # The bf16 forms of K5-K8: JAX's bf16 3-D step runs its jnp ops
    # (_use_pallas3 takes float32 only), the functions of these
    # pallas_calls.
    "jacobi3_sweep_bf16": (f"{CSRC}/jacobi3.cu", f"{TPU_KERNELS_3D}:458"),
    "jacobi3_sweeps_bf16": (f"{CSRC}/jacobi3_tiles.cu",
                            f"{TPU_KERNELS_3D}:522"),
    "advect3_bf16": (f"{CSRC}/advect3.cu", f"{TPU_KERNELS_3D}:728"),
    "advect3_windowed_bf16": (f"{CSRC}/advect3.cu", f"{TPU_KERNELS_3D}:728"),
    "divergence3_bf16": (f"{CSRC}/project3.cu", f"{TPU_KERNELS_3D}:1085"),
    "gradient3_bf16": (f"{CSRC}/project3.cu", f"{TPU_KERNELS_3D}:1101"),
    # The bf16 forms of K13-K16: JAX's bf16 z-slab step runs its jnp
    # _step3_local (its Pallas z-slab route takes float32 only), the
    # functions of these pallas_calls and of its two jnp stencils.
    "jacobi3_slab_bf16": (f"{CSRC}/jacobi3_slab.cu", f"{TPU_SLABS_3D}:349"),
    "jacobi3_slab_sweeps_bf16": (f"{CSRC}/jacobi3_tiles.cu",
                                 f"{TPU_SLABS_3D}:442"),
    "advect3_slab_bf16": (f"{CSRC}/advect3_slab.cu", f"{TPU_SLABS_3D}:530"),
    "advect3_slab_exact_bf16": (f"{CSRC}/advect3_slab.cu",
                                f"{TPU_STEP_3D}:288"),
    "divergence3_slab_bf16": (f"{CSRC}/project3_slab.cu",
                              f"{TPU_STEP_3D}:405"),
    "gradient3_slab_bf16": (f"{CSRC}/project3_slab.cu", f"{TPU_STEP_3D}:419"),
    # K14 grouped: the gather of every z-slab of a device in one launch,
    # on the gather body of advect3_body.cuh (its per-slab forms above,
    # which it replaced on every path, stay as what it is held to).
    "advect3_group": (f"{CSRC}/advect3_slab.cu", f"{TPU_SLABS_3D}:530"),
    "advect3_group_exact": (f"{CSRC}/advect3_slab.cu", f"{TPU_STEP_3D}:288"),
    "advect3_group_bf16": (f"{CSRC}/advect3_slab.cu", f"{TPU_SLABS_3D}:530"),
    "advect3_group_exact_bf16": (f"{CSRC}/advect3_slab.cu",
                                 f"{TPU_STEP_3D}:288"),
}
# Phase 18's batch of grids for the multigrid and CG steps.
SOLVER_BATCH = 64
# The calls in a CUDA graph that times a plain version (kernel_times): its
# many small operations make a graph of 20 slow to capture, and its time is
# no yardstick of the kernel's.
PLAIN_REPS = 3
# The per-sweep K1's forms and the per-sweep K9: the tiled K1, K1-damp and
# the tiled K9 took over every solve they ran, so no path launches them;
# phases 3, 3c, 3f and 18 time them beside the tiled kernels as their
# "before", and the kernels line leaves them out.  So too K18's one sweep,
# which the split-source tiled K9 replaced (phase 3e holds and times it
# beside that).
# The tiled 3-D Jacobi's four forms too: the per-sweep K5's and K13's
# vector walk took over the fast Chebyshev solves at 256³ (cuda_ops.tiled3),
# and phases 3b, 3d, 21 and 22 hold and time them beside it.  And the
# per-block K9-block: the grouped K9-block runs every block solve's chunks,
# and phases 19 and 20 hold it against the per-block form and time both.
# And the per-slab K14: the grouped K14 runs every z-slab gather, and
# phases 3d and 22 hold it against the per-slab forms and time both.  And
# the per-block K11-block and K12-block: their grouped forms run every
# block gradient and gather, and phases 19 and 20 hold them against the
# per-block forms and time both.
OFF_PATH = ("jacobi_sweep", "jacobi_sweep_bf16", "jacobi_slab",
            "jacobi_sweep_damp", "jacobi_slab_split", "jacobi3_sweeps",
            "jacobi3_slab_sweeps", "jacobi3_sweeps_bf16",
            "jacobi3_slab_sweeps_bf16", "jacobi_block_sweeps",
            "jacobi_block_sweeps_bf16", "advect3_slab", "advect3_slab_exact",
            "advect3_slab_bf16", "advect3_slab_exact_bf16", "gradient_block",
            "gradient_block_bf16", "advect_block", "advect_block_exact",
            "advect_block_bf16", "advect_block_exact_bf16")


def phase(title: str) -> None:
    print(f"\n=== {title} (at {time.perf_counter() - START:.1f} s)",
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def mg_cycle_launches(n: int, pre: int = 2, post: int = 2,
                      min_n: int = 16, bf16: bool = False) -> dict[str, int]:
    """Damped K1 launches of one multigrid V-cycle from interior ``n``, by
    kernel: a ``pre`` and a ``post`` smooth on every level whose interior
    is at least ``min_n``, each next padded side the half rounded down to
    a multiple of 8 (at least 16), then 40 sweeps on the coarsest level
    (JAX's ``mg_pressure_solve_fast``; at 2048²: 7 levels, 68 sweeps),
    each smooth in the launches of ``cuda_ops.damped_plan`` (K1-damp's,
    or a launch a sweep of the per-sweep damped K1; at 2048²: 15 K1-damp
    launches; from 256²: 9, one grid or a batch, whose smooths are one
    launch whatever the tile).  ``bf16``: the finest level's rhs is bf16,
    so its smooths take K1-damp's bf16-rhs forms
    (``jacobi_sweeps_damp_bf16``: 2 of the 15 at 2048²)."""
    from fluidsimulationcuda_torch.kernels import cuda_ops

    launches = dict.fromkeys(("jacobi_sweeps_damp", "jacobi_sweep_damp",
                              "jacobi_sweeps_damp_bf16"), 0)
    fine = True

    def smooth(side, sweeps):
        per_launch = cuda_ops.damped_plan(side, sweeps).per_launch
        if per_launch == 0:
            launches["jacobi_sweep_damp"] += sweeps
        else:
            name = "jacobi_sweeps_damp" + ("_bf16" if bf16 and fine else "")
            launches[name] += -(-sweeps // per_launch)

    while n >= min_n:
        smooth(n + 2, pre)
        smooth(n + 2, post)
        fine = False
        half = (n + 2) // 2
        n = max(16, half - half % 8) - 2
    smooth(n + 2, 40)
    return launches


def k1_launches(sweeps: int) -> int:
    """Tiled K1 launches of a solve of ``sweeps`` sweeps: T each, the
    remainder last."""
    from fluidsimulationcuda_torch.kernels import cuda_ops

    return -(-sweeps // cuda_ops.SWEEPS_PER_LAUNCH)


def expected_launches(cfg) -> dict[str, int]:
    """Kernel launches of one step of ``cfg``: each solve on the tiled K1,
    T sweeps a launch (``k1_launches``), the density's first ``iters-1``
    before K4.  The multigrid projection smooths with K1-damp, counted
    apart (``mg_cycle_launches``); the CG projection launches K2 alone
    (its iterations are torch operations).  In bf16 both take K2's bf16
    forms, and multigrid's finest level K1-damp's bf16-rhs forms."""
    k_vel = k_dens = cfg.jacobi_iters
    if cfg.diffusion_solver == "chebyshev":
        k_vel = k_dens = cfg.cheby_iters
    elif cfg.diffusion_solver == "chebyshev-dens":
        k_dens = cfg.cheby_dens_iters
    k_p = {"chebyshev": cfg.press_cheby_iters, "multigrid": 0,
           "cg": 0}.get(cfg.pressure_solver, cfg.jacobi_iters)
    if cfg.dtype == torch.bfloat16:
        # K1's bf16 form for the three diffusions (the density's too: K1
        # then K3 replace K4, as in JAX's bf16 OpSet), its float32 form for
        # the pressure inside fused_project, K2's and K3's bf16 forms.
        launches = {"jacobi_sweeps_bf16": (2 * k1_launches(k_vel)
                                           + k1_launches(k_dens)),
                    "jacobi_sweeps": 2 * k1_launches(k_p),
                    "divergence_bf16": 2, "gradient_bf16": 2,
                    "advect_bf16": 2}
    else:
        launches = {"jacobi_sweeps": (2 * k1_launches(k_vel)
                                      + 2 * k1_launches(k_p)
                                      + k1_launches(k_dens - 1)),
                    "divergence": 2, "gradient": 2, "advect": 1,
                    "dens_advect": 1}
    if cfg.pressure_solver == "multigrid":
        for name, count in mg_cycle_launches(
                cfg.n, bf16=cfg.dtype == torch.bfloat16).items():
            if count:
                launches[name] = 2 * cfg.mg_cycles * count
    return {k: c for k, c in launches.items() if c}


def solves3(cfg) -> list[tuple[int, int, bool]]:
    """(count, sweeps, Chebyshev) of the solves of one 3-D step of ``cfg``:
    three velocity diffusions, two pressure solves, the density
    diffusion."""
    vel = cfg.diffusion_solver == "chebyshev"
    dens = cfg.diffusion_solver in ("chebyshev", "chebyshev-dens")
    press = cfg.pressure_solver == "chebyshev"
    k_dens = (cfg.cheby_dens_iters if cfg.diffusion_solver == "chebyshev-dens"
              else cfg.cheby_iters if dens else cfg.jacobi_iters)
    return [(3, cfg.cheby_iters if vel else cfg.jacobi_iters, vel),
            (2, cfg.press_cheby_iters if press else cfg.jacobi_iters, press),
            (1, k_dens, dens)]


def k3_launches(cfg, mz: int | None = None) -> dict[str, int]:
    """Launches of the 3-D Jacobi kernels in one step of ``cfg`` (on one
    z-slab of ``mz`` planes: each solve in segments of K = min(fuse,
    sweeps, mz-1) sweeps, the remainder last, on buffers of mz + 2(K+1)
    planes, ``parallel/sharded3d.py``): a solve or segment that
    ``cuda_ops.tiled3`` gives the tiled kernel runs ceil(sweeps / T3)
    launches a segment, the others one per-sweep launch a sweep.  In bf16
    storage (one volume) the diffusions take K5's bf16 forms and the
    pressure solves, on the float32 divergence, its float32 forms."""
    from fluidsimulationcuda_torch.kernels import cuda_ops

    per = cuda_ops.SWEEPS_PER_LAUNCH_3D
    names = (("jacobi3_sweeps", "jacobi3_sweep") if mz is None
             else ("jacobi3_slab_sweeps", "jacobi3_slab"))
    launches = dict.fromkeys(names, 0)
    bf16 = cfg.dtype == torch.bfloat16
    for i, (count, sweeps, cheby) in enumerate(solves3(cfg)):
        tiled, plain = (tuple(f"{k}_bf16" for k in names)
                        if bf16 and i != 1 else names)
        launches.setdefault(tiled, 0)
        launches.setdefault(plain, 0)
        seg = (sweeps if mz is None
               else min(cfg.fuse_sweeps or 20, sweeps, mz - 1))
        planes = None if mz is None else mz + 2 * (seg + 1)
        if not cuda_ops.tiled3(cheby, cfg.fast_math, planes, cfg.n + 2):
            launches[plain] += count * sweeps
            continue
        full, rest = divmod(sweeps, seg)
        launches[tiled] += count * (full * -(-seg // per) + -(-rest // per))
    return launches


def expected_launches3(cfg) -> dict[str, int]:
    """Kernel launches of one 3-D step of ``cfg``: three velocity
    diffusions, two pressure solves and the density diffusion on K5, the
    tiled form T3 sweeps a launch where ``cuda_ops.tiled3`` says so
    (``k3_launches``), one K7 and one K8 per projection, one K6 for the
    (u, v, w) self-advection triple and one for the density (counted as
    ``advect3_windowed`` under ``advect_mode="windowed"``); in bf16
    storage K6-K8's bf16 forms."""
    bf16 = _bf16_suffix(cfg)
    advect = ("advect3_windowed" if cfg.advect_mode == "windowed"
              else "advect3")
    return {**k3_launches(cfg), f"divergence3{bf16}": 2,
            f"gradient3{bf16}": 2, f"{advect}{bf16}": 2}


def slab_solve_launches(sweeps: int, rows: int, side: int,
                        split: bool = False) -> dict[str, int]:
    """Tiled K9 launches of a row-slab solve of ``sweeps`` sweeps on a
    (rows, side) buffer: ``sweep_plan``'s, T of ``cuda_ops.slab_tiling``
    sweeps each, the remainder last; ``split``: the first of them from
    B13's split operands (``jacobi_slab_sweeps_split``)."""
    from fluidsimulationcuda_torch.kernels import cuda_ops

    per_launch = cuda_ops.slab_tiling(rows, side, sweeps)[0]
    launches = -(-sweeps // per_launch)
    if split:
        return {"jacobi_slab_sweeps_split": 1,
                "jacobi_slab_sweeps": launches - 1}
    return {"jacobi_slab_sweeps": launches}


def slab_solves(cfg, slabs: int,
                exact: bool = False) -> list[tuple[int, int]]:
    """(sweeps, buffer rows) of each K9 solve one slab runs in a
    multi-device step of ``cfg`` on ``slabs`` row slabs, by the routes of
    ``parallel/sharded.py``: the velocity diffusions in Jacobi chunks of
    ``fuse_sweeps`` (a ``ceil8(s+1)``-row halo each) or one Chebyshev call,
    the pressure solves inside the fused projection (``ceil8(it+3)``) or
    chunked or one Chebyshev call in the composed one (none for the
    multigrid and CG projections), the density's solve
    inside the fused density step (``ceil8(it+1+cmax)``; never with
    ``exact`` gathers, whose density step is composed) or as the
    velocities'."""
    def ceil8(x):
        return -(-x // 8) * 8

    m, it, cmax = (cfg.n + 2) // slabs, cfg.jacobi_iters, cfg.max_courant
    fuse = cfg.fuse_sweeps or 20

    def chunks(iters):
        out, left = [], iters
        while left > 0:
            s = min(fuse, left)
            out.append((s, m + 2 * ceil8(s + 1)))
            left -= s
        return out

    def cheby(iters):
        # A halo deeper than a slab: the block solve (slab_block_solves).
        if ceil8(iters + 1) > m:
            return []
        return [(iters, m + 2 * ceil8(iters + 1))]

    dens_cheby = cfg.diffusion_solver in ("chebyshev", "chebyshev-dens")
    k_dens = (cfg.cheby_iters if cfg.diffusion_solver == "chebyshev"
              else cfg.cheby_dens_iters)
    cheby_p = cfg.pressure_solver == "chebyshev"
    it_p = cfg.press_cheby_iters if cheby_p else it
    vel = (cheby(cfg.cheby_iters) if cfg.diffusion_solver == "chebyshev"
           else chunks(it))
    if cfg.pressure_solver in ("multigrid", "cg"):
        proj = []  # no K9 solve: slab_mg_launches, or torch operations
    elif ceil8(it_p + 3) <= m:
        proj = [(it_p, m + 2 * ceil8(it_p + 3))]
    else:
        proj = cheby(it_p) if cheby_p else chunks(it)
    if (not exact and not dens_cheby and it <= fuse and 1 <= cmax <= 7
            and ceil8(it + 1 + cmax) <= m):
        dens = [(it, m + 2 * ceil8(it + 1 + cmax))]
    else:
        dens = cheby(k_dens) if dens_cheby else chunks(it)
    return 2 * vel + 2 * proj + dens


def slab_block_solves(cfg, slabs: int) -> list[int]:
    """The sweeps of each one-call Chebyshev solve of a slab step of
    ``cfg`` on ``slabs`` row slabs whose ``ceil8(iters+1)``-row halo is
    deeper than a slab: those run JAX's jnp fallback, the block route's
    chunked solve on the (px, 1) blocks (``parallel/sharded.py``,
    ``_cheby_blocks``), one grouped K9-block launch over every slab a
    chunk."""
    m = (cfg.n + 2) // slabs
    deep = [] if cfg.diffusion_solver != "chebyshev" else [cfg.cheby_iters] * 2
    if cfg.pressure_solver == "chebyshev" and -(-(
            cfg.press_cheby_iters + 3) // 8) * 8 > m:
        deep += [cfg.press_cheby_iters] * 2
    if cfg.diffusion_solver in ("chebyshev", "chebyshev-dens"):
        deep.append(cfg.cheby_iters if cfg.diffusion_solver == "chebyshev"
                    else cfg.cheby_dens_iters)
    return [k for k in deep if -(-(k + 1) // 8) * 8 > m]


def slab_mg_launches(cfg, slabs: int) -> dict[str, int]:
    """Kernel launches of one slab multigrid solve of ``cfg`` on ``slabs``
    row slabs of one device (``parallel/solvers.py``), by kernel: each
    cycle's 2-sweep smooths on the grouped K9-damp, every slab in one
    launch of ``cuda_ops.group_smooth_tiling``'s T sweeps (a table of at
    most ``GROUP_SLABS`` slabs a launch), and the replicated coarse grid's
    classic cycle (2 + 40 sweeps on (n/2 + 2)², two-level on more than one
    slab) on K1-damp in the launches of ``cuda_ops.damped_plan`` (at
    1025²: 1 + 4)."""
    from fluidsimulationcuda_torch.kernels import cuda_ops

    side = cfg.n + 2
    m = side // slabs

    def fine(sweeps, launches):
        while sweeps > 0:
            per_launch = cuda_ops.group_smooth_tiling(side * side, m,
                                                      sweeps)[0]
            launches["jacobi_slab_sweeps_damp_group"] += -(
                -slabs // cuda_ops.GROUP_SLABS)
            sweeps -= per_launch

    return _mg_launches(cfg, "jacobi_slab_sweeps_damp_group", fine)


def group_launches(parts: int) -> int:
    """Grouped K9-block launches a chunk over ``parts`` blocks of one
    device: one a table of at most ``cuda_ops.GROUP_BLOCKS``."""
    from fluidsimulationcuda_torch.kernels import cuda_ops

    return -(-parts // cuda_ops.GROUP_BLOCKS)


def block_mg_launches(cfg, px: int, py: int) -> dict[str, int]:
    """``slab_mg_launches`` on the (px, py) blocks of one device on the
    block route: each fine smooth one grouped K9-block launch over every
    block (``group_launches``) for every ``BLOCK_SMOOTH`` sweeps (no more
    than a block's side), the coarse grid as on slabs (in bf16 the grouped
    K9-block's and K1-damp's bf16 forms)."""
    from fluidsimulationcuda_torch.parallel.solvers import BLOCK_SMOOTH

    side = cfg.n + 2
    per = min(BLOCK_SMOOTH, side // px, side // py)
    name = "jacobi_block_group" + _bf16_suffix(cfg)

    def fine(sweeps, launches):
        launches[name] += group_launches(px * py) * -(-sweeps // per)

    return _mg_launches(cfg, name, fine)


def _bf16_suffix(cfg) -> str:
    """``"_bf16"`` for a bf16 config, whose kernels count their bf16
    forms under that suffix, else ``""``."""
    return "_bf16" if cfg.dtype == torch.bfloat16 else ""


def _mg_launches(cfg, fine_kernel: str, fine) -> dict[str, int]:
    """The launches of one sharded multigrid solve of ``cfg``: ``fine(sweeps,
    launches)`` counts a fine-level smooth; the replicated coarse grid's
    classic cycle on K1-damp."""
    from fluidsimulationcuda_torch.kernels import cuda_ops
    from fluidsimulationcuda_torch.ops.multigrid import mg_levels

    # A bf16 coarse grid (the block route's) smooths on K1-damp's bf16-rhs
    # forms, which have no per-sweep form.
    tiled = "jacobi_sweeps_damp" + _bf16_suffix(cfg)
    launches = dict.fromkeys((fine_kernel, tiled, "jacobi_sweep_damp"), 0)

    def coarse(n, sweeps):
        per_launch = cuda_ops.damped_plan(n + 2, sweeps).per_launch
        if per_launch == 0:
            launches["jacobi_sweep_damp"] += sweeps
        else:
            launches[tiled] += -(-sweeps // per_launch)

    def classic(n, level):  # ops.multigrid.v_cycle
        coarse(n, 2)
        if level == 0:
            coarse(n, 40)
            return
        classic(n // 2, level - 1)
        coarse(n, 2)

    levels = mg_levels(cfg.n)
    for _ in range(cfg.mg_cycles):
        fine(2, launches)
        if levels == 0:
            fine(40, launches)
            continue
        classic(cfg.n // 2, levels - 1)
        fine(2, launches)
    return {k: c for k, c in launches.items() if c}


def block_chunks(iters: int, m: int, k: int) -> int:
    """The chunks of a block solve of ``iters`` sweeps on (m, k) blocks,
    of ``parallel.sharded._chunk`` sweeps each: a grouped K9-block launch
    each (``group_launches``)."""
    from fluidsimulationcuda_torch.parallel.sharded import _chunk

    return -(-iters // _chunk(iters, m, k))


def expected_launches_blocks(cfg, px: int, py: int,
                             exact: bool = False) -> dict[str, int]:
    """Kernel launches of one block-route step of ``cfg`` on (px, py)
    blocks of one device (``parallel/sharded.py``, ``_BlockStep``): the
    grouped K9-block once a chunk of each solve over every block
    (``group_launches``; ``block_chunks``: two velocity diffusions, two
    pressure solves, the density diffusion; the multigrid projection's
    smooths by ``block_mg_launches``, none for CG), each block K10-block
    once per projection, the grouped K11-block once per projection and
    the grouped K12-block for the u/v pair and the density (its exact form
    with ``exact`` gathers), each over every block (``group_launches``).
    A bf16 config launches each kernel's bf16 form and none of the float32
    ones."""
    side = cfg.n + 2
    bf = _bf16_suffix(cfg)
    m, k, blocks = side // px, side // py, px * py
    mode = cfg.diffusion_solver
    k_vel = cfg.cheby_iters if mode == "chebyshev" else cfg.jacobi_iters
    k_dens = (cfg.cheby_iters if mode == "chebyshev"
              else cfg.cheby_dens_iters if mode == "chebyshev-dens"
              else cfg.jacobi_iters)
    k_p = {"chebyshev": cfg.press_cheby_iters, "multigrid": 0,
           "cg": 0}.get(cfg.pressure_solver, cfg.jacobi_iters)
    chunks = (2 * block_chunks(k_vel, m, k) + block_chunks(k_dens, m, k)
              + (2 * block_chunks(k_p, m, k) if k_p else 0))
    launches = {f"jacobi_block_group{bf}": group_launches(blocks) * chunks,
                f"divergence_block{bf}": 2 * blocks,
                f"gradient_block_group{bf}": 2 * group_launches(blocks),
                ("advect_block_group_exact" if exact
                 else "advect_block_group") + bf:
                2 * group_launches(blocks)}
    if cfg.pressure_solver == "multigrid":
        for name, count in block_mg_launches(cfg, px, py).items():
            launches[name] = launches.get(name, 0) + 2 * count
    return launches


def expected_launches_sharded(cfg, slabs: int,
                              exact: bool = False) -> dict[str, int]:
    """Kernel launches of one multi-device step of ``cfg`` on ``slabs`` row
    slabs.  Each slab launches K9 for each solve of ``slab_solves`` (two
    velocity diffusions, two pressure solves, its density diffusion) as
    ``slab_solve_launches`` counts them, chunk by chunk; K10 and K11 once
    per projection, K12 for the u/v pair and the density gather (its exact
    form, ``advect_slab_exact``, with ``exact`` gathers).  The
    fused and composed routes launch K10-K12 as often: they differ in halo
    exchanges and in the chunks of their solves.  The multigrid projection
    adds ``slab_mg_launches`` twice; CG's iterations are torch
    operations."""
    launches = {"divergence_slab": 2 * slabs, "gradient_slab": 2 * slabs,
                "advect_slab_exact" if exact else "advect_slab": 2 * slabs}
    for sweeps, rows in slab_solves(cfg, slabs, exact):
        for name, count in slab_solve_launches(sweeps, rows,
                                               cfg.n + 2).items():
            launches[name] = launches.get(name, 0) + slabs * count
    if cfg.pressure_solver == "multigrid":
        for name, count in slab_mg_launches(cfg, slabs).items():
            launches[name] = 2 * count
    side = cfg.n + 2
    chunks = sum(block_chunks(k, side // slabs, side)
                 for k in slab_block_solves(cfg, slabs))
    if chunks:
        launches["jacobi_block_group"] = group_launches(slabs) * chunks
    return launches


def expected_launches_sharded3(cfg, slabs: int,
                               exact: bool = False) -> dict[str, int]:
    """Kernel launches of one 3-D multi-device step of ``cfg`` on ``slabs``
    z-slabs.  Each slab runs its three velocity diffusions, two pressure
    solves and its density diffusion in segments on K13, each on the tiled
    form T3 sweeps a launch where ``cuda_ops.tiled3`` says so
    (``k3_launches``); K15 and K16 once per projection; the grouped K14
    once for the (u, v, w) triple and once for the density over every slab
    of the card, ``GATHER_SLABS`` slabs a launch (its exact form,
    ``advect3_group_exact``, with ``exact`` gathers).  In bf16 storage the
    bf16 forms of each, the pressure solves on the float32 K13
    (``k3_launches``)."""
    from fluidsimulationcuda_torch.kernels.cuda_sharded_3d import GATHER_SLABS

    jacobi = k3_launches(cfg, (cfg.n + 2) // slabs)
    bf16 = _bf16_suffix(cfg)
    advect = "advect3_group_exact" if exact else "advect3_group"
    return {**{k: slabs * n for k, n in jacobi.items()},
            f"divergence3_slab{bf16}": 2 * slabs,
            f"gradient3_slab{bf16}": 2 * slabs,
            f"{advect}{bf16}": 2 * -(-slabs // GATHER_SLABS)}


def fields(state) -> list[tuple[str, torch.Tensor]]:
    return [(name, x) for name, x in zip(state._fields, state)
            if x is not None]


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for (_, x), (_, y) in zip(fields(a), fields(b)))


def require_close(a, b, rtol: float, atol: float, what: str) -> None:
    for (name, x), (_, y) in zip(fields(a), fields(b)):
        bad = (x - y).abs() > atol + rtol * y.abs()
        if bool(bad.any()):
            raise AssertionError(f"{what}: {name} differs in {int(bad.sum())} "
                                 f"cells, max|d|={float((x - y).abs().max()):.3e}")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64: the datagen density decays to ~1e-27
    in 20 steps, whose squares float32 flushes to zero."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-300))


def bf16_bars(got, twins, ref16, ref32, label: str) -> None:
    """The bars of a bf16 run of the ``cuda`` backend.  Its own semantics
    (JAX's Pallas bf16 mode: float32 iterates, bf16 storage) are the
    ``cuda`` OpSet's plain twins in bf16 (``twins``, fast math's fmaf
    included): equal bit for bit.  The float32 run from the same rounded draw (``ref32``): rel-L2 under 0.15
    for density (tests/test_pallas_ops.py:384), and no farther than the
    ``reference`` backend's bf16 run (``ref16``), which rounds every
    sweep to bf16 as JAX's jnp ops do, lies from it.  Every field finite.
    The rel-L2 to ``ref16`` is printed: JAX's bar on it (0.01 density, 0.02
    u) holds at JAX's point (``bf16_jax_point``), not at these sizes."""
    require_finite(got, label)
    twin = max_diff(got, twins)
    d16, u16 = rel_l2(got.dens, ref16.dens), rel_l2(got.u, ref16.u)
    d32, u32 = rel_l2(got.dens, ref32.dens), rel_l2(got.u, ref32.u)
    r32 = rel_l2(ref16.dens, ref32.dens)
    print(f"{label}: max|d| to the plain twins {twin:.3e}; rel-L2 to the float32 run: dens {d32:.3e} (bar "
          f"0.15, and <= the reference bf16 run's {r32:.3e}), u {u32:.3e}; "
          f"to the reference backend's bf16 run: dens {d16:.3e}, u "
          f"{u16:.3e}")
    if twin != 0.0:
        raise AssertionError(f"{label}: differs from the plain twins")
    if not (d32 < 0.15 and d32 <= r32):
        raise AssertionError(f"{label}: too far from the float32 run")


def bf16_unit(x: torch.Tensor) -> float:
    """One bf16 rounding unit at the magnitude of ``x``'s largest value (8
    significant bits)."""
    m = float(x.abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def require_finite(state, what: str) -> None:
    for name, x in fields(state):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: {name} is not finite")


def timed_steps(step_fn, state, steps: int) -> tuple[object, float]:
    """Run ``steps`` calls of ``step_fn(state)``; return the state and
    ms/step from CUDA events around them."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state = step_fn(state)
    stop.record()
    stop.synchronize()
    return state, start.elapsed_time(stop) / steps


def require_walk(counts: dict[str, int], label: str) -> None:
    """Every launch of the per-sweep K5 and K13 (float32 and bf16) in a
    run whose launch ``counts`` these are in the vector walk
    (``cuda_ops.width_counts``, reset with the launch counts): none in the
    one-cell form."""
    from fluidsimulationcuda_torch.kernels import cuda_ops

    widths = cuda_ops.width_counts()
    walk = {k: widths[k] for k in ("jacobi3_sweep", "jacobi3_slab",
                                   "jacobi3_sweep_bf16", "jacobi3_slab_bf16")
            if counts.get(k)}
    if walk:
        print(f"{label}: per-sweep K5/K13 launches by width {walk}")
    for k, by_width in walk.items():
        if by_width[1] or by_width[4] != counts[k]:
            raise AssertionError(f"{label}: {k} launches by width "
                                 f"{by_width}, {counts[k]} in all")


def main_path(cfg, label: str, card: str, steps: int,
              tol: tuple[float, float, float] | None,
              forced_tol: float | None = None,
              oracle: tuple[str, object] | None = None) -> dict[str, int]:
    """Impulse step plus ``steps-1`` steps through ``StableFluids2D`` or
    ``StableFluids3D`` (by ``cfg.ndim``); check and return the launch counts
    of that run.  ``tol = (rtol, atol, last)`` holds step 1 to
    ``|d| <= atol + rtol*|ref|`` and step ``steps`` to ``max|d| <= last``
    against the ``reference`` backend on the same tensors, or against
    ``oracle = (its name, step(state, sources))``; None skips the
    comparison.  ``forced_tol`` also runs ``steps-1`` steps of both backends
    with the sources scaled by 0.05 firing every step (the forced twin of
    the JAX bench, ``bench.py:405-406``) and holds the last to
    ``max|d| <= forced_tol``.  Then times the step: eager with CUDA events
    (what a caller sees) and as a CUDA graph (device time alone; the
    difference is host and launch overhead)."""
    from fluidsimulationcuda_torch import (Sources, StableFluids2D,
                                           StableFluids3D, reference_init,
                                           step, step3, zero_sources)
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    if cfg.ndim == 3:
        model, step_fn, design = StableFluids3D, step3, expected_launches3
    else:
        model, step_fn, design = StableFluids2D, step, expected_launches
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    sim = model(cfg)
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    cuda_ops.reset_width_counts()
    first = sim.step(state0, sources)
    state = first
    for _ in range(steps - 1):
        state = sim.step(state)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    per_step = design(cfg)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    require_walk(counts, label)
    require_finite(state, label)
    ref = cfg.replace(backend="reference")
    if tol is not None:
        rtol, atol, last = tol
        zeros = zero_sources(ref)
        name, o_step = oracle or ("reference backend",
                                  functools.partial(step_fn, ref))
        r_first = o_step(state0, sources)
        d1 = max_diff(first, r_first)
        require_close(first, r_first, rtol, atol, f"{label} step 1")
        r_state, ref_ms = timed_steps(lambda s: o_step(s, zeros), r_first,
                                      steps - 1)
        dn = max_diff(state, r_state)
        print(f"{label}: max|d| vs {name}: step 1 {d1:.3e}, step {steps} "
              f"{dn:.3e}; {name} {ref_ms:.4f} ms/step")
        if not dn <= last:
            raise AssertionError(f"{label}: step {steps} max|d| {dn:.3e} > {last}")
    if forced_tol is not None:
        drive = Sources(*(None if s is None else 0.05 * s for s in sources))
        forced, r_forced = state0, state0
        for _ in range(steps - 1):
            forced = sim.step(forced, drive)
            r_forced = step_fn(ref, r_forced, drive)
        require_finite(forced, f"{label} forced")
        df = max_diff(forced, r_forced)
        scale = max(float(x.abs().max()) for _, x in fields(r_forced))
        print(f"{label}: forced trajectory, step {steps - 1}: max|d| vs "
              f"reference backend {df:.3e} (max|field| {scale:.3e})")
        if not df <= forced_tol:
            raise AssertionError(f"{label}: forced max|d| {df:.3e} > "
                                 f"{forced_tol}")
    state, ms = timed_steps(sim.step, state, max(steps - 1, 2))
    require_finite(state, label)
    EAGER_MS[label] = ms
    graph_ms = checks.device_ms(lambda: sim.step(state), reps=3)
    print(f"{label}: {ms:.4f} ms/step eager, "
          f"{cfg.num_cells / (ms * 1e-3) / 1e6:.1f} Mcell-updates/s; "
          f"{graph_ms:.4f} ms/step as a CUDA graph (device busy "
          f"{100 * graph_ms / ms:.1f}% of the eager step) ({card})")
    return counts


def sharded_path(cfg, slabs: int, label: str, card: str, steps: int,
                 tol: tuple[float, float, float] | None,
                 graph_reps: int = 3, single: bool = True,
                 advect_mode: str = "auto") -> dict[str, int]:
    """Impulse step plus ``steps-1`` steps of ``make_sharded_step_fn(cfg,
    advect_mode=advect_mode, audited=True)`` on ``slabs`` row slabs of one
    card (a mesh that lists ``cuda:0`` once per slab), or in 3-D of
    ``make_sharded_step_fn_3d`` on ``slabs`` z-slabs; check and return the
    launch counts of that run.  ``tol = (rtol, atol, last)`` holds step 1
    to ``|d| <= atol + rtol*|ref|`` and step ``steps`` to ``max|d| <=
    last`` against the ``reference`` backend of the same sharded step on
    the same CUDA tensors and, where the gathers were exact (the mode
    taken is ``"exact"``, or the audited displacement stayed under
    ``cfg.max_courant``), against ``StableFluids2D.step`` (3-D:
    ``StableFluids3D.step``), which gathers exactly; None skips both.  With
    ``tol`` a windowed run also drives ``steps`` steps of a forced
    trajectory (sources scaled by 0.05 every step, as in phase 8), which at
    2048² stays under the window where the impulse does not, and holds it
    against the single-device step the same way; an exact run instead runs
    the windowed step of the same mesh (where its slabs hold the window)
    from the same start and prints its max|d| to the single-device step:
    what the window costs there.  ``single=False`` leaves the single-device
    step out: the slab multigrid runs the classic cycle, the single-device
    step the graded one.  Then times the step eager and as a CUDA graph
    (an exact run: beside the windowed step, with both steps' launches,
    and the share of the exact step's device time that its all-gather
    copies take, ``mesh._gather`` of its gathered fields timed alone)."""
    from fluidsimulationcuda_torch import (StableFluids2D, StableFluids3D,
                                           reference_init, zero_sources)
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    make_sharded_step_fn_3d,
                                                    shard_state,
                                                    shard_state_3d, unshard)
    from fluidsimulationcuda_torch.parallel.mesh import _gather

    if cfg.ndim == 3:
        make_step, shard, model = (make_sharded_step_fn_3d, shard_state_3d,
                                   StableFluids3D)
        design = expected_launches_sharded3
    else:
        make_step, shard, model = (make_sharded_step_fn, shard_state,
                                   StableFluids2D)
        design = expected_launches_sharded
    mesh = make_mesh([torch.device("cuda", 0)] * slabs)
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    step_fn = make_step(cfg, mesh, advect_mode=advect_mode, audited=True)
    exact = step_fn.advect_mode == "exact"
    start, src, zeros = (shard(x, mesh)
                         for x in (state0, sources, zero_sources(cfg)))
    if cfg.ndim == 3:
        print(f"{label}: {slabs} slab(s) of {(cfg.n + 2) // slabs} planes, "
              f"(K, H) per solve {step_fn.chunks}, advect_mode "
              f"{advect_mode!r} took {step_fn.advect_mode!r}")
    else:
        print(f"{label}: {slabs} slab(s) of {(cfg.n + 2) // slabs} rows, "
              f"routes {step_fn.routes}, advect_mode {advect_mode!r} took "
              f"{step_fn.advect_mode!r}")

    def run(fn):
        states, disps, state = [], [], start
        for k in range(steps):
            state, disp = fn(state, src if k == 0 else zeros)
            states.append(state)
            disps.append(disp)
        return states, disps

    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    cuda_ops.reset_width_counts()
    states, disps = run(step_fn)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    per_step = design(cfg, slabs, exact)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    require_walk(counts, label)
    first, last = unshard(states[0]), unshard(states[-1])
    require_finite(last, label)
    disp = max(float(d) for d in disps)
    print(f"{label}: audited displacement {disp:.6f} cells (largest of "
          f"{steps} steps; window {cfg.max_courant}; gathers "
          f"{'exact' if exact else 'windowed'})")
    if tol is not None:
        rtol, atol, last_tol = tol
        ref = make_step(cfg.replace(backend="reference"), mesh,
                        advect_mode=advect_mode, audited=True)
        r_states, _ = run(ref)
        twins = [("reference backend, sharded",
                  unshard(r_states[0]), unshard(r_states[-1]))]
        ones = None
        if not single:
            print(f"{label}: the single-device step solves by another "
                  f"algorithm: no single-device comparison")
        elif exact or disp < cfg.max_courant:
            sim = model(cfg)
            ones = [sim.step(state0, sources)]
            for _ in range(steps - 1):
                ones.append(sim.step(ones[-1]))
            twins.append(("single-device step", ones[0], ones[-1]))
        else:
            print(f"{label}: displacement >= window: no single-device "
                  f"comparison")
        for what, t_first, t_last in twins:
            d1, dn = max_diff(first, t_first), max_diff(last, t_last)
            require_close(first, t_first, rtol, atol, f"{label} step 1 vs {what}")
            print(f"{label}: max|d| vs {what}: step 1 {d1:.3e}, step {steps} "
                  f"{dn:.3e}")
            if not dn <= last_tol:
                raise AssertionError(f"{label}: step {steps} vs {what}: "
                                     f"max|d| {dn:.3e} > {last_tol}")
        if exact:
            windowed_cost(cfg, mesh, make_step, start, src, zeros, steps,
                          ones, label)
        else:
            forced_path(cfg, mesh, step_fn, shard, model, state0, sources,
                        start, steps, single, tol, label)
    plain = make_step(cfg, mesh, advect_mode=advect_mode)
    state, ms = timed_steps(lambda s: plain(s, zeros), states[-1],
                            max(steps - 1, 2))
    require_finite(unshard(state), label)
    graph_ms = checks.device_ms(lambda: plain(state, zeros), reps=graph_reps)
    print(f"{label}: {ms:.4f} ms/step eager, "
          f"{cfg.num_cells / (ms * 1e-3) / 1e6:.1f} Mcell-updates/s; "
          f"{graph_ms:.4f} ms/step as a CUDA graph (device busy "
          f"{100 * graph_ms / ms:.1f}% of the eager step, host share "
          f"{100 * (1 - graph_ms / ms):.1f}%) ({card})")
    if exact:
        # The step's gathered fields: the velocities' (two or three) and
        # the density's, each assembled once on the card.
        gathered = [f for f in (state.u, state.v, state.w, state.dens)
                    if f is not None]
        gather_ms = checks.device_ms(
            lambda: [_gather(f) for f in gathered], reps=graph_reps)
        print(f"{label}: the all-gather copies ({len(gathered)} fields "
              f"assembled) {gather_ms:.4f} ms as a CUDA graph, "
              f"{100 * gather_ms / graph_ms:.1f}% of the exact step's "
              f"device time ({card}){'' if cfg.ndim == 2 else '; the 3-D step on one card no longer runs them (the grouped K14)'}")
        m = (cfg.n + 2) // slabs
        if m >= cfg.max_courant + 1:
            win = make_step(cfg, mesh, advect_mode="windowed")
            cuda_ops.reset_launch_counts()
            win(state, zeros)
            torch.cuda.synchronize()
            w_launches = sum(cuda_ops.launch_counts().values())
            _, w_ms = timed_steps(lambda s: win(s, zeros), state,
                                  max(steps - 1, 2))
            w_graph = checks.device_ms(lambda: win(state, zeros),
                                       reps=graph_reps)
            print(f"{label}: exact {ms:.4f} ms/step eager, {graph_ms:.4f} "
                  f"as a CUDA graph, {sum(per_step.values())} launches a "
                  f"step; windowed {w_ms:.4f} ms/step eager, {w_graph:.4f} "
                  f"as a CUDA graph, {w_launches} launches a step ({card})")
    if cfg.ndim == 3:
        per_slab_route(cfg, mesh, exact, (start, src, zeros), state, label,
                       card, graph_reps)
    return counts


def per_slab_route(cfg, mesh, exact: bool, cut, state, label: str, card: str,
                   reps: int) -> None:
    """The z-slab step of ``cfg`` with its gathers on the per-slab K14, the
    route the grouped K14 replaced (``mesh._ext`` or ``mesh._gather`` of
    each gathered field, then one launch a slab): its step from ``cut``'s
    start and sources bit for bit the grouped step's; both timed from
    ``state``, eager and as a CUDA graph of ``reps`` steps."""
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.parallel.sharded3d import _ZSlabStep

    mesh = mesh.reshape(len(mesh.device_list), 1)
    grouped = _ZSlabStep(cfg, mesh, False, exact)
    per = _ZSlabStep(cfg, mesh, False, exact)
    per.ops = per.ops._replace(advect_group=None)
    start, src, zeros = cut
    a, b = grouped(start, src), per(start, src)
    if not all(torch.equal(x, y) for fa, fb in zip(a, b)
               for x, y in zip(fa, fb)):
        raise AssertionError(f"{label}: the grouped gathers' step differs "
                             f"from the per-slab K14's")
    ms = {"grouped": [], "per-slab": []}
    # In turns grouped, per-slab, per-slab, grouped: eager steps on this
    # host swing from run to run.
    for name in ("grouped", "per-slab", "per-slab", "grouped"):
        fn = grouped if name == "grouped" else per
        last, eager = timed_steps(lambda s: fn(s, zeros), state, 3)
        ms[name].append((eager, checks.device_ms(lambda: fn(last, zeros),
                                                 reps=reps)))
    mean = {k: [sum(x) / len(v) for x in zip(*v)] for k, v in ms.items()}
    print(f"{label}: gathers grouped (one K14 launch a gather) / per-slab "
          f"(_ext or _gather, one K14 launch a slab), bit for bit, in turns: "
          f"eager {mean['grouped'][0]:.4f} / {mean['per-slab'][0]:.4f} "
          f"ms/step (each turn {[round(e, 4) for e, _ in ms['grouped']]} / "
          f"{[round(e, 4) for e, _ in ms['per-slab']]}), as a CUDA graph "
          f"{mean['grouped'][1]:.4f} / {mean['per-slab'][1]:.4f} ({card})")


def copy_share(per_kernel: dict[str, list]) -> float:
    """The share of a traced step's device time that its copies take:
    the halo and all-gather ``torch.cat``, the zero pads and device
    copies (every kernel whose name says cat, copy or fill)."""
    busy = sum(ms for _, ms in per_kernel.values())
    copies = sum(ms for name, (_, ms) in per_kernel.items()
                 if re.search(r"Cat|[Cc]opy|Fill|Memcpy|Memset", name))
    return copies / busy


def block_path(cfg, shape: tuple[int, int], label: str, card: str,
               steps: int, against: str, tol: float = 0.0,
               advect_mode: str = "exact", shard_backend: str = "reference",
               timed: bool = True) -> dict[str, int]:
    """Impulse step plus ``steps-1`` steps of ``make_sharded_step_fn(cfg,
    shard_backend=shard_backend, advect_mode=advect_mode)`` on a ``shape``
    mesh of one card (``cuda:0`` listed once per part): its launches a
    step against ``expected_launches_blocks`` (the slab route's, for a
    run ``"auto"`` keeps on slabs, against ``expected_launches_sharded``),
    and each step's state against ``against``: ``"single"``,
    ``StableFluids2D.step``; ``"slabs"``, the slab route on the flattened
    mesh (its max|d| printed, held to ``tol`` unless None); ``"reference"``
    the same step on the ``reference`` backend (the plain twins); max|d|
    at most ``tol`` (0: bit for bit).  With ``timed``: eager and CUDA-graph
    ms/step and one step traced, with the share of its device time the
    halo copies take (``copy_share``).  Returns the launch counts."""
    from fluidsimulationcuda_torch import (StableFluids2D, reference_init,
                                           zero_sources)
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_blocks,
                                                    shard_state, unshard)

    px, py = shape
    mesh = make_mesh([torch.device("cuda", 0)] * (px * py), shape=shape)
    step_fn = make_sharded_step_fn(cfg, mesh, advect_mode=advect_mode,
                                   shard_backend=shard_backend, audited=True)
    cut = shard_blocks if step_fn.layout == "blocks" else shard_state
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    start, src, zeros = (cut(x, step_fn.mesh)
                         for x in (state0, sources, zero_sources(cfg)))
    side = cfg.n + 2
    print(f"{label}: {step_fn.layout} of {side // px} x "
          f"{side // py if step_fn.layout == 'blocks' else side} on mesh "
          f"{shape}, shard_backend {step_fn.shard_backend!r}, advect_mode "
          f"{advect_mode!r} took {step_fn.advect_mode!r}")

    def run(fn, start=start, src=src, zeros=zeros, mesh=step_fn.mesh):
        states, disps, state = [], [], start
        for k in range(steps):
            state, disp = fn(state, src if k == 0 else zeros)
            states.append(unshard(state, mesh))
            disps.append(float(disp))
        return states, disps, state

    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    states, disps, last = run(step_fn)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    exact = step_fn.advect_mode == "exact"
    per_step = (expected_launches_blocks(cfg, px, py, exact)
                if step_fn.layout == "blocks"
                else expected_launches_sharded(cfg, px * py, exact))
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches a step {sum(per_step.values())} "
          f"({ {k: c for k, c in per_step.items() if c} }, computed from the "
          f"code); counted over {steps} steps {counts == want}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    require_finite(states[-1], label)
    print(f"{label}: audited displacement {max(disps):.6f} cells (window "
          f"{cfg.max_courant})")
    if against == "single":
        sim = StableFluids2D(cfg)
        twins = [sim.step(state0, sources)]
        for _ in range(steps - 1):
            twins.append(sim.step(twins[-1]))
        what = "StableFluids2D.step"
    elif against == "slabs":
        slab = make_sharded_step_fn(cfg, mesh, advect_mode=advect_mode,
                                    shard_backend="slab", audited=True)
        flat = [shard_state(x, slab.mesh)
                for x in (state0, sources, zero_sources(cfg))]
        twins = run(slab, *flat, mesh=None)[0]
        what = f"the slab route on {px * py} slabs"
    else:
        ref = make_sharded_step_fn(cfg.replace(backend="reference"), mesh,
                                   advect_mode=advect_mode,
                                   shard_backend=shard_backend, audited=True)
        twins = run(ref)[0]
        what = "the reference backend (plain twins)"
    errs = [max_diff(a, b) for a, b in zip(states, twins)]
    print(f"{label}: max|d| vs {what} by step "
          f"{', '.join(f'{e:.3e}' for e in errs)}"
          + (" (bit for bit)" if tol == 0.0 else f" (bar {tol})"))
    if tol is not None and not max(errs) <= tol:
        raise AssertionError(f"{label}: max|d| {max(errs):.3e} > {tol} vs "
                             f"{what}")
    if timed:
        plain = make_sharded_step_fn(cfg, mesh, advect_mode=advect_mode,
                                     shard_backend=shard_backend)
        state, ms = timed_steps(lambda s: plain(s, zeros), last, 2)
        graph_ms = checks.device_ms(lambda: plain(state, zeros), reps=2)
        per_kernel = profile_step(lambda: plain(state, zeros), label, card)
        print(f"{label}: {ms:.4f} ms/step eager, {graph_ms:.4f} ms/step as "
              f"a CUDA graph; halo and gather copies "
              f"{100 * copy_share(per_kernel):.1f}% of the traced step's "
              f"device time ({card})")
    return counts


def forced_path(cfg, mesh, step_fn, shard, model, state0, sources, start,
                steps, single, tol, label) -> None:
    """``steps`` steps of the forced trajectory (sources scaled by 0.05
    every step) on the sharded step, held to the single-device step where
    the audited displacement stays under the window."""
    from fluidsimulationcuda_torch import Sources
    from fluidsimulationcuda_torch.parallel import unshard

    rtol, atol, _ = tol
    drive = Sources(*(None if s is None else 0.05 * s for s in sources))
    s_drive, forced, one = shard(drive, mesh), start, state0
    sim, f_disp = model(cfg), 0.0
    for _ in range(steps):
        forced, d = step_fn(forced, s_drive)
        if single:
            one = sim.step(one, drive)
        f_disp = max(f_disp, float(d))
    forced = unshard(forced)
    require_finite(forced, f"{label} forced")
    print(f"{label}: forced trajectory (sources x 0.05 every step): "
          f"audited displacement {f_disp:.6f} cells")
    if single and f_disp < cfg.max_courant:
        df = max_diff(forced, one)
        require_close(forced, one, rtol, atol,
                      f"{label} forced step {steps} vs single-device step")
        print(f"{label}: forced step {steps}: max|d| vs single-device "
              f"step {df:.3e}")
    elif single:
        print(f"{label}: forced displacement >= window: no single-device "
              f"comparison")


def windowed_cost(cfg, mesh, make_step, start, src, zeros, steps, ones,
                  label) -> None:
    """The windowed sharded step from the same start as an exact run: its
    max|d| to the single-device step's states ``ones`` (the exact run's
    twin), step 1 and step ``steps``, where the slabs hold the window."""
    from fluidsimulationcuda_torch.parallel import unshard

    m = (cfg.n + 2) // len(mesh.device_list)
    if ones is None or m < cfg.max_courant + 1:
        print(f"{label}: windowed step not compared ({m}-deep slabs, "
              f"window {cfg.max_courant})")
        return
    win = make_step(cfg, mesh, advect_mode="windowed")
    state = start
    for k in range(steps):
        state = win(state, src if k == 0 else zeros)
        if k == 0:
            d1 = max_diff(unshard(state), ones[0])
    print(f"{label}: the windowed step on the same slabs: max|d| vs the "
          f"single-device step: step 1 {d1:.3e}, step {steps} "
          f"{max_diff(unshard(state), ones[-1]):.3e} (what the "
          f"{cfg.max_courant}-cell window costs here)")


def windowed_tail(cfg, state, sources):
    """The velocity tail of one windowed step of ``cfg`` computed again
    through K17: the step's velocity up to its first projection (the
    diffusions and the projection of ``vel_step``, through ``cfg``'s
    backend), then ``fused_advect_project`` with the step's window and
    pressure solve.  Returns (u, v), to hold against the step's own."""
    from fluidsimulationcuda_torch.kernels.cuda_step import (
        fused_advect_project)
    from fluidsimulationcuda_torch.kernels.dispatch import get_ops
    # The head of vel_step, as the step composes it.
    from fluidsimulationcuda_torch.models.stable_fluids_2d import (
        _diffuse_velocity, _make_project)

    ops = get_ops(cfg)
    u, v = _make_project(cfg, ops)(*_diffuse_velocity(
        cfg, ops, state.u, state.v, sources.u, sources.v))
    cheby = cfg.pressure_solver == "chebyshev"
    return fused_advect_project(
        u, v, cfg.n, cfg.press_cheby_iters if cheby else cfg.jacobi_iters,
        cfg.dt, cmax=cfg.max_courant,
        cheby_rho=cfg.cheby_rho if cheby else None)


def windowed_path(cfg, label: str, card: str) -> dict[str, int]:
    """The impulse step of the windowed ``cfg`` through ``step_audited``
    (its displacement printed beside the window), then its velocity tail
    again through K17 (``windowed_tail``) held against the step's own
    result to ``checks.TOL``; the K17 run's launch counts are checked and
    returned."""
    from fluidsimulationcuda_torch import reference_init, step_audited
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops, cuda_step

    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    state1, disp = step_audited(cfg, state0, sources)
    disp = float(disp)
    print(f"{label}: audited displacement {disp:.6f} cells (window "
          f"{cfg.max_courant}: the gathers "
          f"{'clamp' if disp > cfg.max_courant else 'are exact'})")
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    cuda_step.reset_form_counts()
    u, v = windowed_tail(cfg, state0, sources)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    form = [k for k, n in cuda_step.form_counts().items() if n]
    if counts["advect_project"] != 1 or len(form) != 1:
        raise AssertionError(f"{label}: K17 launches {counts}, forms "
                             f"{form}")
    err = max(float((u - state1.u).abs().max()),
              float((v - state1.v).abs().max()))
    print(f"{label}: velocity tail through K17 ({form[0]} form) against the "
          f"step's own: max|d| {err:.3e} ({card})")
    if not err <= checks.TOL:
        raise AssertionError(f"{label}: K17 tail max|d| {err:.3e} > "
                             f"{checks.TOL}")
    return counts


def split_chunk(cfg, slabs: int, label: str, card: str) -> dict[str, int]:
    """B13 on the row-slab step's Jacobi chunk: the first step's
    u-diffusion chunk of ``cfg`` on ``slabs`` slabs of one card (rhs u +
    dt*src from the guess src, ``min(fuse, iters)`` sweeps over a
    ``ceil8(sweeps+1)``-row halo), each slab's halos as the step exchanges
    them, through ``fused_jacobi_slab_split`` (the split-source tiled K9,
    then the tiled K9) against the step's own route (the ``torch.cat``
    extended slabs and K9), bit for bit; both timed as CUDA graphs over
    every slab, beside the route before (K18's one sweep, then K9).
    Returns the split run's launch counts."""
    from fluidsimulationcuda_torch import reference_init
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.kernels import cuda_sharded as cs
    from fluidsimulationcuda_torch.ops.source import add_source
    from fluidsimulationcuda_torch.parallel import make_mesh, shard_state
    # The step's halo exchange and margin.
    from fluidsimulationcuda_torch.parallel.sharded import _ceil8, _ext, _halos

    mesh = make_mesh([torch.device("cuda", 0)] * slabs)
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    state, src = shard_state(state0, mesh), shard_state(sources, mesh)
    m = (cfg.n + 2) // slabs
    sweeps = min(cfg.fuse_sweeps or 20, cfg.jacobi_iters)
    K = _ceil8(sweeps + 1)
    alpha = cfg.diffusion_alpha_visc
    x = src.u
    rhs = [add_source(a, s, cfg.dt) for a, s in zip(state.u, src.u)]
    flags = [(int(i == 0), int(i == slabs - 1), i * m) for i in range(slabs)]
    kw = dict(m=m, K=K, alpha=alpha, beta=1 + 4 * alpha, sweeps=sweeps,
              fast=cfg.fast_math)

    def own():
        return [cs.fused_jacobi_slab(1, xe, re, fl, **kw)
                for xe, re, fl in zip(_ext(x, K), _ext(rhs, K), flags)]

    def split():
        return [cs.fused_jacobi_slab_split(1, xi, xt, xb, ri, rt, rb, fl,
                                           **kw)
                for xi, (xt, xb), ri, (rt, rb), fl
                in zip(x, _halos(x, K), rhs, _halos(rhs, K), flags)]

    want = own()
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    got = split()
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    design = {**dict.fromkeys(cuda_ops.KERNELS, 0),
              **{name: slabs * count for name, count in slab_solve_launches(
                  sweeps, m + 2 * K, cfg.n + 2, split=True).items()}}
    print(f"{label}: launches {counts} (expected {design})")
    if counts != design:
        raise AssertionError(f"{label}: launch counts {counts} != {design}")
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"{label}: against the step's own route: max|d| {err:.3e}")
    if err != 0.0:
        raise AssertionError(f"{label}: split chunk differs by {err:.3e}")

    def before():
        return [cs._split_k18(1, xi, xt, xb, ri, rt, rb, fl, **kw)
                for xi, (xt, xb), ri, (rt, rb), fl
                in zip(x, _halos(x, K), rhs, _halos(rhs, K), flags)]

    fns = {"split": split, "own": own, "before": before}
    ms = dict.fromkeys(fns, 0.0)
    for name in (*fns, *reversed(fns)):
        ms[name] += checks.device_ms(fns[name]) / 2
    print(f"{label}: the chunk over {slabs} slabs as a CUDA graph: "
          f"split-source K9 {ms['split']:.5f} ms, torch.cat + K9 "
          f"{ms['own']:.5f} ms, K18 + K9 (before) {ms['before']:.5f} ms "
          f"({card})")
    return counts


def batched_kernels(card: str, errs: dict[str, float]) -> None:
    """Phase 3's batched checks: K1-K4 on the datagen step's batch
    (``DATAGEN_BATCH`` grids at ``DATAGEN_N``, K3 and K4 in the window
    ``select_cmax_batched`` probes there) against their plain versions and
    timed beside their bounds; then ``fused_jacobi_pair`` against two
    ``fused_jacobi`` calls, bit for bit, and timed beside them, on stacks
    of two grids of the datagen side and of 2048²."""
    from fluidsimulationcuda_torch import SimConfig, select_cmax_batched
    from fluidsimulationcuda_torch.kernels import checks

    side = DATAGEN_N + 2
    cfg = SimConfig(n=DATAGEN_N, jacobi_iters=20, backend="cuda",
                    device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cmax, probed = select_cmax_batched(gen, cfg, DATAGEN_BATCH)
    print(f"  batched: {DATAGEN_BATCH} grids of {side}²; the datagen probe "
          f"moves the backtrace {probed:.6f} cells: window cmax={cmax}")
    compare(checks.kernel_checks_batched(DATAGEN_BATCH, side, "cuda", SEED,
                                         cmax), checks.TOL, errs)
    compare(checks.kernel_checks_flows(side, "cuda", SEED,
                                        batch=DATAGEN_BATCH), checks.TOL, errs)
    kernel_times(checks.timing_checks_batched(DATAGEN_BATCH, side, "cuda",
                                              SEED, cmax),
                 f"{DATAGEN_BATCH} × {side}²", card)
    for pair_side in (side, 2048):
        compare(checks.pair_against_singles(pair_side, "cuda", SEED), 0.0,
                errs, "against two fused_jacobi calls")
        kernel_times(checks.timing_checks_pair(pair_side, "cuda", SEED),
                     f"{pair_side}², a stack of two", card)


def datagen_path(cfg, label: str, card: str, tol: tuple[float, float, float],
                 steps: int = 20, every: int = 5) -> dict[str, int]:
    """Phase 13 for ``cfg`` on ``DATAGEN_BATCH`` grids: probe the window
    (``select_cmax_batched``), run ``generate_trajectories`` windowed at it
    for ``steps`` steps with a snapshot every ``every``, and check its
    launch counts (those of one grid a step), its audited displacement
    (finite, within the window) and its last snapshot (the final density);
    run ``DATAGEN_GRIDS`` again one by one through ``StableFluids2D.step``
    and hold the batch's snapshots and final state to them bit for bit;
    hold step 1 to ``|d| <= atol + rtol*|ref|`` and the last step to
    ``max|d| <= last`` against the ``reference`` backend (``tol = (rtol,
    atol, last)``); time the step eager and as a CUDA graph and trace one
    step with the profiler.  Returns the trajectory's launch counts."""
    from fluidsimulationcuda_torch import (FluidState, Sources,
                                           StableFluids2D, batched_init,
                                           generate_trajectories,
                                           make_batched_step_fn,
                                           select_cmax_batched)
    from fluidsimulationcuda_torch.core.state import zero_sources_like
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.models.batched import _trajectory_runner

    def gen():
        return torch.Generator(device=cfg.device).manual_seed(SEED)

    batch, side = DATAGEN_BATCH, cfg.n + 2
    cmax, probed = select_cmax_batched(gen(), cfg, batch)
    cfg = cfg.replace(advect_mode="windowed", max_courant=cmax)
    print(f"{label}: probed displacement {probed:.6f} cells (8 exact "
          f"steps): window cmax={cmax}")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    start.record()
    final, snaps, dmax = generate_trajectories(gen(), cfg, batch, steps,
                                               snapshot_every=every)
    stop.record()
    stop.synchronize()
    counts = cuda_ops.launch_counts()
    per_step = expected_launches(cfg)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches {counts} (expected {want}; "
          f"{sum(per_step.values())} a step)")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    require_finite(final, label)
    dmax = float(dmax)
    print(f"{label}: generate_trajectories {steps} steps in "
          f"{start.elapsed_time(stop):.2f} ms (the batch's draw included); "
          f"audited displacement {dmax:.6f} cells (window {cmax})")
    if not (np.isfinite(dmax) and dmax <= cmax):
        raise AssertionError(f"{label}: audited displacement {dmax} outside "
                             f"the window {cmax}")
    if (tuple(snaps.shape) != (steps // every, batch, side, side)
            or not torch.equal(snaps[-1], final.dens)):
        raise AssertionError(f"{label}: snapshots {tuple(snaps.shape)} or "
                             f"the last one differs from the final density")

    state0, sources = batched_init(gen(), cfg, batch)
    sim = StableFluids2D(cfg)
    for g in DATAGEN_GRIDS:
        state = FluidState(*(t[g] for t in state0[:3]))
        src = Sources(*(t[g] for t in sources[:3]))
        dens = []
        for k in range(steps):
            state = sim.step(state, src if k == 0 else None)
            if (k + 1) % every == 0:
                dens.append(state.dens)
        alone = (torch.stack(dens),) + tuple(state[:3])
        batched = (snaps[:, g],) + tuple(t[g] for t in final[:3])
        err = max(float((a - b).abs().max()) for a, b in zip(alone, batched))
        if not all(torch.equal(a, b) for a, b in zip(alone, batched)):
            raise AssertionError(f"{label}: grid {g} alone differs from the "
                                 f"batch by {err:.3e}")
    print(f"{label}: grids {DATAGEN_GRIDS} run alone equal the batch bit for "
          f"bit ({steps // every} snapshots and the final state)")

    rtol, atol, last = tol
    ref = cfg.replace(backend="reference")
    step_fn = make_batched_step_fn(cfg)
    first = step_fn(state0, sources)
    r_first = make_batched_step_fn(ref)(state0, sources)
    d1 = max_diff(first, r_first)
    require_close(first, r_first, rtol, atol, f"{label} step 1")
    r_final, _, r_dmax = _trajectory_runner(ref, steps, every)(state0,
                                                               sources)
    dn = max_diff(final, r_final)
    print(f"{label}: max|d| vs reference backend: step 1 {d1:.3e}, step "
          f"{steps} {dn:.3e}; its audited displacement {float(r_dmax):.6f}")
    if not dn <= last:
        raise AssertionError(f"{label}: step {steps} max|d| {dn:.3e} > "
                             f"{last}")

    zeros = zero_sources_like(sources)
    state, ms = timed_steps(lambda s: step_fn(s, zeros), final, 5)
    require_finite(state, label)
    graph_ms = checks.device_ms(lambda: step_fn(state, zeros), reps=3)
    cells = batch * side * side
    print(f"{label}: {ms:.4f} ms/step eager, "
          f"{cells / (ms * 1e-3) / 1e6:.1f} Mcell-updates/s; "
          f"{graph_ms:.4f} ms/step as a CUDA graph (device busy "
          f"{100 * graph_ms / ms:.1f}% of the eager step) ({card})")
    profile_step(lambda: step_fn(state, zeros), label, card)
    return counts


def profile_step(fn, label: str, card: str) -> dict[str, list]:
    """One ``fn()`` traced with ``torch.profiler``: device ms and share
    per CUDA kernel, and the busy share of the wall time (host clock
    around the traced call, ending in a synchronise).  Returns
    {kernel name: [launches, device ms]}."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name.replace("(anonymous namespace)::", "")
            entry = per_kernel.setdefault(name.split("(")[0], [0, 0.0])
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in per_kernel.values())
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the trace holds no device time")
    print(f"{label}: one step traced ({card}):")
    for name, (count, ms) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][1]):
        print(f"  {name[:50]:50s} {count:4d} launches {ms:9.4f} ms "
              f"{100 * ms / busy_ms:5.1f}% {1e3 * ms / count:9.2f} us/launch")
    print(f"  device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%; profiler on)")
    return per_kernel


def max_div(u, v, n: int) -> float:
    from fluidsimulationcuda_torch.ops.project import divergence

    return float(divergence(u, v, n)[1:-1, 1:-1].abs().max())


def projection_quality(cfg, label: str, bar: bool, slabs: int = 0) -> None:
    """The step's first projection of ``cfg`` (on its backend) beside the
    Jacobi-20 projection (``fused_project``) on the same velocity: the
    impulse step's diffused velocity.  Prints max|div| after each; with
    ``bar``, fails unless the first is at most the second (the JAX bench's
    bar for its multigrid line, ``bench.py:234``).  With ``slabs``, the
    row-slab step's projection on that many slabs of one card is printed
    beside them, and it is what ``bar`` holds."""
    from fluidsimulationcuda_torch import reference_init
    from fluidsimulationcuda_torch.kernels import cuda_ops
    from fluidsimulationcuda_torch.kernels.dispatch import get_ops
    # The head of vel_step, as the step composes it.
    from fluidsimulationcuda_torch.models.stable_fluids_2d import (
        _diffuse_velocity, _make_project)
    from fluidsimulationcuda_torch.parallel import make_mesh
    # The slab step's own projection.
    from fluidsimulationcuda_torch.parallel.sharded import _SlabStep

    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    ops = get_ops(cfg)
    u, v = _diffuse_velocity(cfg, ops, state0.u, state0.v, sources.u,
                             sources.v)
    before = max_div(u, v, cfg.n)
    got = max_div(*_make_project(cfg, ops)(u, v), cfg.n)
    jac = max_div(*cuda_ops.fused_project(u, v, cfg.n, 20), cfg.n)
    line = (f"{label}: max|div| of the diffused impulse velocity "
            f"{before:.4e}; after this projection {got:.4e}, after the "
            f"Jacobi-20 projection {jac:.4e} ({got / jac:.3f}x)")
    if slabs:
        mesh = make_mesh([torch.device("cuda", 0)] * slabs)
        m = (cfg.n + 2) // slabs
        us, vs = ([f[i * m:(i + 1) * m].clone() for i in range(slabs)]
                  for f in (u, v))
        run = _SlabStep(cfg, mesh, audited=False, exact=False)
        got = max_div(*map(torch.cat, run._project(us, vs)), cfg.n)
        line += (f"; after the projection on {slabs} slabs {got:.4e} "
                 f"({got / jac:.3f}x)")
    print(line)
    if not np.isfinite(got) or (bar and not got <= jac):
        raise AssertionError(f"{label}: max|div| {got:.4e} against "
                             f"Jacobi-20's {jac:.4e}")


def fast_math_gap(cfg, label: str) -> None:
    """Step 1 of the fast-math ``cfg`` on the card, and through the
    ``cuda`` OpSet's plain twins, each against the ``reference`` backend,
    which ignores ``fast_math``: max|d| and its largest ratio to the parity
    bar (atol 2e-5, rtol 1e-5).  Where the two gaps are alike, the gap is
    fast math's own as the step carries it, not the kernels' (a reading,
    not a bar)."""
    from fluidsimulationcuda_torch import reference_init, step
    from fluidsimulationcuda_torch.kernels import cuda_ops

    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    ref = step(cfg.replace(backend="reference"), state0, sources)
    plain = cuda_ops.make_opset(cfg, plain=True)
    for name, got in (("the card", step(cfg, state0, sources)),
                      ("the plain twins",
                       step(cfg, state0, sources, plain))):
        ratio = max(float(((a - b).abs() / (2e-5 + 1e-5 * b.abs())).max())
                    for (_, a), (_, b) in zip(fields(got), fields(ref)))
        print(f"{label}: step 1, {name} against the reference backend: "
              f"max|d| {max_diff(got, ref):.3e}, {ratio:.2f}x the parity "
              f"bar")


def transfer_split(per_kernel: dict[str, list], label: str) -> None:
    """The traced step's device time in the multigrid transfers (the GEMM
    kernels of ``torch.matmul``) beside K1-damp (``jacobi_damped_sweeps_
    kernel``, and the per-sweep K1's ``jacobi_sweep_kernel<true, ...>``
    where a level takes it) and the diffusion solves (the tiled K1,
    ``jacobi_sweeps_kernel``)."""
    busy = sum(ms for _, ms in per_kernel.values())

    def share(*marks: str) -> str:
        ms = sum(t for name, (_, t) in per_kernel.items()
                 if any(m in name.lower() for m in marks))
        return f"{ms:.4f} ms ({100 * ms / busy:.1f}%)"

    print(f"{label}: of {busy:.4f} device ms, transfers (GEMM) "
          f"{share('gemm')}, K1-damp "
          f"{share('jacobi_damped_sweeps_kernel', 'jacobi_sweep_kernel<true')}"
          f", K1 diffusion solves {share('jacobi_sweeps_kernel')}")


def smoother_routes(step_fn, state, label: str, card: str,
                    steps: int = 5) -> None:
    """The multigrid step ``step_fn(state)`` as the path runs it (its
    smoother on K1-damp) and with its smoother on the per-sweep damped K1
    (``cuda_ops.smooth_launches(0)``, the route before K1-damp): the state
    after one step of each, held bit for bit, their launches a step, and
    ms/step eager (CUDA events around ``steps`` steps) and as a CUDA graph
    of one step, timed in turns K1-damp, per-sweep, per-sweep, K1-damp."""
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    forms = {"K1-damp": contextlib.nullcontext,
             "per-sweep damped K1": lambda: cuda_ops.smooth_launches(0)}
    outs, counts = {}, {}
    for name, form in forms.items():
        with form():
            cuda_ops.reset_launch_counts()
            outs[name] = step_fn(state)
            torch.cuda.synchronize()
            counts[name] = {k: c for k, c in cuda_ops.launch_counts().items()
                            if c}
    diff = max_diff(*outs.values())
    if diff != 0.0:
        raise AssertionError(f"{label}: K1-damp's step differs from the "
                             f"per-sweep damped K1's by {diff:.3e}")
    eager, graph = dict.fromkeys(forms, 0.0), dict.fromkeys(forms, 0.0)
    for name in [*forms, *reversed(forms)]:
        with forms[name]():
            eager[name] += timed_steps(step_fn, state, steps)[1] / 2
            graph[name] += checks.device_ms(lambda: step_fn(state),
                                            reps=3) / 2
    for name in forms:
        print(f"{label}, smoother on {name}: {eager[name]:.4f} ms/step "
              f"eager, {graph[name]:.4f} as a CUDA graph, launches "
              f"{counts[name]} ({card})")
    before = "per-sweep damped K1"
    print(f"{label}: the state after one step equal bit for bit on both; "
          f"K1-damp's step {graph[before] - graph['K1-damp']:.4f} ms "
          f"shorter as a graph, {eager[before] - eager['K1-damp']:.4f} eager")


def windowed3_path(cfg, label: str, card: str, steps: int) -> None:
    """The windowed 3-D step's audited displacement (``step_audited3``) on
    the impulse step, beside the window; then ``steps`` steps of the forced
    trajectory (sources × 0.05 every step, ``bench.py:405-406``) windowed
    and exact, on the card: while the audited displacement stays under the
    window the two are equal bit for bit."""
    from fluidsimulationcuda_torch import Sources, reference_init, step3
    from fluidsimulationcuda_torch.models.stable_fluids_3d import (
        step_audited3)

    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    _, disp = step_audited3(cfg, state0, sources)
    disp = float(disp)
    print(f"{label}: impulse step audited displacement {disp:.6f} cells "
          f"(window {cfg.max_courant}: the gathers "
          f"{'clamp' if disp > cfg.max_courant else 'are exact'})")
    drive = Sources(*(None if s is None else 0.05 * s for s in sources))
    exact_cfg = cfg.replace(advect_mode="exact")
    windowed, exact, f_disp = state0, state0, 0.0
    for _ in range(steps):
        windowed, d = step_audited3(cfg, windowed, drive)
        exact = step3(exact_cfg, exact, drive)
        f_disp = max(f_disp, float(d))
    require_finite(windowed, f"{label} forced")
    diff = max_diff(windowed, exact)
    print(f"{label}: forced trajectory, {steps} steps: audited displacement "
          f"{f_disp:.6f} cells; max|d| windowed vs exact {diff:.3e} ({card})")
    if f_disp < cfg.max_courant and diff != 0.0:
        raise AssertionError(f"{label}: under the window the windowed step "
                             f"differs from the exact one by {diff:.3e}")


def run_cli(argv: list[str]) -> tuple[dict[str, int], str, str]:
    """``fluidsimulationcuda_torch.__main__.main(argv)`` in this process, its
    output echoed; returns the kernel launches of the call (counters reset
    just before it, read just after) and its stdout and stderr."""
    from fluidsimulationcuda_torch import __main__ as cli
    from fluidsimulationcuda_torch.kernels import cuda_ops

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(argv)
        torch.cuda.synchronize()
    finally:
        # Echoed on failure too: a call that raises keeps its output.
        wall = time.perf_counter() - t0
        print(f"$ python -m fluidsimulationcuda_torch {' '.join(argv)}   "
              f"[{wall:.2f} s]")
        for line in (out.getvalue() + err.getvalue()).splitlines():
            print(f"  | {line}")
    return cuda_ops.launch_counts(), out.getvalue(), err.getvalue()


def require_launches(counts: dict[str, int], want: dict[str, int],
                     label: str) -> None:
    from fluidsimulationcuda_torch.kernels import cuda_ops

    want = {k: want.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches {counts}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")


def cli_ms(err: str, label: str, card: str, eager: str) -> None:
    """The CLI's ms/step incl. dispatch beside phase 5, 6 or 8's eager
    ms/step of the same configuration (``EAGER_MS[eager]``)."""
    ms = float(re.search(r"\(([0-9.]+) ms/step incl. dispatch\)",
                         err).group(1))
    print(f"{label}: {ms:.2f} ms/step incl. dispatch through the CLI; "
          f"{EAGER_MS[eager]:.4f} ms/step eager in the phase of "
          f"{eager!r} ({card})")


def cli_path(card: str) -> dict[str, int]:
    """Phase 17: the command line on the card at full width.  Returns the
    launches of its calls."""
    from fluidsimulationcuda_torch import SimConfig, generate_trajectories
    from fluidsimulationcuda_torch.core.config import perf_operating_point
    from fluidsimulationcuda_torch.kernels import cuda_ops

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    total = dict.fromkeys(cuda_ops.KERNELS, 0)

    def tally(counts):
        for k, c in counts.items():
            total[k] += c
        return counts

    a, b, c = (os.path.join(CLI_DIR, f"{x}.npz") for x in "ABC")
    parity = SimConfig(n=CLI_N, jacobi_iters=20, device="cuda")
    per_step = expected_launches(parity)
    label = "CLI run 2048² parity"
    counts, _, err = run_cli(["run", "--n", str(CLI_N), "--steps", "20",
                              "--save", a])
    require_launches(tally(counts), {k: 20 * v for k, v in per_step.items()},
                     label)
    cli_ms(err, label, card, "2048² parity")
    run_cli(["run", "--resume", a, "--steps", "20", "--save", b])
    run_cli(["run", "--n", str(CLI_N), "--steps", "40", "--save", c])
    with np.load(b) as zb, np.load(c) as zc:
        for k in ("dens", "u", "v"):
            if not np.array_equal(zb[k], zc[k]):
                raise AssertionError(
                    f"{label}: resumed {k} differs from the straight run by "
                    f"{np.abs(zb[k] - zc[k]).max():.3e}")
    print(f"{label}: 20 steps saved and 20 resumed equal 40 straight steps "
          f"bit for bit")

    label = "CLI run 2048² --perf --validate"
    rho, k_d, k_p = perf_operating_point(CLI_N + 2)
    perf = parity.replace(pressure_solver="chebyshev",
                          diffusion_solver="chebyshev", fast_math=True,
                          cheby_rho=rho, cheby_iters=k_d, cheby_press_iters=k_p)
    per_perf = expected_launches(perf)
    counts, _, err = run_cli(["run", "--n", str(CLI_N), "--steps", "20",
                              "--perf", "--validate"])
    # validate_perf_point: the parity and perf divergence audits (20 steps
    # each), the velocity and density forcing twins (8 perf steps each);
    # the injection step runs on the reference backend.
    want = {k: 20 * per_step.get(k, 0) + (20 + 8 + 8) * per_perf.get(k, 0)
            + 20 * per_perf.get(k, 0) for k in cuda_ops.KERNELS}
    require_launches(tally(counts), want, label + " (audits + 20 steps)")
    if "validation PASSED" not in err:
        raise AssertionError(f"{label}: the bars did not pass")
    print(f"{label}: the bars pass; {sum(per_perf.values())} launches a "
          f"step in the run")
    cli_ms(err, label, card,
           f"2048² perf (rho={rho}, k_d={k_d}, k_p={k_p}) fast_math")

    label = "CLI run 256³"
    cfg3 = SimConfig(n=CLI_N3, ndim=3, jacobi_iters=20, device="cuda")
    counts, _, err = run_cli(["run", "--ndim", "3", "--n", str(CLI_N3),
                              "--steps", "10"])
    require_launches(tally(counts), {k: 10 * v for k, v in
                                     expected_launches3(cfg3).items()}, label)
    if "; stable," not in err:
        raise AssertionError(f"{label}: the final state is not finite")
    cli_ms(err, label, card, "256³ parity")

    label = "CLI datagen 1024 × 256²"
    out = os.path.join(CLI_DIR, "T.npz")
    dg = SimConfig(n=DATAGEN_N, jacobi_iters=20, device="cuda")
    counts, _, err = run_cli(["datagen", "--n", str(DATAGEN_N), "--batch",
                              str(DATAGEN_BATCH), "--steps", "20", "--out",
                              out])
    # select_cmax_batched's 8 probe steps, then the 20 of the run.
    require_launches(tally(counts), {k: 28 * v for k, v in
                                     expected_launches(dg).items()}, label)
    cmax = int(re.search(r"auto-selected advect window cmax=(\d+)",
                         err).group(1))
    if "(exact" not in err:
        raise AssertionError(f"{label}: the audit verdict is not exact")
    with np.load(out) as z:
        written = z["dens_final"]
    side = DATAGEN_N + 2
    if written.shape != (DATAGEN_BATCH, side, side):
        raise AssertionError(f"{label}: dens_final {written.shape}")
    final, _, _ = generate_trajectories(
        torch.Generator(device="cuda").manual_seed(SEED),
        dg.replace(max_courant=cmax), DATAGEN_BATCH, 20)
    if not torch.equal(torch.from_numpy(written).cuda(), final.dens):
        raise AssertionError(f"{label}: the file differs from "
                             f"generate_trajectories")
    print(f"{label}: dens_final {written.shape} equals generate_trajectories "
          f"(seed {SEED}, cmax={cmax}) bit for bit")

    label = "CLI profile 2048²"
    trace = os.path.join(CLI_DIR, "trace")
    counts, out, _ = run_cli(["profile", "--n", str(CLI_N), "--trace", trace])
    tally(counts)
    if "full step (est)" not in out:
        raise AssertionError(f"{label}: no phase table")
    size = os.path.getsize(os.path.join(trace, "trace.json"))
    idle = [k for k in ("jacobi_sweeps", "divergence", "gradient", "advect",
                        "dens_advect") if counts[k] == 0]
    if idle:
        raise AssertionError(f"{label}: kernels never launched: {idle}")
    print(f"{label}: trace.json {size} bytes; launches {counts}")

    run_cli(["info"])
    shutil.rmtree(CLI_DIR)
    return total


def bf16_path(cfg, label: str, card: str, steps: int) -> dict[str, int]:
    """Phase 18 on one grid: ``cfg`` (float32, the ``cuda`` backend) in bf16
    through ``StableFluids2D``, an impulse step plus ``steps-1``, from the
    reference draw rounded to bf16: launch counts checked, the state held
    to ``bf16_bars`` (the plain twins; the float32 run from the same
    rounded draw, widened, and the ``reference`` backend's bf16 run), ms/step
    of both storages eager and as a CUDA graph.  Returns the bf16 run's
    launch counts."""
    from fluidsimulationcuda_torch import (FluidState, Sources,
                                           StableFluids2D, reference_init,
                                           step)
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    c16 = cfg.replace(dtype=torch.bfloat16)
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state, src = reference_init(gen, cfg)
    state16 = FluidState(*(t.to(torch.bfloat16) for t in state[:3]))
    src16 = Sources(*(t.to(torch.bfloat16) for t in src[:3]))

    def run(c, st, sr, ops=None):
        zeros = Sources(*(torch.zeros_like(t) for t in sr[:3]))
        for k in range(steps):
            st = step(c, st, sr if k == 0 else zeros, ops)
        return st

    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    cuda_ops.reset_width_counts()
    got = run(c16, state16, src16)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    per_step = expected_launches(c16)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches {counts} (expected {want}); by width "
          f"{cuda_ops.width_counts()}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    if any(f.dtype != torch.bfloat16 for f in got[:3]):
        raise AssertionError(f"{label}: the state left bf16")
    twins = run(c16, state16, src16, cuda_ops.make_opset(c16, plain=True))
    ref16 = run(c16.replace(backend="reference"), state16, src16)
    ref32 = run(cfg, FluidState(*(t.float() for t in state16[:3])),
                Sources(*(t.float() for t in src16[:3])))
    bf16_bars(got, twins, ref16, ref32, f"{label}, step {steps}")
    ms = {}
    for name, c, st in (("bf16", c16, got), ("float32", cfg, ref32)):
        sim = StableFluids2D(c)
        st, eager = timed_steps(sim.step, st, 5)
        graph = checks.device_ms(lambda: sim.step(st), reps=3)
        ms[name] = (eager, graph)
    print(f"{label}: ms/step eager / as a CUDA graph: bf16 "
          f"{ms['bf16'][0]:.4f} / {ms['bf16'][1]:.4f}, float32 "
          f"{ms['float32'][0]:.4f} / {ms['float32'][1]:.4f} (bf16/float32 "
          f"device {ms['bf16'][1] / ms['float32'][1]:.3f}) ({card})")
    return counts


def bf16_forms(side: int, batch: int, errs: dict[str, float]) -> None:
    """Phase 18: every form of the bf16 vector kernels of K3 and K2's
    gradient (``checks.BF16_FORMS``) against the plain version of every
    call of ``checks.kernel_checks_bf16_forms`` at ``side`` (a batch of
    ``batch`` grids if given), bit for bit, each launch in its form's width
    where that divides ``side`` (the one-cell kernel where it does not);
    each plain result is computed once."""
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    calls = checks.kernel_checks_bf16_forms(side, "cuda", SEED, batch)
    for c in calls:
        want = c.plain()
        kernel = c.kernels[0]
        for form in checks.BF16_FORMS[kernel]:
            with cuda_ops.vector_widths((form,)):
                cuda_ops.reset_width_counts()
                got = c.run()
                counts = cuda_ops.width_counts()[kernel]
            width = form if side % form == 0 else 1
            err = checks.max_abs_diff(got, want)
            if err != 0.0 or counts != {w: int(w == width) for w in counts}:
                raise AssertionError(f"{c.label} V={form}: max|d| {err}, "
                                     f"launches by width {counts}")
            errs[kernel] = max(errs[kernel], err)
    size = f"{batch} × {side}²" if batch else f"{side}²"
    forms = "; ".join(f"{k} V = {', '.join(map(str, ws))}"
                      for k, ws in checks.BF16_FORMS.items())
    print(f"{size} bf16 vector forms: {len(calls)} calls, each in every "
          f"form of its kernel ({forms}), bit for bit")


def bf16_jax_point(card: str) -> None:
    """JAX's bar for its Pallas bf16 step against its jnp bf16 step, at
    JAX's own point (tests/test_pallas_ops.py:355-384: n=126, 8 iterations,
    a 2-cell window, 3 steps): the ``cuda`` backend's bf16 run against the
    ``reference`` backend's, both windowed, rel-L2 under 0.01 for density
    and 0.02 for u, and under 0.15 to the float32 run for density."""
    from fluidsimulationcuda_torch import (FluidState, SimConfig, Sources,
                                           reference_init, step)

    cfg = SimConfig(n=126, jacobi_iters=8, max_courant=2,
                    advect_mode="windowed", backend="cuda", device="cuda")
    c16 = cfg.replace(dtype=torch.bfloat16)
    state, src = reference_init(
        torch.Generator(device="cuda").manual_seed(SEED), c16)

    def run(c, st, sr):
        zeros = Sources(*(torch.zeros_like(t) for t in sr[:3]))
        for k in range(3):
            st = step(c, st, sr if k == 0 else zeros)
        return st

    got = run(c16, state, src)
    ref16 = run(c16.replace(backend="reference"), state, src)
    ref32 = run(cfg, FluidState(*(t.float() for t in state[:3])),
                Sources(*(t.float() for t in src[:3])))
    require_finite(got, "bf16 at JAX's point")
    d16, u16 = rel_l2(got.dens, ref16.dens), rel_l2(got.u, ref16.u)
    d32 = rel_l2(got.dens, ref32.dens)
    print(f"bf16 at JAX's point (128², 8 it, window 2, 3 steps): rel-L2 to "
          f"the reference backend's bf16 run dens {d16:.3e} (bar 0.01), u "
          f"{u16:.3e} (bar 0.02); to the float32 run dens {d32:.3e} (bar "
          f"0.15) ({card})")
    if not (d16 < 0.01 and u16 < 0.02 and d32 < 0.15):
        raise AssertionError("bf16 at JAX's point: a bar fails")


def bf16_datagen(cfg, label: str, card: str, steps: int = 20,
                 every: int = 5) -> dict[str, int]:
    """Phase 18 on the datagen batch: ``generate_trajectories`` in bf16 at
    the window ``select_cmax_batched`` probes in bf16, launch counts
    checked (those of one grid), the audit float32 and within the window;
    the final state held to ``bf16_bars`` (the ``reference`` backend's bf16
    trajectory and the float32 one from the same bf16 draw, widened);
    ms/step of both storages.  Returns the trajectory's launch counts."""
    from fluidsimulationcuda_torch import (FluidState, Sources, batched_init,
                                           generate_trajectories,
                                           make_batched_step_fn,
                                           select_cmax_batched, step)
    from fluidsimulationcuda_torch.core.state import zero_sources_like
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.models.batched import _trajectory_runner

    def gen():
        return torch.Generator(device=cfg.device).manual_seed(SEED)

    c16 = cfg.replace(dtype=torch.bfloat16)
    cmax, probed = select_cmax_batched(gen(), c16, DATAGEN_BATCH)
    c16 = c16.replace(advect_mode="windowed", max_courant=cmax)
    c32 = cfg.replace(advect_mode="windowed", max_courant=cmax)
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    cuda_ops.reset_width_counts()
    final, snaps, dmax = generate_trajectories(gen(), c16, DATAGEN_BATCH,
                                               steps, snapshot_every=every)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    per_step = expected_launches(c16)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: probed {probed:.6f} cells, window cmax={cmax}; "
          f"launches {counts} (expected {want}); by width "
          f"{cuda_ops.width_counts()}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    if (dmax.dtype != torch.float32 or not float(dmax) <= cmax
            or snaps.dtype != torch.bfloat16
            or any(f.dtype != torch.bfloat16 for f in final[:3])):
        raise AssertionError(f"{label}: audit {dmax} or storage wrong")
    state0, sources = batched_init(gen(), c16, DATAGEN_BATCH)
    zeros = zero_sources_like(sources)
    twins = state0
    plain = cuda_ops.make_opset(c16, plain=True)
    for k in range(steps):
        twins = step(c16, twins, sources if k == 0 else zeros, plain)
    ref16, _, _ = _trajectory_runner(c16.replace(backend="reference"), steps,
                                     every)(state0, sources)
    wide = (FluidState(*(t.float() for t in state0[:3])),
            Sources(*(t.float() for t in sources[:3])))
    ref32, _, _ = _trajectory_runner(c32, steps, every)(*wide)
    bf16_bars(final, twins, ref16, ref32, f"{label}, step {steps}")
    ms = {}
    for name, c, st, src in (("bf16", c16, final, sources),
                             ("float32", c32, ref32, wide[1])):
        step_fn, zeros = make_batched_step_fn(c), zero_sources_like(src)
        st, eager = timed_steps(lambda s: step_fn(s, zeros), st, 5)
        graph = checks.device_ms(lambda: step_fn(st, zeros), reps=3)
        ms[name] = (eager, graph)
    print(f"{label}: ms/step eager / as a CUDA graph: bf16 "
          f"{ms['bf16'][0]:.4f} / {ms['bf16'][1]:.4f}, float32 "
          f"{ms['float32'][0]:.4f} / {ms['float32'][1]:.4f} (bf16/float32 "
          f"device {ms['bf16'][1] / ms['float32'][1]:.3f}) ({card})")
    return counts


def solver_batch_path(solver: str, card: str,
                      dtype: torch.dtype = torch.float32) -> dict[str, int]:
    """Phase 18's batched multigrid or CG step: ``SOLVER_BATCH`` grids of
    256² (20 Jacobi iterations) in one ``make_batched_step_fn`` step;
    launch counts those of one grid (K1's damped sweep takes the batch);
    every grid within the parity bar (rtol 1e-5, atol 2e-5) of its own
    one-grid step, max|Δ| and the grids equal bit for bit printed (the
    batched transfer GEMMs and CG's per-grid reductions may sum in another
    order than one grid's); the batch held to the ``reference`` backend at
    the same bar.  In bf16 (``dtype``) every field stays bf16, each grid
    is held within 4 bf16 units of each field's magnitude of its own step
    (``bf16_unit``; the batched GEMMs' float32 pressure, a few ulp from
    one grid's, rounds some cells of u to the neighbouring bf16 value,
    which the advection and the second projection carry: 2 units measured
    in multigrid's u, CG bit for bit), and the batch to
    ``bf16_bars`` (the plain twins bit for bit; the float32 batch from the
    same bf16 draw, widened; the ``reference`` backend's bf16 batch).
    Returns the launch counts."""
    from fluidsimulationcuda_torch import (FluidState, Sources, SimConfig,
                                           batched_init, make_batched_step_fn,
                                           step)
    from fluidsimulationcuda_torch.kernels import cuda_ops

    cfg = SimConfig(n=254, jacobi_iters=20, backend="cuda", device="cuda",
                    pressure_solver=solver, dtype=dtype)
    bf16 = dtype == torch.bfloat16
    label = f"{'bf16 ' if bf16 else ''}{SOLVER_BATCH} × 256² {solver} step"
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state, src = batched_init(gen, cfg, SOLVER_BATCH)
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    got = make_batched_step_fn(cfg)(state, src)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    want = {k: expected_launches(cfg).get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches {counts} (expected those of one grid, {want})")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    if any(f.dtype != dtype for f in got[:3]):
        raise AssertionError(f"{label}: the state left {dtype}")
    worst, units, exact = 0.0, 0.0, 0
    for g in range(SOLVER_BATCH):
        one = step(cfg, FluidState(*(t[g] for t in state[:3])),
                   Sources(*(t[g] for t in src[:3])))
        mine = FluidState(*(t[g] for t in got[:3]))
        if bf16:
            for (name, a), (_, b) in zip(fields(mine), fields(one)):
                d = float((a.float() - b.float()).abs().max())
                unit = bf16_unit(b)
                units = max(units, d / unit)
                if not d <= 4 * unit:
                    raise AssertionError(f"{label}, grid {g} alone: {name} "
                                         f"max|d| {d:.3e} > 4 bf16 units "
                                         f"{4 * unit:.3e}")
        else:
            require_close(mine, one, 1e-5, 2e-5, f"{label}, grid {g} alone")
        worst = max(worst, max_diff(mine, one))
        exact += all(torch.equal(a, b) for a, b in zip(mine[:3], one[:3]))
    ref = make_batched_step_fn(cfg.replace(backend="reference"))(state, src)
    if bf16:
        twins = step(cfg, state, src, cuda_ops.make_opset(cfg, plain=True))
        ref32 = make_batched_step_fn(cfg.replace(dtype=torch.float32))(
            FluidState(*(t.float() for t in state[:3])),
            Sources(*(t.float() for t in src[:3])))
        bf16_bars(got, twins, ref, ref32, label)
    else:
        require_close(got, ref, 1e-5, 2e-5,
                      f"{label} vs the reference backend")
    print(f"{label}: each grid against its own step max|d| {worst:.3e} "
          f"({f'{units:.2f} bf16 units, ' if bf16 else ''}{exact} of "
          f"{SOLVER_BATCH} bit for bit); against the reference backend "
          f"max|d| {max_diff(got, ref):.3e} ({card})")
    # The per-sweep damped K1 has no bf16 form.
    if solver == "multigrid" and not bf16:
        fn = make_batched_step_fn(cfg)
        smoother_routes(lambda s: fn(s, src), got, label, card)
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    sys.path.insert(0, ROOT)
    from fluidsimulationcuda_torch import (SimConfig, Sources, StableFluids2D,
                                           reference_init, simulate, step,
                                           zero_state)
    from fluidsimulationcuda_torch.core.config import (PERF_POINTS_2D,
                                                       perf_operating_point)
    from fluidsimulationcuda_torch.kernels import build, checks, cuda_ops

    phase("1 environment")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}")
    print(f"nvcc: {nvcc.splitlines()[-1]}")
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s))")
    torch.backends.cuda.matmul.allow_tf32 = False
    # grid_sample, the gathers' library yardstick (library_gather_ms), may
    # take cuDNN's route: in full float32 too.
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    print(f"library: {build.build(verbose=True)}")
    build.load()
    print(f"build + load: {time.perf_counter() - t0:.2f} s")

    phase("3 kernels against their plain versions (side 2048)")
    errs = dict.fromkeys(cuda_ops.KERNELS, 0.0)
    compare(checks.kernel_checks(2048, "cuda", SEED), checks.TOL, errs)
    compare(checks.kernel_checks_flows(2048, "cuda", SEED), checks.TOL, errs)
    k1_against_both(False, errs)
    times = kernel_times(checks.timing_checks(2048, "cuda", SEED), "2048²",
                         card)
    batched_kernels(card, errs)

    phase("3b 3-D kernels against their plain versions (side 256)")
    compare(checks.kernel_checks3(256, "cuda", SEED), checks.TOL, errs)
    compare(checks.per_sweep_checks(checks.kernel_checks3(256, "cuda", SEED)),
            0.0, errs, "bit for bit")
    compare(checks.kernel_checks_flows(256, "cuda", SEED, ndim=3),
            checks.TOL, errs)
    # K6 against two other kernels on its inputs, bit for bit: the grouped
    # K14 over one slab of the volume and the one-cell K14 on the volume.
    compare(checks.kernel_checks_k6_body(256, "cuda", SEED), 0.0, errs,
            "bit for bit")
    timed3 = checks.timing_checks3(256, "cuda", SEED)
    timed_against_both(timed3, checks.TOL, errs)
    times.update(kernel_times(timed3, "256³", card))
    sweep3_forms(timed3, "jacobi3_sweep", card, errs)
    del timed3

    phase("3c row-slab kernels against their plain twins (2048², m=256)")
    slab = checks.kernel_checks_slab(2048, 256, "cuda", SEED)
    # K12's exact form computes its plain version's expressions: bit for
    # bit.
    compare([c for c in slab if "jacobi_slab_sweeps" not in c.kernels
             and "advect_slab_exact" not in c.kernels], checks.TOL, errs)
    compare([c for c in slab if "advect_slab_exact" in c.kernels], 0.0,
            errs, "bit for bit")
    slab_against_both(slab, errs)
    slab = checks.kernel_checks_slab(8192, 2048, "cuda", SEED)
    print("  8192², slabs of 2048 rows:")
    slab_against_both(slab, errs)
    del slab
    floor = launch_floor_ms()
    print(f"  launch floor: {1e3 * floor:.3f} µs per launch (a one-element "
          f"kernel in a CUDA graph of 20; {card})")
    times.update(kernel_times(checks.timing_checks_slab(2048, 256, "cuda",
                                                        SEED),
                              "2048², slab of 256 rows", card, floor))
    kernel_times(checks.timing_checks_slab(8192, 2048, "cuda", SEED),
                 "8192², slab of 2048 rows", card, floor)
    # K9-damp, the slab multigrid's smoother (every slab in one launch),
    # against its plain twin, and timed on four meshes.  K1-damp on the
    # slab multigrid's odd coarse grid (1025² at 2048²).
    compare(checks.kernel_checks_group_smooth(2048, 256, "cuda", SEED), 0.0,
            errs, "bit for bit")
    for side, m, mesh in ((2048, 256, "2048², 8 slabs of 256 rows"),
                          (2048, 2048, "2048², one slab"),
                          (8192, 2048, "8192², 4 slabs of 2048 rows"),
                          (2048, 16, "2048², 128 slabs of 16 rows")):
        timed = checks.timing_checks_group_smooth(side, m, "cuda", SEED)
        compare(timed, 0.0, errs, "bit for bit")
        timed = kernel_times(timed, f"{mesh}, grouped smooth", card, floor)
        if m == 256:
            times.update(timed)
    timed = checks.kernel_checks_damp(1025, "cuda", SEED)
    timed_against_both(timed, 1e-6, errs)
    kernel_times(timed, "1025² (the slab multigrid's coarse grid)", card,
                 floor)
    del timed

    phase("3d z-slab kernels against their plain twins (256³, mz=32)")
    slab3 = checks.kernel_checks_slab3(256, 32, "cuda", SEED)
    compare([c for c in slab3 if "advect3_slab_exact" not in c.kernels],
            checks.TOL, errs)
    compare([c for c in slab3 if "advect3_slab_exact" in c.kernels], 0.0,
            errs, "bit for bit")
    del slab3
    compare(checks.per_sweep_checks(checks.kernel_checks_slab3(
        256, 32, "cuda", SEED)), 0.0, errs, "bit for bit")
    compare(checks.kernel_checks_slab3_flows(256, 32, "cuda", SEED), 0.0,
            errs, "bit for bit")
    timed3 = checks.timing_checks_slab3(256, 32, "cuda", SEED)
    timed_against_both(timed3, checks.TOL, errs)
    times.update(kernel_times(timed3, "256³, slab of 32 planes", card, floor))
    sweep3_forms(timed3, "jacobi3_slab", card, errs)
    del timed3
    advect3_group_checks(False, errs, times, card, floor)

    phase("3e the fused tail K17 and the split slab Jacobi B13")
    compare(checks.split_against_concat(2048, 256, "cuda", SEED), 0.0, errs,
            "against K9 on the concatenation")
    compare(checks.split_against_concat(8192, 2048, "cuda", SEED), 0.0, errs,
            "against K9 on the concatenation")
    compare(checks.split_against_k18(2048, 256, "cuda", SEED), 0.0, errs,
            "against K18 then K9")
    compare([c for c in checks.kernel_checks(2048, "cuda", SEED)
             if "advect_project" in c.kernels], 0.0, errs, "bit for bit")
    times.update(kernel_times(checks.timing_checks_tail(2048, "cuda", SEED),
                              "2048²", card, floor))
    kernel_times(checks.timing_checks_tail_batched(
        DATAGEN_BATCH, DATAGEN_N + 2, "cuda", SEED), "1024 × 256²", card,
        floor)
    times.update(kernel_times(checks.timing_checks_split(2048, 256, "cuda",
                                                         SEED),
                              "2048², slab of 256 rows", card, floor))
    kernel_times(checks.timing_checks_split(8192, 2048, "cuda", SEED),
                 "8192², slab of 2048 rows", card, floor)

    phase("3f K1-damp and K6's window against their plain versions")
    # K1-damp equals ops.multigrid._smooth bit for bit (--fmad=false);
    # 1e-6 is the bar.  Against the per-sweep damped K1 it is 0.
    for side, batch in ((2048, 0), (128, 0), (16, 0), (16, SOLVER_BATCH)):
        timed_against_both(checks.kernel_checks_damp(side, "cuda", SEED,
                                                     batch), 1e-6, errs)
    compare(checks.kernel_checks3_windowed(256, "cuda", SEED), checks.TOL,
            errs)
    times.update(kernel_times(checks.timing_checks_damp(2048, "cuda", SEED),
                              "2048²", card, floor))
    for side, batch in ((128, 0), (16, 0), (16, SOLVER_BATCH)):
        kernel_times(checks.kernel_checks_damp(side, "cuda", SEED, batch),
                     f"{batch} × {side}²" if batch else f"{side}²", card,
                     floor)
    times.update(kernel_times(checks.timing_checks3_windowed(256, "cuda",
                                                             SEED),
                              "256³", card))

    phase("4 golden fixtures through the cuda backend")
    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "*.npz")))
    if len(paths) != 6:
        raise AssertionError(f"expected 6 golden fixtures, found {len(paths)}")
    for path in paths:
        with np.load(path) as z:
            n, steps, iters = int(z["n"]), int(z["steps"]), int(z["iters"])
            cfg = SimConfig(n=n, jacobi_iters=iters, backend="cuda",
                            device="cuda")
            src = Sources(*(torch.from_numpy(np.array(z[k])).cuda()
                            for k in ("dens_src", "u_src", "v_src")))
            out = simulate(cfg, zero_state(cfg), src, steps)
            err = max(float(np.abs(t.cpu().numpy() - z[k]).max())
                      for t, k in zip(out[:3], ("dens", "u", "v")))
        print(f"  {os.path.basename(path)}: max|d| {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"{path}: max|d| {err:.3e} > 1e-5")

    phase("5 main path: 2048² parity, 20 iterations")
    parity = SimConfig(n=2046, jacobi_iters=20, backend="cuda", device="cuda")
    launches = main_path(parity, "2048² parity", card, 21,
                         tol=(1e-5, 2e-5, 1e-4))

    phase("6 main path: 2048² compensated perf mode")
    rho, k_d, k_p = perf_operating_point(2048)
    cheby = parity.replace(pressure_solver="chebyshev",
                           diffusion_solver="chebyshev", cheby_rho=rho,
                           cheby_iters=k_d, cheby_press_iters=k_p)
    label = f"2048² perf (rho={rho}, k_d={k_d}, k_p={k_p})"
    # The reference backend, like the JAX package's, ignores fast_math: it
    # is held to the parity tolerances without it, and the fast run (the
    # perf mode proper; its kernels match their plain fast forms in phase 3)
    # differs from it by the reciprocal form's roundings, which the
    # velocity self-advection amplifies by dt*n per cell of backtrace.
    main_path(cheby, label + " without fast_math", card, 21,
              tol=(1e-5, 2e-5, 1e-4))
    main_path(cheby.replace(fast_math=True), label + " fast_math", card, 21,
              tol=(0.0, 1e-4, 1e-4))

    phase("7 8192² parity, 40 iterations")
    big = SimConfig(n=8190, jacobi_iters=40, backend="cuda", device="cuda")
    main_path(big, "8192² parity", card, 3, tol=None)

    phase("8 3-D main path: 256³ parity, 20 iterations")
    parity3 = SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                        device="cuda")
    launches3 = main_path(parity3, "256³ parity", card, 21,
                          tol=(1e-5, 2e-5, 1e-4), forced_tol=1e-4)

    phase("9 3-D main path: 256³ compensated mode")
    rho, k_d, k_p = perf_operating_point(256, ndim=3)
    comp3 = parity3.replace(pressure_solver="chebyshev",
                            diffusion_solver="chebyshev", cheby_rho=rho,
                            cheby_iters=k_d, cheby_press_iters=k_p)
    label = f"256³ compensated (rho={rho}, k_d={k_d}, k_p={k_p})"
    # As in phase 6: parity tolerances without fast math, 1e-4 with it.
    main_path(comp3, label + " without fast_math", card, 21,
              tol=(1e-5, 2e-5, 1e-4), forced_tol=1e-4)
    main_path(comp3.replace(fast_math=True), label + " fast_math", card, 21,
              tol=(0.0, 1e-4, 1e-4), forced_tol=1e-4)

    phase("10 multi-device step: row slabs on one card")
    sharded_path(parity, 1, "2048² parity, 1×1 mesh", card, 6,
                 tol=(1e-5, 2e-5, 1e-4))
    launches_slab = sharded_path(parity, 8, "2048² parity, 8 slabs", card, 6,
                                 tol=(1e-5, 2e-5, 1e-4))
    launches_split = split_chunk(parity, 8, "2048² parity, 8 slabs, u "
                                 "diffusion chunk through B13", card)
    rho, k_d, k_p = perf_operating_point(2048)
    # As in phase 6: the reference backend ignores fast_math.
    sharded_path(cheby.replace(fast_math=True), 8,
                 f"2048² perf (rho={rho}, k_d={k_d}, k_p={k_p}) fast_math, "
                 f"8 slabs", card, 6, tol=(0.0, 1e-4, 1e-4))
    sharded_path(big, 4, "8192² parity 40 it, 4 slabs", card, 3,
                 tol=(1e-5, 2e-5, 1e-4))
    sharded_path(parity.replace(fuse_sweeps=8), 128,
                 "2048² parity fuse_sweeps=8, 128 slabs", card, 3,
                 tol=(1e-5, 2e-5, 1e-4), graph_reps=1)
    # The multigrid and CG projections on slabs (parallel/solvers.py).  The
    # slab multigrid is JAX's classic two-level cycle, the single-device
    # step the graded one: no single-device twin; slab CG is the
    # single-device CG step's algorithm.
    mg_slab = parity.replace(pressure_solver="multigrid", mg_cycles=2)
    label = "2048² multigrid, 2 cycles, Jacobi-20 diffusion"
    sharded_path(mg_slab, 1, label + ", 1×1 mesh", card, 6,
                 tol=(1e-5, 2e-5, 1e-4), single=False)
    launches_slab_mg = sharded_path(mg_slab, 8, label + ", 8 slabs", card,
                                    6, tol=(1e-5, 2e-5, 1e-4), single=False)
    # 16-row slabs take Jacobi chunks of at most 8 sweeps (as above); every
    # slab's smooth is one K9-damp launch.
    sharded_path(mg_slab.replace(fuse_sweeps=8), 128,
                 label + ", fuse_sweeps=8, 128 slabs", card, 3,
                 tol=(1e-5, 2e-5, 1e-4), graph_reps=1, single=False)
    projection_quality(mg_slab, label, bar=False, slabs=8)
    cg_slab = parity.replace(pressure_solver="cg", cg_iters=20)
    launches_slab_mg = {k: c + launches_slab_mg[k] for k, c in sharded_path(
        cg_slab, 8, "2048² CG-20, 8 slabs", card, 6,
        tol=(1e-5, 2e-5, 1e-4)).items()}
    projection_quality(cg_slab, "2048² CG-20", bar=False, slabs=8)
    # The exact all-gather advection (K12's exact form): past the window,
    # where the windowed step departs from the single-device step, equal
    # to it and to the reference backend bit for bit.
    launches_exact = sharded_path(parity, 8, "2048² parity, 8 slabs, exact",
                                  card, 6, tol=(0.0, 0.0, 0.0),
                                  advect_mode="exact")
    sharded_path(big, 4, "8192² parity 40 it, 4 slabs, exact", card, 3,
                 tol=(0.0, 0.0, 0.0), advect_mode="exact")

    phase("11 3-D multi-device step: z-slabs on one card")
    sharded_path(parity3, 1, "256³ parity, 1 slab", card, 3,
                 tol=(1e-5, 2e-5, 1e-4))
    launches_slab3 = sharded_path(parity3, 8, "256³ parity, 8 slabs", card,
                                  3, tol=(1e-5, 2e-5, 1e-4))
    rho, k_d, k_p = perf_operating_point(256, ndim=3)
    label = f"256³ compensated (rho={rho}, k_d={k_d}, k_p={k_p})"
    # As in phase 9: the reference backend ignores fast_math.
    launches_slab3 = {k: c + launches_slab3[k] for k, c in sharded_path(
        comp3.replace(fast_math=True), 8, label + " fast_math, 8 slabs",
        card, 3, tol=(0.0, 1e-4, 1e-4)).items()}
    sharded_path(comp3, 32, label + ", 32 slabs of 8 planes", card, 3,
                 tol=(1e-5, 2e-5, 1e-4), graph_reps=1)
    # The exact all-gather advection (K14's exact form), asked for on 8
    # slabs and taken by "auto" on 64 slabs of 4 planes, thinner than the
    # 5 planes the 4-cell window needs.
    launches_exact = {k: c + launches_exact[k] for k, c in sharded_path(
        parity3, 8, "256³ parity, 8 slabs, exact", card, 3,
        tol=(1e-5, 2e-5, 1e-4), advect_mode="exact").items()}
    thin = sharded_path(parity3, 64, "256³ parity, 64 slabs of 4 planes, "
                        "auto", card, 2, tol=(1e-5, 2e-5, 1e-4),
                        graph_reps=1)
    if not thin["advect3_group_exact"]:
        raise AssertionError("auto on 4-plane slabs did not take the exact "
                             "gather")

    phase("12 the windowed 2-D step: 2048², 4-cell window")
    windowed = parity.replace(advect_mode="windowed")
    main_path(windowed, "2048² windowed parity", card, 21,
              tol=(1e-5, 2e-5, 1e-4))
    tails = windowed_path(windowed, "2048² windowed parity", card)
    rho, k_d, k_p = perf_operating_point(2048)
    label = f"2048² windowed perf (rho={rho}, k_d={k_d}, k_p={k_p}) fast_math"
    perf_win = cheby.replace(advect_mode="windowed", fast_math=True)
    # As in phase 6: the reference backend ignores fast_math.
    main_path(perf_win, label, card, 21, tol=(0.0, 1e-4, 1e-4))
    tails = {k: c + tails[k]
             for k, c in windowed_path(perf_win, label, card).items()}

    phase("13 batched datagen: 1024 × 256², 20 iterations")
    datagen = SimConfig(n=DATAGEN_N, jacobi_iters=20, backend="cuda",
                        device="cuda")
    launches_dg = datagen_path(datagen, "1024 × 256² parity", card,
                               tol=(1e-5, 2e-5, 1e-4))
    # The compensated point dev/bench_r3u_datagen_perf.py:98-100 chose at
    # this size, with fast math, which the reference backend ignores (as
    # in phase 6).
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    comp = datagen.replace(pressure_solver="chebyshev",
                           diffusion_solver="chebyshev", cheby_rho=rho,
                           cheby_iters=k_d, cheby_press_iters=k_p,
                           fast_math=True)
    launches_dg = {k: c + launches_dg[k] for k, c in datagen_path(
        comp, f"1024 × 256² compensated (rho={rho}, k_d={k_d}, k_p={k_p}) "
        f"fast_math", card, tol=(0.0, 1e-4, 1e-4)).items()}

    phase("14 the multigrid 2-D step: 2048²")
    # Full float32 transfers: TF32 stays off, as PyTorch leaves it.
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("float32 matmuls are not in full precision")
    mg = parity.replace(pressure_solver="multigrid", mg_cycles=2)
    label = "2048² multigrid, 2 cycles, Jacobi-20 diffusion"
    launches_mg = main_path(mg, label, card, 6, tol=(1e-5, 2e-5, 1e-4))
    projection_quality(mg, label, bar=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state_mg = StableFluids2D(mg).step(*reference_init(gen, mg))
    transfer_split(profile_step(lambda: StableFluids2D(mg).step(state_mg),
                                label, card), label)
    smoother_routes(StableFluids2D(mg).step, state_mg, label, card)
    # The JAX bench's multigrid line (bench.py:140-143): one cycle with fast
    # math.  One cycle is held to the reference backend without fast math.
    # The reference backend ignores fast_math; the cuda OpSet's plain twins
    # take it and round as the kernels do (K1's fmaf), so the fast line is
    # held to them at the parity bar, and to the JAX bench's divergence bar.
    mg1 = mg.replace(mg_cycles=1)
    launches_mg = {k: c + launches_mg[k] for k, c in main_path(
        mg1, "2048² multigrid, 1 cycle", card, 6,
        tol=(1e-5, 2e-5, 1e-4)).items()}
    smoother_routes(StableFluids2D(mg1).step, state_mg,
                    "2048² multigrid, 1 cycle", card)
    mg1 = mg1.replace(fast_math=True)
    label = "2048² multigrid, 1 cycle, fast_math (the bench line)"
    plain_mg1 = functools.partial(step, mg1,
                                  ops=cuda_ops.make_opset(mg1, plain=True))
    launches_mg = {k: c + launches_mg[k] for k, c in main_path(
        mg1, label, card, 6, tol=(1e-5, 2e-5, 1e-4),
        oracle=("the cuda OpSet's plain twins", plain_mg1)).items()}
    fast_math_gap(mg1, label)
    projection_quality(mg1, label, bar=True)
    transfer_split(profile_step(lambda: StableFluids2D(mg1).step(state_mg),
                                label, card), label)

    phase("15 the CG 2-D step: 2048², 20 iterations")
    cg = parity.replace(pressure_solver="cg", cg_iters=20)
    label = "2048² CG-20"
    # main_path captures the step in a CUDA graph: no host sync inside.
    launches_cg = main_path(cg, label, card, 6, tol=(1e-5, 2e-5, 1e-4))
    projection_quality(cg, label, bar=False)

    phase("16 the windowed 3-D step: 256³, 4-cell window")
    win3 = parity3.replace(advect_mode="windowed")
    label = "256³ windowed parity"
    launches_w3 = main_path(win3, label, card, 6, tol=(1e-5, 2e-5, 1e-4),
                            forced_tol=1e-4)
    windowed3_path(win3, label, card, 6)
    rho, k_d, k_p = perf_operating_point(256, ndim=3)
    label = (f"256³ windowed compensated (rho={rho}, k_d={k_d}, k_p={k_p}) "
             f"fast_math")
    win3c = comp3.replace(advect_mode="windowed", fast_math=True)
    # As in phase 9: the reference backend ignores fast_math.
    launches_w3 = {k: c + launches_w3[k] for k, c in main_path(
        win3c, label, card, 6, tol=(0.0, 1e-4, 1e-4),
        forced_tol=1e-4).items()}
    windowed3_path(win3c, label, card, 6)

    phase("17 the command line on the card")
    launches_cli = cli_path(card)

    phase("18 bf16 storage on the 2-D step; multigrid and CG on a batch")
    compare(checks.kernel_checks_bf16(2048, "cuda", SEED), 0.0, errs,
            "bit for bit")
    k1_against_both(True, errs)
    compare(checks.kernel_checks_bf16(DATAGEN_N + 2, "cuda", SEED,
                                      batch=DATAGEN_BATCH), 0.0, errs,
            "bit for bit")
    for side, batch in ((2048, 0), (8192, 0),
                        (DATAGEN_N + 2, DATAGEN_BATCH)):
        bf16_forms(side, batch, errs)
    times.update(kernel_times(checks.timing_checks_bf16(2048, "cuda", SEED),
                              "2048²", card))
    big16 = checks.timing_checks_bf16(8192, "cuda", SEED)
    timed_against_both(big16, 0.0, errs)
    kernel_times(big16, "8192²", card)
    del big16
    kernel_times(checks.timing_checks_bf16(DATAGEN_N + 2, "cuda", SEED,
                                           batch=DATAGEN_BATCH),
                 f"{DATAGEN_BATCH} × {DATAGEN_N + 2}²", card)
    bf16_jax_point(card)
    launches_16 = bf16_path(parity, "bf16 2048² parity", card, 6)
    rho, k_d, k_p = perf_operating_point(2048)
    bf16_path(cheby.replace(fast_math=True),
              f"bf16 2048² compensated (rho={rho}, k_d={k_d}, k_p={k_p}) "
              f"fast_math", card, 6)
    bf16_path(big, "bf16 8192² parity, 40 iterations", card, 3)
    launches_16 = {k: c + launches_16[k] for k, c in bf16_datagen(
        datagen, f"bf16 {DATAGEN_BATCH} × 256² datagen parity",
        card).items()}
    launches_sb = solver_batch_path("multigrid", card)
    launches_sb = {k: c + launches_sb[k]
                   for k, c in solver_batch_path("cg", card).items()}
    # The multigrid and CG projections in bf16: K1-damp's bf16-rhs forms
    # (the finest level of a bf16 multigrid solve) against their plain
    # twins, bit for bit, and timed; the steps at 2048² and on the batch.
    compare(checks.kernel_checks_damp(2048, "cuda", SEED, bf16=True), 0.0,
            errs, "bit for bit")
    compare(checks.kernel_checks_damp(256, "cuda", SEED, SOLVER_BATCH,
                                      bf16=True), 0.0, errs, "bit for bit")
    times.update(kernel_times(checks.timing_checks_damp(2048, "cuda", SEED,
                                                        bf16=True),
                              "2048²", card))
    kernel_times(checks.timing_checks_damp(256, "cuda", SEED, SOLVER_BATCH,
                                           bf16=True),
                 f"{SOLVER_BATCH} × 256²", card)
    for c, label in ((mg, "2048² multigrid, 2 cycles"), (cg, "2048² CG-20")):
        launches_16 = {k: n + launches_16[k] for k, n in bf16_path(
            c, f"bf16 {label}", card, 6).items()}
        projection_quality(c, f"float32 {label}", bar=False)
        projection_quality(c.replace(dtype=torch.bfloat16), f"bf16 {label}",
                           bar=False)
        launches_sb = {k: n + launches_sb[k] for k, n in solver_batch_path(
            c.pressure_solver, card, torch.bfloat16).items()}

    phase("19 the block route: (px, py) blocks on one card")
    launches_blocks = block_phase(parity, cheby, big, card, errs, times)

    phase("20 bf16 on the block route: (px, py) blocks on one card")
    launches_b16 = bf16_block_phase(parity, cheby, big, card, errs, times)

    phase("21 bf16 storage on the 3-D step: 256³")
    launches_3d16 = bf16_3d_phase(parity3, comp3, card, errs, times)

    phase("22 bf16 on the 3-D z-slab step: 256³ on one card")
    launches_zs16 = bf16_zslab_phase(parity3, comp3, card, errs, times)

    main_launches = {k: launches[k] + launches3[k] + launches_slab[k]
                     + launches_slab_mg[k] + launches_exact[k]
                     + launches_slab3[k] + launches_dg[k] + launches_mg[k]
                     + launches_cg[k] + launches_w3[k] + launches_cli[k]
                     + launches_16[k] + launches_sb[k] + launches_blocks[k]
                     + launches_b16[k] + launches_3d16[k]
                     + launches_zs16[k]
                     for k in cuda_ops.KERNELS}
    main_launches["advect_project"] = tails["advect_project"]
    main_launches["jacobi_slab_sweeps_split"] = launches_split[
        "jacobi_slab_sweeps_split"]
    idle = [k for k, c in main_launches.items() if c == 0 and k not in OFF_PATH]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
        "replaces": KERNEL_SOURCES[name][1],
        "launches": main_launches[name], "max_abs_err": errs[name],
        "ms": times[name][0], "plain_ms": times[name][1],
        "bound_ms": times[name][2], "bound_by": times[name][3],
        # The gathers K3, K6, K12 and K14 have a library yardstick:
        # torch.nn.functional.grid_sample at the same departure points,
        # the gather only (library_gather_ms).  No single PyTorch call
        # computes the others' functions (a sweep with its border rule, a
        # sweep fused with a gather, a stencil with its ghost layer or a
        # slab's wall rows or planes).
        "library_ms": times[name][4],
    } for name in cuda_ops.KERNELS if name not in OFF_PATH]
    print()
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def block_phase(parity, cheby, big, card: str, errs: dict[str, float],
                times: dict) -> dict[str, int]:
    """Phase 19: the block forms against their plain twins on a corner, an
    edge, an interior and the far corner block of (2, 4) blocks at 2048²
    (bit for bit, fast forms within ``checks.TOL``) and timed; the block
    step at 2048² on (2, 4) blocks exact, windowed, compensated, multigrid
    and CG-20, at 8192² on (2, 2) exact; ``"auto"`` on 64 slabs of 4 rows
    of 256² (the block route, exact) and the slab route's deep-halo
    Chebyshev on 64 slabs of 8 rows of 512².  Returns the launches of the
    runs whose kernels the kernels line reads."""
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    blocks = checks.kernel_checks_block(2048, 1024, 512, "cuda", SEED)
    compare([c for c in blocks if "fast" not in c.label], 0.0, errs,
            "bit for bit")
    compare([c for c in blocks if "fast" in c.label], checks.TOL, errs)
    times.update(kernel_times(checks.timing_checks_block(2048, 2, 4, "cuda",
                                                         SEED),
                              "2048² on (2, 4) blocks", card))
    group_checks(False, errs, times, card)
    total: dict[str, int] = dict.fromkeys(cuda_ops.KERNELS, 0)

    def add(counts):
        for k, c in counts.items():
            total[k] += c

    mesh24 = (2, 4)
    add(block_path(parity, mesh24, "blocks 2048² parity, exact", card, 3,
                   "single"))
    add(block_path(parity, mesh24, "blocks 2048² parity, windowed", card, 3,
                   "slabs", advect_mode="windowed"))
    rho, k_d, k_p = cheby.cheby_rho, cheby.cheby_iters, cheby.press_cheby_iters
    # As in phase 10: the reference backend ignores fast_math.
    block_path(cheby.replace(fast_math=True), mesh24,
               f"blocks 2048² compensated (rho={rho}, k_d={k_d}, k_p={k_p}) "
               f"fast_math, exact", card, 3, "reference", tol=1e-4)
    mg = parity.replace(pressure_solver="multigrid", mg_cycles=2)
    block_path(mg, mesh24, "blocks 2048² multigrid, 2 cycles, exact", card,
               3, "reference")
    block_path(mg, mesh24, "blocks 2048² multigrid, 2 cycles, exact", card,
               3, "slabs", tol=None, timed=False)
    cg = parity.replace(pressure_solver="cg", cg_iters=20)
    block_path(cg, mesh24, "blocks 2048² CG-20, exact", card, 3,
               "reference")
    block_path(cg, mesh24, "blocks 2048² CG-20, exact", card, 3, "slabs",
               tol=None, timed=False)
    block_path(big, (2, 2), "blocks 8192² parity 40 it, exact", card, 2,
               "single")
    small = parity.replace(n=254)
    block_path(small, (64, 1), "256² parity, 64 slabs of 4 rows, auto", card,
               2, "single", advect_mode="auto", shard_backend="auto",
               timed=False)
    deep = cheby.replace(n=510, fast_math=True)
    block_path(deep, (64, 1), f"512² compensated (rho={rho}, k_d={k_d}, "
               f"k_p={k_p}) fast_math, 64 slabs of 8 rows", card, 2, "single",
               tol=None, advect_mode="auto", shard_backend="auto",
               timed=False)
    return total


def bf16_block_phase(parity, cheby, big, card: str, errs: dict[str, float],
                     times: dict) -> dict[str, int]:
    """Phase 20: the bf16 forms of the block kernels against their plain
    twins on a corner, an edge, an interior and the far corner block of
    (2, 4) blocks at 2048² (bit for bit, fast forms within ``checks.TOL``)
    and timed beside their float32 forms; the bf16 block step at 2048² on
    (2, 4) blocks exact, windowed, compensated, multigrid and CG-20, and
    ``"auto"`` at 8192² on (2, 2), exact (``bf16_block_path``).  Returns
    the launches of its runs."""
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    forms = checks.kernel_checks_block(2048, 1024, 512, "cuda", SEED,
                                       bf16=True)
    compare([c for c in forms if "fast" not in c.label], 0.0, errs,
            "bit for bit")
    compare([c for c in forms if "fast" in c.label], checks.TOL, errs)
    del forms
    times.update(kernel_times(checks.timing_checks_block(
        2048, 2, 4, "cuda", SEED, bf16=True), "2048² on (2, 4) blocks, bf16",
        card))
    group_checks(True, errs, times, card)
    total: dict[str, int] = dict.fromkeys(cuda_ops.KERNELS, 0)

    def add(counts):
        for k, c in counts.items():
            total[k] += c

    mesh24 = (2, 4)
    add(bf16_block_path(parity, mesh24, "bf16 blocks 2048² parity, exact",
                        card, 3))
    add(bf16_block_path(parity, mesh24, "bf16 blocks 2048² parity, windowed",
                        card, 3, advect_mode="windowed"))
    rho, k_d, k_p = cheby.cheby_rho, cheby.cheby_iters, cheby.press_cheby_iters
    add(bf16_block_path(cheby.replace(fast_math=True), mesh24,
                        f"bf16 blocks 2048² compensated (rho={rho}, "
                        f"k_d={k_d}, k_p={k_p}) fast_math, exact", card, 3))
    add(bf16_block_path(parity.replace(pressure_solver="multigrid",
                                       mg_cycles=2), mesh24,
                        "bf16 blocks 2048² multigrid, 2 cycles, exact", card,
                        3, quality=True))
    add(bf16_block_path(parity.replace(pressure_solver="cg", cg_iters=20),
                        mesh24, "bf16 blocks 2048² CG-20, exact", card, 3,
                        quality=True))
    add(bf16_block_path(big, (2, 2), "bf16 8192² parity 40 it, auto, exact",
                        card, 2, shard_backend="auto"))
    return total


def group_checks(bf16: bool, errs: dict[str, float], times: dict,
                 card: str) -> None:
    """The grouped K9-block (float32 or bf16) over the (2, 4) blocks of
    2048² and the (64, 1) blocks of 512² (the slab route's deep-halo
    Chebyshev) in every form: against the per-block K9-block on
    ``Blocks.ext``'s buffers bit for bit, against its plain twin bit for
    bit (the fast forms within ``checks.TOL``); then the path's 8-sweep
    chunk, the fast chained Chebyshev chunk and the damped smooth over
    2048² timed beside their bound, their plain twin and the route they
    replace (``Blocks.ext``, then 8 per-block launches).  Then the grouped
    K11-block and K12-block (``checks.kernel_checks_block_stencil_group``)
    over the (2, 4) blocks of 2048² and the (64, 1) blocks of 256² (the
    64 slabs of 4 rows ``"auto"`` sends to the block route) in every form,
    against the per-block kernels on ``Blocks.halos``', ``ext``'s or
    ``gather``'s buffers and their plain twins, bit for bit; and the
    gradient and the windowed and exact pair and density over 2048² timed
    beside their bound, plain twin, ``grid_sample`` (the gathers) and the
    route they replace (``halos``, ``ext`` or ``gather``, then 8 per-block
    launches)."""
    from fluidsimulationcuda_torch.kernels import checks

    for side, px, py in ((2048, 2, 4), (512, 64, 1)):
        group = checks.kernel_checks_block_group(side, px, py, "cuda", SEED,
                                                 bf16=bf16)
        def loose(c):
            return "fast" in c.label and "vs per-block" not in c.label

        compare([c for c in group if not loose(c)], 0.0, errs,
                "bit for bit")
        compare([c for c in group if loose(c)], checks.TOL, errs)
        del group
    times.update(kernel_times(checks.timing_checks_block_group(
        2048, 2, 4, "cuda", SEED, bf16=bf16),
        "2048² over (2, 4) blocks, grouped" + (", bf16" if bf16 else ""),
        card))
    for side, px, py in ((2048, 2, 4), (256, 64, 1)):
        compare(checks.kernel_checks_block_stencil_group(
            side, px, py, "cuda", SEED, bf16=bf16), 0.0, errs, "bit for bit")
    times.update(kernel_times(checks.timing_checks_block_stencil_group(
        2048, 2, 4, "cuda", SEED, bf16=bf16),
        "2048² over (2, 4) blocks, grouped stencils"
        + (", bf16" if bf16 else ""), card))


def advect3_group_checks(bf16: bool, errs: dict[str, float], times: dict,
                         card: str, floor: float | None = None) -> None:
    """The grouped K14 (float32 or bf16) over the 8 z-slabs of 32 planes
    and the 64 of 4 planes of 256³, windowed and exact, one field and the
    triple: against its plain twin and against the per-slab K14 on
    ``mesh._ext``'s or ``mesh._gather``'s buffers, bit for bit; then the
    path's triple, density and exact triple over the 8 slabs timed beside
    their bound, plain twin, ``grid_sample`` and the route they replace
    (``_ext`` or ``_gather``, then 8 per-slab launches)."""
    from fluidsimulationcuda_torch.kernels import checks

    for mz in (32, 4):
        compare(checks.kernel_checks_advect3_group(256, mz, "cuda", SEED,
                                                   bf16=bf16),
                0.0, errs, "bit for bit")
    times.update(kernel_times(checks.timing_checks_advect3_group(
        256, 32, "cuda", SEED, bf16=bf16),
        "256³ over 8 z-slabs, grouped" + (", bf16" if bf16 else ""), card,
        floor))


def bf16_block_path(cfg, shape: tuple[int, int], label: str, card: str,
                    steps: int, advect_mode: str = "exact",
                    shard_backend: str = "reference",
                    quality: bool = False) -> dict[str, int]:
    """Phase 20's run of ``cfg`` (float32, the ``cuda`` backend) in bf16 on
    a ``shape`` mesh of one card: an impulse step plus ``steps-1`` of
    ``make_sharded_step_fn(cfg in bf16, shard_backend=shard_backend,
    advect_mode=advect_mode)`` from the reference draw rounded to bf16,
    which must take the block route; its launches a step against
    ``expected_launches_blocks`` (the bf16 forms, the float32 block forms
    at 0); the state bf16 and held to ``bf16_bars`` (the plain twins' step
    bit for bit, the float32 block step from the same rounded draw, the
    ``reference`` backend's bf16 block step); eager and CUDA-graph ms/step
    of the bf16 and the float32 block steps.  With ``quality``, max|div|
    after the step's first projection in both storages.  Returns the bf16
    run's launch counts."""
    from fluidsimulationcuda_torch import (FluidState, Sources,
                                           reference_init, zero_sources)
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_blocks, unshard)
    from fluidsimulationcuda_torch.parallel.sharded import _BlockStep

    c16 = cfg.replace(dtype=torch.bfloat16)
    px, py = shape
    mesh = make_mesh([torch.device("cuda", 0)] * (px * py), shape=shape)
    step_fn = make_sharded_step_fn(c16, mesh, advect_mode=advect_mode,
                                   shard_backend=shard_backend)
    if step_fn.layout != "blocks":
        raise AssertionError(f"{label}: bf16 took the {step_fn.layout}")
    exact = step_fn.advect_mode == "exact"
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    draw16 = [FluidState(*(t.to(torch.bfloat16) for t in state0[:3])),
              Sources(*(t.to(torch.bfloat16) for t in sources[:3]))]
    draw32 = [type(t)(*(x.float() for x in t[:3])) for t in draw16]
    cut16 = [shard_blocks(t, mesh) for t in (*draw16, zero_sources(c16))]
    cut32 = [shard_blocks(t, mesh) for t in (*draw32, zero_sources(cfg))]
    side = cfg.n + 2
    print(f"{label}: blocks of {side // px} x {side // py} on mesh {shape}, "
          f"shard_backend {shard_backend!r} took "
          f"{step_fn.shard_backend!r}, advect_mode {step_fn.advect_mode!r}")

    def run(fn, start, src, zeros):
        state = start
        for k in range(steps):
            state = fn(state, src if k == 0 else zeros)
        return state

    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    last = run(step_fn, *cut16)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    per_step = expected_launches_blocks(c16, px, py, exact)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches a step {sum(per_step.values())} "
          f"({ {k: c for k, c in per_step.items() if c} }, computed from the "
          f"code); counted over {steps} steps {counts == want}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    got = unshard(last, mesh)
    if any(f.dtype != torch.bfloat16 for f in got[:3]):
        raise AssertionError(f"{label}: the state left bf16")
    twins = unshard(run(_BlockStep(c16, mesh, False, exact, plain=True),
                        *cut16), mesh)
    ref16 = unshard(run(make_sharded_step_fn(
        c16.replace(backend="reference"), mesh, advect_mode=advect_mode,
        shard_backend=shard_backend), *cut16), mesh)
    step32 = make_sharded_step_fn(cfg, mesh, advect_mode=step_fn.advect_mode,
                                  shard_backend="reference")
    last32 = run(step32, *cut32)
    bf16_bars(got, twins, ref16, unshard(last32, mesh),
              f"{label}, step {steps}")
    ms = {}
    for name, fn, state, zeros in (("bf16", step_fn, last, cut16[2]),
                                   ("float32", step32, last32, cut32[2])):
        state, eager = timed_steps(lambda s: fn(s, zeros), state, 2)
        graph = checks.device_ms(lambda: fn(state, zeros), reps=2)
        ms[name] = (eager, graph)
    print(f"{label}: ms/step eager / as a CUDA graph: bf16 "
          f"{ms['bf16'][0]:.4f} / {ms['bf16'][1]:.4f}, float32 block step "
          f"{ms['float32'][0]:.4f} / {ms['float32'][1]:.4f} (bf16/float32 "
          f"device {ms['bf16'][1] / ms['float32'][1]:.3f}) ({card})")
    if quality:
        divs = [block_projection_div(c, mesh, draw) for c, draw in
                ((c16, draw16), (cfg, draw32),
                 (c16.replace(backend="reference"), draw16))]
        print(f"{label}: max|div| of the diffused impulse velocity "
              f"{divs[1][0]:.4e}; after the first projection bf16 "
              f"{divs[0][1]:.4e}, float32 {divs[1][1]:.4e} "
              f"({divs[0][1] / divs[1][1]:.3f}x), the reference backend's "
              f"bf16 block step {divs[2][1]:.4e} ("
              f"{divs[0][1] / divs[2][1]:.3f}x; the card's gap to float32 "
              f"{'larger' if divs[0][1] > divs[2][1] else 'no larger'} than "
              f"the reference's)")
    return counts


def bf16_3d_phase(parity3, comp3, card: str, errs: dict[str, float],
                  times: dict) -> dict[str, int]:
    """Phase 21: the bf16 forms of K5 (per-sweep and tiled), K6 (exact and
    windowed, the triple and one field), K7 and K8 against their plain
    twins at 256³, bit for bit, every call in the tiled K5's mode also on
    the tiled K5 against the same call on the per-sweep K5; each form
    timed beside its bound in 2-byte storage, its float32 form, its plain
    twin and, for K6, ``grid_sample`` on bf16, the per-sweep K5's also in
    its one-cell form (``sweep3_forms``); then the bf16 3-D step at 256³
    (``bf16_3d_path``): parity (20 iterations), compensated with fast math
    and windowed parity (4 cells).  Returns the launches of its runs."""
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    forms = checks.kernel_checks3_bf16(256, "cuda", SEED)
    compare(forms, 0.0, errs, "bit for bit")
    compare(checks.per_sweep_checks(forms), 0.0, errs, "bit for bit")
    del forms
    # K6's bf16 form, on the gather body, against the grouped K14's bf16
    # form over one slab of the volume and the one-cell K14's on the
    # volume, the arithmetic of the kernel the body replaced.
    compare(checks.kernel_checks_k6_body(256, "cuda", SEED, bf16=True), 0.0,
            errs, "bit for bit")
    timed = checks.timing_checks3_bf16(256, "cuda", SEED)
    timed_against_both(timed, 0.0, errs)
    times.update(kernel_times(timed, "256³, bf16", card))
    sweep3_forms(timed, "jacobi3_sweep_bf16", card, errs)
    del timed
    total: dict[str, int] = dict.fromkeys(cuda_ops.KERNELS, 0)
    rho, k_d, k_p = comp3.cheby_rho, comp3.cheby_iters, comp3.press_cheby_iters
    for cfg, label in (
            (parity3, "bf16 256³ parity"),
            (comp3.replace(fast_math=True),
             f"bf16 256³ compensated (rho={rho}, k_d={k_d}, k_p={k_p}) "
             f"fast_math"),
            (parity3.replace(advect_mode="windowed"),
             "bf16 256³ windowed parity")):
        for k, c in bf16_3d_path(cfg, label, card, 3).items():
            total[k] += c
    return total


def bf16_3d_path(cfg, label: str, card: str, steps: int) -> dict[str, int]:
    """Phase 21's run of ``cfg`` (float32, the ``cuda`` backend) in bf16
    through ``StableFluids3D``: an impulse step plus ``steps-1`` from the
    reference draw rounded to bf16; its launches against
    ``expected_launches3`` (the bf16 forms wherever a bf16 operand enters,
    the float32 K5 for the pressure solves and no other float32 form); the
    state bf16 and held to ``bf16_bars`` (the plain twins' step,
    ``_Ops3(cfg, plain=True)``, bit for bit; the float32 step from the same
    rounded draw; the ``reference`` backend's bf16 step); max|div| after
    the first projection in both storages; eager and CUDA-graph ms/step of
    both.  Returns the bf16 run's launch counts."""
    from fluidsimulationcuda_torch import (FluidState, Sources,
                                           StableFluids3D, reference_init,
                                           step3)
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.models.stable_fluids_3d import _Ops3

    c16 = cfg.replace(dtype=torch.bfloat16)
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state, src = reference_init(gen, cfg)
    draw16 = (FluidState(*(t.to(torch.bfloat16) for t in state)),
              Sources(*(t.to(torch.bfloat16) for t in src)))
    draw32 = tuple(type(t)(*(x.float() for x in t)) for t in draw16)

    def run(c, st, sr, ops=None):
        zeros = Sources(*(torch.zeros_like(t) for t in sr))
        for k in range(steps):
            st = step3(c, st, sr if k == 0 else zeros, ops)
        return st

    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    cuda_ops.reset_width_counts()
    got = run(c16, *draw16)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    widths = cuda_ops.width_counts()["jacobi3_sweep_bf16"]
    per_step = expected_launches3(c16)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches {({k: c for k, c in counts.items() if c})} "
          f"(expected {({k: c for k, c in want.items() if c})}); "
          f"jacobi3_sweep_bf16 by width {widths}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    require_walk(counts, label)
    if any(f.dtype != torch.bfloat16 for f in got):
        raise AssertionError(f"{label}: the state left bf16")
    twins = run(c16, *draw16, _Ops3(c16, plain=True))
    ref16 = run(c16.replace(backend="reference"), *draw16)
    ref32 = run(cfg, *draw32)
    bf16_bars(got, twins, ref16, ref32, f"{label}, step {steps}")
    divs = [projection_div3(c, draw) for c, draw in ((c16, draw16),
                                                      (cfg, draw32))]
    print(f"{label}: max|div| of the diffused impulse velocity "
          f"{divs[1][0]:.4e}; after the first projection bf16 "
          f"{divs[0][1]:.4e}, float32 {divs[1][1]:.4e} "
          f"({divs[0][1] / divs[1][1]:.3f}x)")
    ms = {}
    for name, c, st in (("bf16", c16, got), ("float32", cfg, ref32)):
        sim = StableFluids3D(c)
        st, eager = timed_steps(sim.step, st, 3)
        graph = checks.device_ms(lambda: sim.step(st), reps=3)
        ms[name] = (eager, graph)
    print(f"{label}: ms/step eager / as a CUDA graph: bf16 "
          f"{ms['bf16'][0]:.4f} / {ms['bf16'][1]:.4f}, float32 "
          f"{ms['float32'][0]:.4f} / {ms['float32'][1]:.4f} (bf16/float32 "
          f"device {ms['bf16'][1] / ms['float32'][1]:.3f}) ({card})")
    return counts


def sweep3_forms(check_list, kernel: str, card: str,
                 errs: dict[str, float]) -> None:
    """Phases 3b, 3d, 21 and 22: each timing check whose solves take the
    per-sweep K5 or K13 (``kernel``: float32 or bf16) in both of its
    forms, the vector walk the path takes (``cuda_ops.VECTOR_WIDTHS``,
    ``csrc/jacobi3_walk.cuh``) and the one-cell form
    (``vector_widths((1,))``): each held to the plain twin bit for bit, its
    launches by width (every one in its form's width), and the two timed
    in turns, a bf16 form's beside its float32 form on the same values
    (device ms, CUDA graphs of 20 calls)."""
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    width = cuda_ops.VECTOR_WIDTHS[kernel][0]
    forms = {f"V={width}": None, "one-cell": (1,)}

    def run(c, widths):
        with (contextlib.nullcontext() if widths is None
              else cuda_ops.vector_widths(widths)):
            return c.run()

    for c in [c for c in check_list if c.kernels == (kernel,)]:
        want = c.plain()
        counts = {}
        for name, widths in forms.items():
            cuda_ops.reset_width_counts()
            got = run(c, widths)
            torch.cuda.synchronize()
            counts[name] = cuda_ops.width_counts()[kernel]
            err = checks.max_abs_diff(got, want)
            form_width = 1 if widths else width
            if err != 0.0 or counts[name][form_width] != sum(
                    counts[name].values()):
                raise AssertionError(f"{c.label} {name}: max|d| {err}, "
                                     f"launches by width {counts[name]}")
            errs[kernel] = max(errs[kernel], err)
        ms = dict.fromkeys(forms, 0.0)
        for name in [*forms, *reversed(forms)]:
            ms[name] += checks.device_ms(lambda: run(c, forms[name])) / 2
        vec, one = ms[f"V={width}"], ms["one-cell"]
        line = (f"  {c.label}: V={width} {vec:.5f} ms, one-cell {one:.5f} "
                f"({one / vec:.2f}x)")
        if c.counterpart is not None:
            f32 = checks.device_ms(c.counterpart)
            line += (f", float32 form {f32:.5f} (bf16 V={width} "
                     f"{vec / f32:.3f}x it)")
        print(f"{line}; each bit for bit with the plain twin; launches by "
              f"width {counts} ({card})")


def bf16_zslab_phase(parity3, comp3, card: str, errs: dict[str, float],
                     times: dict) -> dict[str, int]:
    """Phase 22: the bf16 forms of K13 (per-sweep and the tiled slab walk),
    K14 (windowed and exact), K15 and K16 against their plain twins on
    top, interior and bottom slabs of 32 planes of 256³, bit for bit,
    every call in the tiled kernel's mode also on it against the same
    call on the per-sweep K13's
    bf16 form; each form timed beside its bound in 2-byte storage, its
    float32 form, its plain twin and, for K14, ``grid_sample`` on bf16,
    the per-sweep K13's also in its one-cell form (``sweep3_forms``);
    then the bf16 z-slab step at 256³ (``bf16_zslab_path``) on 8 slabs:
    parity windowed (``"auto"``), parity exact, compensated with fast
    math; and compensated with fast math on 32 slabs of 8 planes, whose
    solves all chain across exchanges.  Returns the launches of its
    runs."""
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    forms = checks.kernel_checks_slab3_bf16(256, 32, "cuda", SEED)
    compare(forms, 0.0, errs, "bit for bit")
    compare(checks.per_sweep_checks(forms), 0.0, errs, "bit for bit")
    del forms
    timed = checks.timing_checks_slab3_bf16(256, 32, "cuda", SEED)
    timed_against_both(timed, 0.0, errs)
    times.update(kernel_times(timed, "256³, slab of 32 planes, bf16", card))
    sweep3_forms(timed, "jacobi3_slab_bf16", card, errs)
    del timed
    advect3_group_checks(True, errs, times, card)
    total: dict[str, int] = dict.fromkeys(cuda_ops.KERNELS, 0)
    rho, k_d, k_p = comp3.cheby_rho, comp3.cheby_iters, comp3.press_cheby_iters
    comp = comp3.replace(fast_math=True)
    label = (f"bf16 256³ compensated (rho={rho}, k_d={k_d}, k_p={k_p}) "
             f"fast_math")
    for cfg, slabs, label, advect_mode in (
            (parity3, 8, "bf16 256³ parity", "auto"),
            (parity3, 8, "bf16 256³ parity", "exact"),
            (comp, 8, label, "auto"), (comp, 32, label, "auto")):
        for k, c in bf16_zslab_path(cfg, slabs, f"{label}, {slabs} z-slabs",
                                    card, 2, advect_mode).items():
            total[k] += c
    return total


def bf16_zslab_path(cfg, slabs: int, label: str, card: str, steps: int,
                    advect_mode: str) -> dict[str, int]:
    """Phase 22's run of ``cfg`` (float32, the ``cuda`` backend) in bf16 on
    ``slabs`` z-slabs of one card: an impulse step plus ``steps-1`` of
    ``make_sharded_step_fn_3d(cfg in bf16, advect_mode=advect_mode,
    audited=True)`` from the reference draw rounded to bf16; its launches
    against ``expected_launches_sharded3`` (the bf16 forms wherever a bf16
    operand enters, the float32 K13 for the pressure solves and no other
    float32 form); the state bf16 and held to ``bf16_bars`` (the plain
    twins' z-slab step, ``_ZSlabStep(..., plain=True)``, bit for bit; the
    float32 z-slab step from the same rounded draw; the ``reference``
    backend's bf16 z-slab step, JAX's jnp route); an exact run also to the
    single-device bf16 ``cuda`` step bit for bit; eager and CUDA-graph
    ms/step beside the float32 z-slab step.  Returns the bf16 run's
    launch counts."""
    from fluidsimulationcuda_torch import (FluidState, Sources, reference_init,
                                           step3)
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn_3d,
                                                    shard_state_3d, unshard)
    from fluidsimulationcuda_torch.parallel.sharded3d import _ZSlabStep

    c16 = cfg.replace(dtype=torch.bfloat16)
    mesh = make_mesh([torch.device("cuda", 0)] * slabs)
    step_fn = make_sharded_step_fn_3d(c16, mesh, advect_mode=advect_mode,
                                      audited=True)
    exact = step_fn.advect_mode == "exact"
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    draw16 = (FluidState(*(t.to(torch.bfloat16) for t in state0)),
              Sources(*(t.to(torch.bfloat16) for t in sources)))
    draw32 = tuple(type(t)(*(x.float() for x in t)) for t in draw16)
    zeros16, zeros32 = (Sources(*(torch.zeros_like(x) for x in d[1]))
                        for d in (draw16, draw32))
    cut16 = [shard_state_3d(t, mesh) for t in (*draw16, zeros16)]
    cut32 = [shard_state_3d(t, mesh) for t in (*draw32, zeros32)]
    print(f"{label}: slabs of {(cfg.n + 2) // slabs} planes, (K, H) per "
          f"solve {step_fn.chunks}, advect_mode {advect_mode!r} took "
          f"{step_fn.advect_mode!r}")

    def run(fn, start, src, zeros, audited=False):
        state, disps = start, []
        for k in range(steps):
            state = fn(state, src if k == 0 else zeros)
            if audited:
                state, disp = state
                disps.append(float(disp))
        return state, disps

    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    cuda_ops.reset_width_counts()
    last, disps = run(step_fn, *cut16, audited=True)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    widths = cuda_ops.width_counts()["jacobi3_slab_bf16"]
    per_step = expected_launches_sharded3(c16, slabs, exact)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    float32_forms = {k for k, c in counts.items()
                     if c and not k.endswith("_bf16")}
    print(f"{label}: launches {({k: c for k, c in counts.items() if c})} "
          f"(expected {({k: c for k, c in want.items() if c})}); "
          f"jacobi3_slab_bf16 by width {widths}; float32 "
          f"forms {sorted(float32_forms)} (the pressure solves'); audited "
          f"displacement {max(disps):.4f} cells (window {cfg.max_courant})")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    require_walk(counts, label)
    if not float32_forms <= {"jacobi3_slab", "jacobi3_slab_sweeps"}:
        raise AssertionError(f"{label}: float32 forms {float32_forms}")
    got = unshard(last)
    if any(f.dtype != torch.bfloat16 for f in got):
        raise AssertionError(f"{label}: the state left bf16")
    twins, _ = run(_ZSlabStep(c16, mesh.reshape(slabs, 1), False, exact,
                              plain=True), *cut16)
    ref16, _ = run(make_sharded_step_fn_3d(
        c16.replace(backend="reference"), mesh, advect_mode=advect_mode),
        *cut16)
    step32 = make_sharded_step_fn_3d(cfg, mesh, advect_mode=advect_mode)
    last32, _ = run(step32, *cut32)
    bf16_bars(got, unshard(twins), unshard(ref16), unshard(last32),
              f"{label}, step {steps}")
    if exact:
        single = draw16[0]
        for k in range(steps):
            single = step3(c16, single, draw16[1] if k == 0 else zeros16)
        d = max_diff(got, single)
        print(f"{label}: max|d| to the single-device bf16 cuda step {d:.3e}")
        if d != 0.0:
            raise AssertionError(f"{label}: differs from the single-device "
                                 f"bf16 step")
    ms = {}
    for name, c, state, zeros in (("bf16", c16, last, cut16[2]),
                                  ("float32", cfg, last32, cut32[2])):
        plain = make_sharded_step_fn_3d(c, mesh, advect_mode=advect_mode)
        state, eager = timed_steps(lambda s: plain(s, zeros), state, 2)
        graph = checks.device_ms(lambda: plain(state, zeros),
                                 reps=1 if slabs > 8 else 2)
        ms[name] = (eager, graph)
    print(f"{label}: ms/step eager / as a CUDA graph: bf16 "
          f"{ms['bf16'][0]:.4f} / {ms['bf16'][1]:.4f}, float32 z-slab step "
          f"{ms['float32'][0]:.4f} / {ms['float32'][1]:.4f} (bf16/float32 "
          f"device {ms['bf16'][1] / ms['float32'][1]:.3f}) ({card})")
    per_slab_route(c16, mesh, exact, cut16, last, label, card,
                   1 if slabs > 8 else 2)
    return counts


def projection_div3(cfg, draw) -> tuple[float, float]:
    """max|div| (float32 stencil) of the 3-D step's diffused impulse
    velocity before and after its first projection, on ``cfg``'s backend
    from ``draw`` (state, sources)."""
    from fluidsimulationcuda_torch.models.stable_fluids_3d import (
        _diffuse_velocity, _Ops3)
    from fluidsimulationcuda_torch.ops.three_d import divergence3

    def div(u, v, w):
        return float(divergence3(u.float(), v.float(), w.float(),
                                 cfg.n)[1:-1, 1:-1, 1:-1].abs().max())

    state, src = draw
    ops = _Ops3(cfg)
    vel = _diffuse_velocity(cfg, ops, state.u, state.v, state.w, src.u,
                            src.v, src.w)
    return div(*vel), div(*ops.project(*vel))


def block_projection_div(cfg, mesh, draw) -> tuple[float, float]:
    """max|div| (float32 stencil) of the block step's diffused impulse
    velocity before and after its first projection, on the blocks of
    ``mesh`` from ``draw`` (state, sources)."""
    from fluidsimulationcuda_torch.ops.source import add_source
    from fluidsimulationcuda_torch.parallel import shard_blocks
    from fluidsimulationcuda_torch.parallel.sharded import _BlockStep

    run = _BlockStep(cfg, mesh, False, True)
    state, src = (shard_blocks(t, mesh) for t in draw)
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    u, v = ([add_source(a, s, cfg.dt) for a, s in zip(f, g)]
            for f, g in ((state.u, src.u), (state.v, src.v)))
    u = run._diffusion(1, src.u, u, alpha, beta)
    v = run._diffusion(2, src.v, v, alpha, beta)
    stitch = run.blocks.stitch
    before = max_div(stitch(u).float(), stitch(v).float(), cfg.n)
    u, v = run._project(u, v)
    return before, max_div(stitch(u).float(), stitch(v).float(), cfg.n)


def k1_against_both(bf16: bool, errs: dict[str, float]) -> None:
    """Every call with a K1 solve in it (``checks.k1_checks``; float32 or
    bf16 storage) at 2048² and on the datagen batch, against its plain
    version and against the same call on the per-sweep K1: bit for bit.
    At 8192² phase 18 holds the calls it times
    (``timed_against_both``), in both storage types."""
    from fluidsimulationcuda_torch.kernels import checks

    for side, batch in ((2048, 0), (DATAGEN_N + 2, DATAGEN_BATCH)):
        for chain in (False, True):
            compare(checks.k1_checks(side, "cuda", SEED, batch, bf16, chain),
                    0.0, errs, "bit for bit")


def slab_against_both(check_list, errs: dict[str, float]) -> None:
    """The row-slab checks whose call takes the tiled K9 against their
    plain twins (bit for bit; in fast mode ``max|Δ| <= checks.TOL``, the
    plain twin multiplying and adding where the kernels call ``fmaf``, as
    the per-sweep K9 differs from it too) and against the same call on the
    per-sweep K9, bit for bit."""
    from fluidsimulationcuda_torch.kernels import checks

    tiled = [c for c in check_list if "jacobi_slab_sweeps" in c.kernels]
    compare([c for c in tiled if "fast" not in c.label], 0.0, errs,
            "bit for bit")
    compare([c for c in tiled if "fast" in c.label], checks.TOL, errs)
    compare(checks.slab_per_sweep_checks(tiled), 0.0, errs, "bit for bit")


def timed_against_both(check_list, tol: float,
                       errs: dict[str, float]) -> None:
    """The timing checks whose call has a tiled solve in it (those carrying
    the same call on the per-sweep kernels, ``chain``), on the inputs they
    are timed on, against their plain version (``max|Δ| <= tol``: 0 for
    K1 and the 3-D kernel's bf16 forms, ``checks.TOL`` for its float32
    forms, whose plain fast form takes ``fmaf``'s product and sum in
    float64 and may round a halfway case twice) and against that chain,
    bit for bit."""
    timed = [c for c in check_list if c.chain is not None]
    compare(timed, tol, errs, "bit for bit" if tol == 0.0 else "")
    compare([dataclasses.replace(c, label=f"{c.label} vs per-sweep",
                                 plain=c.chain) for c in timed],
            0.0, errs, "bit for bit")


def compare(check_list, tol: float, errs: dict[str, float],
            against: str = "") -> None:
    """Run each check's kernel and plain version (or what ``against``
    names) on the same inputs and hold them to ``max|d| <= tol``; record
    the worst per kernel."""
    from fluidsimulationcuda_torch.kernels import checks

    for c in check_list:
        got, want = c.run(), c.plain()
        torch.cuda.synchronize()
        err = checks.max_abs_diff(got, want)
        share = (f"  blocks staged {100 * checks.staged_share(c):.1f}%"
                 if c.boxes is not None else "")
        print(f"  {c.label:45s} max|d| {err:.3e} {against}{share}"
              f"{tail_form(c)}")
        if not err <= tol:
            raise AssertionError(f"{c.label}: max|d| {err:.3e} > {tol}")
        for k in c.kernels:
            errs[k] = max(errs[k], err)


def tail_form(check) -> str:
    """For a check of K17, the form its launch takes ("  form resident"),
    from the form counters around one more run; "" for other checks."""
    from fluidsimulationcuda_torch.kernels import cuda_step

    if "advect_project" not in check.kernels:
        return ""
    cuda_step.reset_form_counts()
    check.run()
    return "  form " + "/".join(k for k, n in
                                cuda_step.form_counts().items() if n)


def launch_floor_ms() -> float:
    """Device ms of one launch of a one-element kernel in a CUDA graph: the
    least a kernel launch takes on the card, whatever its work."""
    from fluidsimulationcuda_torch.kernels import checks

    one = torch.zeros(1, device="cuda")
    return checks.device_ms(lambda: one.add_(1.0))


def library_gather_ms(gather) -> float:
    """Device ms of ``torch.nn.functional.grid_sample`` (bilinear, or
    trilinear on a volume; ``align_corners=True``, ``padding_mode=
    "border"``) gathering the fields of ``gather()`` at its departure
    coordinates, in a CUDA graph as ``checks.device_ms`` times a kernel:
    the gather only, the coordinates computed and scaled to [-1, 1] before
    the timing.  It is the gathers' library yardstick and nothing of the
    port calls it; main() turns cuDNN's TF32 off beside it."""
    from fluidsimulationcuda_torch.kernels import checks

    fields, coords = gather()
    ndim = len(coords)
    inp = torch.stack(fields, dim=-ndim - 1)  # (batch, fields, grid)
    sizes = fields[0].shape[-ndim:]
    # grid_sample takes its grid in the fields' dtype (bf16 for K3's bf16
    # form: the same work, coarser coordinates).
    grid = torch.stack([2.0 * c / (size - 1) - 1.0
                        for c, size in zip(coords, reversed(sizes))],
                       dim=-1).to(inp.dtype)
    if inp.dim() == ndim + 1:
        inp, grid = inp[None], grid[None]
    return checks.device_ms(lambda: torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="border",
        align_corners=True))


def kernel_times(check_list, size: str, card: str, floor: float | None = None
                 ) -> dict[str, tuple[float, float, float, str,
                                      float | None]]:
    """Device ms of each timing check, kernel beside plain: CUDA graphs of
    20 calls, timed in turns plain, kernel, kernel (plain, kernel,
    composed, chain, chain, composed, kernel where the check carries the
    composition a fused kernel replaces or the same call on the per-sweep
    K1); the plain version, which repeats the kernel's arithmetic in many
    PyTorch operations and is no yardstick of speed, once in a graph of
    ``PLAIN_REPS`` calls; with the bound (the least time for the bytes the call
    must move, its inputs read once and its outputs written once, and its
    operations, over the HBM and float32 peaks), a gather's library
    yardstick (``library_gather_ms``), the share of K4's or K6's blocks
    that stage their footprint box and, given the launch ``floor``, the
    call's launches times that floor."""
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    times = {}
    print(f"  device ms per call at {size} (CUDA graph of 20 calls, the "
          f"plain version's of {PLAIN_REPS}; {card}):")
    for c in check_list:
        plain = checks.device_ms(c.plain, reps=PLAIN_REPS)
        k1 = checks.device_ms(c.run)
        if c.composed is not None:
            c1 = checks.device_ms(c.composed)
        if c.chain is not None:
            s1 = checks.device_ms(c.chain)
            s2 = checks.device_ms(c.chain)
        if c.composed is not None:
            c2 = checks.device_ms(c.composed)
        k2 = checks.device_ms(c.run)
        bound, bound_by = c.bound()
        kernel = (k1 + k2) / 2
        library = (library_gather_ms(c.gather) if c.gather is not None
                   else None)
        times[c.label] = (kernel, plain, bound, bound_by, library)
        line = (f"  {c.label:45s} kernel {kernel:.5f} ms  plain {plain:.5f} "
                f"ms  bound {bound:.5f} ms ({bound_by}; "
                f"{100 * bound / kernel:.1f}% of it)")
        if c.composed is not None:
            line += f"  composition it replaces {(c1 + c2) / 2:.5f} ms"
        if c.chain is not None:
            chain = (s1 + s2) / 2
            line += (f"  per-sweep chain {chain:.5f} ms ({chain / kernel:.2f}x "
                     f"the tiled kernel's)")
        if library is not None:
            line += f"  grid_sample (gather only) {library:.5f} ms"
        if c.counterpart is not None:
            line += (f"  {c.counterpart_label} "
                     f"{checks.device_ms(c.counterpart):.5f} ms")
        if c.boxes is not None:
            line += (f"  blocks staged "
                     f"{100 * checks.staged_share(c):.1f}%")
        line += tail_form(c)
        if floor is not None:
            cuda_ops.reset_launch_counts()
            c.run()
            launches = sum(cuda_ops.launch_counts().values())
            line += (f"  launch floor {launches} x {1e3 * floor:.3f} µs = "
                     f"{launches * floor:.5f} ms "
                     f"({100 * launches * floor / kernel:.1f}% of it)")
        print(line)
    return times


if __name__ == "__main__":
    main()
