"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when
no CUDA device is present (decided when the test runs, never at import).
On a machine with one H100:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest
"""
import contextlib
import ctypes
import glob
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks, cuda_ops, cuda_ops_3d  # noqa: E402

pytestmark = pytest.mark.gpu

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden",
                                       "*.npz")))
PERF = dict(pressure_solver="chebyshev", diffusion_solver="chebyshev",
            cheby_rho=0.9, cheby_iters=10, cheby_press_iters=14)
COMP3 = dict(pressure_solver="chebyshev", diffusion_solver="chebyshev",
             cheby_rho=0.85, cheby_iters=10, cheby_press_iters=12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("side", [34, 130, 2048])
def test_kernels_match_plain(cuda, side):
    for check in checks.kernel_checks(side, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert all(counts[k] > 0 for k in check.kernels), (check.label, counts)
        err = checks.max_abs_diff(got, want)
        assert err <= checks.TOL, (check.label, err)


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p) for p in GOLDEN])
def test_golden_cuda_backend(cuda, path):
    with np.load(path) as z:
        n, steps, iters = int(z["n"]), int(z["steps"]), int(z["iters"])
        cfg = ft.SimConfig(n=n, jacobi_iters=iters, backend="cuda", device=cuda)
        src = ft.Sources(*(torch.from_numpy(np.array(z[k])).to(cuda)
                           for k in ("dens_src", "u_src", "v_src")))
        got = ft.simulate(cfg, ft.zero_state(cfg), src, steps)
        for name in ("dens", "u", "v"):
            np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                       z[name], atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["parity", "perf"])
def test_step_launches_and_matches_reference(cuda, mode):
    kw = PERF if mode == "perf" else {}
    cfg = ft.SimConfig(n=254, jacobi_iters=20, backend="cuda", device=cuda, **kw)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.step(cfg, state, src)
    torch.cuda.synchronize()
    k_vel = cfg.cheby_iters if mode == "perf" else cfg.jacobi_iters
    k_p = cfg.press_cheby_iters if mode == "perf" else cfg.jacobi_iters
    t = cuda_ops.SWEEPS_PER_LAUNCH

    def launches(k):
        return -(-k // t)

    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        "jacobi_sweeps": 2 * launches(k_vel) + 2 * launches(k_p)
        + launches(k_vel - 1), "divergence": 2, "gradient": 2, "advect": 1,
        "dens_advect": 1}
    want = ft.step(cfg.replace(backend="reference"), state, src)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5)


def test_cuda_tensor_launches_or_raises(cuda):
    x = torch.zeros(34, 34, device=cuda)
    cuda_ops.reset_launch_counts()
    cuda_ops.fused_jacobi(0, x, x, 1.0, 4.0, 3)
    assert cuda_ops.launch_counts()["jacobi_sweeps"] == 1
    with pytest.raises(ValueError):
        cuda_ops.fused_jacobi(0, x, x.cpu(), 1.0, 4.0, 3)


@pytest.mark.parametrize("side", [24, 64])
def test_kernels3_match_plain(cuda, side):
    for check in checks.kernel_checks3(side, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert all(counts[k] > 0 for k in check.kernels), (check.label, counts)
        err = checks.max_abs_diff(got, want)
        assert err <= checks.TOL, (check.label, err)


def _k3(sweeps, segment=None):
    """Tiled 3-D Jacobi launches of ``sweeps`` sweeps in segments of
    ``segment``: T3 sweeps a launch, each segment's remainder last."""
    t, segment = cuda_ops.SWEEPS_PER_LAUNCH_3D, segment or sweeps
    full, rest = divmod(sweeps, segment)
    return full * -(-segment // t) + -(-rest // t)


@pytest.mark.parametrize("mode", ["parity", "compensated", "chebyshev-dens"])
def test_step3_launches_and_matches_reference(cuda, mode):
    kw = {"parity": {}, "compensated": COMP3,
          "chebyshev-dens": dict(diffusion_solver="chebyshev-dens",
                                 cheby_rho=0.85)}[mode]
    cfg = ft.SimConfig(n=62, ndim=3, jacobi_iters=20, backend="cuda",
                       device=cuda, **kw)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.StableFluids3D(cfg).step(state, src)
    torch.cuda.synchronize()
    k_vel = cfg.cheby_iters if mode == "compensated" else cfg.jacobi_iters
    k_p = cfg.press_cheby_iters if mode == "compensated" else cfg.jacobi_iters
    k_dens = {"parity": cfg.jacobi_iters, "compensated": cfg.cheby_iters,
              "chebyshev-dens": cfg.cheby_dens_iters}[mode]
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        "jacobi3_sweep": 3 * k_vel + 2 * k_p + k_dens, "divergence3": 2,
        "gradient3": 2, "advect3": 2}
    want = ft.step3(cfg.replace(backend="reference"), state, src)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("side,m", [(64, 16), (2048, 256)])
def test_slab_kernels_match_plain(cuda, side, m):
    for check in checks.kernel_checks_slab(side, m, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert all(counts[k] > 0 for k in check.kernels), (check.label, counts)
        err = checks.max_abs_diff(got, want)
        assert err <= checks.TOL, (check.label, err)


@pytest.mark.parametrize("mode,slabs", [("parity", 4), ("parity", 16),
                                        ("perf", 4)])
def test_sharded_step_launches_and_matches_reference(cuda, mode, slabs):
    """The multi-device step on a mesh that lists the card once per slab:
    4 slabs of 64 rows take the fused routes, 16 slabs of 16 rows (with
    8-sweep chunks) the composed ones."""
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_state, unshard)

    kw = dict(PERF, fast_math=True) if mode == "perf" else {}
    if slabs == 16:
        kw["fuse_sweeps"] = 8
    cfg = ft.SimConfig(n=254, jacobi_iters=20, backend="cuda", device=cuda,
                       **kw)
    mesh = make_mesh([cuda] * slabs)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    state, src = shard_state(state, mesh), shard_state(src, mesh)
    step = make_sharded_step_fn(cfg, mesh)
    assert step.routes["projection"] == ("fused" if slabs == 4
                                         else "composed")
    cuda_ops.reset_launch_counts()
    got = unshard(step(state, src))
    torch.cuda.synchronize()
    import chip_smoke
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches_sharded(cfg, slabs)}
    ref = make_sharded_step_fn(cfg.replace(backend="reference"), mesh)
    want = unshard(ref(state, src))
    # The reference backend ignores fast_math (phase 6 of chip_smoke.py).
    atol = 1e-4 if mode == "perf" else 2e-5
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


def test_cuda_slab_launches_or_raises(cuda):
    from fluidsimulationcuda_torch.kernels import cuda_sharded

    x = torch.zeros(48, 34, device=cuda)
    cuda_ops.reset_launch_counts()
    cuda_sharded.fused_jacobi_slab(0, x, x, (1, 0, 0), m=32, K=8, alpha=1.0,
                                   beta=4.0, sweeps=3)
    assert cuda_ops.launch_counts()["jacobi_slab_sweeps"] == 1
    with cuda_ops.launch_sweeps(0):
        cuda_sharded.fused_jacobi_slab(0, x, x, (1, 0, 0), m=32, K=8,
                                       alpha=1.0, beta=4.0, sweeps=3)
    assert cuda_ops.launch_counts()["jacobi_slab"] == 3
    with pytest.raises(ValueError):
        cuda_sharded.fused_jacobi_slab(0, x, x.cpu(), (1, 0, 0), m=32, K=8,
                                       alpha=1.0, beta=4.0, sweeps=3)


def test_cuda_volume_launches_or_raises(cuda):
    x = torch.zeros(24, 24, 24, device=cuda)
    cuda_ops.reset_launch_counts()
    cuda_ops_3d.fused_jacobi3(0, x, x, 1.0, 6.0, 3)
    assert cuda_ops.launch_counts()["jacobi3_sweep"] == 3
    with pytest.raises(ValueError):
        cuda_ops_3d.fused_jacobi3(0, x, x.cpu(), 1.0, 6.0, 3)


@pytest.mark.parametrize("side,mz", [(24, 8), (64, 16)])
def test_slab3_kernels_match_plain(cuda, side, mz):
    for check in checks.kernel_checks_slab3(side, mz, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert all(counts[k] > 0 for k in check.kernels), (check.label, counts)
        err = checks.max_abs_diff(got, want)
        assert err <= checks.TOL, (check.label, err)


@pytest.mark.parametrize("mode", ["parity", "compensated"])
def test_sharded3d_step_launches_and_matches_reference(cuda, mode):
    """The 3-D multi-device step on 4 z-slabs of 16 planes of 64³: 15-sweep
    segments, so the 20-sweep solves run chained (15 + 5); compensated with
    fast math, whose fast Chebyshev segments take ceil(sweeps / T3)
    launches of the tiled K13 (one a sweep of the per-sweep K13 before it
    took them; the parity segments still do).  The two gathers are one
    grouped K14 launch each over the 4 slabs (``advect3_group``; 8
    per-slab ``advect3_slab`` launches before the grouped form)."""
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn_3d,
                                                    shard_state_3d, unshard)

    kw = dict(COMP3, fast_math=True) if mode == "compensated" else {}
    cfg = ft.SimConfig(n=62, ndim=3, jacobi_iters=20, backend="cuda",
                       device=cuda, **kw)
    mesh = make_mesh([cuda] * 4)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    state, src = shard_state_3d(state, mesh), shard_state_3d(src, mesh)
    step = make_sharded_step_fn_3d(cfg, mesh)
    cuda_ops.reset_launch_counts()
    got = unshard(step(state, src))
    torch.cuda.synchronize()
    k_vel = cfg.cheby_iters if mode == "compensated" else cfg.jacobi_iters
    k_p = cfg.press_cheby_iters if mode == "compensated" else cfg.jacobi_iters
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **({"jacobi3_slab_sweeps": 4 * (4 * _k3(k_vel, min(k_vel, 15))
                                        + 2 * _k3(k_p, min(k_p, 15)))}
           if mode == "compensated"
           else {"jacobi3_slab": 4 * (4 * k_vel + 2 * k_p)}),
        "divergence3_slab": 8, "gradient3_slab": 8, "advect3_group": 2}
    ref = make_sharded_step_fn_3d(cfg.replace(backend="reference"), mesh)
    want = unshard(ref(state, src))
    # The reference backend ignores fast_math (phase 9 of chip_smoke.py).
    atol = 1e-4 if mode == "compensated" else 2e-5
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("ndim,side,m", [(2, 64, 16), (2, 2048, 256),
                                         (3, 24, 8), (3, 64, 4)])
def test_exact_gathers_match_plain_bit_for_bit(cuda, ndim, side, m):
    """K12's and K14's exact forms from the assembled fields against their
    plain versions on top, interior and bottom slabs, up to 24 cells."""
    kernel = "advect_slab_exact" if ndim == 2 else "advect3_slab_exact"
    make = (checks.kernel_checks_slab if ndim == 2
            else checks.kernel_checks_slab3)
    found = 0
    for check in make(side, m, cuda, seed=side):
        if kernel not in check.kernels:
            continue
        found += 1
        cuda_ops.reset_launch_counts()
        got = check.run()
        assert cuda_ops.launch_counts()[kernel] == 1, check.label
        want = check.plain()
        torch.cuda.synchronize()
        assert checks.max_abs_diff(got, want) == 0.0, check.label
    assert found == 18


@pytest.mark.parametrize("ndim,slabs,mode", [(2, 8, "exact"), (3, 4, "exact"),
                                             (3, 32, "auto")])
def test_exact_sharded_step_equals_single_device(cuda, ndim, slabs, mode):
    """The exact multi-device step past the window: the launches of
    ``chip_smoke.expected_launches_sharded(3)`` with the exact forms, equal
    to the single-device step and to the ``reference`` backend bit for
    bit.  256² on 8 row slabs; 64³ on 4 z-slabs, and on 32 of 2 planes,
    where ``"auto"`` takes the exact gather."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    make_sharded_step_fn_3d,
                                                    shard_state,
                                                    shard_state_3d, unshard)

    if ndim == 2:
        cfg = ft.SimConfig(n=254, jacobi_iters=20, max_courant=2,
                           backend="cuda", device=cuda)
        make, shard = make_sharded_step_fn, shard_state
        design = chip_smoke.expected_launches_sharded
    else:
        cfg = ft.SimConfig(n=62, ndim=3, jacobi_iters=20, max_courant=2,
                           backend="cuda", device=cuda)
        make, shard = make_sharded_step_fn_3d, shard_state_3d
        design = chip_smoke.expected_launches_sharded3
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    # Velocity sources that move the backtrace past the 2-cell window.
    scale = 20 if ndim == 2 else 400
    src = src._replace(**{k: scale * getattr(src, k) for k in ("u", "v", "w")
                          if getattr(src, k) is not None})
    mesh = make_mesh([cuda] * slabs)
    step = make(cfg, mesh, advect_mode=mode, audited=True)
    assert step.advect_mode == "exact"
    cuda_ops.reset_launch_counts()
    got, disp = step(shard(state, mesh), shard(src, mesh))
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0), **design(cfg, slabs, True)}
    assert float(disp) > cfg.max_courant
    got = unshard(got)
    ref = make(cfg.replace(backend="reference"), mesh, advect_mode=mode)
    single = (ft.StableFluids2D if ndim == 2 else ft.StableFluids3D)(cfg)
    for want in (unshard(ref(shard(state, mesh), shard(src, mesh))),
                 single.step(state, src)):
        for a, b in zip(got, want):
            if a is not None:
                assert torch.equal(a, b)


def test_cuda_exact_gathers_launch_or_raise(cuda):
    from fluidsimulationcuda_torch.kernels import cuda_sharded, cuda_sharded_3d

    full, slab = torch.zeros(34, 34, device=cuda), torch.zeros(8, 34,
                                                               device=cuda)
    cuda_ops.reset_launch_counts()
    cuda_sharded.advect_slab_exact((1, 2), (full, full), None, None,
                                   (0, 0, 8), dt=0.016, n=32, m=8,
                                   self_adv=True)
    vol, zslab = (torch.zeros(24, 24, 24, device=cuda),
                  torch.zeros(4, 24, 24, device=cuda))
    cuda_sharded_3d.advect3_flat_slab_exact((0,), (vol,), zslab, zslab,
                                            zslab, (0, 1, 20), dt=0.016,
                                            n=22, mz=4)
    counts = cuda_ops.launch_counts()
    assert counts["advect_slab_exact"] == counts["advect3_slab_exact"] == 1
    with pytest.raises(ValueError):
        cuda_sharded.advect_slab_exact((0,), (full.cpu(),), slab, slab,
                                       (0, 0, 8), dt=0.016, n=32, m=8,
                                       self_adv=False)


def test_cuda_slab3_launches_or_raises(cuda):
    from fluidsimulationcuda_torch.kernels import cuda_sharded_3d

    x = torch.zeros(16, 24, 24, device=cuda)
    cuda_ops.reset_launch_counts()
    cuda_sharded_3d.fused_jacobi3_slab(0, x, x, (1, 0, 0), mz=8, H=4,
                                       alpha=1.0, beta=6.0, sweeps=3)
    assert cuda_ops.launch_counts()["jacobi3_slab"] == 3
    with pytest.raises(ValueError):
        cuda_sharded_3d.fused_jacobi3_slab(0, x, x.cpu(), (1, 0, 0), mz=8,
                                           H=4, alpha=1.0, beta=6.0,
                                           sweeps=3)


@pytest.mark.parametrize("per_launch", [1, 3, None])
def test_tiled_3d_solves_equal_the_per_sweep_chain(cuda, per_launch):
    """Every 3-D solve check at side 66 (tiles and chunks that do not
    divide it) and every z-slab segment on slabs of 16 planes of 64³ that
    takes the tiled kernel (its Chebyshev+fast mode), at T = 1, 3 and T3,
    against the same call on the per-sweep K5 and K13: 0 difference."""
    lists = (checks.kernel_checks3(66, cuda, seed=66),
             checks.kernel_checks_slab3(64, 16, cuda, seed=64))
    for check in checks.per_sweep_checks([c for cl in lists for c in cl]):
        with cuda_ops.launch_sweeps(per_launch or
                                    cuda_ops.SWEEPS_PER_LAUNCH_3D):
            got = check.run()
        want = check.plain()
        torch.cuda.synchronize()
        assert checks.max_abs_diff(got, want) == 0.0, check.label


@pytest.mark.parametrize("per_launch,tile", [(1, 32), (3, 64), (5, 32),
                                             (None, None)])
def test_tiled_slab_solves_equal_the_per_sweep_chain(cuda, per_launch,
                                                      tile):
    """Every row-slab check at 2048² on slabs of 256 rows (top, interior
    and bottom; every solve mode, the projection, the density step and
    K18's split chain) on the tiled K9, at T = 1, 3 and 5 on 32- and
    64-row tiles and as ``slab_tiling`` chooses, against the same call on
    the per-sweep K9 (0 difference) and against its plain twin (0
    difference outside fast mode, ``checks.TOL`` in it)."""
    check_list = (checks.kernel_checks_slab(2048, 256, cuda, seed=7)
                  + checks.split_against_concat(2048, 256, cuda, seed=7))
    for check in checks.slab_per_sweep_checks(check_list):
        forced = (contextlib.nullcontext() if per_launch is None
                  else cuda_ops.launch_sweeps(per_launch, tile_rows=tile))
        with forced:
            got = check.run()
        want = check.plain()
        torch.cuda.synchronize()
        assert checks.max_abs_diff(got, want) == 0.0, check.label
    for check in check_list:
        if "jacobi_slab_sweeps" not in check.kernels:
            continue
        err = checks.max_abs_diff(check.run(), check.plain())
        fast = "fast" in check.label
        assert err <= checks.TOL if fast else err == 0.0, (check.label, err)


def test_slab_step_launches_by_the_tiling(cuda):
    """One 2048² parity step on 8 slabs of 256 rows launches the tiled K9
    as ``chip_smoke.expected_launches_sharded`` counts it chunk by chunk
    (160 launches, 800 on the per-sweep K9) and equals the same step on the
    per-sweep K9 bit for bit."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_state, unshard)

    cfg = ft.SimConfig(n=2046, jacobi_iters=20, backend="cuda", device=cuda)
    mesh = make_mesh([cuda] * 8)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    state, src = shard_state(state, mesh), shard_state(src, mesh)
    step = make_sharded_step_fn(cfg, mesh)
    cuda_ops.reset_launch_counts()
    got = unshard(step(state, src))
    torch.cuda.synchronize()
    want = chip_smoke.expected_launches_sharded(cfg, 8)
    assert cuda_ops.launch_counts() == {**dict.fromkeys(cuda_ops.KERNELS, 0),
                                        **want}
    assert want["jacobi_slab_sweeps"] == 160
    with cuda_ops.launch_sweeps(0):
        cuda_ops.reset_launch_counts()
        chain = unshard(step(state, src))
        assert cuda_ops.launch_counts()["jacobi_slab"] == 800
    for a, b in zip(got, chain):
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("slabs", [4, 8])
@pytest.mark.parametrize("fast", [False, True])
def test_step3_launches_by_the_tiled3_rule(cuda, fast, slabs):
    """One compensated 3-D step at 64³ and one on 4 z-slabs of 16 planes
    or 8 of 8: with fast math the volume's Chebyshev solves take the
    tiled K5, ceil(sweeps / T3) launches a solve, and the slabs' segments
    the tiled K13 on 16-plane slabs (10- and 12-sweep segments on buffers
    of 38 and 42 planes) but the per-sweep K13 on 8-plane slabs (7-sweep
    segments on 24-plane buffers, fewer than 5*T3); without fast math
    every sweep is one per-sweep launch and the tiled kernel is idle
    (``cuda_ops.tiled3``)."""
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn_3d,
                                                    shard_state_3d)

    cfg = ft.SimConfig(n=62, ndim=3, backend="cuda", device=cuda,
                       fast_math=fast, **COMP3)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    ft.StableFluids3D(cfg).step(state, src)
    mesh = make_mesh([cuda] * slabs)
    make_sharded_step_fn_3d(cfg, mesh)(shard_state_3d(state, mesh),
                                       shard_state_3d(src, mesh))
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    k_vel, k_p = cfg.cheby_iters, cfg.press_cheby_iters
    seg = 64 // slabs - 1
    if fast:
        assert counts["jacobi3_sweeps"] == 4 * _k3(k_vel) + 2 * _k3(k_p)
        assert counts["jacobi3_sweep"] == 0
    else:
        assert counts["jacobi3_sweep"] == 4 * k_vel + 2 * k_p
        assert counts["jacobi3_sweeps"] == 0
    if fast and slabs == 4:
        assert counts["jacobi3_slab_sweeps"] == slabs * (
            4 * _k3(k_vel, min(k_vel, seg)) + 2 * _k3(k_p, min(k_p, seg)))
        assert counts["jacobi3_slab"] == 0
    else:
        assert counts["jacobi3_slab"] == slabs * (4 * k_vel + 2 * k_p)
        assert counts["jacobi3_slab_sweeps"] == 0


@pytest.mark.parametrize("side,m", [(64, 16), (2048, 256)])
def test_split_slab_equals_concat_route(cuda, side, m):
    """B13 equals K9 on the ``torch.cat`` of the same operands, bit for
    bit (JAX's contract for B13).  Its first launch is now the tiled K9's
    split-source form (``jacobi_slab_sweeps_split``), where K18's one
    sweep (``jacobi_slab_split``) ran before: the check counts that launch
    once and K18 not at all."""
    for check in checks.split_against_concat(side, m, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert counts["jacobi_slab_sweeps_split"] == 1, (check.label, counts)
        assert counts["jacobi_slab_split"] == 0, (check.label, counts)
        assert checks.max_abs_diff(got, want) == 0.0, check.label


@pytest.mark.parametrize("side,m", [(64, 16), (2048, 256)])
def test_split_slab_equals_the_k18_route(cuda, side, m):
    """B13's split-source tiled K9 equals the route before it, K18's one
    sweep then the tiled K9, bit for bit, in every mode."""
    for check in checks.split_against_k18(side, m, cuda, seed=side):
        got, want = check.run(), check.plain()
        torch.cuda.synchronize()
        assert checks.max_abs_diff(got, want) == 0.0, check.label


def test_grouped_slab_smoother_from_copied_halos(cuda):
    """With the neighbours' rows copied over (the halo exchange a slab on
    another device takes) the grouped K9-damp computes what it computes
    from pointers into the neighbours' arrays, bit for bit."""
    from fluidsimulationcuda_torch.kernels import cuda_sharded as cs

    t = checks._SlabInputs(2048, 256, cuda, 3)
    p, d, fl = t.slab_list(t.p), t.slab_list(t.x0), t.flag_list()
    for sweeps, zero_init in ((2, False), (2, True), (7, False)):
        got = cs._smooth_group(p, d, fl, sweeps, zero_init, copy=True)
        want = cs.smooth_slabs(p, d, fl, sweeps=sweeps, zero_init=zero_init)
        torch.cuda.synchronize()
        assert checks.max_abs_diff(got, want) == 0.0


@pytest.mark.parametrize("mode", ["parity", "perf"])
def test_windowed_step_launches_matches_reference_and_k17(cuda, mode):
    """The windowed 2-D step (a 1-cell window): launches as the exact step,
    held against the ``reference`` backend; its velocity tail again through
    K17 equals the step's own."""
    import chip_smoke

    kw = dict(PERF, fast_math=True) if mode == "perf" else {}
    cfg = ft.SimConfig(n=254, jacobi_iters=20, backend="cuda", device=cuda,
                       advect_mode="windowed", max_courant=1, **kw)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.step(cfg, state, src)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches(cfg)}
    want = ft.step(cfg.replace(backend="reference"), state, src)
    # The reference backend ignores fast_math (phase 6 of chip_smoke.py).
    atol = 1e-4 if mode == "perf" else 2e-5
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
    cuda_ops.reset_launch_counts()
    tail = chip_smoke.windowed_tail(cfg, state, src)
    assert cuda_ops.launch_counts()["advect_project"] == 1
    for a, b in zip(tail, (got.u, got.v)):
        assert float((a - b).abs().max()) <= checks.TOL


@pytest.mark.parametrize("side", [34, 2048])
def test_tail_forms_match_plain_bit_for_bit(cuda, side):
    """K17 in the form its launch takes (resident, where its band fits) and
    in the streaming form, against its plain version: equal to the bit."""
    from fluidsimulationcuda_torch.kernels import cuda_step

    t = checks._Inputs(side, cuda, side)
    for form in (None, "resident", "streaming"):
        for args, kw in (((t.uf, t.vf, t.n, 20, checks.DT), dict(cmax=4)),
                         ((t.uf, t.vf, t.n, 14, checks.DT),
                          dict(cmax=4, cheby_rho=0.9))):
            cuda_step.reset_form_counts()
            got = cuda_step.fused_advect_project(*args, form=form, **kw)
            want = cuda_step.fused_advect_project_plain(*args, **kw)
            torch.cuda.synchronize()
            ran = cuda_step.form_counts()
            assert ran[form or "resident"] == 1, (form, ran)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (form, kw)


def test_tail_resident_form_that_does_not_fit_raises(cuda):
    """Two 2048² grids make bands of 32 rows on 132 SMs, whose 34 rows with
    their halos (278 KB) pass a block's 227 KB of shared memory: the launch
    takes the streaming form, and asking for the resident one raises."""
    from fluidsimulationcuda_torch.kernels import cuda_step

    u = torch.zeros(2, 2048, 2048, device=cuda)
    assert cuda_step.advect_project_form(2048, 2) == "streaming"
    with pytest.raises(RuntimeError, match="resident"):
        cuda_step.fused_advect_project(u, u, 2046, 2, 0.016, cmax=1,
                                       form="resident")


@pytest.mark.parametrize("side,mz", [(24, 3), (64, 16)])
def test_slab3_flows_match_plain_bit_for_bit(cuda, side, mz):
    for check in checks.kernel_checks_slab3_flows(side, mz, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert counts["advect3_slab"] == 1, check.label
        assert checks.max_abs_diff(got, want) == 0.0, check.label


def test_cuda_tail_launches_or_raises(cuda):
    from fluidsimulationcuda_torch.kernels import cuda_step

    u = torch.zeros(34, 34, device=cuda)
    cuda_ops.reset_launch_counts()
    cuda_step.fused_advect_project(u, u, 32, 3, 0.016, cmax=2)
    assert cuda_ops.launch_counts()["advect_project"] == 1
    with pytest.raises(ValueError):
        cuda_step.fused_advect_project(u, u.cpu(), 32, 3, 0.016, cmax=2)


@pytest.mark.parametrize("nb,side", [(3, 34), (2, 130)])
def test_batched_kernels_match_plain_and_per_grid(cuda, nb, side):
    """K1-K4 on a batch: against their plain versions, and against the same
    wrapper launched on each grid alone (bit for bit)."""
    for check in checks.kernel_checks_batched(nb, side, cuda, seed=side,
                                              cmax=2):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert all(counts[k] > 0 for k in check.kernels), (check.label, counts)
        assert checks.max_abs_diff(got, want) <= checks.TOL, check.label
    for check in checks.batched_against_grids(nb, side, cuda, seed=side,
                                              cmax=2):
        got, want = check.run(), check.plain()
        torch.cuda.synchronize()
        assert checks.max_abs_diff(got, want) == 0.0, check.label


@pytest.mark.parametrize("side,batch", [(34, 0), (34, 3), (2048, 0)])
def test_pair_equals_two_singles(cuda, side, batch):
    """B12: one set of tiled K1 launches for the stacked u/v pair, equal to
    two ``fused_jacobi`` calls bit for bit."""
    t = cuda_ops.SWEEPS_PER_LAUNCH
    for check in checks.pair_against_singles(side, cuda, seed=side,
                                             batch=batch):
        cuda_ops.reset_launch_counts()
        got = check.run()
        assert cuda_ops.launch_counts()["jacobi_sweeps"] == -(-20 // t), \
            check.label
        want = check.plain()
        torch.cuda.synchronize()
        assert checks.max_abs_diff(got, want) == 0.0, check.label


@pytest.mark.parametrize("mode", ["parity", "perf"])
def test_batched_step_launches_matches_per_grid_and_reference(cuda, mode):
    """The windowed step on a batch of four 64² grids: the launches of one
    grid, each grid equal to its own step bit for bit, and the batch held
    against the ``reference`` backend."""
    import chip_smoke

    kw = dict(PERF, fast_math=True) if mode == "perf" else {}
    cfg = ft.SimConfig(n=62, jacobi_iters=20, backend="cuda", device=cuda,
                       advect_mode="windowed", max_courant=1, **kw)
    state, src = ft.batched_init(torch.Generator(device=cuda).manual_seed(0),
                                 cfg, 4)
    state = ft.step(cfg, state, src)
    cuda_ops.reset_launch_counts()
    got = ft.step(cfg, state, src)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches(cfg)}
    for g in range(4):
        one = ft.step(cfg, ft.FluidState(*(t[g] for t in state[:3])),
                      ft.Sources(*(t[g] for t in src[:3])))
        for a, b in zip(got[:3], one[:3]):
            assert torch.equal(a[g], b)
    want = ft.step(cfg.replace(backend="reference"), state, src)
    # The reference backend ignores fast_math (phase 6 of chip_smoke.py).
    atol = 1e-4 if mode == "perf" else 2e-5
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


def test_cuda_batch_launches_once_or_raises(cuda):
    x = torch.zeros(5, 34, 34, device=cuda)
    cuda_ops.reset_launch_counts()
    cuda_ops.fused_jacobi(0, x, x, 1.0, 4.0, 3)
    assert cuda_ops.launch_counts()["jacobi_sweeps"] == 1
    with pytest.raises(ValueError):
        cuda_ops.fused_jacobi(0, x, x[:4].clone(), 1.0, 4.0, 3)


@pytest.mark.parametrize("side", [16, 128, 2048])
def test_damped_smoother_matches_plain(cuda, side):
    """K1's damped sweeps (the multigrid smoother) against
    ``ops.multigrid._smooth``: bit for bit expected, 1e-6 required.  The
    smoother now runs on K1-damp (``jacobi_sweeps_damp``, the launches of
    ``cuda_ops.damped_plan``: one a smooth, one whole-grid launch for the
    40 sweeps at 16²) where it ran one per-sweep launch a sweep
    (``jacobi_sweep_damp``), so the check counts those launches and holds
    the result to the per-sweep chain too, bit for bit."""
    for check in checks.kernel_checks_damp(side, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        chain = check.chain()
        torch.cuda.synchronize()
        sweeps = int(check.label.split(" damped jacobi ")[1].split()[0])
        per_launch = cuda_ops.damped_plan(side, sweeps).per_launch
        assert counts["jacobi_sweeps_damp"] == -(-sweeps // per_launch), (
            check.label, counts)
        assert counts["jacobi_sweep_damp"] == counts["jacobi_sweep"] == 0, (
            check.label, counts)
        assert counts["jacobi_sweeps"] == 0, (check.label, counts)
        assert checks.max_abs_diff(got, want) <= 1e-6, check.label
        assert torch.equal(got, chain), check.label


@pytest.mark.parametrize("side", [33, 1025])
def test_damped_smoother_on_odd_sides(cuda, side):
    """K1-damp on the odd coarse grids of the slab multigrid ((n/2 + 2)²
    with n/2 odd: 33² at n = 62, 1025² at 2048²) against
    ``ops.multigrid._smooth`` and the per-sweep damped K1, bit for bit."""
    for check in checks.kernel_checks_damp(side, cuda, seed=side):
        got, want, chain = check.run(), check.plain(), check.chain()
        torch.cuda.synchronize()
        assert torch.equal(got, want), check.label
        assert torch.equal(got, chain), check.label


@pytest.mark.parametrize("side,m", [(64, 16), (64, 8), (2048, 256),
                                    (2048, 16)])
def test_slab_smoother_matches_plain(cuda, side, m):
    """K9-damp (``smooth_slabs``, every slab in one launch) against its
    plain twin on every slab of the mesh, bit for bit, and against itself
    at one launch a sweep; a 2-sweep smooth is one launch for all the
    slabs.  The smoother takes every slab now, where it took one slab's
    extended buffer: the checks are ``kernel_checks_group_smooth``'s and
    count ``jacobi_slab_sweeps_damp_group`` (before,
    ``kernel_checks_slab_smooth``'s top, interior and bottom slab, and
    ``jacobi_slab_sweeps_damp``)."""
    for check in checks.kernel_checks_group_smooth(side, m, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        with cuda_ops.launch_sweeps(0):
            chain = check.run()
        want = check.plain()
        torch.cuda.synchronize()
        if " 2 sweeps" in check.label:
            assert counts["jacobi_slab_sweeps_damp_group"] == 1, check.label
        assert checks.max_abs_diff(got, want) == 0.0, check.label
        assert checks.max_abs_diff(got, chain) == 0.0, check.label


@pytest.mark.parametrize("solver", ["multigrid", "cg"])
def test_slab_solver_step_launches_and_matches_reference(cuda, solver):
    """The row-slab step with the multigrid (two cycles) or CG-20
    projection on 8 slabs of 32 rows: the launches of
    ``chip_smoke.expected_launches_sharded`` (K9-damp and K1-damp for
    multigrid) and the ``reference`` backend's state."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_state, unshard)

    cfg = ft.SimConfig(n=254, jacobi_iters=20, backend="cuda", device=cuda,
                       pressure_solver=solver, mg_cycles=2, cg_iters=20)
    mesh = make_mesh([cuda] * 8)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    state, src = shard_state(state, mesh), shard_state(src, mesh)
    step = make_sharded_step_fn(cfg, mesh)
    assert step.routes["projection"] == "composed"
    cuda_ops.reset_launch_counts()
    got = unshard(step(state, src))
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches_sharded(cfg, 8)}
    ref = make_sharded_step_fn(cfg.replace(backend="reference"), mesh)
    want = unshard(ref(state, src))
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("side", [24, 64])
def test_windowed_k6_matches_plain(cuda, side):
    """K6 in the gather window against ``ops.three_d.advect3_windowed``:
    constant displacements inside, across and far over the window, and
    random velocities (one field and the self-advected triple)."""
    for check in checks.kernel_checks3_windowed(side, cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert counts["advect3_windowed"] == 1, (check.label, counts)
        assert counts["advect3"] == 0, (check.label, counts)
        assert checks.max_abs_diff(got, want) <= checks.TOL, check.label


@pytest.mark.parametrize("solver", ["multigrid", "multigrid fast", "cg"])
def test_solver_step_launches_and_matches_reference(cuda, solver):
    """The 2-D step with the multigrid (two cycles; one with fast math, the
    JAX bench's line) and CG-20 projections: the launches of
    ``chip_smoke.expected_launches`` and the ``reference`` backend's state
    (with fast math, that of the ``cuda`` OpSet's plain twins)."""
    import chip_smoke

    kw = {"multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
          "multigrid fast": dict(pressure_solver="multigrid", mg_cycles=1,
                                 fast_math=True),
          "cg": dict(pressure_solver="cg", cg_iters=20)}[solver]
    cfg = ft.SimConfig(n=254, jacobi_iters=20, backend="cuda", device=cuda,
                       **kw)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.step(cfg, state, src)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches(cfg)}
    # The reference backend ignores fast_math; the cuda OpSet's plain twins
    # take it and round as the kernels do (phase 14 of chip_smoke.py).
    ops = cuda_ops.make_opset(cfg, plain=True) if cfg.fast_math else None
    want = ft.step(cfg.replace(backend="reference"), state, src, ops)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("b", [0, 1, 2])
def test_fast_jacobi_equals_its_plain_twin_to_the_bit(cuda, b):
    """K1's reciprocal form (one fmaf a sweep) against
    ``fused_jacobi_plain(fast=True)``, which rounds the product and the sum
    once: equal to the bit, with a source fold and from zero."""
    gen = torch.Generator().manual_seed(b)
    x, x0 = (torch.rand(258, 258, generator=gen).to(cuda) for _ in range(2))
    for kw in (dict(src_dt=0.016), dict(zero_init=True)):
        got = cuda_ops.fused_jacobi(b, x, x0, 2.5, 11.0, 20, fast=True, **kw)
        want = cuda_ops.fused_jacobi_plain(b, x, x0, 2.5, 11.0, 20, fast=True,
                                           **kw)
        assert torch.equal(got, want), (kw, float((got - want).abs().max()))


@pytest.mark.parametrize("solver", ["multigrid", "cg"])
def test_solver_step_captures_as_a_cuda_graph(cuda, solver):
    """No host sync inside the multigrid or CG projection: the whole step
    captures into a CUDA graph and replays."""
    cfg = ft.SimConfig(n=126, jacobi_iters=20, backend="cuda", device=cuda,
                       pressure_solver=solver)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    state = ft.step(cfg, state, src)
    assert checks.device_ms(lambda: ft.step(cfg, state, src), reps=2) > 0


@pytest.mark.parametrize("mode", ["parity", "compensated"])
def test_windowed_step3_launches_and_matches_reference(cuda, mode):
    """The windowed 3-D step (a 1-cell window, which the reference impulse
    crosses at 64³): K6 in the window twice a step, held against the
    ``reference`` backend."""
    import chip_smoke

    kw = dict(COMP3, fast_math=True) if mode == "compensated" else {}
    cfg = ft.SimConfig(n=62, ndim=3, jacobi_iters=20, backend="cuda",
                       device=cuda, advect_mode="windowed", max_courant=1,
                       **kw)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.StableFluids3D(cfg).step(state, src)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches3(cfg)}
    want = ft.step3(cfg.replace(backend="reference"), state, src)
    atol = 1e-4 if cfg.fast_math else 2e-5
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("side,ndim,batch", [(2048, 2, 0), (258, 2, 1024),
                                             (256, 3, 0)],
                         ids=["2048sq", "1024x258sq", "256cube"])
def test_staged_gathers_match_plain(cuda, side, ndim, batch):
    """K4 (a 2048² grid, the datagen batch of 1024 grids of 258²), which
    stages each block's footprint in shared memory, and K6 (256³) against
    their plain versions on smooth, random and shear velocities, exact and
    windowed; the shear puts K4's blocks astride its jump past the box cap,
    so they gather directly."""
    for check in checks.kernel_checks_flows(side, cuda, seed=1, ndim=ndim,
                                             batch=batch):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert all(counts[k] > 0 for k in check.kernels), (check.label, counts)
        assert checks.max_abs_diff(got, want) <= checks.TOL, check.label
        if check.boxes is not None and "shear" in check.label and (
                "exact" in check.label):
            assert checks.staged_share(check) < 1.0, check.label


# ---------------------------------------------------------------------------
# The command line and the utilities on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("perf", [False, True], ids=["parity", "perf"])
def test_cli_run_launches_and_resumes_bit_for_bit(cuda, tmp_path, perf):
    """``run`` on the card at 128²: each step launches what
    ``expected_launches`` says (16 parity, 13 perf at 20 iterations: each
    solve on the tiled K1, ten sweeps a launch; 105 and 63 when K1 took
    one launch a sweep), and a saved run resumed equals the straight run
    to the bit."""
    import chip_smoke
    from fluidsimulationcuda_torch import __main__ as cli

    common = ["run", "--n", "126", "--iters", "20"] + (["--perf"] if perf
                                                        else [])
    a, b, c = (str(tmp_path / f"{x}.npz") for x in "abc")
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    cli.main(common + ["--steps", "3", "--save", a])
    counts = cuda_ops.launch_counts()
    cfg = cli._cfg(cli._parser().parse_args(common + ["--steps", "3"]))
    per_step = chip_smoke.expected_launches(cfg)
    assert sum(per_step.values()) == (13 if perf else 16)
    assert counts == {**dict.fromkeys(cuda_ops.KERNELS, 0),
                      **{k: 3 * v for k, v in per_step.items()}}
    cli.main(["run", "--resume", a, "--steps", "3", "--save", b])
    cli.main(common + ["--steps", "6", "--save", c])
    with np.load(b) as zb, np.load(c) as zc:
        for k in ("dens", "u", "v"):
            np.testing.assert_array_equal(zb[k], zc[k])


def test_cli_profile_times_on_cuda_events(cuda, tmp_path, capsys):
    from fluidsimulationcuda_torch import __main__ as cli
    from fluidsimulationcuda_torch.utils import timing

    cuda_ops.reset_launch_counts()
    cli.main(["profile", "--n", "254", "--trace", str(tmp_path)])
    assert "full step (est)" in capsys.readouterr().out
    assert (tmp_path / "trace.json").exists()
    counts = cuda_ops.launch_counts()
    assert all(counts[k] > 0 for k in ("jacobi_sweeps", "divergence",
                                       "gradient", "advect")), counts
    assert counts["jacobi_sweep"] == 0, counts
    cfg = ft.SimConfig(n=254)
    rep = timing.profile_phases(cfg, torch.Generator(device=cuda).manual_seed(0))
    assert all(t > 0 for t in (rep.source, rep.diffusion, rep.divergence,
                               rep.projection, rep.advection))


@pytest.mark.parametrize("ndim", [2, 3])
def test_check_stability_on_the_card(cuda, ndim):
    from fluidsimulationcuda_torch.utils import stability

    cfg = ft.SimConfig(n=30, ndim=ndim, max_courant=2)
    rng = np.random.default_rng(ndim)
    fields = [rng.uniform(-1, 1, cfg.grid_shape).astype(np.float32)
              for _ in range(4 if ndim == 3 else 3)]
    state = ft.FluidState(*(torch.from_numpy(f).to(cuda) for f in fields))
    rep = stability.check_stability(cfg, state)
    assert all(t.device.type == "cuda" and t.dim() == 0 for t in rep)
    host = stability.check_stability(
        cfg.replace(device="cpu"), ft.FluidState(*map(torch.from_numpy,
                                                       fields)))
    for a, b in zip(rep, host):
        assert a.cpu().item() == b.item()
    assert stability.is_stable(cfg, state)
    fields[1][3, 3] = np.nan
    bad = ft.FluidState(*(torch.from_numpy(f).to(cuda) for f in fields))
    assert not bool(stability.check_stability(cfg, bad).finite)


def _spy_residuals(monkeypatch, tva):
    """Record each residual the port's bars (``tva``, the port's
    ``utils.validate``) take, as ``(residual, unit)``:
    the unit is float32's rounding of the residual's largest term, 2**-24
    max(beta |x|, |rhs|) (alpha |neighbour sum| is smaller).  The calls
    alternate the Jacobi and the Chebyshev solve of one state."""
    seen = []
    real = tva._residual

    def spy(x, rhs, alpha, beta):
        r = real(x, rhs, alpha, beta)
        big = max(float(beta * x.abs().max()), float(rhs.abs().max()))
        seen.append((float(r), 2.0**-24 * big))
        return r

    monkeypatch.setattr(tva, "_residual", spy)
    return seen


def _residual_bars(seen, steps=8):
    """Per residual bar of ``validate_perf_point`` (the velocity twin's
    ``steps`` states, then the density twin's): its worst Chebyshev /
    Jacobi ratio, that Jacobi residual in rounding units, and the ratio's
    rounding bound, four units on each residual."""
    out = {}
    for k, calls in (("diffusion_residual_ratio", seen[:2 * steps]),
                     ("dens_residual_ratio", seen[2 * steps:])):
        (rj, uj), (rc, uc) = max(zip(calls[0::2], calls[1::2]),
                                 key=lambda p: p[1][0] / p[0][0])
        out[k] = (rc / rj, rj / uj, 4 * (uc / rc + uj / rj))
    return out


@pytest.mark.parametrize("n,backend", [(254, "cuda"), (2046, "cuda"),
                                       (2046, "reference")])
def test_validate_bars_stand_above_rounding(cuda, monkeypatch, capsys, n,
                                            backend):
    """``run --perf --validate``'s bars on the card at the CLI's point for
    the size, against Jacobi-20 over 20 steps: each residual bar's margin
    below 1 exceeds its float32 rounding bound, so the verdict is no
    rounding noise.  The ``reference`` backend runs the same bars on the
    plain torch trajectory.  ``-s`` prints the bars (n=254 against JAX on
    the CPU: tests/test_torch_utils.py)."""
    from fluidsimulationcuda_torch.core.config import perf_operating_point
    from fluidsimulationcuda_torch.utils import validate as tva

    cfg = ft.SimConfig(n=n, jacobi_iters=20, backend=backend, device=cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rho, k_d, k_p = perf_operating_point(n + 2, 2)
    perf = cfg.replace(pressure_solver="chebyshev",
                       diffusion_solver="chebyshev", fast_math=True,
                       cheby_rho=rho, cheby_iters=k_d, cheby_press_iters=k_p)
    seen = _spy_residuals(monkeypatch, tva)
    bars = tva.validate_perf_point(cfg, perf)
    with capsys.disabled():
        print(f"\nn={n} {backend} ({rho}, {k_d}, {k_p}): max|div| "
              f"{bars['max_abs_divergence']:.4g} against "
              f"{bars['jacobi_max_abs_divergence']:.4g}")
        for k, (ratio, units, bound) in _residual_bars(seen).items():
            print(f"  {k} {ratio:.7g}: margin {1.0 - ratio:.3g}, rounding "
                  f"bound {bound:.3g}, Jacobi residual {units:.4g} units")
            assert ratio == bars[k]
            assert 1.0 - ratio > bound, k
    assert bars["ok"]


@pytest.mark.parametrize("side,batch", [(34, 0), (130, 3), (2048, 0)])
def test_bf16_kernel_forms_match_plain(cuda, side, batch):
    """Each bf16 form of K1-K3 against its plain version, bit for bit (the
    same float32 arithmetic, one rounding to bf16), its launches counted
    under its bf16 name."""
    for check in checks.kernel_checks_bf16(side, cuda, seed=side,
                                           batch=batch):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert {k for k, c in counts.items() if c} == set(check.kernels), (
            check.label, counts)
        assert checks.max_abs_diff(got, want) == 0.0, check.label


@pytest.mark.parametrize("side,batch", [(34, 0), (36, 0), (40, 3), (130, 3),
                                        (256, 0)])
def test_bf16_vector_forms_match_plain(cuda, side, batch):
    """Every form of the bf16 vector kernels of K3 and K2's gradient
    (``checks.BF16_FORMS``: K3's V = 4 and 2, the gradient's 8, 4 and 2,
    and the one-cell kernel) against
    the plain version of every call of ``checks.kernel_checks_bf16_forms``,
    bit for bit, each launch in the width its form and the side allow
    (``chip_smoke.bf16_forms``, as phase 18 runs it at 2048², 8192² and on
    the datagen batch); sides 34 and 130 take V = 2 at most, 36 V = 4."""
    import chip_smoke

    errs = dict.fromkeys(cuda_ops.KERNELS, 0.0)
    chip_smoke.bf16_forms(side, batch, errs)
    assert errs["advect_bf16"] == errs["gradient_bf16"] == 0.0


@pytest.mark.parametrize("mode", ["parity", "perf"])
def test_bf16_step_launches_and_matches_reference(cuda, mode):
    """The bf16 step at 256²: K1 then K3 for the density (no K4), the bf16
    forms counted apart; held by ``chip_smoke.bf16_bars`` to the ``cuda``
    OpSet's plain twins bit for bit and to the float32 step from the same
    bf16 draw (rel-L2 under 0.15 for density, and no farther than the
    ``reference`` backend's bf16 step, which rounds every sweep, lies from
    it)."""
    import chip_smoke

    kw = dict(PERF, fast_math=True) if mode == "perf" else {}
    cfg = ft.SimConfig(n=254, jacobi_iters=20, backend="cuda", device=cuda,
                       dtype=torch.bfloat16, **kw)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.step(cfg, state, src)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches(cfg)}
    assert all(f.dtype == torch.bfloat16 for f in got[:3])
    twins = ft.step(cfg, state, src, cuda_ops.make_opset(cfg, plain=True))
    ref16 = ft.step(cfg.replace(backend="reference"), state, src)
    ref32 = ft.step(cfg.replace(dtype=torch.float32),
                    ft.FluidState(*(t.float() for t in state[:3])),
                    ft.Sources(*(t.float() for t in src[:3])))
    chip_smoke.bf16_bars(got, twins, ref16, ref32, f"bf16 256² {mode}")


@pytest.mark.parametrize("side", [16, 130])
def test_damped_smoother_takes_a_batch(cuda, side):
    """K1's damped sweeps (the multigrid smoother) on a batch of three
    grids: the launches of one grid for the batch, equal to each grid
    smoothed alone and to ``ops.multigrid._smooth`` on the batch, bit for
    bit.  On K1-damp a 2-sweep smooth is one launch and the 40-sweep solve
    seven launches on 16-row tiles at 130² (6 sweeps a launch) and one
    whole-grid launch at 16² (``cuda_ops.damped_plan``), where the
    per-sweep damped K1 took one a sweep; so the check counts
    ``jacobi_sweeps_damp`` launches where it counted ``jacobi_sweep_damp``
    ones, which stay 0."""
    from fluidsimulationcuda_torch.ops.multigrid import _smooth

    gen = torch.Generator().manual_seed(5)
    p, div = (torch.rand(3, side, side, generator=gen).to(cuda)
              for _ in range(2))
    for sweeps, zero in ((2, False), (40, True)):
        cuda_ops.reset_launch_counts()
        got = cuda_ops.mg_smooth(p, div, sweeps, zero)
        per_launch = cuda_ops.damped_plan(side, sweeps, 3).per_launch
        assert cuda_ops.launch_counts()["jacobi_sweeps_damp"] == -(
            -sweeps // per_launch)
        assert cuda_ops.launch_counts()["jacobi_sweep_damp"] == 0
        assert torch.equal(got, _smooth(p, div, sweeps, zero))
        for g in range(3):
            assert torch.equal(got[g], cuda_ops.mg_smooth(p[g], div[g],
                                                          sweeps, zero))


@pytest.mark.parametrize("cycles,damped", [(2, 60), (1, 30)])
def test_multigrid_step_2048_on_k1_damp_equals_reference(cuda, cycles,
                                                         damped):
    """The multigrid step at 2048² (Jacobi-20 diffusion), two cycles and
    one: 60 and 30 K1-damp launches a step (one a smooth on each of the 7
    levels, one for the coarsest 16² level's 40 sweeps; 272 and 136
    per-sweep launches before), none of the per-sweep damped K1, and the
    ``reference`` backend's state bit for bit."""
    cfg = ft.SimConfig(n=2046, jacobi_iters=20, backend="cuda", device=cuda,
                       pressure_solver="multigrid", mg_cycles=cycles)
    state, src = ft.reference_init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.step(cfg, state, src)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    assert counts["jacobi_sweeps_damp"] == damped, counts
    assert counts["jacobi_sweep_damp"] == 0, counts
    want = ft.step(cfg.replace(backend="reference"), state, src)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("solver", ["multigrid", "cg"])
def test_batched_solver_step_on_the_card(cuda, solver):
    """The multigrid and CG steps on a batch of three 128² grids: the
    launches of one grid (K1's damped sweep takes the batch), every grid
    within the parity bar of its own step (the batched GEMMs and reductions
    may sum in another order than one grid's), and the batch held to the
    ``reference`` backend."""
    import chip_smoke

    cfg = ft.SimConfig(n=126, jacobi_iters=20, backend="cuda", device=cuda,
                       pressure_solver=solver)
    state, src = ft.batched_init(torch.Generator(device=cuda).manual_seed(0),
                                 cfg, 3)
    cuda_ops.reset_launch_counts()
    got = ft.step(cfg, state, src)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches(cfg)}
    for g in range(3):
        one = ft.step(cfg, ft.FluidState(*(t[g] for t in state[:3])),
                      ft.Sources(*(t[g] for t in src[:3])))
        for a, b in zip(got[:3], one[:3]):
            torch.testing.assert_close(a[g], b, rtol=1e-5, atol=2e-5)
    want = ft.step(cfg.replace(backend="reference"), state, src)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("side,batch", [(34, 0), (66, 3), (130, 0),
                                        (217, 0)])
def test_tiled_k1_matches_plain_and_per_sweep_chain(cuda, side, batch, bf16):
    """The tiled K1 in every call with a K1 solve in it
    (``checks.k1_checks``) against its plain version and against the same
    call on the per-sweep K1, bit for bit; at 217, with 5 or 10 sweeps a
    launch, the last row or column of tiles holds only the grid's last
    ghost line (the halo is one cell deeper there)."""
    for chain in (False, True):
        for check in checks.k1_checks(side, cuda, seed=side, batch=batch,
                                      bf16=bf16, chain=chain):
            got, want = check.run(), check.plain()
            torch.cuda.synchronize()
            assert checks.max_abs_diff(got, want) == 0.0, check.label


@pytest.mark.parametrize("per_launch", [1, 2, 3, 7, 10, 20])
def test_tiled_k1_at_any_sweeps_per_launch(cuda, per_launch):
    """Every T the tiled K1 takes (1 to its kMaxSweeps, 20) gives the
    per-sweep chain's result, in the modes of a solve, at 2048² (a
    Chebyshev+fast and a folded solve); a launch of 21 sweeps is refused."""
    t = checks._Inputs(2048, cuda, 0)
    av = t.a_visc
    for kw, iters in ((dict(src_dt=checks.DT), 20),
                      (dict(src_dt=checks.DT, fast=True, cheby_rho=0.9), 10),
                      (dict(zero_init=True), 20)):
        args = (1, t.src, t.x0, av, 1 + 4 * av, iters)
        with cuda_ops.launch_sweeps(per_launch):
            cuda_ops.reset_launch_counts()
            got = cuda_ops.fused_jacobi(*args, **kw)
            assert cuda_ops.launch_counts()["jacobi_sweeps"] == \
                -(-iters // per_launch)
        with cuda_ops.launch_sweeps(0):
            want = cuda_ops.fused_jacobi(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kw, per_launch)
    with cuda_ops.launch_sweeps(21), pytest.raises(RuntimeError,
                                                   match="jacobi_sweeps"):
        cuda_ops.fused_jacobi(*args[:-1], 21, zero_init=True)


BLOCK_MESHES = [(2048, 2, 4), (66, 3, 3), (64, 1, 8)]


@pytest.mark.parametrize("side,px,py", BLOCK_MESHES,
                         ids=[f"{s}-{a}x{b}" for s, a, b in BLOCK_MESHES])
def test_block_forms_match_plain(cuda, side, px, py):
    """K9-block, K12-block, K10-block and K11-block against their plain
    twins on a corner, an edge, an interior and the far corner block: bit
    for bit, the fast forms within ``checks.TOL``."""
    for check in checks.kernel_checks_block(side, side // px, side // py,
                                            cuda, seed=side):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = cuda_ops.launch_counts()
        want = check.plain()
        torch.cuda.synchronize()
        assert counts[check.kernels[0]] == 1, (check.label, counts)
        err = checks.max_abs_diff(got, want)
        tol = checks.TOL if "fast" in check.label else 0.0
        assert err <= tol, (check.label, err)


def test_block_step_2048_exact_equals_single_device(cuda):
    """The 2048² exact block step on (2, 4) blocks equals
    ``StableFluids2D.step`` bit for bit over 3 steps, past the window (the
    impulse moves the backtrace ~20 cells), with the launches
    ``chip_smoke.expected_launches_blocks`` counts."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_blocks, unshard)

    cfg = ft.SimConfig(n=2046, jacobi_iters=20, backend="cuda", device=cuda)
    mesh = make_mesh([torch.device("cuda", 0)] * 8, shape=(2, 4))
    step = make_sharded_step_fn(cfg, mesh, advect_mode="exact",
                                shard_backend="reference", audited=True)
    state0, src = ft.reference_init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    zeros = shard_blocks(ft.zero_sources(cfg), mesh)
    state, sources = shard_blocks(state0, mesh), shard_blocks(src, mesh)
    states, disps = [], []
    cuda_ops.reset_launch_counts()
    for k in range(3):
        state, disp = step(state, sources if k == 0 else zeros)
        states.append(unshard(state, mesh))
        disps.append(float(disp))
    per_step = chip_smoke.expected_launches_blocks(cfg, 2, 4, True)
    assert cuda_ops.launch_counts() == {
        k: 3 * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    assert max(disps) > cfg.max_courant
    sim = ft.StableFluids2D(cfg)
    single = state0
    for k, got in enumerate(states):
        single = sim.step(single, src) if k == 0 else sim.step(single)
        for a, b in zip(got[:3], single[:3]):
            assert torch.equal(a, b), f"step {k + 1}"


@pytest.mark.parametrize("side,px,py", BLOCK_MESHES,
                         ids=[f"{s}-{a}x{b}" for s, a, b in BLOCK_MESHES])
def test_block_bf16_forms_match_plain(cuda, side, px, py):
    """The bf16 forms of K9-block, K12-block, K10-block and K11-block
    against their plain twins (float32 arithmetic, a bf16 rounding where
    the kernel stores) on a corner, an edge, an interior and the far corner
    block: bit for bit, the fast forms within ``checks.TOL``; each call
    launches its bf16 form once and nothing else, and returns bf16."""
    for check in checks.kernel_checks_block(side, side // px, side // py,
                                            cuda, seed=side, bf16=True):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = {k: c for k, c in cuda_ops.launch_counts().items() if c}
        want = check.plain()
        torch.cuda.synchronize()
        assert counts == {check.kernels[0]: 1}, (check.label, counts)
        assert check.kernels[0].endswith("_bf16"), check.label
        for g in (got if isinstance(got, tuple) else (got,)):
            assert g.dtype == torch.bfloat16, check.label
        err = checks.max_abs_diff(got, want)
        tol = checks.TOL if "fast" in check.label else 0.0
        assert err <= tol, (check.label, err)


BF16_BLOCK_STEPS = {
    "parity": dict(),
    "compensated-fast": dict(PERF, fast_math=True),
    "multigrid": dict(pressure_solver="multigrid", mg_cycles=2),
    "cg": dict(pressure_solver="cg", cg_iters=20),
}


@pytest.mark.parametrize("mode", list(BF16_BLOCK_STEPS))
def test_block_bf16_step_launches_only_bf16_forms(cuda, mode):
    """The bf16 block step at 2048² on (2, 4) blocks (exact, 2 steps)
    launches only the bf16 forms (``chip_smoke.expected_launches_blocks``:
    every float32 block form at 0), stays bf16 and finite, and equals the
    plain twins' step (``_BlockStep(..., plain=True)``) bit for bit."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_blocks, unshard)
    from fluidsimulationcuda_torch.parallel.sharded import _BlockStep

    cfg = ft.SimConfig(n=2046, jacobi_iters=20, backend="cuda", device=cuda,
                       dtype=torch.bfloat16, **BF16_BLOCK_STEPS[mode])
    mesh = make_mesh([torch.device("cuda", 0)] * 8, shape=(2, 4))
    step = make_sharded_step_fn(cfg, mesh, advect_mode="exact")
    assert step.layout == "blocks"
    state0, src = ft.reference_init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    state, sources, zeros = (shard_blocks(t, mesh) for t in
                             (state0, src, ft.zero_sources(cfg)))
    twins = _BlockStep(cfg, mesh, False, True, plain=True)
    cuda_ops.reset_launch_counts()
    got, want = state, state
    for k in range(2):
        got = step(got, sources if k == 0 else zeros)
    counts = cuda_ops.launch_counts()
    for k in range(2):
        want = twins(want, sources if k == 0 else zeros)
    per_step = chip_smoke.expected_launches_blocks(cfg, 2, 4, True)
    assert all(k.endswith("_bf16") for k, c in per_step.items() if c)
    assert counts == {k: 2 * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    for a, b in zip(unshard(got, mesh)[:3], unshard(want, mesh)[:3]):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


@pytest.mark.parametrize("side,batch", [(16, 0), (130, 3), (2048, 0)])
def test_damped_bf16_rhs_forms_match_plain(cuda, side, batch):
    """K1-damp's bf16-rhs forms (``checks.kernel_checks_damp(bf16=True)``:
    2-sweep smooths from zero and from a float32 guess, 40-sweep solves
    from zero and from a bf16 guess) against their plain twin
    ``cuda_ops.mg_smooth_plain``, bit for bit, counted as
    ``jacobi_sweeps_damp_bf16`` alone; the per-sweep damped route refuses
    them."""
    for check in checks.kernel_checks_damp(side, cuda, side, batch,
                                           bf16=True):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = {k: c for k, c in cuda_ops.launch_counts().items() if c}
        want = check.plain()
        torch.cuda.synchronize()
        assert set(counts) == {"jacobi_sweeps_damp_bf16"}, (check.label,
                                                           counts)
        assert got.dtype == want.dtype and torch.equal(got, want), check.label
    x, div = (torch.rand(side, side, device=cuda) for _ in range(2))
    with pytest.raises(TypeError), cuda_ops.smooth_launches(0):
        cuda_ops.mg_smooth(x, div.to(torch.bfloat16), 2)


@pytest.mark.parametrize("solver", ["multigrid", "cg"])
def test_bf16_solver_step_2048_launches_and_matches_plain(cuda, solver):
    """The bf16 multigrid (two cycles) and CG-20 steps at 2048²: the
    launches ``chip_smoke.expected_launches`` counts (8 of K1-damp's
    bf16-rhs forms a multigrid step, 52 of its float32 form), every field
    bf16, held by ``chip_smoke.bf16_bars`` to the ``cuda`` OpSet's plain
    twins bit for bit and to the float32 step from the same bf16 draw."""
    import chip_smoke

    cfg = ft.SimConfig(n=2046, jacobi_iters=20, backend="cuda", device=cuda,
                       dtype=torch.bfloat16, pressure_solver=solver,
                       mg_cycles=2, cg_iters=20)
    state, src = ft.reference_init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.step(cfg, state, src)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    assert counts == {**dict.fromkeys(cuda_ops.KERNELS, 0),
                      **chip_smoke.expected_launches(cfg)}
    assert counts["jacobi_sweeps_damp_bf16"] == (8 if solver == "multigrid"
                                                 else 0)
    assert all(f.dtype == torch.bfloat16 for f in got[:3])
    twins = ft.step(cfg, state, src, cuda_ops.make_opset(cfg, plain=True))
    ref16 = ft.step(cfg.replace(backend="reference"), state, src)
    ref32 = ft.step(cfg.replace(dtype=torch.float32),
                    ft.FluidState(*(t.float() for t in state[:3])),
                    ft.Sources(*(t.float() for t in src[:3])))
    chip_smoke.bf16_bars(got, twins, ref16, ref32, f"bf16 2048² {solver}")


@pytest.mark.parametrize("side", [34, 66])
def test_bf16_3d_forms_match_plain(cuda, side):
    """The bf16 forms of K5 (per-sweep and tiled), K6 (exact and windowed),
    K7 and K8 against their plain twins (``checks.kernel_checks3_bf16``),
    bit for bit, each launching only its bf16 forms; every tiled call also
    against the same call on the per-sweep K5's bf16 form."""
    forms = checks.kernel_checks3_bf16(side, cuda, seed=side)
    for check in forms:
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = {k: c for k, c in cuda_ops.launch_counts().items() if c}
        want = check.plain()
        torch.cuda.synchronize()
        assert set(counts) == set(check.kernels), (check.label, counts)
        assert checks.max_abs_diff(got, want) == 0.0, check.label
    for check in checks.per_sweep_checks(forms):
        assert checks.max_abs_diff(check.run(), check.plain()) == 0.0, \
            check.label


BF16_STEPS3 = {"parity": {}, "compensated fast": dict(COMP3, fast_math=True),
               "windowed": dict(advect_mode="windowed")}


@pytest.mark.parametrize("mode", list(BF16_STEPS3))
def test_bf16_step3_launches_and_matches_plain(cuda, mode):
    """The bf16 3-D step at 64³: the launches
    ``chip_smoke.expected_launches3`` counts (K5's bf16 forms for the diffusions, its float32 forms for the
    pressure solves, K6-K8's bf16 forms), every field bf16, held by
    ``chip_smoke.bf16_bars`` to the plain twins' step (``_Ops3(cfg,
    plain=True)``) bit for bit and to the float32 step from the same bf16
    draw."""
    import chip_smoke
    from fluidsimulationcuda_torch.models.stable_fluids_3d import _Ops3

    cfg = ft.SimConfig(n=62, ndim=3, jacobi_iters=20, backend="cuda",
                       device=cuda, dtype=torch.bfloat16, **BF16_STEPS3[mode])
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cuda_ops.reset_launch_counts()
    got = ft.StableFluids3D(cfg).step(state, src)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0),
        **chip_smoke.expected_launches3(cfg)}
    assert all(f.dtype == torch.bfloat16 for f in got)
    twins = ft.step3(cfg, state, src, _Ops3(cfg, plain=True))
    ref16 = ft.step3(cfg.replace(backend="reference"), state, src)
    ref32 = ft.step3(cfg.replace(dtype=torch.float32),
                     ft.FluidState(*(t.float() for t in state)),
                     ft.Sources(*(t.float() for t in src)))
    chip_smoke.bf16_bars(got, twins, ref16, ref32, f"bf16 64³ {mode}")


def test_bf16_3d_kernels_refuse_other_operands(cuda):
    """K8's bf16 form reads a float32 pressure only; the tiled K5's bf16
    form refuses x and x_{k-1} both bf16 (no solve reads its guess as
    both)."""
    from fluidsimulationcuda_torch.kernels import build

    vol = torch.zeros((18,) * 3, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        cuda_ops_3d.gradient3_p(vol, vol, vol, vol, 16)
    omegas = (ctypes.c_float * 1)(1.0)
    err = build.load().fsc_jacobi3_sweeps_bf16(
        vol.data_ptr(), vol.data_ptr(), None, vol.data_ptr(), vol.data_ptr(),
        None, None, 18, 0, 1.0, 6.0, 1 / 6, 1 / 6, 0.0,
        ctypes.addressof(omegas), 6, 1, 1, 3,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.parametrize("side,mz", [(34, 17), (66, 22)])
def test_bf16_slab3_forms_match_plain(cuda, side, mz):
    """The bf16 forms of K13 (per-sweep and the tiled slab walk), K14
    (windowed and exact), K15 and K16 against their plain twins on top,
    interior and bottom slabs (``checks.kernel_checks_slab3_bf16``), bit
    for bit and in the twin's dtype, each launching only its bf16 forms;
    every tiled call also against the same call on the per-sweep K13's
    bf16 form."""
    forms = checks.kernel_checks_slab3_bf16(side, mz, cuda, seed=side)
    for check in forms:
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = {k: c for k, c in cuda_ops.launch_counts().items() if c}
        want = check.plain()
        torch.cuda.synchronize()
        assert set(counts) == set(check.kernels), (check.label, counts)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert g.dtype == w.dtype, check.label
        assert checks.max_abs_diff(got, want) == 0.0, check.label
    for check in checks.per_sweep_checks(forms):
        assert checks.max_abs_diff(check.run(), check.plain()) == 0.0, \
            check.label


BF16_ZSLAB_STEPS = {"parity windowed": ({}, "auto"),
                    "parity exact": ({}, "exact"),
                    "compensated fast": (dict(COMP3, fast_math=True), "auto")}


@pytest.mark.parametrize("mode", list(BF16_ZSLAB_STEPS))
def test_bf16_zslab_step_256_launches_only_bf16_forms(cuda, mode):
    """The bf16 z-slab step at 256³ on 8 slabs of one card: the launches
    ``chip_smoke.expected_launches_sharded3`` counts, every one a bf16 form
    but the pressure solves' float32 K13, every field bf16, equal to the
    plain twins' z-slab step (``_ZSlabStep(..., plain=True)``) bit for
    bit; the exact run also to the single-device bf16 step."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (
        make_mesh, make_sharded_step_fn_3d, shard_state_3d, unshard)
    from fluidsimulationcuda_torch.parallel.sharded3d import _ZSlabStep

    kw, advect_mode = BF16_ZSLAB_STEPS[mode]
    cfg = ft.SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                       device=cuda, dtype=torch.bfloat16, **kw)
    mesh = make_mesh([torch.device(cuda)] * 8)
    step = make_sharded_step_fn_3d(cfg, mesh, advect_mode=advect_mode)
    exact = step.advect_mode == "exact"
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    cut = [shard_state_3d(t, mesh) for t in (state, src)]
    cuda_ops.reset_launch_counts()
    got = unshard(step(*cut))
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    assert counts == {**dict.fromkeys(cuda_ops.KERNELS, 0),
                      **chip_smoke.expected_launches_sharded3(cfg, 8, exact)}
    assert {k for k, c in counts.items() if c and not k.endswith("_bf16")} \
        <= {"jacobi3_slab", "jacobi3_slab_sweeps"}
    assert all(f.dtype == torch.bfloat16 for f in got)
    twins = unshard(_ZSlabStep(cfg, mesh.reshape(8, 1), False, exact,
                               plain=True)(*cut))
    for a, b in zip(got, twins):
        assert torch.equal(a, b)
    if exact:
        for a, b in zip(got, ft.step3(cfg, state, src)):
            assert torch.equal(a, b)


def _widths_and_result(run, kernel, widths=None):
    """``run()`` in the path's widths (or inside ``vector_widths(widths)``):
    (its result, its launches of ``kernel`` by width)."""
    forced = (contextlib.nullcontext() if widths is None
              else cuda_ops.vector_widths(widths))
    with forced:
        cuda_ops.reset_width_counts()
        got = run()
        torch.cuda.synchronize()
        return got, cuda_ops.width_counts()[kernel]


@pytest.mark.parametrize("mz", [0, 32, 8],
                         ids=["256³", "8 z-slabs of 256³",
                              "32 z-slabs of 256³"])
def test_bf16_per_sweep_3d_vector_form_equals_one_cell(cuda, mz):
    """Every call of ``checks.kernel_checks3_bf16`` (256³) or
    ``kernel_checks_slab3_bf16`` (top, interior and bottom slabs of ``mz``
    planes of 256³) whose solves take the per-sweep K5 or K13's bf16 form:
    every launch in the vector form (width 4, ``cuda_ops.width_counts``),
    bit for bit with the same call in the one-cell form
    (``vector_widths((1,))``)."""
    if mz:
        forms = checks.kernel_checks_slab3_bf16(256, mz, cuda, seed=mz)
        kernel = "jacobi3_slab_bf16"
    else:
        forms = checks.kernel_checks3_bf16(256, cuda, seed=0)
        kernel = "jacobi3_sweep_bf16"
    calls = [c for c in forms if c.kernels == (kernel,)]
    assert len(calls) >= 19
    for check in calls:
        got, widths = _widths_and_result(check.run, kernel)
        want, one_cell = _widths_and_result(check.run, kernel, (1,))
        assert widths[1] == 0 and widths[4] > 0, (check.label, widths)
        assert one_cell == {4: 0, 1: widths[4]}, (check.label, one_cell)
        for g, w in zip(checks._as_tuple(got), checks._as_tuple(want)):
            assert g.dtype == w.dtype and torch.equal(g, w), check.label


@pytest.mark.parametrize("slabs", [0, 8, 32])
def test_bf16_step3_256_takes_the_vector_form(cuda, slabs):
    """The bf16 3-D steps at 256³ (parity on one volume and on 8 z-slabs,
    compensated with fast math on 32 z-slabs of 8 planes, whose segments
    keep the per-sweep K13): the launches ``chip_smoke`` counts (80 and
    640 per-sweep bf16 launches a parity step), every per-sweep bf16
    launch at width 4, the state bit for bit with the one-cell form's."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (
        make_mesh, make_sharded_step_fn_3d, shard_state_3d, unshard)

    kw = dict(COMP3, fast_math=True) if slabs == 32 else {}
    cfg = ft.SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                       device=cuda, dtype=torch.bfloat16, **kw)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    if slabs:
        mesh = make_mesh([torch.device(cuda)] * slabs)
        step = make_sharded_step_fn_3d(cfg, mesh)
        cut = [shard_state_3d(t, mesh) for t in (state, src)]
        want_counts = chip_smoke.expected_launches_sharded3(
            cfg, slabs, step.advect_mode == "exact")
        kernel = "jacobi3_slab_bf16"

        def run():
            return unshard(step(*cut))
    else:
        want_counts = chip_smoke.expected_launches3(cfg)
        kernel = "jacobi3_sweep_bf16"

        def run():
            return ft.StableFluids3D(cfg).step(state, src)
    if slabs != 32:
        assert want_counts[kernel] == (640 if slabs else 80)
    cuda_ops.reset_launch_counts()
    got, widths = _widths_and_result(run, kernel)
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0), **want_counts}
    assert widths == {4: want_counts[kernel], 1: 0}
    want, _ = _widths_and_result(run, kernel, (1,))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mz", [0, 32, 8],
                         ids=["256³", "8 z-slabs of 256³",
                              "32 z-slabs of 256³"])
def test_float32_per_sweep_3d_walk_equals_one_cell(cuda, mz):
    """Every call of ``checks.kernel_checks3`` (256³) or
    ``kernel_checks_slab3`` (top, interior and bottom slabs of ``mz``
    planes of 256³) whose solves take the float32 per-sweep K5 or K13 (the
    fast Chebyshev ones too, ``cuda_ops.tiled3``): every launch in the
    vector walk (width 4, ``cuda_ops.width_counts``), bit for bit with the
    same call in the one-cell form (``vector_widths((1,))``), and within
    ``checks.TOL`` of its plain twin (bit for bit outside fast mode)."""
    if mz:
        forms = checks.kernel_checks_slab3(256, mz, cuda, seed=mz)
        kernel = "jacobi3_slab"
    else:
        forms = checks.kernel_checks3(256, cuda, seed=0)
        kernel = "jacobi3_sweep"
    calls = [c for c in forms if c.kernels == (kernel,)]
    assert len(calls) >= 12
    for check in calls:
        got, widths = _widths_and_result(check.run, kernel)
        want, one_cell = _widths_and_result(check.run, kernel, (1,))
        assert widths[1] == 0 and widths[4] > 0, (check.label, widths)
        assert one_cell == {4: 0, 1: widths[4]}, (check.label, one_cell)
        for g, w in zip(checks._as_tuple(got), checks._as_tuple(want)):
            assert torch.equal(g, w), check.label
        tol = checks.TOL if "fast" in check.label else 0.0
        assert checks.max_abs_diff(got, check.plain()) <= tol, check.label


F32_STEPS3 = {"parity": (0, {}), "parity, 8 z-slabs": (8, {}),
              "compensated": (0, COMP3),
              "compensated fast, 32 z-slabs": (32, dict(COMP3,
                                                        fast_math=True))}


@pytest.mark.parametrize("mode", list(F32_STEPS3))
def test_float32_step3_256_takes_the_walk(cuda, mode):
    """The float32 3-D steps at 256³ (parity on one volume and on 8
    z-slabs, compensated, compensated with fast math on 32 z-slabs of 8
    planes): the launches ``chip_smoke`` counts (120 per-sweep K5 launches
    a parity step, 960 K13 on 8 z-slabs; the fast Chebyshev solves on the
    per-sweep kernels, ``cuda_ops.tiled3``), every per-sweep launch at
    width 4, the state bit for bit with the one-cell form's and, outside
    fast math, with the ``reference`` backend's (ROADMAP §C)."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import (
        make_mesh, make_sharded_step_fn_3d, shard_state_3d, unshard)

    slabs, kw = F32_STEPS3[mode]
    cfg = ft.SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                       device=cuda, **kw)
    state, src = ft.reference_init(torch.Generator().manual_seed(0), cfg)
    if slabs:
        mesh = make_mesh([torch.device(cuda)] * slabs)
        cut = [shard_state_3d(t, mesh) for t in (state, src)]
        want_counts = chip_smoke.expected_launches_sharded3(
            cfg, slabs, make_sharded_step_fn_3d(cfg, mesh).advect_mode
            == "exact")
        kernel = "jacobi3_slab"

        def run(c=cfg):
            return unshard(make_sharded_step_fn_3d(c, mesh)(*cut))
    else:
        want_counts = chip_smoke.expected_launches3(cfg)
        kernel = "jacobi3_sweep"

        def run(c=cfg):
            return ft.step3(c, state, src)
    if mode.startswith("parity"):
        assert want_counts[kernel] == (960 if slabs else 120)
    assert not want_counts.get("jacobi3_sweeps") and not want_counts.get(
        "jacobi3_slab_sweeps")
    cuda_ops.reset_launch_counts()
    got, widths = _widths_and_result(run, kernel)
    assert cuda_ops.launch_counts() == {
        **dict.fromkeys(cuda_ops.KERNELS, 0), **want_counts}
    assert widths == {4: want_counts[kernel], 1: 0}
    one_cell, _ = _widths_and_result(run, kernel, (1,))
    for a, b in zip(got, one_cell):
        assert torch.equal(a, b)
    if not cfg.fast_math:
        for a, b in zip(got, run(cfg.replace(backend="reference"))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("side,px,py", [(512, 2, 4), (512, 64, 1),
                                        (1024, 2, 2)])
def test_block_group_matches_per_block_and_plain(cuda, side, px, py, bf16):
    """The grouped K9-block over every block of the mesh in each form, one
    launch: against the per-block K9-block on ``Blocks.ext``'s buffers
    bit for bit, against its plain twin bit for bit (the fast forms
    within ``checks.TOL``), in the storage dtype."""
    for check in checks.kernel_checks_block_group(side, px, py, cuda,
                                                  seed=side, bf16=bf16):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = {k: c for k, c in cuda_ops.launch_counts().items() if c}
        want = check.plain()
        torch.cuda.synchronize()
        assert counts == {check.kernels[0]: 1}, (check.label, counts)
        for g in got:
            assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        err = checks.max_abs_diff(got, want)
        loose = "fast" in check.label and "vs per-block" not in check.label
        assert err <= (checks.TOL if loose else 0.0), (check.label, err)


def test_block_group_refuses_what_the_path_library_lacks(cuda):
    """The library builds the grouped K9-block on 32 and 64 rows of 128
    columns: the 128- and 16-row tiles that were timed and not kept are
    refused through ``_launch``."""
    from fluidsimulationcuda_torch.kernels import cuda_sharded as cs

    t, blocks, xs, rhs, xms = checks._group_inputs(256, 2, 2, cuda, 0,
                                                   False)
    for rows in (128, 16):
        with cuda_ops.launch_sweeps(8, tile_rows=rows):
            with pytest.raises(RuntimeError, match="failed to launch"):
                cs.fused_jacobi_blocks(blocks, 1, xs, rhs, n=t.n, K=8,
                                       alpha=0.3, beta=2.2, sweeps=8)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("side,px,py", [(512, 2, 4), (256, 64, 1),
                                        (66, 3, 3), (1024, 2, 2)])
def test_block_stencil_group_matches_per_block_and_plain(cuda, side, px, py,
                                                         bf16):
    """The grouped K11-block and K12-block over every block of the mesh in
    each form (``checks.kernel_checks_block_stencil_group``: the gradient,
    windowed and exact gathers of the pair and the density), one launch:
    against the per-block kernels on ``Blocks.halos``', ``ext``'s or
    ``gather``'s buffers and against the plain twins, bit for bit, in the
    storage dtype, at the width ``cuda_ops.VECTOR_WIDTHS`` gives it (the
    narrower one on the 22-cell blocks of (3, 3))."""
    for check in checks.kernel_checks_block_stencil_group(
            side, px, py, cuda, seed=side, bf16=bf16):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = {k: c for k, c in cuda_ops.launch_counts().items() if c}
        want = check.plain()
        torch.cuda.synchronize()
        assert counts == {check.kernels[0]: 1}, (check.label, counts)
        for g in got:
            assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert checks.max_abs_diff(got, want) == 0.0, check.label


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_block_stencil_group_every_kept_width(cuda, bf16):
    """Each width the library keeps for the grouped K11-block and K12-block
    (``VECTOR_WIDTHS`` and the one-cell form) gives the plain twin's bits
    over the (2, 4) blocks of 256², counted by width; a width it does not
    keep (the float32 gradient's 4, every form's 8 but the bf16
    gradient's) raises through ``_launch``."""
    t, blocks, _, _, ps = checks._group_inputs(256, 2, 4, cuda, 0, bf16)
    us, vs = (list(blocks.cut(f)) for f in (t.u, t.v))
    tag = "_bf16" if bf16 else ""
    for mode, form in checks.BLOCK_STENCIL_FORMS.items():
        args = (form, blocks, us, vs, ps, t.n)
        name = checks._stencil_name(form, tag)
        want = checks.block_stencil("plain", *args)
        for width in cuda_ops.VECTOR_WIDTHS[name] + (1,):
            cuda_ops.reset_width_counts()
            with cuda_ops.vector_widths((width,)):
                got = checks.block_stencil("group", *args)
            torch.cuda.synchronize()
            assert cuda_ops.width_counts()[name][width] == 1, (mode, width)
            assert checks.max_abs_diff(got, want) == 0.0, (mode, width)
        refused = 8 if name != "gradient_block_group_bf16" else 16
        with cuda_ops.vector_widths((refused,)):
            with pytest.raises(RuntimeError, match="failed to launch"):
                checks.block_stencil("group", *args)


def test_block_step_on_the_grouped_stencils_equals_per_block(cuda):
    """The 2048² exact and windowed block steps on (2, 4) blocks, float32
    and bf16, on the grouped K11-block and K12-block equal the same steps
    on the per-block kernels (``gradient_group`` and ``advect_group`` set
    to None) bit for bit over 2 steps, with one grouped gradient a
    projection and one grouped gather a gather."""
    from fluidsimulationcuda_torch.parallel import make_mesh, shard_blocks
    from fluidsimulationcuda_torch.parallel.sharded import _BlockStep

    mesh = make_mesh([torch.device("cuda", 0)] * 8, shape=(2, 4))
    for dtype in (torch.float32, torch.bfloat16):
        cfg = ft.SimConfig(n=2046, jacobi_iters=20, backend="cuda",
                           device=cuda, dtype=dtype)
        state0, src = ft.reference_init(
            torch.Generator(device=cuda).manual_seed(0),
            cfg.replace(dtype=torch.float32))
        state0 = ft.FluidState(*(x.to(dtype) for x in state0[:3]))
        src = ft.Sources(*(x.to(dtype) for x in src[:3]))
        tag = "_bf16" if dtype == torch.bfloat16 else ""
        for exact in (True, False):
            grouped = _BlockStep(cfg, mesh, False, exact)
            per_block = _BlockStep(cfg, mesh, False, exact)
            per_block.ops = per_block.ops._replace(gradient_group=None,
                                                   advect_group=None)
            zeros = shard_blocks(ft.zero_sources(cfg), mesh)
            got = want = shard_blocks(state0, mesh)
            cuda_ops.reset_launch_counts()
            for k in range(2):
                got = grouped(got, shard_blocks(src, mesh) if k == 0
                              else zeros)
            counts = cuda_ops.launch_counts()
            for k in range(2):
                want = per_block(want, shard_blocks(src, mesh) if k == 0
                                 else zeros)
            gather = "advect_block_group" + ("_exact" if exact else "")
            assert counts[f"gradient_block_group{tag}"] == 4
            assert counts[gather + tag] == 4
            assert counts[f"gradient_block{tag}"] == 0
            for a, b in zip(got[:3], want[:3]):
                for x, y in zip(a, b):
                    assert torch.equal(x, y)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("side,mz", [(64, 16), (66, 6), (64, 4)])
def test_advect3_group_matches_per_slab_and_plain(cuda, side, mz, bf16):
    """The grouped K14 over every z-slab, windowed and exact, one field and
    the triple, one launch: against the per-slab K14 on ``_ext``'s or
    ``_gather``'s buffers and against its plain twin, bit for bit, in the
    storage dtype (66³: rows the vector form cannot take)."""
    for check in checks.kernel_checks_advect3_group(side, mz, cuda,
                                                    seed=side, bf16=bf16):
        cuda_ops.reset_launch_counts()
        got = check.run()
        counts = {k: c for k, c in cuda_ops.launch_counts().items() if c}
        want = check.plain()
        torch.cuda.synchronize()
        assert counts == {check.kernels[0]: 1}, (check.label, counts)
        for g in got:
            assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert checks.max_abs_diff(got, want) == 0.0, check.label


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("side", [64, 66])
def test_k6_equals_grouped_k14_and_one_cell_k14(cuda, side, bf16):
    """K6 (its bf16 form on the gather body) against the grouped K14 over
    one slab of the volume and the one-cell K14 on the volume, bit for
    bit, exact and windowed."""
    for check in checks.kernel_checks_k6_body(side, cuda, seed=side,
                                              bf16=bf16):
        got, want = check.run(), check.plain()
        torch.cuda.synchronize()
        assert checks.max_abs_diff(got, want) == 0.0, check.label


def test_zslab_step_256_gathers_grouped_and_per_slab_alike(cuda):
    """The 256³ z-slab step on 8 slabs, windowed and exact, float32 and
    bf16: two grouped K14 launches a step, and the step bit for bit the
    same step on the per-slab K14."""
    from fluidsimulationcuda_torch.parallel import make_mesh, shard_state_3d
    from fluidsimulationcuda_torch.parallel.sharded3d import _ZSlabStep

    mesh = make_mesh([cuda] * 8).reshape(8, 1)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = ft.SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                           device=cuda, dtype=dtype)
        state, src = ft.reference_init(torch.Generator(cuda).manual_seed(0),
                                       cfg)
        state, src = (shard_state_3d(x, mesh) for x in (state, src))
        for exact in (False, True):
            grouped = _ZSlabStep(cfg, mesh, False, exact)
            per = _ZSlabStep(cfg, mesh, False, exact)
            per.ops = per.ops._replace(advect_group=None)
            cuda_ops.reset_launch_counts()
            a = grouped(state, src)
            counts = cuda_ops.launch_counts()
            name = ("advect3_group" + ("_exact" if exact else "")
                    + ("_bf16" if dtype == torch.bfloat16 else ""))
            assert counts[name] == 2
            b = per(state, src)
            for fa, fb in zip(a, b):
                for x, y in zip(fa, fb):
                    assert torch.equal(x, y)


def test_bf16_block_cg20_divergence_follows_its_diffusion(cuda):
    """The recorded bf16 block CG-20 gap (ROADMAP §C): at 2048² on (2, 4)
    blocks the card's bf16 step, whose diffusions round once a chunk,
    leaves its diffused impulse velocity with float32's max|div| to 1%, and
    after the first projection a max|div| within 15% of the ``reference``
    bf16 block step's (which rounds every operation, and lies further from
    float32 before the projection) and of float32's, as phase 20 prints
    them."""
    import chip_smoke
    from fluidsimulationcuda_torch.parallel import make_mesh

    cfg = ft.SimConfig(n=2046, jacobi_iters=20, pressure_solver="cg",
                       cg_iters=20, backend="cuda", device=cuda)
    c16 = cfg.replace(dtype=torch.bfloat16)
    mesh = make_mesh([cuda] * 8, shape=(2, 4))
    state0, sources = ft.reference_init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    draw16 = [ft.FluidState(*(t.to(torch.bfloat16) for t in state0[:3])),
              ft.Sources(*(t.to(torch.bfloat16) for t in sources[:3]))]
    draw32 = [type(t)(*(x.float() for x in t[:3])) for t in draw16]
    card = chip_smoke.block_projection_div(c16, mesh, draw16)
    f32 = chip_smoke.block_projection_div(cfg, mesh, draw32)
    ref = chip_smoke.block_projection_div(c16.replace(backend="reference"),
                                          mesh, draw16)
    assert abs(card[0] / f32[0] - 1) < 0.01, (card, f32)
    assert abs(card[1] / ref[1] - 1) < 0.15, (card, ref)
    assert abs(card[1] / f32[1] - 1) < 0.15, (card, f32)
