"""The grouped K14 (``csrc/advect3_slab.cu``, ``fsc_advect3_group``: the
gather of every z-slab of a device in one launch, each corner read from the
array of the slab that owns its plane) and K6's bf16 form, both on the
gather body of ``csrc/advect3_body.cuh``, behind the host shim of
``dev/rehearse_kernels_cpu.py`` (a CUDA kernel has no interpret mode, so
this file compiles the sources with ``g++ -ffp-contract=off``).

The grouped gather, windowed (cmax 1, 2 and 4) and exact, in float32 and
bf16, of one to three fields, on 2, 4 and 8 slabs of 24³, 6 slabs of 4
planes and 5 slabs of 25³ (odd rows: the one-cell form of the body), on
velocities inside and beyond the window and, exact, departures that cross
several slabs, is held bit for bit against the per-slab K14 on
``mesh._ext``'s and ``mesh._gather``'s buffers (one launch a slab, the top
and bottom slabs holding the wall planes) and against the plain twin; so
too with the slabs split over two launches (their neighbours read from
copies of the planes read, the route of slabs on other devices).  K6's
bf16 form equals its plain twin and the one-cell K14 on the whole volume
(the arithmetic of the kernel it replaced) bit for bit, in both widths.
The ``cuda`` z-slab step through the grouped kernel equals the step on
the per-slab K14 and, with exact gathers, the single-device step, bit for
bit, with ``chip_smoke.expected_launches_sharded3``'s launches; a
gather on one device runs no ``torch.cat``.  Skips only without ``g++``.
"""
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch.kernels import checks, cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops_3d as co3  # noqa: E402
from fluidsimulationcuda_torch.kernels import (  # noqa: E402
    cuda_sharded_3d as cs3)
from fluidsimulationcuda_torch.parallel import (  # noqa: E402
    make_mesh, shard_state_3d, unshard)
from fluidsimulationcuda_torch.parallel.sharded3d import _ZSlabStep  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("advect3.cu", "advect3_slab.cu", "jacobi3.cu", "jacobi3_slab.cu",
           "jacobi3_tiles.cu", "project3.cu", "project3_slab.cu")
DT = checks.DT
BF16 = torch.bfloat16
DTYPES = {"float32": torch.float32, "bf16": BF16}


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
    return mod, mod.build_shim_library(SOURCES, mod.OUT / "advect3_group")


def _run(shim, fn, *args, **kw):
    """fn through the shim library: (result, launch counts)."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib):
        cuda_ops.reset_launch_counts()
        out = fn(*args, **kw)
        return out, {k: c for k, c in cuda_ops.launch_counts().items() if c}


def _same(a, b) -> bool:
    a, b = list(a), list(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for p, q in zip(a, b) for x, y in zip(p, q))


class _Volume:
    """Random fields of a ``side``³ volume cut into ``slabs`` z-slabs, with
    velocities that move a backtrace up to ``reach`` cells."""

    def __init__(self, side: int, slabs: int, reach: float, dtype,
                 seed: int = 0):
        g = torch.Generator().manual_seed(seed)
        self.side, self.slabs, self.mz = side, slabs, side // slabs
        self.n = side - 2
        scale = reach / (DT * self.n)
        self.vel = [((2 * torch.rand((side,) * 3, generator=g) - 1) * scale)
                    .to(dtype) for _ in range(3)]
        self.x = torch.rand((side,) * 3, generator=g).to(dtype)
        self.flags = [(int(i == 0), int(i == slabs - 1), i * self.mz)
                      for i in range(slabs)]

    def cut(self, f):
        return [s.contiguous() for s in f.split(self.mz)]

    def fields(self, count: int):
        """(bs, fields as slab lists) of one, two or three fields: the
        density, then the velocities."""
        vols = ([self.x] + self.vel[:2]) if count < 3 else self.vel
        bs = (0, 1, 2) if count < 3 else (1, 2, 3)
        return bs[:count], [self.cut(f) for f in vols[:count]]


def _grouped(t: _Volume, bs, fields, cmax):
    u, v, w = (t.cut(f) for f in t.vel)
    return cs3.advect3_group(bs, fields, u, v, w, t.flags, dt=DT, n=t.n,
                             cmax=cmax, mz=t.mz)


def _plain(t: _Volume, bs, fields, cmax):
    u, v, w = (t.cut(f) for f in t.vel)
    return cs3.advect3_group_plain(bs, fields, u, v, w, t.flags, dt=DT,
                                   n=t.n, cmax=cmax, mz=t.mz)


def _per_slab(t: _Volume, bs, fields, cmax):
    """JAX's composition on the per-slab K14: ``_ext`` or ``_gather``, then
    one launch a slab."""
    u, v, w = (t.cut(f) for f in t.vel)
    return cs3.advect3_composed(cs3.advect3_flat_slab,
                                cs3.advect3_flat_slab_exact, bs, fields, u, v,
                                w, t.flags, dt=DT, n=t.n, cmax=cmax, mz=t.mz)


# (side, slabs, windows): 24³ on 2, 4 and 8 slabs, 6 slabs of 4 planes,
# 25³ on 5 slabs (odd rows: the body's one-cell form).
MESHES = [(24, 2, (1, 2, 4)), (24, 4, (1, 2, 4)), (24, 8, (1, 2)),
          (24, 6, (1, 2)), (25, 5, (1, 2, 4))]
# Backtrace reach in cells: inside the 1-cell window, inside 4, and beyond
# every window (the exact gather's departures cross several slabs).
REACHES = (0.8, 3.5, 9.0)


def _cases(windows):
    return [None, *windows]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("side,slabs,windows", MESHES,
                         ids=[f"{s}^3-{p}slabs" for s, p, _ in MESHES])
def test_grouped_equals_per_slab_and_plain(shim, side, slabs, windows,
                                           dtype):
    """Every window and the exact gather, one to three fields, every
    reach: one grouped launch, bit for bit the per-slab K14 on the
    extended or assembled buffers (one launch a slab) and the plain
    twin."""
    sfx = "_bf16" if dtype == BF16 else ""
    for reach in REACHES:
        t = _Volume(side, slabs, reach, dtype, seed=slabs)
        for cmax in _cases(windows):
            name = "advect3_group" + ("_exact" if cmax is None else "") + sfx
            per = ("advect3_slab" + ("_exact" if cmax is None else "")
                   + sfx)
            for count in (1, 2, 3):
                bs, fields = t.fields(count)
                got, counts = _run(shim, _grouped, t, bs, fields, cmax)
                assert counts == {name: 1}, (reach, cmax, count)
                want, counts = _run(shim, _per_slab, t, bs, fields, cmax)
                assert counts == {per: slabs}
                assert _same(got, want), (reach, cmax, count)
                assert _same(got, _plain(t, bs, fields, cmax)), (
                    reach, cmax, count)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("split", ["halves", "interleaved", "one each"])
def test_slabs_on_other_devices_read_from_copies(shim, monkeypatch, split,
                                                 dtype):
    """Slabs split over several launches, as slabs on several devices are:
    each launch reads its neighbours from copies of the planes it reads
    (the whole slab where its slabs lie on both sides of it, or for the
    exact gather), and the result stays the plain twin's."""
    t = _Volume(24, 8, 3.5, dtype, seed=5)
    parts = {"halves": [list(range(4)), list(range(4, 8))],
             "interleaved": [[0, 2, 4, 6], [1, 3, 5, 7]],
             "one each": [[i] for i in range(8)]}[split]
    monkeypatch.setattr(cs3, "_device_groups",
                        lambda slabs: [(slabs[0].device, p) for p in parts])
    for cmax in (None, 1, 2):
        bs, fields = t.fields(3)
        got, counts = _run(shim, _grouped, t, bs, fields, cmax)
        assert sum(counts.values()) == len(parts)
        assert _same(got, _plain(t, bs, fields, cmax)), cmax


def test_launches_split_past_the_table(shim, monkeypatch):
    """More slabs than a launch writes take several launches of the same
    table, with the same result."""
    t = _Volume(24, 8, 3.5, torch.float32, seed=6)
    monkeypatch.setattr(cs3, "GATHER_SLABS", 3)
    bs, fields = t.fields(3)
    for cmax in (None, 2):
        got, counts = _run(shim, _grouped, t, bs, fields, cmax)
        assert sum(counts.values()) == 3
        assert _same(got, _plain(t, bs, fields, cmax))


def test_the_library_refuses_bad_tables(shim):
    """A launch of no slab, of more slabs than its table holds or of four
    fields is refused before it runs (cudaErrorInvalidValue)."""
    import ctypes

    mod, lib_path = shim
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.fsc_advect3_group
    fn.argtypes = cs3.build._SIGNATURES["fsc_advect3_group"]
    srcs = (ctypes.c_void_p * 3)()
    starts = (ctypes.c_int * 1)()
    slabs = (ctypes.c_void_p * 6)()
    walls = (ctypes.c_int * 3)()

    def call(nsrc, nslab, nf):
        return fn(ctypes.addressof(srcs), ctypes.addressof(starts), nsrc,
                  ctypes.addressof(slabs), ctypes.addressof(walls), nslab, 4,
                  8, nf, 0, 0, 0, 0.1, 1, None)

    assert call(1, 0, 1) != 0
    assert call(1, cs3.GATHER_SLABS + 1, 1) != 0
    assert call(cs3.GATHER_SOURCES + 1, 1, 1) != 0
    assert call(1, 1, 4) != 0


@pytest.mark.parametrize("side", [24, 25])
@pytest.mark.parametrize("cmax", [None, 1, 4])
def test_k6_bf16_body_equals_the_one_cell_gather(shim, side, cmax):
    """K6's bf16 form on the body (kVolumeVec cells a thread on 24³, one on
    25³): bit for bit its plain twin and the one-cell K14 on the whole
    volume as one slab of ``side`` planes (the exact form on the volume,
    the windowed one on the volume padded with ``cmax+1`` zero planes),
    the arithmetic of the kernel it replaced."""
    t = _Volume(side, 1, 3.5, BF16, seed=side)
    vel, n = t.vel, t.n
    for bs, fields in (((1, 2, 3), vel), ((0,), [t.x])):
        got, counts = _run(shim, co3.advect3_shift_fused, bs, fields, *vel,
                           DT, n, cmax)
        name = "advect3_bf16" if cmax is None else "advect3_windowed_bf16"
        assert counts == {name: 1}
        assert _same([got], [co3.advect3_shift_fused_plain(
            bs, fields, *vel, DT, n, cmax)])
        if cmax is None:
            one, counts = _run(shim, cs3.advect3_flat_slab_exact, bs, fields,
                               *vel, (1, 1, 0), dt=DT, n=n, mz=side)
        else:
            pad = [torch.cat([f.new_zeros((cmax + 1, side, side)), f,
                              f.new_zeros((cmax + 1, side, side))])
                   for f in fields]
            one, counts = _run(shim, cs3.advect3_flat_slab, bs, pad, *vel,
                               (1, 1, 0), dt=DT, n=n, cmax=cmax, mz=side)
        assert sum(counts.values()) == 1
        assert _same([got], [one])


def test_k6_float32_unchanged(shim):
    """K6's float32 form keeps its own kernel: bit for bit its plain
    version."""
    t = _Volume(24, 1, 3.5, torch.float32, seed=2)
    for cmax in (None, 2):
        got, counts = _run(shim, co3.advect3_shift_fused, (1, 2, 3), t.vel,
                           *t.vel, DT, t.n, cmax)
        assert sum(counts.values()) == 1
        assert _same([got], [co3.advect3_shift_fused_plain(
            (1, 2, 3), t.vel, *t.vel, DT, t.n, cmax)])


def _step_cfg(dtype, exact: bool, side: int = 24):
    cfg = ft.SimConfig(n=side - 2, ndim=3, jacobi_iters=6, max_courant=2,
                       dtype=dtype, device="cpu", backend="reference")
    object.__setattr__(cfg, "backend", "cuda")
    return cfg


STEPS = {"windowed, 4 slabs": (4, False), "exact, 4 slabs": (4, True),
         "exact, 8 slabs of 3 planes": (8, True)}


@pytest.fixture(scope="module")
def step_runs(shim):
    """Per dtype and mode: the grouped step's, the per-slab step's and,
    exact, the single-device step's states after two steps (an impulse
    past the window, then none), and the grouped run's launches."""
    import chip_smoke

    out = {}
    for dname, dtype in DTYPES.items():
        for mode, (slabs, exact) in STEPS.items():
            cfg = _step_cfg(dtype, exact)
            mesh = make_mesh([torch.device("cpu")] * slabs).reshape(slabs, 1)
            gen = torch.Generator().manual_seed(3)
            state0, src = ft.reference_init(gen, cfg)
            src = ft.Sources(*(s * 400.0 for s in src))
            cut = [shard_state_3d(x, mesh)
                   for x in (state0, src, ft.zero_sources(cfg))]

            def run(step, cut=cut):
                state = cut[0]
                for k in range(2):
                    state = step(state, cut[1] if k == 0 else cut[2])
                return unshard(state)

            grouped = _ZSlabStep(cfg, mesh, False, exact)
            per_slab = _ZSlabStep(cfg, mesh, False, exact)
            per_slab.ops = per_slab.ops._replace(advect_group=None)
            got, counts = _run(shim, run, grouped)
            want, _ = _run(shim, run, per_slab)
            single = None
            if exact:
                sim = ft.StableFluids3D(cfg)

                def one():
                    s = sim.step(state0, src)
                    return sim.step(s)

                single, _ = _run(shim, one)
            out[dname, mode] = (got, want, single, counts,
                                chip_smoke.expected_launches_sharded3(
                                    cfg, slabs, exact))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", list(STEPS))
def test_zslab_step_through_the_grouped_kernel(step_runs, mode, dtype):
    got, want, single, counts, per_step = step_runs[dtype, mode]
    assert counts == {k: 2 * c for k, c in per_step.items() if c}
    assert _same([got], [want])
    if single is not None:
        assert _same([got], [single])


@pytest.mark.parametrize("exact", [False, True])
def test_a_cuda_gather_on_one_device_runs_no_cat(shim, monkeypatch, exact):
    """The ``cuda`` z-slab step's gathers build no extended slab and no
    assembled volume (the ``reference`` backend's composition runs one
    ``torch.cat`` a slab and field, or one a field)."""
    cfg = _step_cfg(torch.float32, exact)
    mesh = make_mesh([torch.device("cpu")] * 4).reshape(4, 1)
    t = _Volume(24, 4, 1.5, torch.float32, seed=7)
    u, v, w = (t.cut(f) for f in t.vel)
    cats = []
    cat = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda *a, **kw: cats.append(1) or cat(*a, **kw))
    step = _ZSlabStep(cfg, mesh, False, exact)
    out, counts = _run(shim, step._advect, (1, 2, 3), (u, v, w), u, v, w)
    assert cats == [] and sum(counts.values()) == 1
    ref = _ZSlabStep(cfg.replace(backend="reference"), mesh, False, exact)
    assert _same(zip(*out), zip(*ref._advect((1, 2, 3), (u, v, w), u, v,
                                             w)))
    assert cats


@pytest.mark.parametrize("dtype", DTYPES)
def test_chip_smoke_checks_through_the_kernels(shim, dtype):
    """The checks ``chip_smoke.py`` phases 3b, 3d, 21 and 22 run on the
    card (``checks.kernel_checks_advect3_group``, its timing checks and
    ``kernel_checks_k6_body``), at 24³ on 3 slabs of 8 planes: each kernel
    call equals what it is held to, bit for bit, and launches its kernel
    once."""
    bf16 = dtype == "bf16"
    group = checks.kernel_checks_advect3_group(24, 8, "cpu", 0, bf16=bf16)
    timed = checks.timing_checks_advect3_group(24, 8, "cpu", 0, bf16=bf16)
    body = checks.kernel_checks_k6_body(24, "cpu", 0, bf16=bf16)
    assert len(group) == 2 * 2 * (2 * 3 + 3) and len(timed) == 3
    for c in group + timed + body:
        got, counts = _run(shim, c.run)
        assert counts == {c.kernels[0]: 1}, c.label
        want, _ = _run(shim, c.plain)
        assert checks.max_abs_diff(got, want) == 0.0, c.label
        if c.composed is not None:
            per, _ = _run(shim, c.composed)
            assert checks.max_abs_diff(got, per) == 0.0, c.label
            fields, coords = c.gather()
            assert len(coords) == 3 and fields[0].dtype == DTYPES[dtype]
