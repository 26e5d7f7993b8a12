"""K3's bf16 form (``csrc/advect.cu``) and K2's bf16 gradient
(``csrc/project.cu``) run in V-cell vectors: a thread owns V consecutive
cells of a row, the first of the kernel's widths (``cuda_ops.VECTOR_WIDTHS``:
K3 4 or 2, the gradient 8, 4 or 2) that divides the side with every pointer
aligned to its access (``cuda_ops.vector_width``), else the one-cell kernel
(V = 1).  A CUDA kernel has no interpret mode, so this file compiles both
sources with ``g++ -ffp-contract=off`` behind the host shim of
``dev/rehearse_kernels_cpu.py`` and holds every form
(``checks.BF16_FORMS``, forced by ``cuda_ops.vector_widths``) bit for bit
against its plain version on CPU tensors:

- sides 34, 36, 40, 130 and 256 (V = 2, 4, 8, 2, 8 at most), one grid and
  a batch of three;
- K3 on one field with border mode 0, 1 and 2 and on the u/v pair,
  exact and in windows of 1 and 4 cells, on random, smooth and shear
  velocities and on velocities that put most departures on the clamp;
- the gradient from a float32 and a bf16 pressure;
- the width each launch takes (``cuda_ops.width_counts``): by form and
  side, on the path's widths, and on views whose storage offset misaligns
  them; and the launches the library refuses (K3 at V = 8 among them).

Skips only without ``g++``.
"""
import contextlib
import functools
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fluidsimulationcuda_torch.kernels import checks, cuda_ops  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("advect.cu", "project.cu")
# Each side and the widest of 8, 4 and 2 that divides it.
WIDTHS = {34: 2, 36: 4, 40: 8, 130: 2, 256: 8}
WINDOWS = {"exact": None, "cmax1": 1, "cmax4": 4}


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
    lib = mod.build_shim_library(SOURCES, mod.OUT / "bf16_stencils")
    return mod, lib


@functools.lru_cache(maxsize=4)
def _checks(side: int, batch: int) -> dict[str, checks.Check]:
    return {c.label: c for c in checks.kernel_checks_bf16_forms(
        side, "cpu", seed=side, batch=batch)}


def _run(shim, check, widths=None):
    """The check's kernel through the shim, in the first of ``widths``
    that its operands allow (the path's widths if None): (result, width
    counts of its launch)."""
    mod, lib = shim
    forced = (cuda_ops.vector_widths(widths) if widths is not None
              else contextlib.nullcontext())
    with mod.kernels_on_cpu(lib), forced:
        cuda_ops.reset_width_counts()
        out = check.run()
        return out, cuda_ops.width_counts()


def _width(side: int, widths: tuple[int, ...]) -> int:
    """The width a launch on aligned grids of ``side`` takes."""
    return next((w for w in widths if side % w == 0), 1)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(checks._as_tuple(a),
                                                  checks._as_tuple(b)))


def _one_launch(counts, kernel: str, width: int) -> bool:
    return counts[kernel] == {w: int(w == width) for w in counts[kernel]}


def _forms(kernel: str):
    """The kernel's forms (``checks.BF16_FORMS``) as test parameters."""
    return pytest.mark.parametrize(
        "form", checks.BF16_FORMS[kernel],
        ids=[f"V={w}" for w in checks.BF16_FORMS[kernel]])


@_forms("advect_bf16")
@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("velocity", checks.BF16_FORM_VELOCITIES)
@pytest.mark.parametrize("batch", [0, 3], ids=["grid", "batch3"])
@pytest.mark.parametrize("side", list(WIDTHS))
def test_k3_bf16_forms_match_plain(shim, side, batch, velocity, window,
                                   form):
    cmax = WINDOWS[window]
    win = "exact" if cmax is None else f"cmax={cmax}"
    cases = _checks(side, batch)
    widths = (form,)
    for fields in checks.BF16_FORM_FIELDS:
        label = (f"{'3x' if batch else ''}{side}² bf16 advect {fields} "
                 f"{win}, {velocity} velocities")
        check = cases[label]
        got, counts = _run(shim, check, widths)
        assert _same(got, check.plain()), label
        assert _one_launch(counts, "advect_bf16",
                           _width(side, widths)), counts


@_forms("gradient_bf16")
@pytest.mark.parametrize("p_dtype", ["float32 p", "bf16 p"])
@pytest.mark.parametrize("batch", [0, 3], ids=["grid", "batch3"])
@pytest.mark.parametrize("side", list(WIDTHS))
def test_k2_bf16_gradient_forms_match_plain(shim, side, batch, p_dtype,
                                            form):
    check = _checks(side, batch)[
        f"{'3x' if batch else ''}{side}² bf16 gradient, {p_dtype}"]
    widths = (form,)
    got, counts = _run(shim, check, widths)
    assert _same(got, check.plain())
    assert _one_launch(counts, "gradient_bf16", _width(side, widths)), counts


@pytest.mark.parametrize("side", list(WIDTHS))
def test_path_takes_its_widths(shim, side):
    """Unforced, each kernel takes the first of its ``VECTOR_WIDTHS`` that
    divides the side: K3 V = 4 where it can, the gradient V = 8."""
    cases = _checks(side, 0)
    for label, kernel in (
            (f"{side}² bf16 advect u/v pair exact, smooth velocities",
             "advect_bf16"),
            (f"{side}² bf16 gradient, float32 p", "gradient_bf16")):
        got, counts = _run(shim, cases[label])
        assert _same(got, cases[label].plain())
        assert _one_launch(counts, kernel, _width(
            side, cuda_ops.VECTOR_WIDTHS[kernel])), counts


def _view(x: torch.Tensor, dtype, shift: int) -> torch.Tensor:
    """``x`` as ``dtype`` in a contiguous view ``shift`` elements into a
    larger buffer (aligned as the buffer's address plus ``shift``
    elements)."""
    flat = torch.zeros(x.numel() + 16, dtype=dtype)
    out = flat[shift:shift + x.numel()].view(x.shape)
    out.copy_(x.to(dtype))
    return out


@pytest.mark.parametrize("kernel", ["advect_bf16", "gradient_bf16"])
@pytest.mark.parametrize("side", [40, 36])
def test_vector_width_by_side_and_alignment(side, kernel):
    """The width: the first of the kernel's widths that divides the side
    and whose access (at most 16 bytes) every operand's address is aligned
    to; at side 40 K3 takes V = 4, the gradient V = 8."""
    x = torch.zeros(side, side)
    bf = torch.bfloat16
    full = _width(side, cuda_ops.VECTOR_WIDTHS[kernel])
    assert full == {("advect_bf16", 40): 4}.get((kernel, side), WIDTHS[side])
    for shift, width in ((0, full), (8, full), (4, min(full, 4)),
                         (2, 2), (6, 2), (1, 1), (3, 1)):
        assert cuda_ops.vector_width(kernel, side,
                                     _view(x, bf, shift)) == width
    # A float32 operand's access is 4 V bytes, at most 16.
    for shift, width in ((0, full), (4, full), (2, 2), (1, 1)):
        assert cuda_ops.vector_width(
            kernel, side, _view(x, bf, 0),
            _view(x, torch.float32, shift)) == width
    for odd in (33, 35, 129):
        assert cuda_ops.vector_width(
            kernel, odd, torch.zeros(odd, odd, dtype=bf)) == 1
    for forced in ((), (1,)):
        with cuda_ops.vector_widths(forced):
            assert cuda_ops.vector_width(kernel, side, _view(x, bf, 0)) == 1


@pytest.mark.parametrize("shift", [1, 2, 4, 8])
def test_misaligned_views_take_narrower_forms(shim, shift):
    """Operands in views at a storage offset of ``shift`` bf16 values
    (2 shift bytes) take the width that offset allows on the path's widths
    (K3 4 at most), the one-cell kernel at an odd offset, with the same
    bits."""
    t = checks._Inputs(40, "cpu", 0)
    u, v, x = (_view(f, torch.bfloat16, shift) for f in (t.u, t.v, t.x))
    p32 = _view(t.p, torch.float32, shift)
    n = t.n
    for fn, plain, args, kernel in (
            (cuda_ops.advect_shift_fused, cuda_ops.advect_shift_fused_plain,
             ((1, 2), (u, v), u, v, checks.DT, n), "advect_bf16"),
            (cuda_ops.advect_shift_fused, cuda_ops.advect_shift_fused_plain,
             ((0,), (x,), u, v, checks.DT, n, 4), "advect_bf16"),
            (cuda_ops.gradient_p, cuda_ops.gradient_p_plain, (u, v, x, n),
             "gradient_bf16")):
        check = checks.Check("view", (kernel,), lambda: fn(*args),
                             lambda: plain(*args))
        got, counts = _run(shim, check)
        assert _same(got, check.plain())
        assert _one_launch(counts, kernel, min(
            shift, cuda_ops.VECTOR_WIDTHS[kernel][0])), counts
    # A float32 p at an offset of 4 bytes: its V-cell access needs 8 or 16.
    check = checks.Check(
        "float32 p", ("gradient_bf16",),
        lambda: cuda_ops.gradient_p(u, v, p32, n),
        lambda: cuda_ops.gradient_p_plain(u, v, p32, n))
    got, counts = _run(shim, check)
    assert _same(got, check.plain())
    assert _one_launch(counts, "gradient_bf16", shift), counts


def _raw_args(t, width):
    bf = torch.bfloat16
    u, v = t.u.to(bf), t.v.to(bf)
    outs = [torch.empty_like(u) for _ in range(2)]
    return (u.data_ptr(), v.data_ptr(), u.data_ptr(), v.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), t.n + 2, 1, 1, 2,
            cuda_ops._dt0(checks.DT, t.n), 0, width, 0), (u, v, outs)


def test_refused_launches_raise_and_count_nothing(shim):
    """A width that does not divide the side, one that is not among the
    kernel's forms (1, 2 and 4 for K3; 8 too for the gradient), or a
    pointer off its access is refused by the library
    (cudaErrorInvalidValue), and the wrapper's launch helper raises and
    counts nothing."""
    mod, lib = shim
    with mod.kernels_on_cpu(lib) as handle:
        t = checks._Inputs(34, "cpu", 0)
        for width in (4, 8, 3, 16):
            args, keep = _raw_args(t, width)
            assert handle.fsc_advect_bf16(*args) == 1, width
        args, keep = _raw_args(t, 2)
        assert handle.fsc_advect_bf16(*args) == 0
        misaligned = (args[0] + 2,) + args[1:]
        assert handle.fsc_advect_bf16(*misaligned) == 1
        # K3 has no V = 8 form, though 8 divides 40.
        t40 = checks._Inputs(40, "cpu", 0)
        for width, rc in ((8, 1), (4, 0)):
            args40, keep40 = _raw_args(t40, width)
            assert handle.fsc_advect_bf16(*args40) == rc, width
        bf = torch.bfloat16
        u, v = t.u.to(bf), t.v.to(bf)
        p = t.p
        outs = [torch.empty_like(u) for _ in range(2)]
        grad = (u.data_ptr(), v.data_ptr(), p.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr(), 34, 1, 0.03, 0)
        assert handle.fsc_gradient_bf16(*grad, 8, 0) == 1
        assert handle.fsc_gradient_bf16(*grad, 2, 0) == 0
        cuda_ops.reset_launch_counts()
        cuda_ops.reset_width_counts()
        args, keep = _raw_args(t, 8)
        with pytest.raises(RuntimeError, match="advect_bf16 failed"):
            cuda_ops._launch_vector("advect_bf16", 8, handle.fsc_advect_bf16,
                                    *args)
        assert cuda_ops.launch_counts()["advect_bf16"] == 0
        assert sum(cuda_ops.width_counts()["advect_bf16"].values()) == 0
