"""The port's command line against the JAX package's, on the CPU.

Both CLIs run in this process (``main(argv)``), the port's with ``--device
cpu``; JAX's on the CPU, where its ``"auto"`` backend is the reference and
gathers exactly, as the port's ``"auto"`` does on the CPU.  The scenarios
compared are the deterministic ones (``vortex-pair``, ``jets``), so both
packages start from the same arrays; states are held at atol 1e-5, the
golden fixtures' tolerance (tests/test_golden.py).  Sizes n=30 (2-D) and
n=14 (3-D), at most 8 steps.
"""
import contextlib
import json
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fluidsimulationcuda_torch as ft  # noqa: E402
from fluidsimulationcuda_torch import __main__ as cli  # noqa: E402
from fluidsimulationcuda_torch.kernels import build, cuda_ops  # noqa: E402
from fluidsimulationcuda_torch.utils import checkpoint as tck  # noqa: E402
import fluidsimulationcuda_tpu as fj  # noqa: E402
import jax  # noqa: E402
from fluidsimulationcuda_tpu import __main__ as jcli  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _fields(path):
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        return {k: z[k] for k in ("dens", "u", "v", "w") if k in z.files}, meta


def test_module_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "fluidsimulationcuda_torch", "run", *CPU,
         "--n", "30", "--steps", "3"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "ms/step incl. dispatch" in res.stderr and "stable" in res.stderr


@pytest.mark.parametrize("scenario", ["vortex-pair", "jets"])
def test_scenario_runs_match_jax(tmp_path, capsys, scenario):
    args = ["run", "--n", "30", "--steps", "5", "--scenario", scenario]
    jcli.main(args + ["--save", str(tmp_path / "jax.npz")])
    cli.main(args + CPU + ["--save", str(tmp_path / "port.npz")])
    err = capsys.readouterr().err
    assert err.count("5 steps in") == 2 and "UNSTABLE" not in err
    want, jmeta = _fields(tmp_path / "jax.npz")
    got, meta = _fields(tmp_path / "port.npz")
    assert set(got) == set(want) == {"dens", "u", "v"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert meta["step"] == jmeta["step"] == 5
    assert meta["config"] == jmeta["config"]


def test_jax_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """A JAX checkpoint resumed by the port's CLI equals JAX's own resume."""
    first = str(tmp_path / "first.npz")
    jcli.main(["run", "--n", "30", "--steps", "3", "--scenario",
               "vortex-pair", "--save", first])
    jcli.main(["run", "--resume", first, "--steps", "3", "--save",
               str(tmp_path / "jax.npz")])
    cli.main(["run", *CPU, "--resume", first, "--steps", "3", "--save",
              str(tmp_path / "port.npz")])
    assert "resumed step 3, n=30" in capsys.readouterr().err
    want, _ = _fields(tmp_path / "jax.npz")
    got, meta = _fields(tmp_path / "port.npz")
    assert meta["step"] == 6
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("ndim,n", [(2, 30), (3, 14)])
def test_resume_continues_bit_for_bit(tmp_path, ndim, n):
    """Save after 3 steps and resume for 3: the straight 6-step run, to the
    bit (the impulse fires on the first step of the run only)."""
    common = ["run", *CPU, "--n", str(n), "--ndim", str(ndim)]
    a, b, c = (str(tmp_path / f"{x}.npz") for x in "abc")
    cli.main(common + ["--steps", "3", "--save", a])
    cli.main(["run", *CPU, "--resume", a, "--steps", "3", "--save", b])
    cli.main(common + ["--steps", "6", "--save", c])
    resumed, meta = _fields(b)
    straight, _ = _fields(c)
    assert meta["step"] == 6 and set(resumed) == set(straight)
    assert ("w" in resumed) == (ndim == 3)
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


@pytest.mark.parametrize("scenario", ["plume", "jets"])
def test_3d_run_is_the_reference_impulse_as_in_jax(tmp_path, monkeypatch,
                                                   capsys, scenario):
    """``run --ndim 3`` ignores ``--scenario`` in both CLIs and runs
    ``reference_init`` of ``--seed``; fed JAX's draws, the port's run
    equals JAX's."""
    def jax_draws(generator, cfg):
        jcfg = fj.SimConfig(n=cfg.n, ndim=cfg.ndim)
        fields = fj.reference_init(jax.random.key(generator.initial_seed()),
                                   jcfg)
        return tuple(type(f)._make(torch.from_numpy(np.array(x)).to(
            cfg.device) for x in f) for f in fields)

    monkeypatch.setattr(cli, "reference_init", jax_draws)
    args = ["run", "--ndim", "3", "--n", "14", "--steps", "3", "--seed", "5",
            "--scenario", scenario]
    jcli.main(args + ["--save", str(tmp_path / "jax.npz")])
    cli.main(args + CPU + ["--save", str(tmp_path / "port.npz")])
    err = capsys.readouterr().err
    assert err.count("3 steps in") == 2 and "UNSTABLE" not in err
    want, jmeta = _fields(tmp_path / "jax.npz")
    got, meta = _fields(tmp_path / "port.npz")
    assert set(got) == set(want) == {"dens", "u", "v", "w"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert meta["config"] == jmeta["config"]


# ---------------------------------------------------------------------------
# --perf: presets, sentinel, the configuration gates
# ---------------------------------------------------------------------------


def _ns(ndim=2, **kw):
    """Parsed flags as argparse leaves them (None: not passed); _cfg
    mutates them, so each call takes a fresh one."""
    base = dict(n=126, iters=20, backend="reference", cmax=2, dt=0.016,
                visc=0.0025, diff=0.1, ndim=ndim, pressure_solver=None,
                diffusion_solver=None, fast_math=None, cheby_iters=None,
                cheby_press_iters=None, cheby_rho=None, perf=True,
                device="cpu")
    return SimpleNamespace(**{**base, **kw})


def test_cli_perf_preset_pins_validated_operating_points():
    """Mirror of tests/test_batched_and_utils.py:244-283."""
    c2 = cli._cfg(_ns(2))
    assert c2.pressure_solver == c2.diffusion_solver == "chebyshev"
    assert c2.fast_math and c2.cheby_iters == 10
    assert (c2.cheby_rho, c2.press_cheby_iters) == (0.9, 14)
    c3 = cli._cfg(_ns(3))
    assert (c3.cheby_rho, c3.press_cheby_iters) == (0.85, 12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c8k = cli._cfg(_ns(2, n=8190))
    assert (c8k.cheby_rho, c8k.cheby_iters, c8k.press_cheby_iters) == \
        (0.96, 12, 14)
    plain = cli._cfg(_ns(2, perf=False))
    assert plain.pressure_solver == "jacobi" and not plain.fast_math
    assert (plain.cheby_iters, plain.cheby_press_iters, plain.cheby_rho) == \
        (8, 0, 0.99)
    expl = cli._cfg(_ns(2, perf=False, pressure_solver="multigrid",
                        cheby_rho=0.5))
    assert expl.pressure_solver == "multigrid" and expl.cheby_rho == 0.5


# JAX's probe traces the step on an allocated zero state: two sizes only
# (every side is held in tests/test_torch_utils.py).
@pytest.mark.parametrize("ndim,n", [(2, 4094), (3, 62)])
def test_cli_perf_point_matches_jax(ndim, n):
    """Both CLIs' ``--perf`` pick the same point (4094: the 2048² anchor)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = cli._cfg(_ns(ndim, n=n))
        want = jcli._cfg(_ns(ndim, n=n))
    keys = ("pressure_solver", "diffusion_solver", "fast_math",
            "cheby_iters", "cheby_press_iters", "cheby_rho")
    assert [getattr(got, k) for k in keys] == [getattr(want, k) for k in keys]


def test_cli_perf_warns_on_clobbered_flags(capsys):
    """Mirror of tests/test_batched_and_utils.py:286-316."""
    cli._cfg(_ns(cheby_rho=0.5))
    err = capsys.readouterr().err
    assert "overrides" in err and "--cheby-rho" in err
    cli._cfg(_ns(cheby_rho=0.99))  # passing the default value warns too
    err = capsys.readouterr().err
    assert "overrides" in err and "--cheby-rho" in err
    cli._cfg(_ns())
    assert "overrides" not in capsys.readouterr().err


def test_perf_probe_at_8190_allocates_nothing(monkeypatch):
    """The perf probe at the full 8192² size on the ``cuda`` backend asks
    the gates of a configuration for the card (which needs no card to be
    built) and allocates no tensor."""
    def refuse(*a, **k):
        raise AssertionError("allocated a tensor")

    for name in ("zeros", "empty", "empty_like", "zeros_like", "full",
                 "rand", "randn", "tensor"):
        monkeypatch.setattr(torch, name, refuse)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = cli._cfg(_ns(2, n=8190, backend="cuda", device="cuda"))
    assert cfg.resolved_backend == "cuda" and cfg.grid_shape == (8192, 8192)
    assert (cfg.cheby_rho, cfg.cheby_iters, cfg.press_cheby_iters) == \
        (0.96, 12, 14)


@pytest.mark.parametrize("perf", [True, False])
def test_grid_gate_error_propagates(perf):
    """A grid past the kernels' 32-bit indexing fails the gate before
    anything is allocated, in every solver mode: the error propagates and
    no other configuration is tried."""
    with pytest.raises(ValueError, match="unsupported grid shape"):
        cli._cfg(_ns(2, n=46340, backend="cuda", device="cuda", perf=perf))


# ---------------------------------------------------------------------------
# No fallback: build, launch and device errors raise through the CLI
# ---------------------------------------------------------------------------


def test_a_launch_error_propagates(monkeypatch):
    """The ``cuda`` backend on CPU tensors made to launch, on a library
    whose every entry point returns a CUDA error: ``run --perf`` raises
    the launch error; nothing falls back to the plain ops."""
    real = cli._build_cfg

    def cuda_on_cpu(args):
        cfg = real(args)
        object.__setattr__(cfg, "backend", "cuda")
        return cfg

    class FailingLibrary:
        def __getattr__(self, name):
            return lambda *args: 1  # cudaErrorInvalidValue

    monkeypatch.setattr(cli, "_build_cfg", cuda_on_cpu)
    monkeypatch.setattr(cuda_ops, "_on_device", lambda *specs: True)
    monkeypatch.setattr(cuda_ops, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(build, "_lib", FailingLibrary())
    cuda_ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="failed to launch"):
        cli.main(["run", *CPU, "--n", "30", "--steps", "1", "--perf"])
    assert sum(cuda_ops.launch_counts().values()) == 0


def test_cuda_backend_on_the_cpu_is_refused():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cli.main(["run", *CPU, "--backend", "cuda", "--n", "30", "--steps",
                  "1"])


def test_no_card_raises():
    """The default device is the card: without one the run raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["run", "--n", "30", "--steps", "1"])


# ---------------------------------------------------------------------------
# --validate, datagen, profile, info, --png
# ---------------------------------------------------------------------------


def test_validate_prints_the_bars(capsys):
    cli.main(["run", *CPU, "--n", "30", "--iters", "4", "--steps", "1",
              "--perf", "--validate"])
    err = capsys.readouterr().err
    assert "validating solver point at n=30 against jacobi-4" in err
    for key in ("max_abs_divergence", "diffusion_residual_ratio",
                "dens_residual_ratio", "  ok: "):
        assert key in err
    assert "validation PASSED" in err or "validation FAILED" in err
    cli.main(["run", *CPU, "--n", "30", "--steps", "1", "--validate"])
    assert "parity jacobi config IS the bar" in capsys.readouterr().err


@pytest.mark.parametrize("every", [0, 1])
def test_datagen_equals_generate_trajectories(tmp_path, capsys, every):
    out = str(tmp_path / "traj.npz")
    cli.main(["datagen", *CPU, "--n", "30", "--iters", "4", "--batch", "2",
              "--steps", "3", "--seed", "4", "--snapshot-every", str(every),
              "--out", out])
    err = capsys.readouterr().err
    cmax = int(err.split("auto-selected advect window cmax=")[1].split()[0])
    assert "compressed and written in" in err
    cfg = ft.SimConfig(n=30, jacobi_iters=4, device="cpu", max_courant=cmax)
    gen = torch.Generator().manual_seed(4)
    assert ft.select_cmax_batched(gen, cfg, 2)[0] == cmax
    final, snaps, _ = ft.generate_trajectories(
        torch.Generator().manual_seed(4), cfg, 2, 3, snapshot_every=every)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["dens_final"], final.dens.numpy())
        assert z["dens_final"].shape == (2, 32, 32)
        if every:
            np.testing.assert_array_equal(z["dens_snapshots"],
                                          snaps.numpy())
        else:
            assert "dens_snapshots" not in z.files


def test_profile_prints_the_table_and_writes_a_trace(tmp_path, capsys):
    trace = tmp_path / "trace"
    cli.main(["profile", *CPU, "--n", "30", "--iters", "4", "--trace",
              str(trace)])
    out = capsys.readouterr()
    assert "full step (est)" in out.out and "Mcell/s" in out.out
    with open(trace / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_info_runs_without_the_card(capsys):
    cli.main(["info"])
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert "kernel build directory" in out and "nvcc:" in out


def test_png_written(tmp_path):
    pytest.importorskip("matplotlib")
    path = tmp_path / "dens.png"
    cli.main(["run", *CPU, "--n", "30", "--steps", "2", "--png", str(path)])
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_port_checkpoint_of_the_cli_loads_in_jax(tmp_path):
    from fluidsimulationcuda_tpu.utils.checkpoint import load_checkpoint

    path = str(tmp_path / "port.npz")
    cli.main(["run", *CPU, "--n", "30", "--steps", "2", "--save", path])
    state, cfg, step = load_checkpoint(path)
    mine, _, _ = tck.load_checkpoint(path, device="cpu")
    assert step == 2 and cfg.n == 30 and cfg.backend == "auto"
    for a, b in zip(state, mine):
        if b is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
