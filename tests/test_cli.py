"""CLI smoke tests (-n/-i/-m parsing + timed report format, SURVEY.md §4f)."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    XLA_FLAGS=os.environ.get("XLA_FLAGS", ""),
)


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "sphjax", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=ENV,
        timeout=600,
    )


def test_time_mode_report_format():
    r = run_cli("-n", "256", "-i", "grid", "-m", "time", "--steps", "3")
    assert r.returncode == 0, r.stderr
    out = r.stdout
    # Times table layout (times.h:12-36)
    assert "Operation" in out and "Per frame" in out and "Total" in out
    assert "Grid construction" in out
    assert "SPH update" in out
    assert "Data transfer" in out
    assert re.search(r"\d+\.\d{5}", out)  # fixed 5-decimal values


def test_invalid_init_mode_rejected():
    r = run_cli("-n", "10", "-i", "bogus")
    assert r.returncode == 1
    assert "Program Options:" in r.stdout


def test_invalid_exec_mode_rejected():
    r = run_cli("-m", "bogus")
    assert r.returncode == 1
    assert "Program Options:" in r.stdout


def test_help_flag():
    r = run_cli("-?")
    assert r.returncode == 1  # reference returns 1 after usage (main.cpp:50-52)
    assert "Number of particles to simulate" in r.stdout


def test_backend_flag_choices():
    """--backend accepts the three backends and rejects the retired ones."""
    from sphjax.cli import build_parser
    from sphjax.engine.step import BACKENDS

    p = build_parser()
    for name in ("auto", *BACKENDS):
        assert p.parse_args(["--backend", name]).backend == name
    r = run_cli("-n", "64", "--backend", "pallas")
    assert r.returncode == 1 and "Program Options:" in r.stdout


def test_mesh_flag_runs_dist_simulator():
    """--mesh z on a 2-virtual-device CPU mesh runs the sharded engine."""
    env = dict(ENV)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    )
    r = subprocess.run(
        [sys.executable, "-m", "sphjax", "-n", "256", "-m", "time",
         "--steps", "2", "--mesh", "z"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    assert "SPH update" in r.stdout


def test_mesh_flag_bad_shape_rejected():
    r = run_cli("-n", "64", "--mesh", "2x2")
    assert r.returncode == 1
    assert "Program Options:" in r.stdout


def test_checkpoint_roundtrip(tmp_path):
    """--save/--load resume exactly: 2+2 resumed steps equal 4 straight
    steps bitwise (--warmup 0 so every step is counted)."""
    import numpy as np

    a = str(tmp_path / "a.npz")
    b = str(tmp_path / "b.npz")
    c = str(tmp_path / "c.npz")
    r = run_cli("-n", "256", "-m", "time", "--warmup", "0", "--steps", "4",
                "--save", a)
    assert r.returncode == 0, r.stderr
    r = run_cli("-n", "256", "-m", "time", "--warmup", "0", "--steps", "2",
                "--save", b)
    assert r.returncode == 0, r.stderr
    r = run_cli("--load", b, "-m", "time", "--warmup", "0", "--steps", "2",
                "--save", c)
    assert r.returncode == 0, r.stderr
    with np.load(a) as da, np.load(c) as dc:
        np.testing.assert_array_equal(da["position"], dc["position"])
        np.testing.assert_array_equal(da["velocity"], dc["velocity"])


def test_mesh_timed_report_has_build_phase(tmp_path):
    """--mesh z timed mode reports a real per-phase split (the sharded
    engine's grid-construction phase must not be lumped into SPH update)."""
    env = dict(ENV)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    )
    ckpt = str(tmp_path / "m.npz")
    r = subprocess.run(
        [sys.executable, "-m", "sphjax", "-n", "256", "-m", "time",
         "--steps", "2", "--mesh", "z", "--save", ckpt],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    m = re.search(r"Grid construction\s*(\d+\.\d{5})", r.stdout)
    assert m is not None, r.stdout
    assert float(m.group(1)) > 0.0
    # the dist checkpoint is the SAME format: resumes on the single chip
    r2 = run_cli("--load", ckpt, "-m", "time", "--warmup", "0", "--steps", "1")
    assert r2.returncode == 0, r2.stderr


def test_free_mode_headless_frames(tmp_path):
    out = str(tmp_path / "frames")
    r = run_cli(
        "-n", "128", "-i", "random", "-m", "free",
        "--frames", "2", "--out", out, "--click", "1:400,300",
    )
    assert r.returncode == 0, r.stderr
    files = sorted(os.listdir(out))
    assert files == ["frame_00000.png", "frame_00001.png"]
    with open(os.path.join(out, files[0]), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
