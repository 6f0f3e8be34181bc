"""bench.py tests: the device rules (no GPU → failure, except an explicit
JAX_PLATFORMS=cpu rehearsal whose line carries no rate) and smoke runs."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench(*args, platforms="cpu", extra_env=None, timeout=600):
    env = dict(os.environ, **(extra_env or {}))
    env.pop("JAX_PLATFORMS", None)
    if platforms is not None:
        env["JAX_PLATFORMS"] = platforms
    return subprocess.run(
        [sys.executable, "bench.py", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout,
    )


def test_bench_fails_without_gpu():
    """Without a GPU and without an explicit JAX_PLATFORMS=cpu the bench
    exits non-zero and prints no result line."""
    r = _bench("--n", "512", "--steps", "1", platforms=None)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_bench_cpu_rehearsal_line_names_device():
    """An explicit CPU rehearsal names the device and carries no rate."""
    r = _bench("--n", "512", "--steps", "2", "--no-verify",
               "--backend", "cell_list")
    assert r.returncode == 0, r.stderr
    data = json.loads(r.stdout.strip().splitlines()[-1])
    assert data["metric"] == "sph_timesteps_per_sec_n512"
    assert data["device"]["platform"] == "cpu"
    assert data["device"]["count"] >= 1 and data["device"]["kind"]
    assert data["value"] is None


@pytest.mark.slow  # ~60 s on CPU: parity gates + 3-step chain
def test_bench_emits_json_line():
    r = _bench("--n", "512", "--steps", "3", "--backend", "cell_list")
    assert r.returncode == 0, r.stderr
    data = json.loads(r.stdout.strip().splitlines()[-1])
    assert data["parity"] == "pass"
    assert data["backend"] == "cell_list"


@pytest.mark.slow  # ~30 s: dist bench on a 2-device virtual CPU mesh
def test_bench_dist_mode_smoke():
    """--dist runs the scan-chained sharded loop and emits the dist line."""
    flags = os.environ.get("XLA_FLAGS", "")
    r = _bench("--dist", "2", "--n", "512", "--steps", "3",
               extra_env={"XLA_FLAGS": flags
                          + " --xla_force_host_platform_device_count=2"})
    assert r.returncode == 0, r.stderr
    data = json.loads(r.stdout.strip().splitlines()[-1])
    assert data["metric"] == "sph_dist_timesteps_per_sec_n512_d2"
    assert data["parity"] == "pass"
