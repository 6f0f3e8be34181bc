"""Triton pair-pass kernels (pallas/pair_passes.py) and the backend plumbing
around them. On the CPU the kernels run in interpret mode — the same kernel
code the GPU compiles; the `gpu` test compiles them for the card."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.engine.step import (
    _density_pass_sorted,
    _force_pass_sorted,
    build_phase,
    choose_backend,
    make_step,
    step_pallas_triton,
)
from sphjax.pallas.pair_passes import density_pairs, force_pairs
from sphjax.physics.kernels import pressure_from_density
from tests.oracle_numpy import oracle_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sorted_inputs(n, init, trim=False):
    """Cell-sorted inputs with random velocities and pressures, so both
    force terms are live (the lattice starts at rest, below ρ₀). The random
    fill is squeezed into [1, 1.8)³ so that small N still has neighbors."""
    cfg = default_config(n)
    st = init_state(cfg, random_init=(init == "random"), seed=5)
    rng = np.random.default_rng(n)
    pos = st.position
    if init == "random":
        pos = jnp.where(st.valid[:, None], 1.0 + (pos - 1.0) * 0.1, pos)
    st = st._replace(position=pos, velocity=jnp.asarray(
        rng.normal(size=st.velocity.shape).astype(np.float32)))
    cl = build_phase(st, cfg)
    sp, sv = st.position[cl.perm], st.velocity[cl.perm]
    key, valid = cl.key_sorted, cl.valid_sorted
    p = jnp.where(valid, jnp.asarray(
        rng.uniform(0.0, 50.0, size=valid.shape).astype(np.float32)), 0.0)
    if trim:  # only the valid (sorted-first) rows: n is not a block multiple
        sp, sv, key, valid, p = sp[:n], sv[:n], key[:n], valid[:n], p[:n]
    return cfg, sp, sv, key, valid, cl.starts, p


@pytest.mark.parametrize("init", ["grid", "random"])
@pytest.mark.parametrize("n", [256, 1000, 2048])
def test_density_kernel_matches_xla(n, init):
    cfg, sp, _, key, valid, starts, _ = _sorted_inputs(n, init)
    raw = jax.jit(lambda *a: density_pairs(*a, cfg, interpret=True))(
        sp, key, starts)
    rho_k, _ = pressure_from_density(raw, cfg)
    rho_x, _, ovf = _density_pass_sorted(sp, key, valid, starts, cfg)
    assert int(ovf) == 0
    v = np.asarray(valid)
    np.testing.assert_allclose(np.asarray(rho_k)[v], np.asarray(rho_x)[v],
                               rtol=1e-5)


@pytest.mark.parametrize("init", ["grid", "random"])
@pytest.mark.parametrize("n", [256, 1000, 2048])
def test_force_kernel_matches_xla(n, init):
    cfg, sp, sv, key, valid, starts, p = _sorted_inputs(n, init)
    rho, _, _ = _density_pass_sorted(sp, key, valid, starts, cfg)
    f_k = jax.jit(lambda *a: force_pairs(*a, cfg, interpret=True))(
        sp, sv, rho, p, key, starts)
    f_x = _force_pass_sorted(sp, sv, rho, p, key, valid, starts, cfg)
    v = np.asarray(valid)
    f_x = np.asarray(f_x)[v]
    scale = np.abs(f_x).max()
    assert scale > 0
    # opposite-signed pair forces summed in another order cancel: bound the
    # error by the force scale, not elementwise
    np.testing.assert_allclose(np.asarray(f_k)[v], f_x, rtol=0,
                               atol=1e-5 * scale)


def test_kernels_handle_ragged_n():
    """n = 1000 valid rows (not a multiple of the target block): masked
    target loads and stores, same answers as the XLA passes."""
    cfg, sp, sv, key, valid, starts, p = _sorted_inputs(1000, "random",
                                                        trim=True)
    assert sp.shape[0] == 1000
    raw = density_pairs(sp, key, starts, cfg, interpret=True)
    rho_k, _ = pressure_from_density(raw, cfg)
    rho_x, _, _ = _density_pass_sorted(
        jnp.pad(sp, ((0, 24), (0, 0))), jnp.pad(key, (0, 24),
                                                constant_values=cfg.num_cells),
        jnp.pad(valid, (0, 24)), starts, cfg)
    np.testing.assert_allclose(np.asarray(rho_k), np.asarray(rho_x)[:1000],
                               rtol=1e-5)
    f = force_pairs(sp, sv, rho_k, p, key, starts, cfg, interpret=True)
    assert f.shape == (1000, 3) and bool(jnp.isfinite(f).all())


def test_kernel_step_matches_oracle():
    cfg = default_config(512, chunk_size=512)
    st = init_state(cfg, random_init=True, seed=7)
    valid = np.asarray(st.valid)
    ref = oracle_step(np.asarray(st.position)[valid],
                      np.asarray(st.velocity)[valid], cfg)
    new, aux = jax.jit(lambda s: step_pallas_triton(s, cfg, interpret=True))(st)
    assert int(aux.window_overflow) == 0
    np.testing.assert_allclose(np.asarray(new.density)[valid], ref["density"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(new.position)[valid],
                               ref["position"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(new.velocity)[valid],
                               ref["velocity"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("init", ["grid", "random"])
@pytest.mark.parametrize("n", [256, 1000, 2048])
def test_cell_list_matches_oracle(n, init):
    cfg = default_config(n)
    st = init_state(cfg, random_init=(init == "random"), seed=3)
    valid = np.asarray(st.valid)
    ref = oracle_step(np.asarray(st.position)[valid],
                      np.asarray(st.velocity)[valid], cfg)
    new, _ = make_step(cfg, "cell_list")(st)
    np.testing.assert_allclose(np.asarray(new.density)[valid], ref["density"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(new.position)[valid],
                               ref["position"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile_batch", [1, 3, 64])
def test_batched_tile_map_matches_unbatched(monkeypatch, tile_batch):
    """lax.map's batch_size (TILE_BATCH tiles per loop trip) must not change
    the XLA passes' answers: 4 tiles of 256, batched 1 / 3 (ragged
    remainder) / 64 (more than there are tiles)."""
    from sphjax.engine import step

    cfg, sp, sv, key, valid, starts, p = _sorted_inputs(1024, "grid")

    def passes(batch):
        monkeypatch.setattr(step, "TILE_BATCH", batch)
        rho, _, _ = _density_pass_sorted(sp, key, valid, starts, cfg)
        return rho, _force_pass_sorted(sp, sv, rho, p, key, valid, starts, cfg)

    rho1, f1 = passes(1)
    rho2, f2 = passes(tile_batch)
    np.testing.assert_allclose(np.asarray(rho2), np.asarray(rho1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f1), rtol=1e-6,
                               atol=1e-6 * float(np.abs(f1).max()))


@pytest.mark.parametrize("platform,want", [
    ("cpu", "cell_list"), ("gpu", None), ("metal", ValueError),
])
def test_choose_backend_by_platform(platform, want):
    from sphjax.engine import step

    if want is ValueError:
        with pytest.raises(ValueError, match="no SPH backend"):
            choose_backend(platform)
        return
    got = choose_backend(platform)
    assert got == (want or step.GPU_BACKEND)
    assert got in step.BACKENDS


def test_choose_backend_defaults_to_this_platform():
    assert choose_backend() == "cell_list"  # the suite runs on the CPU


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    from sphjax.utils import cache

    if env_dir is None:
        monkeypatch.delenv(cache.ENV, raising=False)
        assert cache.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv(cache.ENV, str(tmp_path / env_dir))
        assert cache.compile_cache_dir() == str(tmp_path / env_dir)


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py exits non-zero on the CPU and prints no ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.mark.gpu
def test_compiled_kernels_match_xla_on_gpu(gpu_device):
    """The kernels as compiled for the card (interpret=False) at N=2048."""
    cfg, sp, sv, key, valid, starts, p = _sorted_inputs(2048, "random")
    args = jax.device_put((sp, sv, key, valid, starts, p), gpu_device)
    sp, sv, key, valid, starts, p = args
    raw = jax.jit(lambda *a: density_pairs(*a, cfg))(sp, key, starts)
    rho_k, _ = pressure_from_density(raw, cfg)
    rho_x, _, _ = jax.jit(lambda *a: _density_pass_sorted(*a, cfg))(
        sp, key, valid, starts)
    v = np.asarray(valid)
    np.testing.assert_allclose(np.asarray(rho_k)[v], np.asarray(rho_x)[v],
                               rtol=1e-4)
    f_k = jax.jit(lambda *a: force_pairs(*a, cfg))(sp, sv, rho_x, p, key, starts)
    f_x = jax.jit(lambda *a: _force_pass_sorted(*a, cfg))(
        sp, sv, rho_x, p, key, valid, starts)
    f_x = np.asarray(f_x)[v]
    np.testing.assert_allclose(np.asarray(f_k)[v], f_x, rtol=0,
                               atol=1e-4 * np.abs(f_x).max())
