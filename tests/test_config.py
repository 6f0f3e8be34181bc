"""Config validation and derived-constant tests (Settings parity)."""

import math

import pytest

from sphjax.core.config import SimConfig, default_config
from sphjax.core.init import grid_positions, init_state


def test_derived_coefficients_match_reference_formulas():
    cfg = default_config(8)
    # main.cpp:57-61: v = 45/(π h⁶), d = 315/(64 π h⁹)
    assert cfg.v_kernel_coeff == pytest.approx(45.0 / (math.pi * 0.1**6), rel=1e-6)
    assert cfg.d_kernel_coeff == pytest.approx(
        315.0 / (64.0 * math.pi * 0.1**9), rel=1e-6
    )
    assert cfg.num_cells == 100**3


def test_invalid_configs_rejected():
    with pytest.raises(ValueError):
        default_config(0)
    with pytest.raises(ValueError):
        default_config(10, h=-1.0)
    with pytest.raises(ValueError):
        default_config(10, dt=0.0)
    with pytest.raises(ValueError, match="window_capacity"):
        default_config(10, window_capacity=0)
    with pytest.raises(ValueError, match="tile_cand_capacity"):
        default_config(10, tile_cand_capacity=-1)


def test_lattice_capacity_exceeded_raises():
    cfg = SimConfig(num_particles=109**3 + 1)
    with pytest.raises(ValueError, match="lattice capacity"):
        grid_positions(cfg)


def test_padding_is_chunk_aligned():
    for n in (1, 255, 256, 1000, 4097):
        cfg = default_config(n)
        st = init_state(cfg)
        assert st.num_slots % 256 == 0
        assert st.num_slots >= n
        assert int(st.valid.sum()) == n


def test_config_hashable_static_under_jit():
    import jax

    cfg = default_config(64, chunk_size=64)
    calls = []

    @jax.jit
    def f(x, cfg_static=None):
        calls.append(1)
        return x

    hash(cfg)  # must be hashable (jit-static requirement)
    assert cfg == default_config(64, chunk_size=64)
