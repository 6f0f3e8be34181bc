"""Initialization parity tests (Simulator::setup, simulator.cu:411-460)."""

import numpy as np

from sphjax.core.config import default_config
from sphjax.core.init import grid_positions, init_state, random_positions


def test_grid_lattice_spacing_and_origin():
    cfg = default_config(109 * 109 + 1)
    pos = grid_positions(cfg)
    assert pos.shape == (cfg.num_particles, 3)
    # origin (h, h, h), spacing 0.9h, z-fastest
    assert np.allclose(pos[0], [0.1, 0.1, 0.1])
    assert np.allclose(pos[1] - pos[0], [0.0, 0.0, 0.09], atol=1e-6)
    # nx = floor((10 - 0.2)/0.09) + 1 = 109 → z wraps at 109, y at 109²
    assert np.allclose(pos[109] - pos[0], [0.0, 0.09, 0.0], atol=1e-6)
    assert np.allclose(pos[109 * 109] - pos[0], [0.09, 0.0, 0.0], atol=1e-5)


def test_grid_fill_order_z_fastest():
    cfg = default_config(300)
    pos = grid_positions(cfg)
    # first 109 particles share x and y
    assert np.all(pos[:109, 0] == pos[0, 0])
    assert np.all(pos[:109, 1] == pos[0, 1])
    assert np.all(np.diff(pos[:109, 2]) > 0)


def test_random_in_bounds():
    cfg = default_config(4096)
    pos = random_positions(cfg, seed=3)
    assert pos.min() >= 1.0
    assert pos.max() <= 9.0


def test_init_state_padding_and_zeros():
    cfg = default_config(1000, chunk_size=512)
    st = init_state(cfg)
    assert st.num_slots == cfg.padded_num_particles
    assert int(st.valid.sum()) == 1000
    assert float(np.abs(np.asarray(st.velocity)).max()) == 0.0
    assert float(np.abs(np.asarray(st.density)).max()) == 0.0


def test_lattice_capacity_is_the_grid_init_boundary():
    """lattice_capacity is exactly where grid_positions stops fitting — the
    CLI/bench random-init fallback threshold (simulator.cu:438-453 math)."""
    import pytest

    from sphjax.core.init import lattice_capacity

    cap = lattice_capacity(default_config(1000))
    assert cap == 109**3  # 0.9h lattice in the 10^3 box
    pos = grid_positions(default_config(cap))
    assert pos.shape == (cap, 3)
    with pytest.raises(ValueError):
        grid_positions(default_config(cap + 1))
