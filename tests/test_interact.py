"""Click-impulse tests (kernelMoveParticles parity, simulator.cu:329-367)."""

import jax.numpy as jnp
import numpy as np

from sphjax.core.config import BOX_MAX_X, BOX_MAX_Y, BOX_MIN_X, BOX_MIN_Y, default_config
from sphjax.core.state import make_state
from sphjax.interact.impulse import (
    _slab_multiplicity,
    apply_click_impulse,
    click_in_box,
)

CFG = default_config(8)


def _click_world_cell(px, py):
    """Replicate the reference's pixel→cell math in f32."""
    x = np.float32(px - BOX_MIN_X) / np.float32(BOX_MAX_X - BOX_MIN_X) * np.float32(10)
    y = np.float32(py - BOX_MIN_Y) / np.float32(BOX_MAX_Y - BOX_MIN_Y) * np.float32(10)
    cx = int(np.float32(x) / np.float32(0.1))
    cy = 100 - int(np.float32(y) / np.float32(0.1))
    return cx, cy


def test_click_in_box_bounds():
    assert click_in_box(400, 300)
    assert not click_in_box(199, 300)
    assert not click_in_box(600, 300)  # exclusive upper (display.cpp:24-25)
    assert not click_in_box(400, 149)
    assert not click_in_box(400, 450)


def test_slab_multiplicity_totals():
    m = np.asarray(_slab_multiplicity(CFG))
    assert m.sum() == CFG.num_cells_per_dim  # each slab maps somewhere
    assert (m >= 0).all() and m.max() <= 2  # f32 rounding doubles some cells


def test_center_column_pushed_in_z():
    px, py = 400, 300
    cx, cy = _click_world_cell(px, py)
    # place one particle exactly in the click's center cell
    pos = jnp.asarray(
        [[(cx + 0.5) * 0.1, (cy + 0.5) * 0.1, 5.05]], jnp.float32
    )
    st = make_state(pos)
    new = apply_click_impulse(st, st.position, jnp.asarray([px, py], jnp.int32), CFG)
    v = np.asarray(new.velocity)[0]
    assert v[0] == 0.0 and v[1] == 0.0
    assert v[2] < 0  # center column: v.z -= PUSH (cu:360-361)


def test_offset_cell_gets_inverse_distance_kick():
    px, py = 400, 300
    cx, cy = _click_world_cell(px, py)
    pos = jnp.asarray(
        [[(cx + 2 + 0.5) * 0.1, (cy + 0.5) * 0.1, 5.05]], jnp.float32
    )
    st = make_state(pos)
    new = apply_click_impulse(st, st.position, jnp.asarray([px, py], jnp.int32), CFG)
    v = np.asarray(new.velocity)[0]
    mult = np.asarray(_slab_multiplicity(CFG))[
        int(np.float32(5.05) / np.float32(0.1))
    ]
    assert v[0] == (1.0 / 2) * 5.0 * mult  # (1/dx)·PUSH (cu:355-356)
    assert v[1] == 0.0 and v[2] == 0.0


def test_far_particles_untouched():
    px, py = 400, 300
    cx, cy = _click_world_cell(px, py)
    pos = jnp.asarray(
        [[(cx + 5) * 0.1, (cy + 0.5) * 0.1, 5.05]], jnp.float32
    )
    st = make_state(pos)
    new = apply_click_impulse(st, st.position, jnp.asarray([px, py], jnp.int32), CFG)
    np.testing.assert_array_equal(np.asarray(new.velocity), 0.0)


def test_invalid_slots_untouched():
    px, py = 400, 300
    cx, cy = _click_world_cell(px, py)
    pos = jnp.asarray(
        [[(cx + 0.5) * 0.1, (cy + 0.5) * 0.1, 5.05]] * 2, jnp.float32
    )
    st = make_state(pos, num_valid=1)
    new = apply_click_impulse(st, st.position, jnp.asarray([px, py], jnp.int32), CFG)
    assert np.abs(np.asarray(new.velocity)[1]).max() == 0.0
