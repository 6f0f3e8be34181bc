"""Click-ripple impulse — the equivalent of kernelMoveParticles
(/root/reference/src/simulator.cu:329-367).

Reference semantics reproduced exactly, vectorized per particle:
  * pixel → world: x = (mx−BOX_MIN_X)/(BOX_MAX_X−BOX_MIN_X)·box_dim, same for
    y; both in f32 (cu:331-336).
  * click cell from getGridCell, then y-flip: cell.y = C − cell.y (cu:340).
  * a particle in cell (px,py,pz) is kicked when |px−cx| ≤ 2 and |py−cy| ≤ 2:
    v.x += (1/dx)·PUSH, v.y += (1/dy)·PUSH for nonzero dx/dy, and the center
    column gets v.z −= PUSH (cu:342-366).
  * slab multiplicity: the reference launches one thread per z-slab at
    z = t·h and two slabs can round to the same cell_z (f32 truncation),
    racing unsynchronized `+=` on the same particles. We resolve that race
    deterministically: each particle's kick is scaled by the number of slabs
    that map to its cell_z — the value the reference nominally computes.

The impulse runs *after* integration using cells from the *pre-step*
positions, matching the reference's ordering (simulate() applies it after
kernelUpdatePositions but before the grid reset, cu:482-489).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphjax.core.config import (
    BOX_MAX_X,
    BOX_MAX_Y,
    BOX_MIN_X,
    BOX_MIN_Y,
    PUSH_STRENGTH,
    SimConfig,
)
from sphjax.core.state import FluidState


def click_in_box(px: int, py: int) -> bool:
    """Pixel-bounds gate, as in the mouse() callback (display.cpp:24-27)."""
    return BOX_MIN_X <= px < BOX_MAX_X and BOX_MIN_Y <= py < BOX_MAX_Y


def _slab_multiplicity(cfg: SimConfig) -> jnp.ndarray:
    """count[cz] = #slabs t ∈ [0, C) with (int)((t·h)/h) == cz, in f32 like
    the reference's per-thread z computation (cu:337, 57-59)."""
    c = cfg.num_cells_per_dim
    t = jnp.arange(c, dtype=jnp.float32)
    z = t * jnp.float32(cfg.h)
    cz = (z / jnp.float32(cfg.h)).astype(jnp.int32)
    return jnp.zeros((c,), jnp.int32).at[jnp.clip(cz, 0, c - 1)].add(1)


def click_cell_from_px(px: int, py: int, cfg: SimConfig) -> tuple[int, int]:
    """Pixel → (cell_x, cell_y_flipped) on the HOST in numpy f32 — IEEE
    division exactly like the reference's device math (cu:331-340). Kept out
    of traced code deliberately: a click can land exactly on a cell boundary
    (pixel 400 → world x = 5.0, and 5.0/0.1f = 49.99999925), where XLA's
    choice between true division and reciprocal-multiply flips the cell."""
    import numpy as np

    F = np.float32
    x = (F(px) - F(BOX_MIN_X)) / F(BOX_MAX_X - BOX_MIN_X) * F(cfg.box_dim)
    y = (F(py) - F(BOX_MIN_Y)) / F(BOX_MAX_Y - BOX_MIN_Y) * F(cfg.box_dim)
    cx = int(x / F(cfg.h))
    cy = cfg.num_cells_per_dim - int(y / F(cfg.h))  # y-flip (cu:340)
    return cx, cy


def click_kick_fields(
    x: jnp.ndarray,
    y: jnp.ndarray,
    z: jnp.ndarray,
    valid: jnp.ndarray,
    click_cell: jnp.ndarray,
    cfg: SimConfig,
):
    """click_kick on 1-D field rows (f32[N] each): velocity-delta rows
    (kx, ky, kz) for a click at grid cell click_cell (int32[2], from
    click_cell_from_px), from pre-step cells. Identical per-component
    arithmetic to the (N,3) variant — the fields-native hot loops (single-
    chip free mode and the sharded per-device step) use this to avoid
    materializing an (N,3) array."""
    c = cfg.num_cells_per_dim
    ccx = click_cell[0]
    ccy = click_cell[1]
    inv = jnp.float32(cfg.h)

    pcx = jnp.clip((x / inv).astype(jnp.int32), 0, c - 1)
    pcy = jnp.clip((y / inv).astype(jnp.int32), 0, c - 1)
    pcz = jnp.clip((z / inv).astype(jnp.int32), 0, c - 1)
    dx = pcx - ccx
    dy = pcy - ccy
    mult = _slab_multiplicity(cfg)[pcz].astype(jnp.float32)

    hit = (jnp.abs(dx) <= 2) & (jnp.abs(dy) <= 2) & valid
    push = jnp.float32(PUSH_STRENGTH)
    fdx = dx.astype(jnp.float32)
    fdy = dy.astype(jnp.float32)
    kick_x = jnp.where(dx != 0, push / jnp.where(dx != 0, fdx, 1.0), 0.0)
    kick_y = jnp.where(dy != 0, push / jnp.where(dy != 0, fdy, 1.0), 0.0)
    kick_z = jnp.where((dx == 0) & (dy == 0), -push, 0.0)
    zero = jnp.float32(0.0)
    return (
        jnp.where(hit, kick_x * mult, zero),
        jnp.where(hit, kick_y * mult, zero),
        jnp.where(hit, kick_z * mult, zero),
    )


def click_kick(
    pre_step_position: jnp.ndarray,
    valid: jnp.ndarray,
    click_cell: jnp.ndarray,
    cfg: SimConfig,
) -> jnp.ndarray:
    """Velocity delta f32[N,3] for a click at grid cell click_cell (int32[2],
    from click_cell_from_px), from pre-step cells. Pure and elementwise per
    particle — usable both on the single-chip state and per-device under
    shard_map. (N,3) wrapper around click_kick_fields."""
    kx, ky, kz = click_kick_fields(
        pre_step_position[:, 0],
        pre_step_position[:, 1],
        pre_step_position[:, 2],
        valid,
        click_cell,
        cfg,
    )
    return jnp.stack([kx, ky, kz], axis=-1)


def apply_click_impulse(
    state: FluidState,
    pre_step_position: jnp.ndarray,
    click_px,
    cfg: SimConfig,
) -> FluidState:
    """click_px: CONCRETE (host) int pixel coords — the pixel→cell conversion
    runs on the host (see click_cell_from_px); the kick itself is traced."""
    import numpy as np

    px, py = (int(v) for v in np.asarray(click_px))
    cell = jnp.asarray(click_cell_from_px(px, py, cfg), jnp.int32)
    kick = click_kick(pre_step_position, state.valid, cell, cfg)
    return state._replace(velocity=state.velocity + kick)


def make_impulse(cfg: SimConfig):
    """`(state, pre_pos, click_px) -> state` with the traced kick jitted and
    the pixel→cell scalar conversion on the host (no retrace per click: the
    cell coords enter as a traced int32[2])."""

    @jax.jit
    def _kick(state, pre_pos, click_cell):
        kick = click_kick(pre_pos, state.valid, click_cell, cfg)
        return state._replace(velocity=state.velocity + kick)

    def impulse(state, pre_pos, click_px):
        import numpy as np

        px, py = (int(v) for v in np.asarray(click_px))
        cell = jnp.asarray(click_cell_from_px(px, py, cfg), jnp.int32)
        return _kick(state, pre_pos, cell)

    return impulse
