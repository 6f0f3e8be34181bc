"""Uniform-grid cell assignment — the equivalent of getGridCell /
flattenGridCoord (/root/reference/src/simulator.cu:57-82).

cell = (int)(position / h) per axis (truncation; positions are non-negative
after the boundary clamp so this equals floor). The reference prints an OOB
warning without clamping (simulator.cu:60-73); we count OOB particles into a
diagnostic and clamp the cell for safety (contributions remain correct because
every pair interaction is re-masked on r ≤ h).

Flat key = x + C·y + C²·z, row-major with **x fastest** — exactly the
reference's layout (simulator.cu:78-82). After sorting by this key, the three
x-adjacent cells of any (y,z) column are contiguous, which turns the 27-cell
stencil into 9 contiguous windows (see cell_list.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphjax.core.config import SimConfig


def cell_coords(position: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """position f32[...,3] → int32[...,3] grid cell, truncated like the
    reference's (int)(p / h) cast."""
    return (position / jnp.float32(cfg.h)).astype(jnp.int32)


def flatten_rowmajor(cell: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    c = jnp.int32(cfg.num_cells_per_dim)
    return cell[..., 0] + c * cell[..., 1] + c * c * cell[..., 2]


class GridKeys(NamedTuple):
    key: jnp.ndarray  # int32[N] flat cell key; == num_cells sentinel if invalid
    cell: jnp.ndarray  # int32[N,3] clamped cell coords
    oob_count: jnp.ndarray  # int32[] — valid particles outside [0, C)³


def compute_keys(
    position: jnp.ndarray, valid: jnp.ndarray, cfg: SimConfig
) -> GridKeys:
    """Cell keys for every particle slot. Invalid slots get the out-of-range
    sentinel `num_cells` so they sort to the end and join no cell.

    The key is row-major x-fastest, deliberately NOT Morton: the reference's
    z_index_sort branch (README.md:5) uses a Z-order key to improve GPU cache
    locality of its per-cell list walks, but this engine's tile formulation
    depends on the 27-cell stencil collapsing into 9 CONSTANT-OFFSET
    contiguous ranges of the sorted array (cell_list.py) — true only for the
    row-major key, where cells (x±1, y+dy, z+dz) at fixed (dy, dz) are
    adjacent. Under a Morton key the stencil fragments into up to 27 scattered
    ranges with block-boundary discontinuities, breaking the contiguous
    column windows the pair passes walk. Row-major sort + contiguous windows IS this engine's analog of
    the z_index_sort design."""
    c = cfg.num_cells_per_dim
    raw = cell_coords(position, cfg)
    oob = jnp.any((raw < 0) | (raw >= c), axis=-1)
    oob_count = jnp.sum(oob & valid).astype(jnp.int32)
    cell = jnp.clip(raw, 0, c - 1)
    key = flatten_rowmajor(cell, cfg)
    key = jnp.where(valid, key, jnp.int32(cfg.num_cells))
    return GridKeys(key=key, cell=cell, oob_count=oob_count)


def compute_keys_fields(x, y, z, valid, cfg: SimConfig):
    """compute_keys on 1-D field rows (f32[N] each) — avoids materializing an
    (N,3) array in the fields-native hot loop. Returns (key int32[N],
    oob_count int32[]) with identical semantics to compute_keys."""
    c = cfg.num_cells_per_dim
    inv = jnp.float32(cfg.h)
    cx = (x / inv).astype(jnp.int32)
    cy = (y / inv).astype(jnp.int32)
    cz = (z / inv).astype(jnp.int32)
    oob = (
        (cx < 0) | (cx >= c) | (cy < 0) | (cy >= c) | (cz < 0) | (cz >= c)
    )
    oob_count = jnp.sum(oob & valid).astype(jnp.int32)
    ci = jnp.int32(c)
    key = (
        jnp.clip(cx, 0, c - 1)
        + ci * jnp.clip(cy, 0, c - 1)
        + ci * ci * jnp.clip(cz, 0, c - 1)
    )
    key = jnp.where(valid, key, jnp.int32(cfg.num_cells))
    return key, oob_count
