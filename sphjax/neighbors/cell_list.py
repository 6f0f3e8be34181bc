"""Sort-based cell lists — the one neighbor structure that replaces
all three CUDA variants (lock-free CAS linked lists on `main`, index sort,
Morton z-index sort; /root/reference/README.md:5).

Design (no atomics, no pointer chasing, fully static shapes):

  1. key[i] = x + C·y + C²·z  (row-major, x fastest — the reference's own
     flatten, simulator.cu:78-82). Invalid slots get sentinel `num_cells`.
  2. Stable argsort of keys → particles of the same cell are contiguous, and
     the 3 x-adjacent cells of a (y,z) column are contiguous too.
  3. starts[k] = #particles with key < k (bincount + exclusive cumsum) — the
     analog of the per-cell list heads (simulator.cu:133-147), rebuilt
     every step, which also subsumes kernelResetGrid (simulator.cu:321-326).
  4. The 27-cell stencil (simulator.cu:163-185) becomes **9 contiguous
     windows**: for neighbor column (dy,dz), candidates live in the flat-key
     range [key−1+dy·C+dz·C², key+2+dy·C+dz·C²) — a fixed-capacity dynamic
     slice of the sorted arrays, masked by the true range length.

Boundary note: at domain edges a window can wrap into cells on the far side of
the box (flat-key arithmetic wraps rows). Those candidates are ≥ (C−2)·h away,
so the exact r ≤ h kernel masks zero them — correctness never depends on the
window contents, only on the distance test, mirroring how the reference's
27-cell walk over-scans and relies on the same cutoff.

Window capacity is static (cfg.window_capacity); occupancy beyond it is
*detected* (overflow count in the step aux) so the engine can re-trace with a
larger capacity instead of silently dropping interactions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphjax.core.config import SimConfig
from sphjax.neighbors.grid import compute_keys


def starts_table(key, cfg: SimConfig) -> jnp.ndarray:
    """starts[k] = #particles with key < k, as an int32[num_cells + 2] table,
    via bincount scatter-add + exclusive cumsum. Each column window of the
    pair passes is then [starts[k−1+off], starts[k+2+off])."""
    counts = jnp.zeros((cfg.num_cells + 1,), jnp.int32).at[key].add(1)
    return jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )


class CellList(NamedTuple):
    perm: jnp.ndarray  # int32[Np] — sorted[i] = original[perm[i]]
    key_sorted: jnp.ndarray  # int32[Np]
    starts: jnp.ndarray  # int32[num_cells + 2] — exclusive prefix counts
    valid_sorted: jnp.ndarray  # bool[Np]
    oob_count: jnp.ndarray  # int32[] diagnostic (reference printf, cu:60-73)


def build_cell_list(
    position: jnp.ndarray, valid: jnp.ndarray, cfg: SimConfig
) -> CellList:
    """One sorted pass replaces kernelBuildGrid + kernelResetGrid."""
    keys = compute_keys(position, valid, cfg)
    perm = jnp.argsort(keys.key, stable=True).astype(jnp.int32)
    key_sorted = keys.key[perm]
    return CellList(
        perm=perm,
        key_sorted=key_sorted,
        starts=starts_table(keys.key, cfg),
        valid_sorted=key_sorted < cfg.num_cells,
        oob_count=keys.oob_count,
    )


def column_offsets(cfg: SimConfig) -> list[int]:
    """Flat-key offsets of the 9 (dy,dz) neighbor columns."""
    c = cfg.num_cells_per_dim
    return [dy * c + dz * c * c for dz in (-1, 0, 1) for dy in (-1, 0, 1)]


def window_candidates(
    target_key: jnp.ndarray, starts: jnp.ndarray, n_sorted: int, cfg: SimConfig
):
    """Candidate neighbor indices (into the *sorted* arrays) for each target.

    target_key: int32[B]; n_sorted = total sorted slots (for index clamping).
    Returns (idx int32[B, 9, W], mask bool[B, 9, W], overflow int32[]) where
    W = cfg.window_capacity. Sentinel-keyed (invalid) targets produce
    fully-masked junk that callers discard.
    """
    w = cfg.window_capacity
    nc = cfg.num_cells
    offs = jnp.asarray(column_offsets(cfg), jnp.int32)
    base = target_key[:, None] + offs[None, :] - 1  # [B, 9]
    lo = jnp.clip(base, 0, nc)
    hi = jnp.clip(base + 3, 0, nc)  # exclusive of the sentinel bucket
    hi = jnp.maximum(hi, lo)
    start = starts[lo]
    cnt = jnp.minimum(starts[hi] - start, w)  # truncate; excess is counted below
    full_cnt = starts[hi] - start
    lane = jnp.arange(w, dtype=jnp.int32)
    idx = jnp.minimum(start[..., None] + lane, n_sorted - 1)  # [B, 9, W]
    mask = lane < cnt[..., None]
    overflow = jnp.sum(jnp.maximum(full_cnt - w, 0)).astype(jnp.int32)
    return idx, mask, overflow
