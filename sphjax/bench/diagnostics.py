"""Simulation diagnostics — the observability layer the reference lacks
(SURVEY.md §5: its only instrumentation is the Times report and device-printf
OOB warnings). Pure jnp; cheap enough to fetch every few steps."""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphjax.core.config import SimConfig
from sphjax.core.state import FluidState
from sphjax.neighbors.grid import compute_keys


class Diagnostics(NamedTuple):
    num_valid: jnp.ndarray  # int32
    kinetic_energy: jnp.ndarray  # f32 — ½ m Σ|v|²
    momentum: jnp.ndarray  # f32[3] — m Σ v
    max_speed: jnp.ndarray  # f32
    mean_density: jnp.ndarray  # f32 (valid only)
    max_density: jnp.ndarray  # f32
    occupied_cells: jnp.ndarray  # int32
    max_cell_occupancy: jnp.ndarray  # int32


def compute_diagnostics(state: FluidState, cfg: SimConfig) -> Diagnostics:
    v = state.valid
    vel = jnp.where(v[:, None], state.velocity, 0.0)
    m = jnp.float32(cfg.mass)
    speed2 = jnp.sum(vel * vel, axis=1)
    nvalid = jnp.sum(v)
    keys = compute_keys(state.position, v, cfg).key
    counts = jnp.zeros((cfg.num_cells + 1,), jnp.int32).at[keys].add(1)
    counts = counts[: cfg.num_cells]
    rho = jnp.where(v, state.density, 0.0)
    return Diagnostics(
        num_valid=nvalid.astype(jnp.int32),
        kinetic_energy=0.5 * m * jnp.sum(speed2),
        momentum=m * jnp.sum(vel, axis=0),
        max_speed=jnp.sqrt(jnp.max(speed2)),
        mean_density=jnp.sum(rho) / jnp.maximum(nvalid, 1),
        max_density=jnp.max(rho),
        occupied_cells=jnp.sum(counts > 0).astype(jnp.int32),
        max_cell_occupancy=jnp.max(counts).astype(jnp.int32),
    )


def format_diagnostics(d) -> str:
    """One-line report (the spiritual successor of printGridList's occupancy
    dump, simulator.cu:22-41)."""
    return (
        f"N={int(d.num_valid)} KE={float(d.kinetic_energy):.4f} "
        f"|p|={float(sum(x * x for x in d.momentum)) ** 0.5:.4f} "
        f"v_max={float(d.max_speed):.3f} "
        f"rho mean/max={float(d.mean_density):.1f}/{float(d.max_density):.1f} "
        f"cells={int(d.occupied_cells)} occ_max={int(d.max_cell_occupancy)}"
    )
