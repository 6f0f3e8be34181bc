"""O(N²) all-pairs neighbor oracle.

Mathematically identical to the reference's 27-cell walk: the grid cell edge
equals the smoothing radius h, so every pair within the kernel support r ≤ h is
inside the 3×3×3 stencil, and every pair outside it contributes exactly zero
through the kernel cutoffs (simulator.cu:84-130). This path is therefore the
correctness oracle for the cell-list path, and the practical engine for small N
(SURVEY.md §4 item (b)).

Row-chunked (lax.map) so peak memory is O(B·N), not O(N²).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphjax.core.config import SimConfig
from sphjax.physics.kernels import pair_density, pair_force, pressure_from_density
from sphjax.utils.chunking import pick_chunk


def _chunks(n: int, cfg: SimConfig) -> int:
    return n // pick_chunk(n, cfg.chunk_size)


def density_allpairs(position, valid, cfg: SimConfig):
    """ρᵢ = Σⱼ m·W_poly6 over all valid j (self included, simulator.cu:161-185);
    then the ρ/p clamps of simulator.cu:186-189. Returns (density, pressure)."""
    n = position.shape[0]
    b = n // _chunks(n, cfg)

    def row(args):
        tpos, tvalid = args
        disp = tpos[:, None, :] - position[None, :, :]  # [B, N, 3]
        contrib = pair_density(disp, cfg)
        rho = jnp.sum(jnp.where(valid[None, :], contrib, 0.0), axis=1)
        rho, p = pressure_from_density(rho, cfg)
        rho = jnp.where(tvalid, rho, 1.0)
        return rho, jnp.where(tvalid, p, 0.0)

    rho, p = jax.lax.map(row, (position.reshape(-1, b, 3), valid.reshape(-1, b)))
    return rho.reshape(-1), p.reshape(-1)


def forces_allpairs(position, velocity, density, pressure, valid, cfg: SimConfig):
    """fᵢ = Σⱼ pressure + viscosity terms over all valid j (simulator.cu:192-256)."""
    n = position.shape[0]
    b = n // _chunks(n, cfg)

    def row(args):
        tpos, tvel, tp, tvalid = args
        disp = tpos[:, None, :] - position[None, :, :]  # [B, N, 3]
        dv = velocity[None, :, :] - tvel[:, None, :]
        f = pair_force(disp, dv, tp[:, None], pressure[None, :], density[None, :], cfg)
        f = jnp.where(valid[None, :, None], f, 0.0)
        f = jnp.sum(f, axis=1)
        return jnp.where(tvalid[:, None], f, 0.0)

    f = jax.lax.map(
        row,
        (
            position.reshape(-1, b, 3),
            velocity.reshape(-1, b, 3),
            pressure.reshape(-1, b),
            valid.reshape(-1, b),
        ),
    )
    return f.reshape(-1, 3)
