"""Initial particle placement — parity with Simulator::setup
(/root/reference/src/simulator.cu:411-460).

Two modes, matching the `-i random|grid` flag:
  * grid  — cubic lattice, spacing 0.9h, origin (h,h,h), z-fastest fill order,
    truncated at N (simulator.cu:438-453).
  * random — uniform in [1, box_dim-1]³ (simulator.cu:430-437). The reference
    uses unseeded libc rand(); we use the JAX counter PRNG (seed 0 default) —
    deterministic, splittable, generated on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sphjax.core.config import SimConfig
from sphjax.core.state import FluidState, make_state, pad_state


def _lattice_nx(cfg: SimConfig) -> int:
    """Lattice points per axis: nx = floor((box-2h)/0.9h)+1 in f32, the exact
    reference arithmetic (simulator.cu:441-443). Single source of truth for
    grid_positions AND lattice_capacity, so the CLI/bench fallback threshold
    can never drift from the actual ValueError boundary."""
    h = np.float32(cfg.h)
    spacing = np.float32(0.9) * h
    return int(np.floor((np.float32(cfg.box_dim) - 2 * h) / spacing)) + 1


def grid_positions(cfg: SimConfig) -> np.ndarray:
    """Lattice exactly as simulator.cu:438-453: spacing = 0.9h;
    nx = floor((box-2h)/spacing)+1 per axis; position = h + spacing*(x,y,z);
    filled z-fastest (x outer, y middle, z inner) until count == N."""
    h = np.float32(cfg.h)
    spacing = np.float32(0.9) * h
    nx = _lattice_nx(cfg)
    n = cfg.num_particles
    if n > lattice_capacity(cfg):
        raise ValueError(
            f"num_particles={n} exceeds lattice capacity {lattice_capacity(cfg)}"
        )
    idx = np.arange(n, dtype=np.int64)
    # z-fastest: count = x*(ny*nz) + y*nz + z
    x = idx // (nx * nx)
    y = (idx // nx) % nx
    z = idx % nx
    pos = np.stack([x, y, z], axis=1).astype(np.float32)
    return (h + spacing * pos).astype(np.float32)


def lattice_capacity(cfg: SimConfig) -> int:
    """Particles the 0.9h grid lattice holds in the box (nx³ with the exact
    grid_positions spacing math, simulator.cu:438-453). N above this must
    use random init — the CLI and bench fall back automatically."""
    return _lattice_nx(cfg) ** 3


def random_positions(
    cfg: SimConfig, seed: int = 0, reference_rng: bool = False
) -> np.ndarray:
    """Uniform in [1, box_dim-1]³ (simulator.cu:430-437: rand()/RAND_MAX *
    (box-2) + 1). Default: JAX counter PRNG. With reference_rng=True, uses the
    native C++ library to reproduce the reference's libc rand() sequence
    bit-exactly (glibc default seed when seed=1, like the unseeded reference)."""
    if reference_rng:
        from sphjax.utils.native import reference_random_positions

        pos = reference_random_positions(cfg.num_particles, cfg.box_dim, seed=max(seed, 1))
        if pos is not None:
            return pos
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (cfg.num_particles, 3), dtype=jnp.float32)
    pos = u * (cfg.box_dim - 2.0) + 1.0
    return np.asarray(pos, dtype=np.float32)


def init_state(cfg: SimConfig, random_init: bool = False, seed: int = 0) -> FluidState:
    """Build the padded initial FluidState for `cfg` (velocities etc. zero,
    matching the Particle ctor, simulator.h:39-46)."""
    pos = random_positions(cfg, seed) if random_init else grid_positions(cfg)
    state = make_state(jnp.asarray(pos))
    return pad_state(state, cfg.padded_num_particles)
