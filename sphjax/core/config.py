"""Simulation configuration — the JAX analog of the reference's `Settings`
struct plus its compile-time physics `#define`s.

Reference parity:
  - `Settings` fields: /root/reference/src/simulator.h:19-31, populated in
    /root/reference/src/main.cpp:57-63 and uploaded to CUDA `__constant__`
    memory at /root/reference/src/simulator.cu:459.
  - Physics constants (`MASS`, `GAS_CONSTANT`, ...): /root/reference/src/simulator.h:6-12.
  - Screen-box click region: /root/reference/src/simulator.h:14-17.

Here the `__constant__`-memory broadcast becomes a frozen (hashable)
dataclass that is a *static* argument under `jax.jit` — every constant is baked
into the compiled executable, exactly like constant memory, with zero runtime
reads.
"""

from __future__ import annotations

import dataclasses

PI = 3.14159265  # reference: simulator.h:6 (float literal 3.14159265f)
EPS_F = 1e-4  # reference: simulator.cu:14

# Click-region pixel bounds (reference: simulator.h:14-17)
BOX_MIN_X = 200
BOX_MAX_X = 600
BOX_MIN_Y = 150
BOX_MAX_Y = 450

PUSH_STRENGTH = 5.0  # reference: simulator.cu:13
MAX_PARTICLES_DEFAULT = 1000  # reference default -n (main.cpp:21)


def _f32(x: float) -> float:
    """Round a python float through float32, mirroring the reference's
    single-precision constant computation (main.cpp:57-61)."""
    import struct

    return struct.unpack("f", struct.pack("f", x))[0]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static physics + scene configuration. Hashable → usable as a jit-static arg."""

    num_particles: int = MAX_PARTICLES_DEFAULT
    h: float = 0.1  # smoothing radius (main.cpp:57)
    box_dim: float = 10.0  # main.cpp:62
    num_cells_per_dim: int = 100  # box_dim / h (main.cpp:62)
    dt: float = 0.01  # main.cpp:62
    mass: float = 0.02  # simulator.h:7
    gas_constant: float = 1.0  # simulator.h:8
    rest_density: float = 1000.0  # simulator.h:9
    viscosity: float = 1.0  # simulator.h:10
    gravity: float = -9.8  # simulator.h:11
    elasticity: float = 0.5  # simulator.h:12
    eps: float = EPS_F

    # --- capacity knobs (static under jit; no dynamic shapes) ---
    # Max particles per 3-cell x-window gathered per (dy, dz) neighbor column
    # (used by the per-target window API; the engine's hot path uses tiles).
    # Overflow is *detected* (aux.window_overflow) rather than silently dropped;
    # the engine re-traces with a larger capacity when tripped.
    window_capacity: int = 48
    # Tile formulation of the XLA pair passes: sorted particles are processed
    # in tiles of `tile_size` targets; each tile's 9 neighbor columns are
    # CONTIGUOUS slices of the sorted arrays (dynamic slices, no gathers)
    # holding up to `tile_cand_capacity` candidates shared by the whole tile.
    # Capacity must cover tile_size + ~2×max-cell-occupancy; overflow is
    # detected and the driver re-traces larger.
    tile_size: int = 256
    tile_cand_capacity: int = 768
    # Particle chunk size for the blocked density/force passes (bounds peak HBM
    # footprint of gathered candidates; pipelined by XLA via lax.map).
    chunk_size: int = 8192

    @property
    def h2(self) -> float:
        return _f32(self.h) * _f32(self.h)

    @property
    def v_kernel_coeff(self) -> float:
        """45/(π h⁶) — shared by the spiky-gradient and viscosity-Laplacian
        kernels (main.cpp:59, note the reference reuses one coefficient)."""
        return _f32(45.0 / (PI * self.h**6))

    @property
    def d_kernel_coeff(self) -> float:
        """315/(64 π h⁹) — poly6 density kernel coefficient (main.cpp:60)."""
        return _f32(315.0 / (64.0 * PI * self.h**9))

    @property
    def num_cells(self) -> int:
        return self.num_cells_per_dim**3

    @property
    def padded_num_particles(self) -> int:
        """Internal particle count, rounded up to a multiple of chunk_size so
        the blocked passes see static, evenly-divisible shapes. Extra slots are
        invalid (masked; parked outside every grid cell)."""
        c = min(self.chunk_size, _round_up(self.num_particles, 256))
        return _round_up(self.num_particles, c)

    @property
    def effective_chunk_size(self) -> int:
        c = min(self.chunk_size, _round_up(self.num_particles, 256))
        return c

    def validate(self) -> None:
        if self.num_particles <= 0:
            raise ValueError("num_particles must be positive")
        if self.h <= 0 or self.box_dim <= 0 or self.dt <= 0:
            raise ValueError("h, box_dim, dt must be positive")
        for f in (
            "window_capacity",
            "tile_size",
            "tile_cand_capacity",
            "chunk_size",
        ):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive (capacity doubling "
                                 f"cannot grow a zero capacity)")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def default_config(num_particles: int = MAX_PARTICLES_DEFAULT, **kw) -> SimConfig:
    """Build the reference's exact scene: h=0.1 in a 10×10×10 box with a
    100³ uniform grid and dt=0.01 (main.cpp:57-63)."""
    cfg = SimConfig(num_particles=num_particles, **kw)
    cfg.validate()
    return cfg

