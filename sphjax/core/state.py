"""Particle state — structure-of-arrays pytree.

The reference stores an AoS `Particle {float3 position, velocity, force;
float density, pressure; Particle *next}` (/root/reference/src/simulator.h:33-51)
with an intrusive linked-list pointer for the neighbor grid. Here the natural
layout is SoA `f32[N,3]` / `f32[N]` arrays (vector units want contiguous
same-field data), and the linked-list pointer disappears entirely — neighbor
structure is recomputed per step from a sort (see sphjax.neighbors).

`valid` marks live particle slots: the engine pads N up to a chunk multiple so
every blocked pass sees static shapes; padding slots are invalid and are parked
outside every grid cell (their sort key is the out-of-range sentinel).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class FluidState(NamedTuple):
    """SoA particle state; a pytree (NamedTuple) so it flows through jit/scan."""

    position: jnp.ndarray  # f32[N, 3]
    velocity: jnp.ndarray  # f32[N, 3]
    force: jnp.ndarray  # f32[N, 3]
    density: jnp.ndarray  # f32[N]
    pressure: jnp.ndarray  # f32[N]
    valid: jnp.ndarray  # bool[N]

    @property
    def num_slots(self) -> int:
        return self.position.shape[0]


def make_state(position: jnp.ndarray, num_valid: int | None = None) -> FluidState:
    """Build a zero-velocity state from positions, mirroring the reference
    Particle ctor (simulator.h:39-46: velocity/force/density/pressure = 0)."""
    n = position.shape[0]
    position = position.astype(jnp.float32)
    zeros3 = jnp.zeros((n, 3), jnp.float32)
    zeros1 = jnp.zeros((n,), jnp.float32)
    if num_valid is None:
        num_valid = n
    valid = jnp.arange(n) < num_valid
    return FluidState(
        position=position,
        velocity=zeros3,
        force=zeros3,
        density=zeros1,
        pressure=zeros1,
        valid=valid,
    )


def pad_state(state: FluidState, target_slots: int) -> FluidState:
    """Pad a state to `target_slots` slots with invalid particles parked at the
    box origin (they are excluded from every neighbor structure via the key
    sentinel, so their position value is irrelevant)."""
    n = state.num_slots
    if target_slots < n:
        raise ValueError("target_slots must be >= current slots")
    if target_slots == n:
        return state
    pad = target_slots - n

    def pad3(a):
        return jnp.concatenate([a, jnp.zeros((pad, 3), a.dtype)], axis=0)

    def pad1(a):
        return jnp.concatenate([a, jnp.zeros((pad,), a.dtype)], axis=0)

    return FluidState(
        position=pad3(state.position),
        velocity=pad3(state.velocity),
        force=pad3(state.force),
        density=pad1(state.density),
        pressure=pad1(state.pressure),
        valid=jnp.concatenate([state.valid, jnp.zeros((pad,), bool)]),
    )
