"""Symplectic (semi-implicit) Euler integration with reflective box boundaries.

Parity with kernelUpdatePositions (/root/reference/src/simulator.cu:258-318):
  1. v += dt · f/ρ, with gravity added as an *acceleration* on y
     (v.y += dt·(f.y/ρ + g), simulator.cu:269-272).
  2. x += dt · v.
  3. Per-axis clamp to [h, box−h]; on clamp, v *= −elasticity (= −0.5).
  4. Per-component velocity deadband: |v_c| < EPS_F → 0 (simulator.cu:306-314).

Purely elementwise → fuses into one VPU pass under XLA.
"""

from __future__ import annotations

import jax.numpy as jnp

from sphjax.core.config import SimConfig


def integrate(
    position: jnp.ndarray,
    velocity: jnp.ndarray,
    force: jnp.ndarray,
    density: jnp.ndarray,
    cfg: SimConfig,
):
    """Returns (new_position, new_velocity). Shapes [N,3],[N,3],[N,3],[N]."""
    dt = jnp.float32(cfg.dt)
    g = jnp.zeros((3,), jnp.float32).at[1].set(jnp.float32(cfg.gravity))
    v = velocity + dt * (force / density[:, None] + g)
    x = position + dt * v

    lo = jnp.float32(cfg.h)
    hi = jnp.float32(cfg.box_dim) - jnp.float32(cfg.h)
    out = (x < lo) | (x > hi)
    x = jnp.clip(x, lo, hi)
    v = jnp.where(out, v * jnp.float32(-cfg.elasticity), v)

    v = jnp.where(jnp.abs(v) < jnp.float32(cfg.eps), 0.0, v)
    return x, v


def integrate_fields(x, y, z, vx, vy, vz, fx, fy, fz, density, cfg: SimConfig):
    """integrate() on 1-D field rows — identical per-component f32 arithmetic
    (gravity enters the y component exactly as the 3-vector add does; the x/z
    components' +0.0 is an f32 identity), avoiding (N,3) materialization in
    the fields-native hot loop. Returns (x, y, z, vx, vy, vz)."""
    dt = jnp.float32(cfg.dt)
    g = jnp.float32(cfg.gravity)
    lo = jnp.float32(cfg.h)
    hi = jnp.float32(cfg.box_dim) - jnp.float32(cfg.h)
    el = jnp.float32(-cfg.elasticity)
    eps = jnp.float32(cfg.eps)

    def axis(p, v, f, grav):
        v = v + dt * (f / density + grav)
        p = p + dt * v
        out = (p < lo) | (p > hi)
        p = jnp.clip(p, lo, hi)
        v = jnp.where(out, v * el, v)
        v = jnp.where(jnp.abs(v) < eps, 0.0, v)
        return p, v

    x, vx = axis(x, vx, fx, jnp.float32(0.0))
    y, vy = axis(y, vy, fy, g)
    z, vz = axis(z, vz, fz, jnp.float32(0.0))
    return x, y, z, vx, vy, vz
