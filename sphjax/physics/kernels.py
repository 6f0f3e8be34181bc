"""SPH smoothing kernels — pure, vectorized jnp functions.

Parity with the reference's device helpers (/root/reference/src/simulator.cu):
  * poly6 density kernel      — densityKernel,   simulator.cu:84-97
  * spiky pressure gradient   — pressureKernel,  simulator.cu:99-117
  * viscosity Laplacian       — viscosityKernel, simulator.cu:119-130

Exact guard semantics preserved:
  * poly6: zero iff r² > h² (NO self-exclusion — a particle's own poly6
    contribution is included in its density, simulator.cu:93).
  * spiky grad: zero iff r² > h² or r < EPS_F (self excluded).
  * viscosity: zero iff r > h or r < EPS_F.

All functions broadcast over leading dims and are safe at r=0 (no NaN from the
masked-out 1/r): division is guarded before the select.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from sphjax.core.config import SimConfig


def poly6(r2: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """W_poly6(r) = (315/64πh⁹)(h²−r²)³ for r² ≤ h², else 0. Takes squared
    distance (the reference never takes the sqrt for density)."""
    h2 = np.float32(cfg.h2)
    diff = h2 - r2
    w = np.float32(cfg.d_kernel_coeff) * diff * diff * diff
    return jnp.where(r2 <= h2, w, 0.0)


def spiky_scale(r2: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """Scalar factor of ∇W_spiky as the reference evaluates it
    (simulator.cu:99-117): ∇W = disp · scale with
    scale = −(45/πh⁶)(h−r)²/r, zeroed when r² > h² or r < EPS_F. Takes the
    squared distance, so callers without a trailing xyz axis (the Triton
    pair kernels) share it."""
    h = np.float32(cfg.h)
    eps = np.float32(cfg.eps)
    r = jnp.sqrt(r2)
    live = (r2 <= h * h) & (r >= eps)
    safe_r = jnp.where(live, r, 1.0)
    return jnp.where(
        live, (-np.float32(cfg.v_kernel_coeff)) * (h - safe_r) ** 2 / safe_r, 0.0
    )


def spiky_grad(disp: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """∇W_spiky for disp = x_i − x_j (shape [..., 3]): disp · spiky_scale."""
    r2 = jnp.sum(disp * disp, axis=-1)
    return disp * spiky_scale(r2, cfg)[..., None]


def viscosity_lap(r: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """∇²W_visc(r) = (45/πh⁶)(h−r) for EPS_F ≤ r ≤ h, else 0
    (simulator.cu:119-130 — boundary r == h is *included*)."""
    h = np.float32(cfg.h)
    live = (r <= h) & (r >= np.float32(cfg.eps))
    return jnp.where(live, np.float32(cfg.v_kernel_coeff) * (h - r), 0.0)


def pair_density(disp: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """mass · W_poly6(‖disp‖) — one neighbor's density contribution
    (simulator.cu:178-179)."""
    r2 = jnp.sum(disp * disp, axis=-1)
    return np.float32(cfg.mass) * poly6(r2, cfg)


def pressure_from_density(density: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """ρ ← max(ρ, EPS_F); p = max(0, k(ρ − ρ₀)) (simulator.cu:186-189).
    Returns (clamped_density, pressure)."""
    density = jnp.maximum(density, np.float32(cfg.eps))
    pressure = jnp.maximum(
        0.0, np.float32(cfg.gas_constant) * (density - np.float32(cfg.rest_density))
    )
    return density, pressure


def pair_force_terms(r2, p_i, p_j, rho_j, cfg: SimConfig):
    """Scalar factors of one neighbor's force (simulator.cu:224-250), so that
    force = coef_p · (disp · scale) + coef_v · dv with
      coef_p = −m (p_i + p_j)/(2 ρ_j),  scale = spiky_scale(r²),
      coef_v = μ m ∇²W_visc(r) / ρ_j.
    Shared by pair_force and the per-axis Triton force kernel."""
    m = np.float32(cfg.mass)
    coef_p = -m * (p_i + p_j) / (2.0 * rho_j)
    coef_v = np.float32(cfg.viscosity) * m * viscosity_lap(jnp.sqrt(r2), cfg) / rho_j
    return coef_p, spiky_scale(r2, cfg), coef_v


def pair_force(
    disp: jnp.ndarray,
    dv: jnp.ndarray,
    p_i: jnp.ndarray,
    p_j: jnp.ndarray,
    rho_j: jnp.ndarray,
    cfg: SimConfig,
) -> jnp.ndarray:
    """One neighbor's force contribution (simulator.cu:224-250):
      pressure:  −m (p_i + p_j)/(2 ρ_j) · ∇W_spiky(disp)
      viscosity:  μ m (v_j − v_i) ∇²W_visc(r) / ρ_j
    disp = x_i − x_j [...,3]; dv = v_j − v_i [...,3]; scalars broadcast."""
    r2 = jnp.sum(disp * disp, axis=-1)
    coef_p, scale, coef_v = pair_force_terms(r2, p_i, p_j, rho_j, cfg)
    return coef_p[..., None] * (disp * scale[..., None]) + coef_v[..., None] * dv
