"""Unit tests for the SPH smoothing kernels against closed-form values
(SURVEY.md §4a), with the exact guard semantics of simulator.cu:84-130."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from sphjax.core.config import default_config
from sphjax.physics.kernels import (
    pair_density,
    poly6,
    pressure_from_density,
    spiky_grad,
    viscosity_lap,
)
from sphjax.physics.integrate import integrate

CFG = default_config(8)
H = CFG.h


def test_poly6_closed_form():
    # W(0) = d_coeff * h^6
    expected = CFG.d_kernel_coeff * H**6
    got = float(poly6(jnp.float32(0.0), CFG))
    assert got == pytest.approx(expected, rel=1e-6)
    # W at r = h/2: d_coeff * (h² - h²/4)³
    r2 = (H / 2) ** 2
    expected = CFG.d_kernel_coeff * (H**2 - r2) ** 3
    assert float(poly6(jnp.float32(r2), CFG)) == pytest.approx(expected, rel=1e-5)


def test_poly6_cutoff_inclusive():
    h2 = jnp.float32(CFG.h2)
    assert float(poly6(h2, CFG)) == 0.0  # (h²-r²)³ = 0 at boundary
    assert float(poly6(h2 * 1.0001, CFG)) == 0.0  # beyond cutoff
    assert float(poly6(h2 * 0.9999, CFG)) > 0.0


def test_self_density_value():
    """Self contribution m·W(0) = 0.02 · 315/(64π·h³) ≈ 31.33 (SURVEY §2.3)."""
    d = pair_density(jnp.zeros((1, 3), jnp.float32), CFG)
    assert float(d[0]) == pytest.approx(0.02 * 315.0 / (64.0 * math.pi * 0.001), rel=1e-5)


def test_spiky_grad_self_excluded():
    g = spiky_grad(jnp.zeros((3,), jnp.float32), CFG)
    np.testing.assert_array_equal(np.asarray(g), 0.0)
    # below EPS_F distance also excluded
    g = spiky_grad(jnp.asarray([5e-5, 0, 0], jnp.float32), CFG)
    np.testing.assert_array_equal(np.asarray(g), 0.0)


def test_spiky_grad_closed_form():
    r = 0.05
    disp = jnp.asarray([r, 0.0, 0.0], jnp.float32)
    g = np.asarray(spiky_grad(disp, CFG))
    scale = -CFG.v_kernel_coeff * (H - r) ** 2 / r
    assert g[0] == pytest.approx(r * scale, rel=1e-5)
    assert g[1] == g[2] == 0.0
    # points from j toward i scaled negative → attractive direction sign check
    assert g[0] < 0


def test_spiky_cutoff():
    g = spiky_grad(jnp.asarray([H * 1.01, 0, 0], jnp.float32), CFG)
    np.testing.assert_array_equal(np.asarray(g), 0.0)


def test_viscosity_lap():
    r = 0.07
    assert float(viscosity_lap(jnp.float32(r), CFG)) == pytest.approx(
        CFG.v_kernel_coeff * (H - r), rel=1e-5
    )
    assert float(viscosity_lap(jnp.float32(H), CFG)) == 0.0  # (h-r)=0 at boundary
    assert float(viscosity_lap(jnp.float32(H * 1.01), CFG)) == 0.0
    assert float(viscosity_lap(jnp.float32(5e-5), CFG)) == 0.0  # below EPS


def test_pressure_clamps():
    rho, p = pressure_from_density(jnp.asarray([0.0, 500.0, 1500.0], jnp.float32), CFG)
    np.testing.assert_allclose(np.asarray(rho), [1e-4, 500.0, 1500.0])
    np.testing.assert_allclose(np.asarray(p), [0.0, 0.0, 500.0])


def test_integrate_gravity_and_clamp():
    pos = jnp.asarray([[5.0, 0.1001, 5.0]], jnp.float32)
    vel = jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32)
    force = jnp.zeros((1, 3), jnp.float32)
    rho = jnp.ones((1,), jnp.float32)
    x, v = integrate(pos, vel, force, rho, CFG)
    # v.y = -1 + 0.01*(-9.8) = -1.098 → y = 0.1001 - 0.01098 < h → clamp + reflect
    assert float(x[0, 1]) == pytest.approx(0.1)
    assert float(v[0, 1]) == pytest.approx(1.098 * CFG.elasticity, rel=1e-5)


def test_integrate_deadband():
    pos = jnp.asarray([[5.0, 5.0, 5.0]], jnp.float32)
    vel = jnp.asarray([[5e-5, 0.0, 0.0]], jnp.float32)
    force = jnp.zeros((1, 3), jnp.float32)
    rho = jnp.ones((1,), jnp.float32)
    # gravity pulls y; x component stays tiny → zeroed by deadband
    x, v = integrate(pos, vel, force, rho, CFG)
    assert float(v[0, 0]) == 0.0
    assert float(v[0, 1]) == pytest.approx(-0.098, rel=1e-5)
