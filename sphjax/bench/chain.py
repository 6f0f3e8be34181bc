"""Scan-chained step runs and the parity comparisons shared by bench.py and
chip_smoke.py.

A run chains `steps` timesteps on device with lax.scan (steps are
sequentially dependent; the scan removes per-step host dispatch, as a
production loop runs). It is compiled ahead of time, so compilation is
set-up time, and run once before any timed window; a nonzero overflow count
grows the capacities and recompiles, so the timed physics is never
degraded. A timed window ends with block_until_ready.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from sphjax.core.config import SimConfig
from sphjax.engine.step import BACKENDS


def grow(cfg: SimConfig) -> SimConfig:
    """The capacities doubled — the one grow step of every replay loop."""
    return dataclasses.replace(
        cfg,
        tile_cand_capacity=cfg.tile_cand_capacity * 2,
        window_capacity=cfg.window_capacity * 2,
    )


def make_chain(cfg: SimConfig, backend: str, steps: int):
    """Jitted `state -> (state, summed window overflow)` over `steps` steps."""
    step = BACKENDS[backend]

    def run(state):
        def body(s, _):
            s2, aux = step(s, cfg)
            return s2, aux.window_overflow

        s2, ovf = jax.lax.scan(body, state, None, length=steps)
        return s2, jnp.sum(ovf)

    return jax.jit(run)


def compile_chain(cfg: SimConfig, backend: str, steps: int, state0,
                  tries: int = 6):
    """AOT-compile the chain and run it once, growing the capacities while
    the run overflows. Returns (cfg, compiled, compile_seconds, final)."""
    for _ in range(tries):
        t0 = time.perf_counter()
        compiled = make_chain(cfg, backend, steps).lower(state0).compile()
        seconds = time.perf_counter() - t0
        final, ovf = compiled(state0)
        if int(ovf) == 0:
            return cfg, compiled, seconds, final
        cfg = grow(cfg)
    raise RuntimeError(f"{backend}: capacity growth did not converge")


def time_chain(compiled, state0) -> float:
    """Seconds of one run of a compiled chain, ended by block_until_ready."""
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(state0))
    return time.perf_counter() - t0


def compare_states(a, b, n: int, pos_atol: float = 1e-4,
                   rho_rtol: float = 1e-4) -> list[str]:
    """Per-particle comparison of two FluidStates' valid rows (every
    backend keeps the caller's particle order): positions within pos_atol,
    densities within rho_rtol. Returns the failures (empty: pass)."""
    a, b = jax.device_get((a, b))
    va, vb = np.asarray(a.valid), np.asarray(b.valid)
    if int(va.sum()) != n or not np.array_equal(va, vb):
        return [f"valid rows differ ({int(va.sum())} / {int(vb.sum())} of {n})"]
    errors = []
    for name, x, y, rtol, atol in (
        ("positions", a.position, b.position, 0.0, pos_atol),
        ("density", a.density, b.density, rho_rtol, 0.0),
    ):
        try:
            np.testing.assert_allclose(np.asarray(x)[va], np.asarray(y)[va],
                                       rtol=rtol, atol=atol)
        except AssertionError as e:
            errors.append(f"{name}: {e}")
    return errors
