"""One SPH timestep — the reference's four-kernel launch sequence
(kernelBuildGrid → kernelUpdatePressureAndDensity → kernelUpdateForces →
kernelUpdatePositions → kernelResetGrid, /root/reference/src/simulator.cu:462-497)
fused into a single jitted function.

Interchangeable backends with identical physics (BACKENDS):
  * allpairs      — O(N²) oracle (tests / small N).
  * cell_list     — sort-based cell lists with XLA tile passes: the CPU step
    and the plain reference on the GPU.
  * pallas_triton — the same cell lists with the density and force passes as
    Pallas kernels through Triton (pallas/pair_passes.py); GPU only.

choose_backend() maps the platform to the production backend. The cell-list
backends compute in *sorted* particle order (gather once, work on contiguous
data) and scatter results back to the caller's particle order, keeping
stable particle identity exactly like the reference's fixed particle array.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sphjax.core.config import SimConfig
from sphjax.core.state import FluidState
from sphjax.neighbors.allpairs import density_allpairs, forces_allpairs
from sphjax.neighbors.cell_list import CellList, build_cell_list, column_offsets
from sphjax.physics.integrate import integrate
from sphjax.physics.kernels import pair_density, pair_force, pressure_from_density
from sphjax.utils.chunking import pick_chunk


class StepAux(NamedTuple):
    """Per-step diagnostics (the analog of the reference's device-printf
    OOB warnings, simulator.cu:60-73, plus capacity-overflow accounting that
    the fixed-shape design requires)."""

    oob_count: jnp.ndarray  # int32[] — particles outside the grid
    window_overflow: jnp.ndarray  # int32[] — candidates beyond window capacity


def _tile_shape(n: int, cfg: SimConfig) -> tuple[int, int]:
    """(tile_size, candidate_capacity) with tile_size dividing n."""
    t = pick_chunk(n, cfg.tile_size)
    return t, cfg.tile_cand_capacity


def _tile_ranges(tkey, tvalid, offset: int, starts, cfg: SimConfig, cap: int):
    """Contiguous sorted-array range holding ALL candidates at flat-key offset
    `offset` for every valid target in the tile: keys span [kmin−1+off,
    kmax+2+off) in flat-cell space, which is one contiguous slice after the
    row-major sort. Returns (start, cnt, full_cnt)."""
    nc = cfg.num_cells
    big = jnp.int32(nc)
    kmin = jnp.min(jnp.where(tvalid, tkey, big))
    kmax = jnp.max(jnp.where(tvalid, tkey, -1))
    lo_cell = jnp.clip(kmin + offset - 1, 0, nc)
    hi_cell = jnp.clip(kmax + offset + 2, lo_cell, nc)
    start = starts[lo_cell]
    full_cnt = starts[hi_cell] - start
    return start, jnp.minimum(full_cnt, cap), full_cnt


# Tiles per lax.map loop trip of the XLA pair passes (vmapped within a trip):
# the fastest of 1 / 16 / 64 on an H100 at N = 262,144 (PERF.md).
TILE_BATCH = 16


def _map_tiles(tile, xs):
    """lax.map over the tile axis, TILE_BATCH tiles per loop trip."""
    return jax.lax.map(tile, xs, batch_size=min(TILE_BATCH, xs[0].shape[0]))


def _density_pass_sorted(sp, key_s, valid_s, starts, cfg: SimConfig):
    """Density + pressure for sorted targets (kernelUpdatePressureAndDensity,
    simulator.cu:149-190), tile formulation: each tile's 9 neighbor columns
    are contiguous dynamic slices shared by all targets in the tile
    (contiguous loads instead of per-element gathers). Returns
    (rho, p, overflow)."""
    n = sp.shape[0]
    t, cap = _tile_shape(n, cfg)
    offsets = column_offsets(cfg)
    # pad so dynamic_slice never clamps (start ≤ n always holds)
    sp_pad = jnp.concatenate([sp, jnp.zeros((cap, 3), sp.dtype)])
    key_pad = jnp.concatenate(
        [key_s, jnp.full((cap,), jnp.int32(2**30), jnp.int32)]
    )
    lane = jnp.arange(cap, dtype=jnp.int32)

    def tile(args):
        tpos, tkey, tvalid = args
        rho = jnp.zeros((t,), jnp.float32)
        ovf = jnp.int32(0)
        for off in offsets:
            start, cnt, full = _tile_ranges(tkey, tvalid, off, starts, cfg, cap)
            cand = jax.lax.dynamic_slice(sp_pad, (start, 0), (cap, 3))
            ckey = jax.lax.dynamic_slice(key_pad, (start,), (cap,))
            # Tile slices can overlap across columns when the tile spans ≥C
            # cells; the key-difference mask assigns each stencil pair to
            # exactly one column (the 27 accepted diffs are disjoint).
            diff = ckey[None, :] - tkey[:, None]
            hit = (diff >= off - 1) & (diff <= off + 1) & (lane < cnt)[None, :]
            disp = tpos[:, None, :] - cand[None, :, :]
            w = pair_density(disp, cfg)  # [T, cap]
            rho += jnp.sum(jnp.where(hit, w, 0.0), axis=1)
            ovf += jnp.maximum(full - cap, 0)
        rho, p = pressure_from_density(rho, cfg)
        rho = jnp.where(tvalid, rho, 1.0)
        return rho, jnp.where(tvalid, p, 0.0), ovf

    rho, p, ovf = _map_tiles(
        tile, (sp.reshape(-1, t, 3), key_s.reshape(-1, t), valid_s.reshape(-1, t))
    )
    return rho.reshape(-1), p.reshape(-1), jnp.sum(ovf).astype(jnp.int32)


def _force_pass_sorted(sp, sv, rho_s, p_s, key_s, valid_s, starts, cfg: SimConfig):
    """Pressure + viscosity forces for sorted targets (kernelUpdateForces,
    simulator.cu:192-256), tile formulation. Candidate fields are packed into
    one f32[n, 8] array so each column is a single dynamic slice."""
    n = sp.shape[0]
    t, cap = _tile_shape(n, cfg)
    offsets = column_offsets(cfg)
    packed = jnp.concatenate([sp, sv, rho_s[:, None], p_s[:, None]], axis=1)
    pad = jnp.zeros((cap, 8), packed.dtype).at[:, 6].set(1.0)  # padding ρ=1
    packed = jnp.concatenate([packed, pad])
    key_pad = jnp.concatenate(
        [key_s, jnp.full((cap,), jnp.int32(2**30), jnp.int32)]
    )
    lane = jnp.arange(cap, dtype=jnp.int32)

    def tile(args):
        tpos, tvel, tp, tkey, tvalid = args
        f = jnp.zeros((t, 3), jnp.float32)
        for off in offsets:
            start, cnt, _ = _tile_ranges(tkey, tvalid, off, starts, cfg, cap)
            cand = jax.lax.dynamic_slice(packed, (start, 0), (cap, 8))
            ckey = jax.lax.dynamic_slice(key_pad, (start,), (cap,))
            diff = ckey[None, :] - tkey[:, None]
            hit = (diff >= off - 1) & (diff <= off + 1) & (lane < cnt)[None, :]
            disp = tpos[:, None, :] - cand[None, :, :3]
            dv = cand[None, :, 3:6] - tvel[:, None, :]
            fij = pair_force(
                disp, dv, tp[:, None], cand[None, :, 7], cand[None, :, 6], cfg
            )
            f += jnp.sum(jnp.where(hit[..., None], fij, 0.0), axis=1)
        return jnp.where(tvalid[:, None], f, 0.0)

    f = _map_tiles(
        tile,
        (
            sp.reshape(-1, t, 3),
            sv.reshape(-1, t, 3),
            p_s.reshape(-1, t),
            key_s.reshape(-1, t),
            valid_s.reshape(-1, t),
        ),
    )
    return f.reshape(-1, 3)


def _finish(state: FluidState, force, density, pressure, cfg: SimConfig):
    """Integrate valid particles; freeze invalid padding slots."""
    x, v = integrate(state.position, state.velocity, force, density, cfg)
    valid3 = state.valid[:, None]
    return FluidState(
        position=jnp.where(valid3, x, state.position),
        velocity=jnp.where(valid3, v, state.velocity),
        force=force,
        density=density,
        pressure=pressure,
        valid=state.valid,
    )


def step_allpairs(state: FluidState, cfg: SimConfig):
    """Oracle timestep: O(N²) masked pairs, same physics and integration."""
    rho, p = density_allpairs(state.position, state.valid, cfg)
    f = forces_allpairs(state.position, state.velocity, rho, p, state.valid, cfg)
    new_state = _finish(state, f, rho, p, cfg)
    aux = StepAux(
        oob_count=jnp.int32(0),
        window_overflow=jnp.int32(0),
    )
    return new_state, aux


def sorted_passes(sp, sv, key_s, valid_s, starts, cfg: SimConfig,
                  backend: str = "cell_list", interpret: bool = False):
    """Density, pressure and force for cell-sorted particles by the chosen
    pair-pass implementation. Returns (rho_s, p_s, f_s[n, 3], overflow);
    invalid rows carry ρ = 1, p = 0, f = 0."""
    if backend == "cell_list":
        rho_s, p_s, ovf = _density_pass_sorted(sp, key_s, valid_s, starts, cfg)
        f_s = _force_pass_sorted(sp, sv, rho_s, p_s, key_s, valid_s, starts, cfg)
        return rho_s, p_s, f_s, ovf
    if backend != "pallas_triton":
        raise ValueError(f"no sorted pair passes for backend {backend!r}")
    from sphjax.pallas.pair_passes import density_pairs, force_pairs

    raw = density_pairs(sp, key_s, starts, cfg, interpret=interpret)
    rho_s, p_s = pressure_from_density(raw, cfg)
    rho_s = jnp.where(valid_s, rho_s, 1.0)
    p_s = jnp.where(valid_s, p_s, 0.0)
    f_s = force_pairs(sp, sv, rho_s, p_s, key_s, starts, cfg, interpret=interpret)
    return rho_s, p_s, jnp.where(valid_s[:, None], f_s, 0.0), jnp.int32(0)


def build_phase(state: FluidState, cfg: SimConfig) -> CellList:
    """Neighbor-structure build — the timed "grid construction" phase
    (kernelBuildGrid, simulator.cu:505-513). Also subsumes kernelResetGrid:
    the structure is rebuilt from scratch each step."""
    return build_cell_list(state.position, state.valid, cfg)


def update_phase(state: FluidState, cl: CellList, cfg: SimConfig,
                 backend: str = "cell_list", interpret: bool = False):
    """Density → forces → integrate — the timed "SPH update" phase
    (simulator.cu:516-529). Returns (new_state, aux)."""
    sp = state.position[cl.perm]
    sv = state.velocity[cl.perm]
    rho_s, p_s, f_s, ovf = sorted_passes(
        sp, sv, cl.key_sorted, cl.valid_sorted, cl.starts, cfg, backend,
        interpret,
    )

    # Scatter back to original order: sorted[i] corresponds to original[perm[i]].
    n = state.num_slots
    force = jnp.zeros((n, 3), jnp.float32).at[cl.perm].set(f_s)
    density = jnp.ones((n,), jnp.float32).at[cl.perm].set(rho_s)
    pressure = jnp.zeros((n,), jnp.float32).at[cl.perm].set(p_s)

    new_state = _finish(state, force, density, pressure, cfg)
    aux = StepAux(oob_count=cl.oob_count, window_overflow=ovf)
    return new_state, aux


def step_cell_list(state: FluidState, cfg: SimConfig):
    """Production timestep on the CPU: sort → cell ranges → windowed XLA
    density/force tiles → integrate → scatter back to original order."""
    return update_phase(state, build_phase(state, cfg), cfg)


def step_pallas_triton(state: FluidState, cfg: SimConfig, interpret=False):
    """The cell-list step with the Triton pair-pass kernels."""
    return update_phase(
        state, build_phase(state, cfg), cfg, "pallas_triton", interpret
    )


BACKENDS = {
    "allpairs": step_allpairs,
    "cell_list": step_cell_list,
    "pallas_triton": step_pallas_triton,
}

# Production backend on a GPU: the kernel backend won the 100-step A/B
# against cell_list on an H100 at N = 262,144 and 1,048,576 (PERF.md).
GPU_BACKEND = "pallas_triton"


def choose_backend(platform: str | None = None) -> str:
    """Production backend for a JAX platform (default: the first device's)."""
    platform = platform or jax.devices()[0].platform
    if platform == "gpu":
        return GPU_BACKEND
    if platform == "cpu":
        return "cell_list"
    raise ValueError(
        f"no SPH backend for platform {platform!r}: sphjax runs on 'cpu' "
        "(XLA) and 'gpu' (XLA + Triton kernels)"
    )


def make_step(cfg: SimConfig, backend: str = "cell_list"):
    """Jitted `state -> (state, aux)` with cfg baked in as a static constant
    (the analog of CUDA __constant__ deviceSettings, simulator.cu:19)."""
    fn = BACKENDS[backend]

    @jax.jit
    def step(state: FluidState):
        return fn(state, cfg)

    return step
