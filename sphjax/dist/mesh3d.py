"""3-D brick-mesh spatial sharding — the full generalization of the z-slab
layer in dist/sharded.py (SURVEY.md §7.10: "1-D (then 3-D) mesh").

The box is split into bricks over a (z, y, x) `jax.sharding.Mesh`; each device
owns the particles resident in its brick. The 27-neighborhood communication
uses the STAGED-AXIS scheme — three face exchanges instead of 26 point-to-point
sends, with edge/corner data forwarded transitively:

  staged 2h halo exchange (positions+velocities, ONE round):
    phase z: pack local particles within 2h of the brick's z faces, ppermute
             along the z axis → halo set Hz.
    phase y: pack from local ∪ Hz within 2h of the y faces, ppermute along y
             → Hy (z-edge/corner particles ride along).
    phase x: pack from local ∪ Hz ∪ Hy within 2h of the x faces → Hx.
  The final set covers the full L∞-2h shell, so every halo copy within h of
  the brick sees ALL of its own neighbors locally — its locally-computed
  ρ/p is exact and no second "authoritative ρ/p" round is needed (same
  argument as the 1-D slab layer, dist/sharded.py). Requires brick width
  ≥ 2h per axis (checked at build).
  density + force by the single-card pair passes over one payload-sorted
  row set (_compute_sorted_fields); integrate local rows.
  migration: three one-hop phases (z, then y, then x), each packing both
  direction buffers from ONE category sort with arrivals APPENDED, so a
  diagonal brick-corner crosser reaches its owner within one step via
  axis-by-axis hops; a final kept-first sort compacts the state.

All buffers fixed-capacity with overflow DETECTION (never silent drop), and a
per-axis misrouting counter for the one-hop-per-axis invariant — identical
philosophy to the slab layer. Replaces the reference's free HBM boundary reads
(/root/reference/src/simulator.cu:163-185) with explicit collectives.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sphjax.core.config import SimConfig
from sphjax.core.state import FluidState
from sphjax.dist.sharded import (
    DistAux,
    DistState,
    _compact,
    _compute_sorted_fields,
)
from sphjax.interact.impulse import click_kick_fields
from sphjax.neighbors.grid import compute_keys_fields
from sphjax.physics.integrate import integrate_fields

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

AXES = ("z", "y", "x")
AXIS_DIM = {"z": 2, "y": 1, "x": 0}  # position column per axis name


@dataclasses.dataclass(frozen=True)
class Mesh3DConfig:
    """Static capacities for the brick-sharded engine (all per-device)."""

    mesh_shape: tuple[int, int, int]  # devices along (z, y, x)
    dev_capacity: int
    halo_capacity: tuple[int, int, int]  # per-direction rows, per axis phase
    migration_capacity: tuple[int, int, int]
    # Optional BALANCE-AWARE partition: per mesh axis (z, y, x order), an
    # ascending tuple of m_ax+1 cell-plane indices giving device d the
    # interval [planes[d], planes[d+1]) along that axis in CELL space —
    # the 3-D analog of DistConfig.slab_planes (per-axis occupancy
    # quantiles fix the structural imbalance of equal-width bricks).
    # balanced_brick_planes() computes them; DistSimulator.setup applies
    # them by default. None = equal-width bricks.
    axis_planes: tuple | None = None

    def validate(self) -> None:
        if len(self.mesh_shape) != 3 or any(m < 1 for m in self.mesh_shape):
            raise ValueError(f"mesh_shape must be 3 positive ints, got {self.mesh_shape}")
        if self.dev_capacity <= 0 or self.dev_capacity % 8:
            raise ValueError("dev_capacity must be a positive multiple of 8")
        for name, caps in (("halo", self.halo_capacity),
                           ("migration", self.migration_capacity)):
            for v in caps:
                if v <= 0 or v % 8:
                    raise ValueError(
                        f"{name}_capacity entries must be positive multiples of 8"
                    )


def _axis_perms(n: int):
    up = [(i, i + 1) for i in range(n - 1)]
    dn = [(i + 1, i) for i in range(n - 1)]
    return up, dn


def _pshift(x, axis, perm):
    if not perm:
        return jnp.zeros_like(x)
    return lax.ppermute(x, axis, perm)


def _halo_buffers(x, y, z, vx, vy, vz, send_dn, send_up, h_cap: int,
                  disjoint: bool):
    """Pack the two 2h face layers into (h_cap, 6) send matrices. When the
    brick is ≥ 4h wide along this axis the dn/up sets are DISJOINT, so ONE
    stable category payload sort yields both buffers (dn rows to the front,
    up rows to the back); narrower bricks fall back to two compacts. The
    1-D slab layer replaced this with key-sorted slicing (sharded.py §1),
    but the y/x staged phases here select by a coordinate that is NOT
    major in the flat key, so the category sort stays. Returns
    (dn6, dn_valid, up6, up_valid, overflow, max_send)."""
    n_dn = jnp.sum(send_dn).astype(jnp.int32)
    n_up = jnp.sum(send_up).astype(jnp.int32)
    overflow = jnp.maximum(n_dn - h_cap, 0) + jnp.maximum(n_up - h_cap, 0)
    max_send = jnp.maximum(n_dn, n_up)
    lane = jnp.arange(h_cap, dtype=jnp.int32)
    if disjoint:
        cat = jnp.where(send_dn, 0, jnp.where(send_up, 2, 1)).astype(
            jnp.int32
        )
        _, hx, hy, hz, hvx, hvy, hvz = lax.sort(
            (cat, x, y, z, vx, vy, vz), num_keys=1, is_stable=True
        )
        dn6 = jnp.stack(
            [hx[:h_cap], hy[:h_cap], hz[:h_cap],
             hvx[:h_cap], hvy[:h_cap], hvz[:h_cap]], axis=1
        )
        t0 = x.shape[0] - h_cap
        up6 = jnp.stack(
            [hx[t0:], hy[t0:], hz[t0:], hvx[t0:], hvy[t0:], hvz[t0:]],
            axis=1,
        )
        dn_valid = lane < n_dn
        up_valid = lane >= (h_cap - jnp.minimum(n_up, h_cap))
        return dn6, dn_valid, up6, up_valid, overflow, max_send
    dn_rows, dn_valid, _, _ = _compact(
        send_dn, (x, y, z, vx, vy, vz), h_cap
    )
    up_rows, up_valid, _, _ = _compact(
        send_up, (x, y, z, vx, vy, vz), h_cap
    )
    return (
        jnp.stack(dn_rows, axis=1), dn_valid,
        jnp.stack(up_rows, axis=1), up_valid, overflow, max_send,
    )


def _check_brick_widths(cfg: SimConfig, mcfg: Mesh3DConfig) -> None:
    """The 2h ghost layer needs bricks at least 2h wide per axis (see
    sharded.py's slab-width check). With explicit axis planes that is a
    ≥ 2-cell minimum gap per axis, plus shape/monotonicity validation."""
    if mcfg.axis_planes is not None:
        C = cfg.num_cells_per_dim
        if len(mcfg.axis_planes) != 3:
            raise ValueError(
                f"axis_planes must have one plane tuple per mesh axis, got "
                f"{mcfg.axis_planes}"
            )
        for ax_i, (m, pl) in enumerate(
            zip(mcfg.mesh_shape, mcfg.axis_planes)
        ):
            pl = tuple(int(p) for p in pl)
            if len(pl) != m + 1 or pl[0] != 0 or pl[-1] != C:
                raise ValueError(
                    f"axis_planes[{AXES[ax_i]}] must be {m + 1} cell planes "
                    f"spanning [0, {C}], got {pl}"
                )
            gaps = [b - a for a, b in zip(pl, pl[1:])]
            if min(gaps) < 2:
                raise ValueError(
                    f"axis_planes[{AXES[ax_i]}] gaps {gaps}: every brick "
                    "needs ≥ 2 cells per axis (2h ghost layer)"
                )
        return
    for ax_i, m in enumerate(mcfg.mesh_shape):
        if cfg.box_dim / m < 2 * cfg.h:
            raise ValueError(
                f"brick width {cfg.box_dim / m:.4f} along {AXES[ax_i]} < "
                f"2h = {2 * cfg.h:.4f}: at most "
                f"{int(cfg.box_dim // (2 * cfg.h))} devices per axis"
            )


def _brick_geometry(cfg: SimConfig, mcfg: Mesh3DConfig):
    """Per-axis (lo, hi, width) bounds of this device's brick. With explicit
    axis planes the float bounds are plane·h (informational — the halo bands
    and migration predicates then run in CELL space, see _axis_bands /
    _axis_migration)."""
    lo, hi, widths = {}, {}, {}
    for ax_i, ax in enumerate(AXES):
        m = mcfg.mesh_shape[ax_i]
        d = lax.axis_index(ax)
        if mcfg.axis_planes is not None:
            pl = jnp.asarray(
                mcfg.axis_planes[ax_i], jnp.float32
            ) * jnp.float32(cfg.h)
            lo[ax] = pl[d]
            hi[ax] = pl[d + 1]
            widths[ax] = hi[ax] - lo[ax]
        else:
            w = jnp.float32(cfg.box_dim) / m
            lo[ax] = d.astype(jnp.float32) * w
            hi[ax] = lo[ax] + w
            widths[ax] = w
    return lo, hi, widths


def _cellspace(coord, cfg: SimConfig):
    """f32 coordinate → clamped cell index, the exact truncation the build's
    keys use (neighbors.grid.compute_keys_fields)."""
    C = cfg.num_cells_per_dim
    return jnp.clip((coord / jnp.float32(cfg.h)).astype(jnp.int32), 0, C - 1)


def _axis_bands(coord, cvalid, ax_i: int, ax: str, cfg: SimConfig,
                mcfg: Mesh3DConfig, lo, hi):
    """(send_dn, send_up) 2h-halo-layer masks along one axis. With explicit
    axis planes the bands are 2-CELL bands at the plane faces (exact integer
    supersets of the float 2h bands — sharded._band_thresholds' argument);
    equal-width bricks keep the historical float comparison."""
    if mcfg.axis_planes is not None:
        pl = jnp.asarray(mcfg.axis_planes[ax_i], jnp.int32)
        d = lax.axis_index(ax)
        cc = _cellspace(coord, cfg)
        return cvalid & (cc < pl[d] + 2), cvalid & (cc >= pl[d + 1] - 2)
    halo_w = jnp.float32(2.0 * cfg.h)
    return cvalid & (coord < lo[ax] + halo_w), cvalid & (
        coord >= hi[ax] - halo_w
    )


def _axis_migration(coord, lv, ax_i: int, ax: str, cfg: SimConfig,
                    mcfg: Mesh3DConfig, lo, hi, w):
    """(mig_dn, mig_up, misrouted_mask) along one axis for post-integration
    coordinates. With explicit axis planes ownership is decided in CELL
    space — the truncation the next build's keys use — so migration,
    distribute_state_3d and the ownership invariant can never disagree at a
    float brick face; the one-hop bound uses the ADJACENT bricks' exact
    plane edges. Equal-width bricks keep the float comparison."""
    if mcfg.axis_planes is not None:
        m = mcfg.mesh_shape[ax_i]
        pl = jnp.asarray(mcfg.axis_planes[ax_i], jnp.int32)
        d = lax.axis_index(ax)
        cc = _cellspace(coord, cfg)
        mig_dn = lv & (cc < pl[d])
        mig_up = lv & (cc >= pl[d + 1])
        far_lo = pl[jnp.maximum(d - 1, 0)]
        far_hi = pl[jnp.minimum(d + 2, m)]
        mis = lv & ((cc < far_lo) | (cc >= far_hi))
        return mig_dn, mig_up, mis
    mig_dn = lv & (coord < lo[ax])
    mig_up = lv & (coord >= hi[ax])
    mis = lv & ((coord < lo[ax] - w) | (coord >= hi[ax] + w))
    return mig_dn, mig_up, mis


def _device_build3d(pos, vel, valid, pid, cfg: SimConfig,
                    mcfg: Mesh3DConfig):
    """Phase 1 on one device's brick: staged 2h halo exchange (z → y → x,
    corner rows forwarded transitively — see module docstring) + cell-key
    payload sort. Returns the sorted comb rows + per-device
    (halo_overflow, oob_count, max_halo_send) scalars (not yet reduced)."""
    lo, hi, _widths = _brick_geometry(cfg, mcfg)

    rows = [pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1], vel[:, 2]]
    cvalid = valid
    tag = jnp.where(valid, pid, jnp.int32(-1))
    halo_ovf = jnp.int32(0)
    halo_send = jnp.int32(0)
    for ax_i, ax in enumerate(AXES):
        m = mcfg.mesh_shape[ax_i]
        h_cap = mcfg.halo_capacity[ax_i]
        perm_up, perm_dn = _axis_perms(m)
        coord = rows[AXIS_DIM[ax]]
        send_dn, send_up = _axis_bands(
            coord, cvalid, ax_i, ax, cfg, mcfg, lo, hi
        )
        # dn/up send sets disjoint (one category sort serves both)? static:
        # 2-cell bands need a ≥ 4-cell gap; float 2h bands need width ≥ 4h
        if mcfg.axis_planes is not None:
            pl = mcfg.axis_planes[ax_i]
            disjoint = min(b - a for a, b in zip(pl, pl[1:])) >= 4
        else:
            disjoint = cfg.box_dim / m >= 4 * cfg.h
        dn6, dn_valid, up6, up_valid, ovf, max_send = _halo_buffers(
            *rows, send_dn, send_up, h_cap, disjoint
        )
        lo6 = _pshift(up6, ax, perm_up)  # halo from the device below
        lo_valid = _pshift(up_valid, ax, perm_up)
        hi6 = _pshift(dn6, ax, perm_dn)  # halo from the device above
        hi_valid = _pshift(dn_valid, ax, perm_dn)
        rows = [
            jnp.concatenate([r, lo6[:, j], hi6[:, j]])
            for j, r in enumerate(rows)
        ]
        cvalid = jnp.concatenate([cvalid, lo_valid, hi_valid])
        tag = jnp.concatenate([tag, jnp.full((2 * h_cap,), -2, jnp.int32)])
        halo_ovf = halo_ovf + ovf
        halo_send = jnp.maximum(halo_send, max_send)

    # invalid/stale slots parked at origin (physically inert — sharded.py)
    for j in range(3):
        rows[j] = jnp.where(cvalid, rows[j], 0.0)

    key, oob_count = compute_keys_fields(rows[0], rows[1], rows[2], cvalid,
                                         cfg)
    key_s, sx, sy, sz, svx, svy, svz, tag_s = lax.sort(
        (key, *rows, tag), num_keys=1, is_stable=True
    )
    return (key_s, sx, sy, sz, svx, svy, svz, tag_s, halo_ovf, oob_count,
            halo_send)


def _device_update3d(
    key_s, sx, sy, sz, svx, svy, svz, tag_s, click_cell, click_active,
    cfg: SimConfig, mcfg: Mesh3DConfig,
    backend: str = "cell_list", interpret: bool = False,
    with_click: bool = True,
):
    """Phase 2 on one device's brick: physics on the tuned fields-native hot
    path (_compute_sorted_fields) + integrate + click + per-axis migration.
    The z and y migration hops APPEND arrivals (they may still hop along
    later axes); the final x hop cannot feed further hops, so it uses the
    merged migration/compaction sort of the 1-D slab layer (sharded.py §6):
    ONE category sort dn < kept < up < dead yields both direction buffers
    AND the kept-first compacted state, with arrivals scattered into the
    free tail — no separate compaction sort. Returns
    (x, v, valid_new, pid_new, (ovf_w, mig_ovf, misrouted, n_valid,
    max_mig_send)) with the scalars not yet reduced."""
    c_dev = mcfg.dev_capacity
    lo, hi, widths = _brick_geometry(cfg, mcfg)

    rho_s, p_s, (fx, fy, fz), _valid_s, ovf_w = _compute_sorted_fields(
        key_s, sx, sy, sz, svx, svy, svz, cfg, backend, interpret
    )

    # ---- integrate live local rows; freeze halo copies and padding
    live = tag_s >= 0
    nx, ny, nz, nvx, nvy, nvz = integrate_fields(
        sx, sy, sz, svx, svy, svz, fx, fy, fz, rho_s, cfg
    )
    nx = jnp.where(live, nx, sx)
    ny = jnp.where(live, ny, sy)
    nz = jnp.where(live, nz, sz)
    nvx = jnp.where(live, nvx, svx)
    nvy = jnp.where(live, nvy, svy)
    nvz = jnp.where(live, nvz, svz)

    # click impulse (free-mode parity): pre-step cells, before migration;
    # the scan-chained run skips it statically (see sharded.py)
    if with_click:
        kx, ky, kz = click_kick_fields(sx, sy, sz, live, click_cell, cfg)
        ca = click_active.astype(jnp.float32)
        nvx = nvx + kx * ca
        nvy = nvy + ky * ca
        nvz = nvz + kz * ca

    # ---- migration: one hop per axis, z → y → x, on sorted rows
    cr = [nx, ny, nz, nvx, nvy, nvz]
    ctag = tag_s
    mig_ovf = jnp.int32(0)
    misrouted = jnp.int32(0)
    mig_send = jnp.int32(0)
    for ax_i, ax in enumerate(AXES[:-1]):
        m = mcfg.mesh_shape[ax_i]
        m_cap = mcfg.migration_capacity[ax_i]
        w = widths[ax]
        perm_up, perm_dn = _axis_perms(m)
        lv = ctag >= 0
        coord = cr[AXIS_DIM[ax]]
        mig_dn, mig_up, mis_mask = _axis_migration(
            coord, lv, ax_i, ax, cfg, mcfg, lo, hi, w
        )
        misrouted = misrouted + jnp.sum(mis_mask).astype(jnp.int32)
        n_dn = jnp.sum(mig_dn).astype(jnp.int32)
        n_up = jnp.sum(mig_up).astype(jnp.int32)
        mig_ovf = mig_ovf + jnp.maximum(n_dn - m_cap, 0) + jnp.maximum(
            n_up - m_cap, 0
        )
        mig_send = jnp.maximum(mig_send, jnp.maximum(n_dn, n_up))
        # one category sort: dn-senders to the front, up-senders to the back
        cat = jnp.where(mig_dn, 0, jnp.where(mig_up, 2, 1)).astype(jnp.int32)
        _, m0, m1, m2, m3, m4, m5, mtag = lax.sort(
            (cat, *cr, ctag), num_keys=1, is_stable=True
        )
        srows = [m0, m1, m2, m3, m4, m5]
        total = m0.shape[0]
        lane = jnp.arange(m_cap, dtype=jnp.int32)
        dn6 = jnp.stack([r[:m_cap] for r in srows], axis=1)
        dn_tag = mtag[:m_cap]
        dn_valid = lane < n_dn
        t0 = total - m_cap
        up6 = jnp.stack([r[t0:] for r in srows], axis=1)
        up_tag = mtag[t0:]
        up_valid = lane >= (m_cap - jnp.minimum(n_up, m_cap))
        # departures become invalid locally (front n_dn / back n_up rows)
        pos_i = jnp.arange(total, dtype=jnp.int32)
        mtag = jnp.where(
            (pos_i < n_dn) | (pos_i >= total - n_up), jnp.int32(-2), mtag
        )

        in_lo6 = _pshift(up6, ax, perm_up)  # arrivals from below
        in_lo_tag = _pshift(up_tag, ax, perm_up)
        in_lo_valid = _pshift(up_valid, ax, perm_up)
        in_hi6 = _pshift(dn6, ax, perm_dn)  # arrivals from above
        in_hi_tag = _pshift(dn_tag, ax, perm_dn)
        in_hi_valid = _pshift(dn_valid, ax, perm_dn)
        inc6 = jnp.concatenate([in_lo6, in_hi6])
        inc_tag = jnp.concatenate([in_lo_tag, in_hi_tag])
        inc_valid = jnp.concatenate([in_lo_valid, in_hi_valid])
        inc_tag = jnp.where(inc_valid, inc_tag, jnp.int32(-2))
        inc6 = jnp.where(inc_valid[:, None], inc6, 0.0)
        # APPEND arrivals: they participate in the later axes' hops
        cr = [jnp.concatenate([srows[j], inc6[:, j]]) for j in range(6)]
        ctag = jnp.concatenate([mtag, inc_tag])

    # ---- final axis (x) + compaction, ONE sort (see docstring)
    ax = AXES[-1]
    m = mcfg.mesh_shape[-1]
    m_cap = mcfg.migration_capacity[-1]
    w = widths[ax]
    perm_up, perm_dn = _axis_perms(m)
    lv = ctag >= 0
    coord = cr[AXIS_DIM[ax]]
    mig_dn, mig_up, mis_mask = _axis_migration(
        coord, lv, len(AXES) - 1, ax, cfg, mcfg, lo, hi, w
    )
    misrouted = misrouted + jnp.sum(mis_mask).astype(jnp.int32)
    kept = lv & ~mig_dn & ~mig_up
    n_dn = jnp.sum(mig_dn).astype(jnp.int32)
    n_up = jnp.sum(mig_up).astype(jnp.int32)
    n_kept = jnp.sum(kept).astype(jnp.int32)
    mig_ovf = mig_ovf + jnp.maximum(n_dn - m_cap, 0) + jnp.maximum(
        n_up - m_cap, 0
    )
    mig_send = jnp.maximum(mig_send, jnp.maximum(n_dn, n_up))
    cat = jnp.where(
        mig_dn, 0, jnp.where(mig_up, 2, jnp.where(kept, 1, 3))
    ).astype(jnp.int32)
    # pad with m_cap dead rows so the kept/up dynamic_slices stay in bounds
    # for any capacity combination whenever the flags are clean (sharded.py)
    mpad = lambda r, v: jnp.concatenate(
        [r, jnp.full((m_cap,), v, r.dtype)]
    )
    _, m0, m1, m2, m3, m4, m5, mtag = lax.sort(
        (mpad(cat, 3), *[mpad(r, 0.0) for r in cr], mpad(ctag, -2)),
        num_keys=1, is_stable=True,
    )
    srows = [m0, m1, m2, m3, m4, m5]
    lane = jnp.arange(m_cap, dtype=jnp.int32)
    mdn = jnp.stack([r[:m_cap] for r in srows], axis=1)
    mdn_tag = mtag[:m_cap]
    mdn_valid = lane < n_dn
    up0 = n_dn + n_kept
    mup = jnp.stack(
        [lax.dynamic_slice(r, (up0,), (m_cap,)) for r in srows], axis=1
    )
    mup_tag = lax.dynamic_slice(mtag, (up0,), (m_cap,))
    mup_valid = lane < n_up

    in_lo = _pshift(mup, ax, perm_up)
    in_lo_tag = _pshift(mup_tag, ax, perm_up)
    in_lo_valid = _pshift(mup_valid, ax, perm_up)
    in_hi = _pshift(mdn, ax, perm_dn)
    in_hi_tag = _pshift(mdn_tag, ax, perm_dn)
    in_hi_valid = _pshift(mdn_valid, ax, perm_dn)
    inc = jnp.concatenate([in_lo, in_hi])
    inc_tag = jnp.concatenate([in_lo_tag, in_hi_tag])
    inc_valid = jnp.concatenate([in_lo_valid, in_hi_valid])
    (inc, inc_tag), inc_valid, _, _ = _compact(
        inc_valid, (inc, inc_tag), 2 * m_cap
    )

    o0, o1, o2, o3, o4, o5 = (
        lax.dynamic_slice(r, (n_dn,), (c_dev,)) for r in srows
    )
    otag = lax.dynamic_slice(mtag, (n_dn,), (c_dev,))
    valid_new = jnp.arange(c_dev, dtype=jnp.int32) < n_kept
    mig_ovf = mig_ovf + jnp.maximum(n_kept - c_dev, 0)

    idx = n_kept + jnp.arange(2 * m_cap, dtype=jnp.int32)
    write = inc_valid & (idx < c_dev)
    dev_overflow = jnp.sum(inc_valid & (idx >= c_dev)).astype(jnp.int32)
    mig_ovf = mig_ovf + dev_overflow
    widx = jnp.where(write, idx, c_dev)  # OOB → dropped by mode="drop"
    put = lambda row, val: row.at[widx].set(val, mode="drop")
    o0 = put(o0, inc[:, 0])
    o1 = put(o1, inc[:, 1])
    o2 = put(o2, inc[:, 2])
    o3 = put(o3, inc[:, 3])
    o4 = put(o4, inc[:, 4])
    o5 = put(o5, inc[:, 5])
    otag = put(otag, inc_tag)
    valid_new = valid_new.at[widx].set(True, mode="drop")

    x = jnp.stack([o0, o1, o2], axis=1)
    v = jnp.stack([o3, o4, o5], axis=1)
    pid_new = jnp.where(valid_new, otag, jnp.int32(-1))
    scalars = (
        ovf_w, mig_ovf, misrouted,
        jnp.sum(valid_new).astype(jnp.int32), mig_send,
    )
    return x, v, valid_new, pid_new, scalars


def _device_step3d(
    pos, vel, valid, pid, click_cell, click_active,
    cfg: SimConfig, mcfg: Mesh3DConfig,
    backend: str = "cell_list", interpret: bool = False,
    with_click: bool = True,
):
    """One timestep on one device's brick (runs under shard_map over AXES):
    _device_build3d (staged halo exchange + sort) composed with
    _device_update3d (kernels + integrate + migration + compaction),
    counters reduced into a DistAux."""
    (key_s, sx, sy, sz, svx, svy, svz, tag_s, halo_ovf, oob_count,
     halo_send) = _device_build3d(pos, vel, valid, pid, cfg, mcfg)
    (x, v, valid_new, pid_new,
     (ovf_w, mig_ovf, misrouted, n_valid, mig_send)) = _device_update3d(
        key_s, sx, sy, sz, svx, svy, svz, tag_s, click_cell, click_active,
        cfg, mcfg, backend, interpret, with_click=with_click,
    )
    aux = DistAux(
        halo_overflow=lax.psum(halo_ovf, AXES),
        migration_overflow=lax.psum(mig_ovf, AXES),
        window_overflow=lax.psum(ovf_w, AXES),
        oob_count=lax.psum(oob_count, AXES),
        misrouted=lax.psum(misrouted, AXES),
        num_particles=lax.psum(n_valid, AXES),
        max_dev_particles=lax.pmax(n_valid, AXES),
        max_halo_send=lax.pmax(halo_send, AXES),
        max_migration_send=lax.pmax(mig_send, AXES),
    )
    return x, v, valid_new, pid_new, aux


def make_mesh3d_step(
    cfg: SimConfig, mcfg: Mesh3DConfig, mesh: Mesh,
    backend: str = "cell_list", interpret: bool = False,
):
    """Jitted brick-sharded `DistState -> (DistState, DistAux)`."""
    mcfg.validate()
    _check_brick_widths(cfg, mcfg)
    spec = P(("z", "y", "x"))

    fn = partial(
        _device_step3d, cfg=cfg, mcfg=mcfg, backend=backend,
        interpret=interpret,
    )
    sharded = shard_map(
        fn,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, P(), P()),
        out_specs=(spec, spec, spec, spec, P()),
        check_vma=False,
    )

    @jax.jit
    def _step(state: DistState, click_cell, click_active):
        xx, v, valid, pid, aux = sharded(
            state.position, state.velocity, state.valid, state.pid,
            click_cell, click_active,
        )
        return DistState(xx, v, valid, pid), aux

    def step(state: DistState, click_px=None, click_active=None):
        from sphjax.interact.impulse import click_cell_from_px

        if click_px is None or (click_active is not None and not bool(click_active)):
            cell = jnp.zeros((2,), jnp.int32)
            active = jnp.zeros((), bool)
        else:
            px, py = (int(v) for v in np.asarray(click_px))
            cell = jnp.asarray(click_cell_from_px(px, py, cfg), jnp.int32)
            active = jnp.ones((), bool)
        return _step(state, cell, active)

    return step


def make_mesh3d_timed(
    cfg: SimConfig, mcfg: Mesh3DConfig, mesh: Mesh,
    backend: str = "cell_list", interpret: bool = False,
):
    """Two-stage jitted step for the TIMED protocol on the 3-D brick mesh —
    the reference's per-phase report (times.h:12-36) applied to the brick
    engine, mirroring sharded.make_sharded_timed:

      build(state)  -> (sorted-rows intermediate, halo_ovf, oob, halo_send)
          — staged halo exchange + payload sort ("grid construction")
      update(inter, ..., click_cell, click_active) -> (DistState, DistAux)
          — kernels + integrate + click + migration ("SPH update")

    Returns (build_fn, update_fn)."""
    mcfg.validate()
    _check_brick_widths(cfg, mcfg)
    spec = P(AXES)

    def dev_build(pos, vel, valid, pid):
        (key_s, sx, sy, sz, svx, svy, svz, tag_s, halo_ovf, oob,
         halo_send) = _device_build3d(pos, vel, valid, pid, cfg, mcfg)
        return (
            key_s, sx, sy, sz, svx, svy, svz, tag_s,
            lax.psum(halo_ovf, AXES), lax.psum(oob, AXES),
            lax.pmax(halo_send, AXES),
        )

    def dev_update(key_s, sx, sy, sz, svx, svy, svz, tag_s, cc, ca):
        (x, v, valid_new, pid_new,
         (ovf_w, mig_ovf, misrouted, n_valid, mig_send)) = _device_update3d(
            key_s, sx, sy, sz, svx, svy, svz, tag_s, cc, ca, cfg, mcfg,
            backend, interpret,
            # the reference's simulateAndTime runs the step minus mouse
            # handling (simulator.cu:499-546) — same here, statically
            with_click=False,
        )
        return x, v, valid_new, pid_new, (
            lax.psum(ovf_w, AXES), lax.psum(mig_ovf, AXES),
            lax.psum(misrouted, AXES), lax.psum(n_valid, AXES),
            lax.pmax(n_valid, AXES), lax.pmax(mig_send, AXES),
        )

    build_sharded = shard_map(
        dev_build, mesh=mesh,
        in_specs=(spec,) * 4,
        out_specs=(spec,) * 8 + (P(), P(), P()),
        check_vma=False,
    )
    update_sharded = shard_map(
        dev_update, mesh=mesh,
        in_specs=(spec,) * 8 + (P(), P()),
        out_specs=(spec,) * 4 + (P(),),
        check_vma=False,
    )

    @jax.jit
    def build(state: DistState):
        out = build_sharded(
            state.position, state.velocity, state.valid, state.pid
        )
        return out[:8], out[8], out[9], out[10]

    @jax.jit
    def update(inter, halo_ovf, oob, halo_send, click_cell, click_active):
        (x, v, valid, pid,
         (ovf_w, mig_ovf, misrouted, n_valid, max_dev, mig_send)) = (
            update_sharded(*inter, click_cell, click_active)
        )
        aux = DistAux(
            halo_overflow=halo_ovf,
            migration_overflow=mig_ovf,
            window_overflow=ovf_w,
            oob_count=oob,
            misrouted=misrouted,
            num_particles=n_valid,
            max_dev_particles=max_dev,
            max_halo_send=halo_send,
            max_migration_send=mig_send,
        )
        return DistState(x, v, valid, pid), aux

    return build, update


def make_mesh3d_run(
    cfg: SimConfig, mcfg: Mesh3DConfig, mesh: Mesh, steps: int,
    backend: str = "cell_list", interpret: bool = False,
):
    """Scan-chained brick-mesh production loop (the 3-D analog of
    sharded.make_sharded_run): one jitted dispatch runs `steps` timesteps,
    aux accumulated in-graph (overflow/misrouting summed, census from the
    final step)."""
    mcfg.validate()
    _check_brick_widths(cfg, mcfg)
    spec = P(AXES)
    zero_cell = jnp.zeros((2,), jnp.int32)
    inactive = jnp.zeros((), bool)

    def device_run(pos, vel, valid, pid):
        def body(carry, _):
            pos, vel, valid, pid = carry
            x, v, valid2, pid2, aux = _device_step3d(
                pos, vel, valid, pid, zero_cell, inactive, cfg, mcfg,
                backend=backend, interpret=interpret,
                with_click=False,  # production chain: no click surface
            )
            return (x, v, valid2, pid2), aux
        carry, auxs = lax.scan(body, (pos, vel, valid, pid), None, length=steps)
        aux = DistAux(
            halo_overflow=jnp.sum(auxs.halo_overflow),
            migration_overflow=jnp.sum(auxs.migration_overflow),
            window_overflow=jnp.sum(auxs.window_overflow),
            oob_count=jnp.sum(auxs.oob_count),
            misrouted=jnp.sum(auxs.misrouted),
            num_particles=auxs.num_particles[-1],
            max_dev_particles=jnp.max(auxs.max_dev_particles),
            max_halo_send=jnp.max(auxs.max_halo_send),
            max_migration_send=jnp.max(auxs.max_migration_send),
        )
        return carry[0], carry[1], carry[2], carry[3], aux

    sharded = shard_map(
        device_run,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec, spec, spec, P()),
        check_vma=False,
    )

    @jax.jit
    def run(state: DistState):
        x, v, valid, pid, aux = sharded(
            state.position, state.velocity, state.valid, state.pid
        )
        return DistState(x, v, valid, pid), aux

    return run


def make_mesh(devices, mesh_shape: tuple[int, int, int]) -> Mesh:
    mz, my, mx = mesh_shape
    return Mesh(np.asarray(devices).reshape(mz, my, mx), AXES)


def brick_owner(
    pos: np.ndarray, cfg: SimConfig, mcfg: Mesh3DConfig
) -> np.ndarray:
    """Host-side owning-device index (flat, (z,y,x)-major like the mesh) per
    position — the exact mirror of the device step's per-axis migration
    predicate (_axis_migration): cell-space with explicit axis planes, float
    equal-width otherwise."""
    mz, my, mx = mcfg.mesh_shape

    def owner_of(col, ax_i, m):
        if mcfg.axis_planes is not None:
            cc = np.clip(
                (np.asarray(pos[:, col], np.float32) / np.float32(cfg.h))
                .astype(np.int32),
                0, cfg.num_cells_per_dim - 1,
            )
            interior = np.asarray(mcfg.axis_planes[ax_i][1:-1], np.int64)
            return np.searchsorted(interior, cc, side="right")
        w = cfg.box_dim / m
        return np.clip((pos[:, col] / w).astype(np.int64), 0, m - 1)

    # AXES order (z, y, x) ↔ position columns (2, 1, 0)
    return (
        owner_of(2, 0, mz) * my + owner_of(1, 1, my)
    ) * mx + owner_of(0, 2, mx)


def balanced_brick_planes(
    pos: np.ndarray, cfg: SimConfig, mesh_shape: tuple[int, int, int]
) -> tuple:
    """Per-axis occupancy-quantile cell planes for the 3-D brick mesh —
    the 3-D analog of sharded.balanced_slab_planes (each axis partitioned
    at its own marginal occupancy quantiles; (z, y, x) order matching
    Mesh3DConfig.axis_planes). Exact joint balance would need a
    non-rectilinear partition; per-axis marginals capture the structural
    skew (e.g. the dam-break lattice filling one corner of the box)."""
    from sphjax.dist.sharded import balanced_slab_planes

    return tuple(
        balanced_slab_planes(pos[:, AXIS_DIM[ax]], cfg, mesh_shape[ax_i])
        for ax_i, ax in enumerate(AXES)
    )


def distribute_state_3d(
    state: FluidState, cfg: SimConfig, mcfg: Mesh3DConfig, mesh: Mesh
) -> DistState:
    """Host-side: assign each valid particle to its brick owner and build the
    padded per-device blocks with the (z,y,x)-major device order of the mesh."""
    pos = np.asarray(state.position)
    vel = np.asarray(state.velocity)
    valid = np.asarray(state.valid)
    mz, my, mx = mcfg.mesh_shape
    c_dev = mcfg.dev_capacity
    n_dev = mz * my * mx

    owner = brick_owner(pos, cfg, mcfg)

    gx = np.zeros((n_dev, c_dev, 3), np.float32)
    gv = np.zeros((n_dev, c_dev, 3), np.float32)
    gvalid = np.zeros((n_dev, c_dev), bool)
    gpid = np.full((n_dev, c_dev), -1, np.int32)
    for dev in range(n_dev):
        idx = np.nonzero(valid & (owner == dev))[0]
        if len(idx) > c_dev:
            raise ValueError(
                f"device {dev} needs {len(idx)} slots > dev_capacity {c_dev}"
            )
        k = len(idx)
        gx[dev, :k] = pos[idx]
        gv[dev, :k] = vel[idx]
        gvalid[dev, :k] = True
        gpid[dev, :k] = idx

    sharding = NamedSharding(mesh, P(("z", "y", "x")))
    put = lambda a: jax.device_put(
        a.reshape(n_dev * c_dev, *a.shape[2:]), sharding
    )
    return DistState(put(gx), put(gv), put(gvalid), put(gpid))
