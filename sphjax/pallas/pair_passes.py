"""Density and force pair passes as Pallas kernels through Triton.

The same semantics as the XLA tile passes (`engine/step.py`
`_density_pass_sorted` / `_force_pass_sorted`), laid out for a GPU: one
program per block of BT cell-sorted targets, with no atomics and no
candidate capacity.

  * Each program loads its targets' x, y, z and key and takes kmin / kmax
    over the valid ones (key < num_cells).
  * For each of the 9 (dy, dz) neighbor columns (static unroll) it reads
    the column's sorted-array range [starts[kmin+off−1], starts[kmax+off+2])
    from the `starts` table itself, and walks it in chunks of BC candidates
    with masked loads — the trip count follows the real window.
  * The key-difference mask (diff ∈ [off−1, off+1]) assigns every stencil
    pair to exactly one column, as in the XLA passes, so windows that
    overlap (a block spanning ≥ C cells) count no pair twice; the exact
    r ≤ h cutoffs zero the flat-key wraps at the box edges.
  * Sums stay in registers, and each program writes only its own targets:
    deterministic, and no overflow to detect.

Pair math is the reference's (physics/kernels.py, shared with the XLA path)
in float32 with the exact displacement form Σ(tᵢ−cᵢ)²; no matrix product is
involved, so TF32 never enters. `interpret=True` runs the kernels on the
CPU for tests; it is never chosen implicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
import numpy as np

from sphjax.core.config import SimConfig
from sphjax.neighbors.cell_list import column_offsets
from sphjax.physics.kernels import pair_force_terms, poly6

# (targets per program, candidates per chunk, warps), the fastest of a
# sweep on an H100 at N = 262,144 and 1,048,576 (PERF.md): small target
# blocks keep the block-union column windows short.
DENSITY_BLOCK = (16, 32, 2)
FORCE_BLOCK = (16, 32, 4)
NUM_STAGES = 2

_BIG_KEY = 2**30  # key of masked candidate lanes: matches no column


def _targets(ref_fields, key_ref, bt: int, n_cells: int):
    """Load this program's targets; returns (slice, mask, fields, key)."""
    base = pl.program_id(0) * bt
    n = key_ref.shape[0]
    t = pl.ds(base, bt)
    tmask = base + jnp.arange(bt) < n
    fields = [plgpu.load(r.at[t], mask=tmask, other=0.0) for r in ref_fields]
    tkey = plgpu.load(key_ref.at[t], mask=tmask, other=n_cells)
    return t, tmask, fields, tkey


def _walk_columns(starts_ref, tkey, cfg: SimConfig, bc: int, body, carry):
    """Run body(chunk_slice, chunk_mask, off, carry) over every BC-chunk of
    the 9 column windows of this program's valid targets."""
    nc = cfg.num_cells
    valid = tkey < nc
    kmin = jnp.min(jnp.where(valid, tkey, nc))
    kmax = jnp.max(jnp.where(valid, tkey, -1))
    for off in column_offsets(cfg):
        lo = jnp.clip(kmin + off - 1, 0, nc)
        hi = jnp.clip(kmax + off + 2, lo, nc)
        start = starts_ref[lo]
        end = starts_ref[hi]

        def chunk(c, carry, start=start, end=end, off=off):
            c0 = start + c * bc
            cmask = c0 + jnp.arange(bc) < end
            return body(pl.ds(c0, bc), cmask, off, carry)

        carry = lax.fori_loop(0, pl.cdiv(end - start, bc), chunk, carry)
    return carry


def _hit(ref_key, c, cmask, tkey, off: int):
    ckey = plgpu.load(ref_key.at[c], mask=cmask, other=_BIG_KEY)
    diff = ckey[None, :] - tkey[:, None]
    return (diff >= off - 1) & (diff <= off + 1)


def _density_kernel(x_ref, y_ref, z_ref, key_ref, starts_ref, rho_ref, *,
                    cfg: SimConfig, bt: int, bc: int):
    t, tmask, (tx, ty, tz), tkey = _targets(
        (x_ref, y_ref, z_ref), key_ref, bt, cfg.num_cells
    )
    mass = np.float32(cfg.mass)

    def body(c, cmask, off, rho):
        hit = _hit(key_ref, c, cmask, tkey, off)
        cx, cy, cz = (
            plgpu.load(r.at[c], mask=cmask, other=0.0)
            for r in (x_ref, y_ref, z_ref)
        )
        dx = tx[:, None] - cx[None, :]
        dy = ty[:, None] - cy[None, :]
        dz = tz[:, None] - cz[None, :]
        w = mass * poly6(dx * dx + dy * dy + dz * dz, cfg)
        return rho + jnp.sum(jnp.where(hit, w, 0.0), axis=1)

    rho = _walk_columns(
        starts_ref, tkey, cfg, bc, body, jnp.zeros((bt,), jnp.float32)
    )
    plgpu.store(rho_ref.at[t], rho, mask=tmask)


def _force_kernel(x_ref, y_ref, z_ref, vx_ref, vy_ref, vz_ref, rho_ref, p_ref,
                  key_ref, starts_ref, fx_ref, fy_ref, fz_ref, *,
                  cfg: SimConfig, bt: int, bc: int):
    t, tmask, (tx, ty, tz, tvx, tvy, tvz, tp), tkey = _targets(
        (x_ref, y_ref, z_ref, vx_ref, vy_ref, vz_ref, p_ref), key_ref, bt,
        cfg.num_cells,
    )

    def body(c, cmask, off, acc):
        hit = _hit(key_ref, c, cmask, tkey, off)
        cx, cy, cz, cvx, cvy, cvz, cp = (
            plgpu.load(r.at[c], mask=cmask, other=0.0)
            for r in (x_ref, y_ref, z_ref, vx_ref, vy_ref, vz_ref, p_ref)
        )
        crho = plgpu.load(rho_ref.at[c], mask=cmask, other=1.0)
        dx = tx[:, None] - cx[None, :]
        dy = ty[:, None] - cy[None, :]
        dz = tz[:, None] - cz[None, :]
        coef_p, scale, coef_v = pair_force_terms(
            dx * dx + dy * dy + dz * dz, tp[:, None], cp[None, :],
            crho[None, :], cfg,
        )
        out = []
        for a, d, cv, tv in zip(acc, (dx, dy, dz), (cvx, cvy, cvz),
                                (tvx, tvy, tvz)):
            f = coef_p * (d * scale) + coef_v * (cv[None, :] - tv[:, None])
            out.append(a + jnp.sum(jnp.where(hit, f, 0.0), axis=1))
        return tuple(out)

    zero = jnp.zeros((bt,), jnp.float32)
    fx, fy, fz = _walk_columns(
        starts_ref, tkey, cfg, bc, body, (zero, zero, zero)
    )
    plgpu.store(fx_ref.at[t], fx, mask=tmask)
    plgpu.store(fy_ref.at[t], fy, mask=tmask)
    plgpu.store(fz_ref.at[t], fz, mask=tmask)


def _call(kernel, n_out: int, n: int, block, name: str, interpret: bool):
    bt, _bc, warps = block
    out = jax.ShapeDtypeStruct((n,), jnp.float32)
    return pl.pallas_call(
        kernel,
        out_shape=out if n_out == 1 else (out,) * n_out,
        grid=(pl.cdiv(n, bt),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=warps, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name=name,
    )


def density_pairs(sp, key_s, starts, cfg: SimConfig, *, interpret=False):
    """Raw SPH density Σⱼ m W_poly6 (self included) for cell-sorted
    positions sp f32[n, 3]; pressure_from_density follows in XLA."""
    bt, bc, _ = DENSITY_BLOCK
    kernel = functools.partial(_density_kernel, cfg=cfg, bt=bt, bc=bc)
    call = _call(kernel, 1, sp.shape[0], DENSITY_BLOCK, "sph_density_pairs",
                 interpret)
    return call(sp[:, 0], sp[:, 1], sp[:, 2], key_s, starts)


def force_pairs(sp, sv, rho_s, p_s, key_s, starts, cfg: SimConfig, *,
                interpret=False):
    """Pressure + viscosity force f32[n, 3] on cell-sorted targets."""
    bt, bc, _ = FORCE_BLOCK
    kernel = functools.partial(_force_kernel, cfg=cfg, bt=bt, bc=bc)
    call = _call(kernel, 3, sp.shape[0], FORCE_BLOCK, "sph_force_pairs",
                 interpret)
    fx, fy, fz = call(
        sp[:, 0], sp[:, 1], sp[:, 2], sv[:, 0], sv[:, 1], sv[:, 2],
        rho_s, p_s, key_s, starts,
    )
    return jnp.stack([fx, fy, fz], axis=1)
