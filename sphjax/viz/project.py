"""Device-side pixel projection for free mode.

The reference renders ON the device (OpenGL vertex transform,
/root/reference/src/display.cpp:83-91) and never ships raw positions to the
host. The analog here: project every particle to its integer pixel
coordinate in-graph and ship ONE packed int32 per particle instead of three
f32s — 4 bytes/particle instead of 12 over the device→host link.

The math mirrors sphjax/viz/render.py::project line for line (same f32
ops, same order — add, negate, max, mul, div are all exactly-rounded IEEE
f32 on CPU XLA, so packed frames are bit-identical to host-projected ones
there; on an accelerator the division may differ by an ulp, which can move
a particle one pixel at most once in ~1e7 — the chunked and sequential
device paths stay self-consistent since both use this projection).

Packing: bit 20 = inside-frame flag, bits 19..10 = y pixel, bits 9..0 = x
pixel (800x600 frame: x < 1024, y < 1024). Outside particles pack to 0.
"""

from __future__ import annotations

import jax.numpy as jnp

from sphjax.viz.render import FRUSTUM_HALF, HEIGHT, NEAR, WIDTH

PACK_INSIDE = 1 << 20


def project_bitmap(position: jnp.ndarray) -> jnp.ndarray:
    """f32[N, 3] world positions → bit-packed uint8[HEIGHT, WIDTH//8]
    occupancy bitmap (little bit order): the frame stream whose size is
    N-INDEPENDENT — 60 KB at 800×600 versus 4·N bytes for packed pixel
    coords (1 MB at 262k). The reference draws uniform 3-px blue
    GL_POINTS (display.cpp:83-91), so pixel occupancy IS the frame: point
    multiplicity never changes a pixel's color, and
    render.render_frame_bitmap reproduces render_frame_packed's output
    bit-identically (tested). Pass positions of VALID particles only
    (padding slots park at the origin, which projects inside the frame).

    Device cost: one N-index scatter of ones (the same primitive as the
    build histogram) + a 480k-lane bit-pack reduce, for a 17× smaller
    transfer than packed coords at 262k."""
    packed = project_pixels_packed(position)
    inside = (packed & PACK_INSIDE) != 0
    xi = packed & 0x3FF
    yi = (packed >> 10) & 0x3FF
    flat = yi * WIDTH + xi
    idx = jnp.where(inside, flat, HEIGHT * WIDTH)  # outside → scratch slot
    grid = jnp.zeros((HEIGHT * WIDTH + 1,), jnp.uint8).at[idx].set(1)
    bits = grid[: HEIGHT * WIDTH].reshape(HEIGHT, WIDTH // 8, 8)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.int32)
    return (bits.astype(jnp.int32) * weights).sum(axis=-1).astype(jnp.uint8)


def project_pixels_packed(position: jnp.ndarray) -> jnp.ndarray:
    """f32[N, 3] world positions -> packed int32[N] pixel coords (see module
    docstring for the layout). Mirrors render.py::project + the inside test
    of _render_frame_numpy."""
    f = jnp.float32
    view_x = position[:, 0] + f(-5.0)
    view_y = position[:, 1] + f(-5.0)
    view_z = position[:, 2] + f(-15.0)
    z = jnp.maximum(-view_z, f(1e-6))
    ndc_x = (f(NEAR) * view_x / z) / f(FRUSTUM_HALF)
    ndc_y = (f(NEAR) * view_y / z) / f(FRUSTUM_HALF)
    px = (ndc_x * f(0.5) + f(0.5)) * f(WIDTH)
    py = (f(1.0) - (ndc_y * f(0.5) + f(0.5))) * f(HEIGHT)
    inside = (
        (px >= 1) & (px < WIDTH - 1) & (py >= 1) & (py < HEIGHT - 1)
        & (z > NEAR)
    )
    xi = px.astype(jnp.int32)
    yi = py.astype(jnp.int32)
    packed = xi | (yi << 10) | PACK_INSIDE
    return jnp.where(inside, packed, 0)
