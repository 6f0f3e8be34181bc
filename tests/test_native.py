"""Native C++ host-runtime library tests (native/sphnative.cpp)."""

import ctypes
import ctypes.util

import numpy as np
import pytest

from sphjax.core.config import default_config
from sphjax.core.init import grid_positions
from sphjax.utils.native import (
    get_lib,
    reference_random_positions,
    render_frame_native,
)
from sphjax.viz.render import _render_frame_numpy

pytestmark = pytest.mark.skipif(get_lib() is None, reason="native lib unavailable")


def test_reference_random_matches_libc():
    """The native init must replay libc's exact rand() sequence — the parity
    property that lets us reproduce the reference's unseeded random scenes."""
    pos = reference_random_positions(4, 10.0, seed=1)
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    libc.srand(1)
    expected = []
    for _ in range(12):
        expected.append(libc.rand() / 2147483647.0 * 8.0 + 1.0)
    np.testing.assert_allclose(pos.ravel(), np.float32(expected), rtol=1e-6)
    assert pos.min() >= 1.0 and pos.max() <= 9.0


def test_native_grid_matches_python():
    cfg = default_config(1000)
    lib = get_lib()
    out = np.empty((1000, 3), np.float32)
    k = lib.sph_grid_init(1000, ctypes.c_float(0.1), ctypes.c_float(10.0),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    assert k == 1000
    np.testing.assert_allclose(out, grid_positions(cfg), atol=1e-6)



def test_native_render_matches_numpy():
    rng = np.random.default_rng(1)
    pos = rng.uniform(1, 9, size=(200, 3)).astype(np.float32)
    a = render_frame_native(pos)
    b = _render_frame_numpy(pos)
    assert a.shape == b.shape == (600, 800, 3)
    # identical particle pixels; wireframe sampling may differ by a pixel
    np.testing.assert_array_equal(a[..., 2] == 255, b[..., 2] == 255)


def test_native_packed_render_matches_numpy():
    """The packed-coordinate rasterizer (free-mode frame stream) must agree
    with the numpy fallback pixel-for-pixel on particle pixels."""
    import jax.numpy as jnp

    from sphjax.utils.native import render_packed_native
    from sphjax.viz.project import project_pixels_packed

    rng = np.random.default_rng(2)
    pos = rng.uniform(-1, 11, size=(300, 3)).astype(np.float32)
    packed = np.asarray(project_pixels_packed(jnp.asarray(pos)))
    a = render_packed_native(packed)

    # numpy path, bypassing the native dispatch inside render_frame_packed
    from sphjax.viz.render import _wireframe_layer
    from sphjax.viz.project import PACK_INSIDE

    img = _wireframe_layer().copy()
    p = packed[(packed & PACK_INSIDE) != 0]
    xi, yi = p & 0x3FF, (p >> 10) & 0x3FF
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            img[yi + dy, xi + dx] = (0, 0, 255)
    np.testing.assert_array_equal(a[..., 2] == 255, img[..., 2] == 255)
