"""Loader for the native C++ host-runtime library (native/sphnative.cpp).

Compiles on demand with g++ (cached as native/build/libsphnative.so) and binds
via ctypes. Every caller has a pure-Python fallback, so absence of a compiler
only costs speed/parity-of-RNG, never functionality.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "sphnative.cpp")
_SO = os.path.join(_REPO, "native", "build", "libsphnative.so")

_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """ctypes handle to libsphnative, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sph_reference_random_init.argtypes = [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, f32p,
    ]
    lib.sph_grid_init.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float, f32p]
    lib.sph_grid_init.restype = ctypes.c_int
    lib.sph_render_frame.argtypes = [f32p, ctypes.c_int, u8p]
    lib.sph_render_packed.argtypes = [i32p, ctypes.c_int, u8p]
    lib.sph_native_abi_version.restype = ctypes.c_int
    if lib.sph_native_abi_version() != 2:
        return None
    _lib = lib
    return _lib


def reference_random_positions(n: int, box_dim: float, seed: int = -1):
    """Bit-exact replica of the reference's libc-rand() placement
    (simulator.cu:430-437). seed=-1 keeps process rand() state (the
    reference never seeds → glibc default seed 1 at process start).
    Returns f32[n,3] or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((n, 3), np.float32)
    lib.sph_reference_random_init(
        n, box_dim, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    return out


def render_frame_native(positions: np.ndarray):
    """Native rasterizer (display.cpp parity). Returns uint8[600,800,3] or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float32)
    img = np.empty((600, 800, 3), np.uint8)
    lib.sph_render_frame(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pos.shape[0],
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return img


def render_packed_native(packed: np.ndarray):
    """Native rasterizer over DEVICE-projected packed pixel coords
    (sphjax/viz/project.py layout). Returns uint8[600,800,3] or None if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(packed, np.int32)
    img = np.empty((600, 800, 3), np.uint8)
    lib.sph_render_packed(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.shape[0],
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return img


