"""Visualization — free mode, replacing the OpenGL/GLUT renderer
(/root/reference/src/display.cpp).

The reference draws an 800×600 window ("SPH Simulation"): black clear color,
the 10×10×10 box wireframe in white lines, every particle as a 3-px blue
smooth point, under glFrustum(−2,2,−2,2,1,100) translated by (−5,−5,−15)
(display.cpp:66-91). Here the same camera is a small numpy rasterizer (no GL
dependency): frames are rendered on host from async position snapshots and
either dumped to PNG (headless) or shown interactively via matplotlib with the
same left-click → ripple-impulse wiring (display.cpp:22-32).

Double-buffered readback: step k+1 is dispatched before the host fetch of
step k's positions completes (SURVEY.md §5 "distributed communication
backend"), so rendering never stalls the device step loop.
"""

from __future__ import annotations

import os

import numpy as np

WIDTH, HEIGHT = 800, 600  # display.cpp:72
NEAR, FRUSTUM_HALF = 1.0, 2.0  # glFrustum(-2,2,-2,2,1,100), display.cpp:85
CAMERA_OFFSET = np.array([-5.0, -5.0, -15.0], np.float32)  # display.cpp:86

_BOX_VERTICES = np.array(
    [
        [0, 0, 0], [10, 0, 0], [10, 10, 0], [0, 10, 0],
        [0, 0, 10], [10, 0, 10], [10, 10, 10], [0, 10, 10],
    ],
    np.float32,
)  # display.cpp:10-13
_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6),
    (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7),
]  # display.cpp:15-16


def project(points: np.ndarray) -> np.ndarray:
    """World → pixel coords under the reference camera. Returns f32[N,2]
    (x right, y down, matching image convention) and the view-space depth."""
    view = points.astype(np.float32) + CAMERA_OFFSET
    z = -view[:, 2]  # camera looks down -z; z > 0 in front
    z = np.maximum(z, 1e-6)
    ndc_x = (NEAR * view[:, 0] / z) / FRUSTUM_HALF
    ndc_y = (NEAR * view[:, 1] / z) / FRUSTUM_HALF
    px = (ndc_x * 0.5 + 0.5) * WIDTH
    py = (1.0 - (ndc_y * 0.5 + 0.5)) * HEIGHT
    return np.stack([px, py], axis=1), z


def render_frame(positions: np.ndarray) -> np.ndarray:
    """Rasterize one frame: black background, white box wireframe, blue 3-px
    particles (display.cpp:35-57). Returns uint8[H, W, 3]. Uses the native
    C++ rasterizer (native/sphnative.cpp) when available, numpy otherwise."""
    from sphjax.utils.native import render_frame_native

    native = render_frame_native(positions)
    if native is not None:
        return native
    return _render_frame_numpy(positions)


def _render_frame_numpy(positions: np.ndarray) -> np.ndarray:
    img = np.zeros((HEIGHT, WIDTH, 3), np.uint8)

    # box wireframe: sample each edge densely (cheap, 12 edges)
    for a, b in _BOX_EDGES:
        t = np.linspace(0.0, 1.0, 400, dtype=np.float32)[:, None]
        seg = _BOX_VERTICES[a][None, :] * (1 - t) + _BOX_VERTICES[b][None, :] * t
        px, _ = project(seg)
        xi = np.clip(px[:, 0].astype(np.int32), 0, WIDTH - 1)
        yi = np.clip(px[:, 1].astype(np.int32), 0, HEIGHT - 1)
        img[yi, xi] = 255

    # particles: 3-px blue points (GL_POINTS with glPointSize(3))
    px, z = project(positions)
    inside = (
        (px[:, 0] >= 1) & (px[:, 0] < WIDTH - 1)
        & (px[:, 1] >= 1) & (px[:, 1] < HEIGHT - 1) & (z > NEAR)
    )
    xi = px[inside, 0].astype(np.int32)
    yi = px[inside, 1].astype(np.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            img[yi + dy, xi + dx, 2] = 255
            img[yi + dy, xi + dx, 0] = 0
            img[yi + dy, xi + dx, 1] = 0
    return img


_WIREFRAME_CACHE: np.ndarray | None = None


def _wireframe_layer() -> np.ndarray:
    """uint8[H, W, 3] black frame with the white box wireframe — static
    across frames, rasterized once per process."""
    global _WIREFRAME_CACHE
    if _WIREFRAME_CACHE is None:
        img = np.zeros((HEIGHT, WIDTH, 3), np.uint8)
        for a, b in _BOX_EDGES:
            t = np.linspace(0.0, 1.0, 400, dtype=np.float32)[:, None]
            seg = _BOX_VERTICES[a][None, :] * (1 - t) + _BOX_VERTICES[b][None, :] * t
            px, _ = project(seg)
            xi = np.clip(px[:, 0].astype(np.int32), 0, WIDTH - 1)
            yi = np.clip(px[:, 1].astype(np.int32), 0, HEIGHT - 1)
            img[yi, xi] = 255
        _WIREFRAME_CACHE = img
    return _WIREFRAME_CACHE


def render_frame_packed(packed: np.ndarray) -> np.ndarray:
    """Rasterize one frame from DEVICE-projected packed pixel coords
    (sphjax/viz/project.py: bit 20 inside flag, bits 19..10 y, bits 9..0 x)
    — the 4-bytes-per-particle frame stream for the transfer-bound free
    mode. Same output as render_frame on host-projected positions. Uses the
    native C++ rasterizer (native/sphnative.cpp) when available."""
    from sphjax.utils.native import render_packed_native
    from sphjax.viz.project import PACK_INSIDE

    native = render_packed_native(packed)
    if native is not None:
        return native

    img = _wireframe_layer().copy()
    p = packed[(packed & PACK_INSIDE) != 0]
    xi = p & 0x3FF
    yi = (p >> 10) & 0x3FF
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            img[yi + dy, xi + dx, 2] = 255
            img[yi + dy, xi + dx, 0] = 0
            img[yi + dy, xi + dx, 1] = 0
    return img


def _paint_blue_3px(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Dilate the pixel-occupancy mask by the uniform 3×3 point footprint
    (separable shift-OR — ~0.2 ms at 800×600 vs ~12 ms for per-point fancy
    indexing) and paint the result blue over img, in place. Shifts clip at
    the frame edge, matching the per-point loops (the inside test keeps
    point centers ≥1 px from the border, so nothing ever clipped there)."""
    v = mask.copy()
    v[:-1] |= mask[1:]
    v[1:] |= mask[:-1]
    d = v.copy()
    d[:, :-1] |= v[:, 1:]
    d[:, 1:] |= v[:, :-1]
    img[d] = (0, 0, 255)
    return img


def render_frame_bitmap(bits: np.ndarray) -> np.ndarray:
    """Rasterize one frame from a DEVICE-rasterized occupancy bitmap
    (sphjax/viz/project.py::project_bitmap — bit-packed uint8[H, W//8],
    little bit order). Bit-identical output to render_frame_packed on the
    same positions: occupancy is all the uniform 3-px blue point style
    carries (multiplicity never changes a pixel)."""
    img = _wireframe_layer().copy()
    mask = np.unpackbits(
        np.asarray(bits, np.uint8), axis=-1, bitorder="little"
    ).astype(bool)
    return _paint_blue_3px(img, mask)


def save_png(img: np.ndarray, path: str) -> None:
    """PNG encode; PIL if present, else a minimal stdlib encoder.
    compress_level=1: PNG is lossless at every level, and on these
    mostly-black 800×600 frames level 1 encodes several times faster than
    zlib's default 6 for slightly more bytes, so the headless frame dump
    is not bound by the encoder."""
    try:
        from PIL import Image

        Image.fromarray(img).save(path, compress_level=1)
    except ImportError:
        _save_png_stdlib(img, path)


def _save_png_stdlib(img: np.ndarray, path: str) -> None:
    import struct
    import zlib

    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data))
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def frames_to_gif(frames_dir: str, gif_path: str, fps: int = 30) -> None:
    """Assemble the PNG frames in frames_dir into an animated GIF (PIL)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "--gif needs the Pillow package (PIL), which is not installed"
        ) from e

    paths = sorted(
        os.path.join(frames_dir, f)
        for f in os.listdir(frames_dir)
        if f.endswith(".png")
    )
    if not paths:
        raise ValueError(f"no frames in {frames_dir}")
    imgs = [Image.open(p) for p in paths]
    imgs[0].save(
        gif_path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=0,
    )


def run_free_mode(
    sim, frames: int = 0, out_dir: str = "frames", clicks=None,
    chunk: int | None = None,
) -> None:
    """Free mode: continuous animation (display() callback loop,
    display.cpp:35-64). frames>0 → headless frame dump with optional scripted
    clicks {frame: (px, py)}; frames==0 → interactive matplotlib window with
    live left-click ripple impulses. chunk=S (or SPHJAX_VIZ_CHUNK=S) runs S
    steps per device dispatch — see _run_chunked."""
    clicks = clicks or {}
    if frames > 0:
        os.makedirs(out_dir, exist_ok=True)
        if chunk is None:
            chunk = int(os.environ.get("SPHJAX_VIZ_CHUNK", "0"))
        if chunk > 1 and hasattr(sim, "dispatch_chunk"):
            _run_chunked(sim, frames, chunk, clicks, out_dir)
            return
        # Double-buffered readback: step k+1 is dispatched BEFORE the host
        # waits on step k's position transfer, so the D2H copy (and the
        # host-side rasterization) overlap the next device step — frame
        # time ≈ max(step, fetch + render) instead of their sum. Frames
        # are identical to the sequential loop: frame k always renders the
        # post-step-k positions, exactly like the reference's display()
        # (display.cpp:35-57, paying its stall at simulator.cu:479-480).
        pending = None  # (frame index, in-flight fetch)
        use_async = hasattr(sim, "get_position_async") and not os.environ.get(
            "SPHJAX_VIZ_SYNC"
        )  # SPHJAX_VIZ_SYNC=1: sequential fetch (A/B measurement aid)
        for k in range(frames):
            sim.simulate(click=clicks.get(k))
            fetch = sim.get_position_async() if use_async else None
            if pending is not None:
                _render_to(pending[1].wait(), pending[0], out_dir)
            if fetch is None:  # DistSimulator: synchronous collect
                _render_to(sim.get_position(), k, out_dir)
            else:
                pending = (k, fetch)
        if pending is not None:
            _render_to(pending[1].wait(), pending[0], out_dir)
        print(f"wrote {frames} frames to {out_dir}/")
        return

    _run_interactive(sim)


def _run_chunked(sim, frames: int, chunk: int, clicks, out_dir: str) -> None:
    """SPHJAX_VIZ_CHUNK=S: one device dispatch per S frames. The scan-chained
    chunk (Simulator.dispatch_chunk) amortizes the dispatch round-trip
    and the overflow check over S frames, and the (S, N, 3) position stack
    crosses to host in one transfer that overlaps the NEXT chunk's compute
    (two chunks in flight). Frames are bitwise identical to the sequential
    loop — scripted clicks fire at their exact frame inside the scan. On
    overflow the oldest chunk rewinds to its pre-state (speculative newer
    chunks are discarded) and replays with grown capacity."""
    # Device-side frame encoding: SPHJAX_VIZ_PACK=bitmap rasterizes on
    # device into a bit-packed occupancy bitmap (60 KB/frame,
    # N-independent — the default at the headline N, where packed coords
    # are 1 MB/frame); =1 ships packed pixel
    # coords (4 B/particle); =0 ships raw positions (12 B/particle).
    default_pack = "bitmap" if sim.cfg.num_particles >= 65536 else "1"
    mode = os.environ.get("SPHJAX_VIZ_PACK", default_pack)
    pack = {"0": False, "1": True}.get(mode, "bitmap")
    inflight: list[tuple[int, object]] = []  # (start frame, ChunkHandle)
    k = 0  # next frame to dispatch

    # PNG encode on worker threads: zlib releases the GIL, and the encode
    # otherwise serializes against the next chunk's fetch. Encodes
    # are only ever submitted for COMMITTED chunks (overflowed chunks
    # rewind before rendering), so no file needs un-writing.
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=2)
    saves: list = []

    def dispatch():
        nonlocal k
        s = min(chunk, frames - k)
        local = {j - k: clicks[j] for j in range(k, k + s) if j in clicks}
        inflight.append((k, sim.dispatch_chunk(s, local, pack_pixels=pack)))
        k += s

    done = 0
    while done < frames:
        while k < frames and len(inflight) < 2:
            dispatch()
        start, h = inflight.pop(0)
        pos, ovf = h.fetch.wait()
        if ovf:
            sim.rewind_chunk(h)
            inflight.clear()
            k = start
            continue
        for j in range(h.n_steps):
            if pack == "bitmap":
                img = render_frame_bitmap(pos[j])
            elif pack:
                img = render_frame_packed(pos[j])
            else:
                img = render_frame(pos[j])
            saves.append(pool.submit(
                save_png, img,
                os.path.join(out_dir, f"frame_{start + j:05d}.png"),
            ))
            done += 1
    for s in saves:
        s.result()  # propagate encode errors; all files on disk past here
    pool.shutdown()
    print(f"wrote {frames} frames to {out_dir}/")


def _render_to(positions: np.ndarray, k: int, out_dir: str) -> None:
    save_png(render_frame(positions), os.path.join(out_dir, f"frame_{k:05d}.png"))


def _build_interactive(sim):
    """Construct the interactive window pieces: (fig, tick, pending).
    `tick` is the per-frame FuncAnimation callback (the queued click is
    consumed exactly like the reference's mouseClicked global,
    display.cpp:59-61); `pending["click"]` injects a click the way the mpl
    button_press_event handler does. Split from _run_interactive so a
    headless test (matplotlib Agg) can drive real ticks without a display.

    The default tick is PIPELINED: it dispatches this tick's step (with
    the click — it applies to the step dispatched at the tick it was
    queued, reference parity) and then rasters/displays the PREVIOUS
    tick's device-encoded frame while the new step runs on device. Frame
    time ≈ max(step, small fetch + raster) instead of step + full-position
    fetch + raster (the synchronous loop pays ~3·4·N B/frame of transfer,
    3 MB at 262k). The window therefore
    displays one frame behind the physics. SPHJAX_VIZ_SYNC=1 restores the
    sequential simulate→fetch→render tick; SPHJAX_VIZ_PACK picks the frame
    encoding as in _run_chunked."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    if fig.canvas.manager is not None:  # Agg has no window manager
        fig.canvas.manager.set_window_title("SPH Simulation")  # display.cpp:73
    im = ax.imshow(render_frame(sim.get_position()))
    ax.set_axis_off()
    pending = {"click": None}

    def on_click(event):  # mouse() callback parity (display.cpp:22-32)
        if event.button == 1 and event.xdata is not None:
            pending["click"] = (int(event.xdata), int(event.ydata))

    fig.canvas.mpl_connect("button_press_event", on_click)

    sync = os.environ.get("SPHJAX_VIZ_SYNC") == "1" or not hasattr(
        sim, "dispatch_chunk"  # DistSimulator: synchronous collect only
    )
    default_pack = "bitmap" if sim.cfg.num_particles >= 65536 else "1"
    mode = os.environ.get("SPHJAX_VIZ_PACK", default_pack)
    pack = {"0": False, "1": True}.get(mode, "bitmap")
    # Pipeline depth: frames the display lags the physics. At depth 2 the
    # popped handle has had two full ticks in flight, so its 60 KB fetch
    # has already landed — the tick pays one round-trip (its own dispatch)
    # instead of dispatch + fetch.
    depth = max(1, int(os.environ.get("SPHJAX_VIZ_DEPTH", "2")))
    inflight: list = []  # oldest-first (ChunkHandle, click)

    def _raster(snap):
        if pack == "bitmap":
            return render_frame_bitmap(snap)
        if pack:
            return render_frame_packed(snap)
        return render_frame(snap)

    def _dispatch(c):
        return sim.dispatch_chunk(1, {0: c} if c else None, pack_pixels=pack)

    def tick(_frame):
        click = pending["click"]
        pending["click"] = None
        if sync:
            sim.simulate(click=click)
            im.set_data(render_frame(sim.get_position()))
            return (im,)
        inflight.append((_dispatch(click), click))
        if len(inflight) > depth:
            prev, prev_click = inflight.pop(0)
            snaps, ovf = prev.fetch.wait()
            if ovf:
                # prev overflowed, so every younger dispatch consumed a
                # clipped state: rewind to prev's pre-state, replay prev
                # through simulate()'s grow-and-retry, then re-dispatch the
                # younger steps in order to refill the pipeline.
                sim.rewind_chunk(prev)
                sim.simulate(click=prev_click)
                im.set_data(render_frame(sim.get_position()))
                inflight[:] = [(_dispatch(c), c) for _, c in inflight]
            else:
                im.set_data(_raster(snaps[0]))
        return (im,)

    return fig, tick, pending


def _run_interactive(sim) -> None:
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(
            "interactive free mode needs the matplotlib package, which is not "
            "installed; use --frames N to dump PNG frames headlessly"
        ) from e
    if not os.environ.get("DISPLAY") and os.name == "posix":
        print(
            "No interactive display available; use --frames N to dump frames "
            "headlessly (e.g. sph -m free --frames 100 --out frames/)."
        )
        return

    from matplotlib.animation import FuncAnimation

    fig, tick, _pending = _build_interactive(sim)
    _anim = FuncAnimation(fig, tick, interval=1, blit=True, cache_frame_data=False)
    plt.show()
