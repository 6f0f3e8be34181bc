"""Simulator driver tests (class Simulator parity + Times report)."""

import numpy as np
import pytest

from sphjax.bench.times import Times, format_times
from sphjax.core.config import default_config
from sphjax.engine.simulator import Simulator
from sphjax.viz.render import render_frame


def test_simulate_and_get_position():
    cfg = default_config(256, chunk_size=256)
    sim = Simulator(cfg, random_init=True, seed=9)
    sim.setup()
    p0 = sim.get_position().copy()
    assert p0.shape == (256, 3)
    sim.simulate()
    p1 = sim.get_position()
    assert not np.allclose(p0, p1)  # gravity moved the fluid
    assert p1.min() >= cfg.h - 1e-6 and p1.max() <= cfg.box_dim - cfg.h + 1e-6


def test_simulate_and_time_accumulates():
    cfg = default_config(256, chunk_size=256)
    sim = Simulator(cfg)
    sim.setup()
    times = Times()
    for _ in range(3):
        sim.simulate_and_time(times)
    assert times.iters == 3
    assert times.build_grid > 0 and times.sph_update > 0 and times.memcpy > 0
    report = format_times(times)
    assert "Grid construction" in report and "SPH update" in report


@pytest.mark.slow  # ~28 s: repeated re-traces while capacity doubles
def test_capacity_growth_on_overflow():
    """Start with a deliberately tiny window capacity; the driver must grow it
    transparently rather than drop interactions."""
    cfg = default_config(512, chunk_size=512, tile_cand_capacity=64)
    sim = Simulator(cfg)
    sim.setup()
    sim.simulate()
    assert sim.cfg.tile_cand_capacity > 64
    # physics still matches a generous-capacity run
    ref = Simulator(default_config(512, chunk_size=512))
    ref.setup()
    ref.simulate()
    np.testing.assert_allclose(sim.get_position(), ref.get_position(), atol=1e-6)


@pytest.mark.slow  # ~15 s: deliberate overflow re-trace
def test_timed_retry_excludes_failed_attempt(monkeypatch):
    """A capacity-overflow retry inside simulate_and_time must not inflate the
    per-frame averages: the failed attempt's phase seconds are rolled back and
    iters counts only the success. perf_counter is stubbed to +1.0 per call so
    each attempt contributes exactly 1.0 to each phase — without rollback the
    overflowing first attempt would leave build_grid == sph_update == 2.0."""
    import itertools

    import sphjax.engine.simulator as sim_mod

    cfg = default_config(512, chunk_size=512, tile_cand_capacity=64)
    sim = Simulator(cfg)
    sim.setup()
    counter = itertools.count()
    monkeypatch.setattr(
        sim_mod.time, "perf_counter", lambda: float(next(counter))
    )
    times = Times()
    sim.simulate_and_time(times)
    assert sim.cfg.tile_cand_capacity > 64  # the retry actually fired
    assert times.iters == 1
    assert times.build_grid == 1.0
    assert times.sph_update == 1.0
    assert times.memcpy == 1.0


def test_click_during_simulate():
    cfg = default_config(256, chunk_size=256)
    sim = Simulator(cfg, random_init=True, seed=3)
    sim.setup()
    v_before = np.asarray(sim.state.velocity).copy()
    sim.simulate(click=(400, 300))
    # some particle must have received a kick beyond plain gravity
    dv = np.abs(np.asarray(sim.state.velocity) - v_before).max()
    assert dv > 1.0


def test_move_particles_out_of_bounds_noop():
    cfg = default_config(64, chunk_size=64)
    sim = Simulator(cfg, random_init=True, seed=1)
    sim.setup()
    v0 = np.asarray(sim.state.velocity).copy()
    sim.move_particles((10, 10))  # outside click box → ignored (display.cpp:24-27)
    np.testing.assert_array_equal(np.asarray(sim.state.velocity), v0)


def test_get_position_async_matches_sync():
    cfg = default_config(256, chunk_size=256)
    sim = Simulator(cfg, random_init=True, seed=9)
    sim.setup()
    sim.simulate()
    fetch = sim.get_position_async()
    sim_sync = sim.get_position()
    np.testing.assert_array_equal(fetch.wait(), sim_sync)
    # a stale handle (pre-advance) must not leak into get_position
    stale = sim.get_position_async()
    sim.simulate()
    assert not np.allclose(stale.wait(), sim.get_position())


def test_free_mode_pipelined_frames_match_sequential(tmp_path):
    """The double-buffered free-mode loop must produce byte-identical frames
    to the sequential simulate→fetch→render loop (same trajectory, same
    per-frame positions — only the overlap schedule differs)."""
    from sphjax.viz.render import render_frame, run_free_mode

    cfg = default_config(128, chunk_size=128)
    clicks = {1: (400, 300)}

    sim = Simulator(cfg, random_init=True, seed=4)
    sim.setup()
    out = tmp_path / "frames"
    run_free_mode(sim, frames=4, out_dir=str(out), clicks=clicks)
    assert sorted(p.name for p in out.iterdir()) == [
        f"frame_{k:05d}.png" for k in range(4)
    ]

    from sphjax.viz.render import save_png

    ref = Simulator(cfg, random_init=True, seed=4)
    ref.setup()
    for k in range(4):
        ref.simulate(click=clicks.get(k))
        img = render_frame(ref.get_position())
        got = (out / f"frame_{k:05d}.png").read_bytes()
        tmp = tmp_path / "ref.png"
        save_png(img, str(tmp))
        assert tmp.read_bytes() == got, f"frame {k} differs"


def test_render_frame_shape_and_content():
    cfg = default_config(128, chunk_size=128)
    sim = Simulator(cfg, random_init=True, seed=2)
    sim.setup()
    img = render_frame(sim.get_position())
    assert img.shape == (600, 800, 3)
    assert img[..., 2].max() == 255  # blue particles present
    white = (img == 255).all(axis=-1)
    assert white.sum() > 100  # box wireframe present


def test_chunked_positions_match_sequential():
    """simulate_chunk runs the same step+click composition as S sequential
    simulate() calls inside one lax.scan — per-step position snapshots must
    be bitwise identical, clicks included."""
    cfg = default_config(256, chunk_size=256)
    clicks = {2: (400, 300)}

    sim = Simulator(cfg, random_init=True, seed=9)
    sim.setup()
    pos = sim.simulate_chunk(5, clicks=clicks)
    assert pos.shape == (5, 256, 3)

    ref = Simulator(cfg, random_init=True, seed=9)
    ref.setup()
    for k in range(5):
        ref.simulate(click=clicks.get(k))
        np.testing.assert_array_equal(pos[k], ref.get_position(), err_msg=str(k))
    # final carried state identical too
    np.testing.assert_array_equal(
        np.asarray(sim.state.velocity), np.asarray(ref.state.velocity)
    )


def test_chunked_free_mode_frames_match_sequential(tmp_path, monkeypatch):
    """SPHJAX_VIZ_CHUNK=3 over 7 frames (uneven tail chunk) with a scripted
    click must write byte-identical frames to the sequential loop."""
    from sphjax.viz.render import render_frame, run_free_mode, save_png

    cfg = default_config(128, chunk_size=128)
    clicks = {1: (400, 300), 4: (350, 250)}

    monkeypatch.setenv("SPHJAX_VIZ_CHUNK", "3")
    sim = Simulator(cfg, random_init=True, seed=4)
    sim.setup()
    out = tmp_path / "frames"
    run_free_mode(sim, frames=7, out_dir=str(out), clicks=clicks)
    assert sorted(p.name for p in out.iterdir()) == [
        f"frame_{k:05d}.png" for k in range(7)
    ]

    ref = Simulator(cfg, random_init=True, seed=4)
    ref.setup()
    for k in range(7):
        ref.simulate(click=clicks.get(k))
        img = render_frame(ref.get_position())
        tmp = tmp_path / "ref.png"
        save_png(img, str(tmp))
        assert tmp.read_bytes() == (
            out / f"frame_{k:05d}.png"
        ).read_bytes(), f"frame {k} differs"


@pytest.mark.slow  # ~20 s: chunk re-trace loop
def test_chunked_overflow_rewind():
    """A chunk that overflows its windows must rewind to the pre-chunk state,
    grow capacity, and replay — never ship clipped interactions."""
    cfg = default_config(512, chunk_size=512, tile_cand_capacity=64)
    sim = Simulator(cfg)
    sim.setup()
    pos = sim.simulate_chunk(3)
    assert sim.cfg.tile_cand_capacity > 64  # growth happened

    ref = Simulator(default_config(512, chunk_size=512))
    ref.setup()
    for k in range(3):
        ref.simulate()
        np.testing.assert_allclose(
            pos[k], ref.get_position(), atol=1e-6, err_msg=str(k)
        )


def test_device_projection_matches_host():
    """project_pixels_packed (device, jnp) must agree with render.project
    (host, numpy) — same f32 ops in the same order — including the
    inside-frame mask and int truncation."""
    import jax.numpy as jnp

    from sphjax.viz.project import PACK_INSIDE, project_pixels_packed
    from sphjax.viz.render import HEIGHT, NEAR, WIDTH, project

    rng = np.random.default_rng(3)
    pos = rng.uniform(-2.0, 12.0, size=(4096, 3)).astype(np.float32)
    packed = np.asarray(project_pixels_packed(jnp.asarray(pos)))

    px, z = project(pos)
    inside = (
        (px[:, 0] >= 1) & (px[:, 0] < WIDTH - 1)
        & (px[:, 1] >= 1) & (px[:, 1] < HEIGHT - 1) & (z > NEAR)
    )
    np.testing.assert_array_equal((packed & PACK_INSIDE) != 0, inside)
    np.testing.assert_array_equal(
        packed[inside] & 0x3FF, px[inside, 0].astype(np.int32)
    )
    np.testing.assert_array_equal(
        (packed[inside] >> 10) & 0x3FF, px[inside, 1].astype(np.int32)
    )


def test_bitmap_frame_matches_packed():
    """The device-rasterized occupancy bitmap (project_bitmap +
    render_frame_bitmap) must reproduce the packed-pixel frame
    bit-identically: uniform 3-px blue points carry only pixel occupancy,
    so the 60 KB N-independent bitmap loses nothing."""
    import jax.numpy as jnp

    from sphjax.viz.project import project_bitmap, project_pixels_packed
    from sphjax.viz.render import render_frame_bitmap, render_frame_packed

    rng = np.random.default_rng(5)
    pos = rng.uniform(-2.0, 12.0, size=(4096, 3)).astype(np.float32)
    packed = np.asarray(project_pixels_packed(jnp.asarray(pos)))
    bits = np.asarray(project_bitmap(jnp.asarray(pos)))
    assert bits.nbytes == 600 * 100  # 60 KB/frame regardless of N
    np.testing.assert_array_equal(
        render_frame_bitmap(bits), render_frame_packed(packed)
    )


def test_chunked_bitmap_stream_matches_sequential():
    """dispatch_chunk(pack_pixels='bitmap') must emit per-step bitmaps
    identical to rasterizing the sequential loop's positions (the chunked
    free-mode path at the headline N ships these 60 KB frames)."""
    import jax.numpy as jnp

    from sphjax.viz.project import project_bitmap
    from sphjax.viz.render import render_frame_bitmap, render_frame

    cfg = default_config(512, chunk_size=512)
    sim = Simulator(cfg)
    sim.setup()
    h = sim.dispatch_chunk(3, pack_pixels="bitmap")
    frames, ovf = h.fetch.wait()
    assert ovf == 0
    assert frames.shape == (3, 600, 100) and frames.dtype == np.uint8

    ref = Simulator(cfg)
    ref.setup()
    for k in range(3):
        ref.simulate()
        want = np.asarray(
            project_bitmap(jnp.asarray(ref.get_position()))
        )
        np.testing.assert_array_equal(frames[k], want, err_msg=str(k))
        # and the rasterized image equals the raw-position render
        np.testing.assert_array_equal(
            render_frame_bitmap(frames[k]), render_frame(ref.get_position())
        )
