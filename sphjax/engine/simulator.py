"""Simulator — the host-side driver, mirroring `class Simulator`
(/root/reference/src/simulator.h:53-74, src/simulator.cu:370-546) with a
functional JAX core.

API parity:
  * Simulator(cfg)            ← Simulator(Settings*)       (cu:370-375)
  * setup()                   ← setup()                    (cu:411-460)
  * simulate(click=None)      ← simulate() + mouse globals (cu:462-497)
  * simulate_and_time(times)  ← simulateAndTime(Times*)    (cu:499-546)
  * get_position()            ← getPosition()              (cu:407-409)
  * move_particles(click)     ← declared-but-never-defined in the reference
                                (simulator.h:73); implemented here.

Differences from the reference:
  * State is device-resident across steps; only positions cross to host, and only
    when get_position() is called (the reference pays a D2H memcpy every step,
    cu:479-480 — we fetch lazily/async instead).
  * Static capacity management: window overflow is detected in the step aux;
    the driver transparently re-traces with doubled capacity and replays the
    step, so fixed shapes never silently drop interactions.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from sphjax.bench.times import Times
from sphjax.core.config import SimConfig
from sphjax.core.init import init_state
from sphjax.core.state import FluidState
from sphjax.engine.step import (
    BACKENDS,
    build_phase,
    choose_backend,
    make_step,
    update_phase,
)
from sphjax.interact.impulse import (
    click_cell_from_px,
    click_in_box,
    click_kick,
    make_impulse,
)


class AsyncPositionFetch:
    """An in-flight device→host position copy. Constructing it starts the
    transfer (copy_to_host_async); wait() blocks until the data is on host.
    Keeping the device array referenced keeps the source buffer alive for
    the duration of the transfer."""

    def __init__(self, position, num_particles: int):
        self._arr = position
        self._n = num_particles
        self._host: np.ndarray | None = None
        try:
            position.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass  # backend without async copies: wait() falls back to sync

    def matches(self, position) -> bool:
        return self._arr is position

    def wait(self) -> np.ndarray:
        if self._host is None:
            self._host = np.asarray(jax.device_get(self._arr))[: self._n]
        return self._host


class AsyncChunkFetch:
    """In-flight device→host copy of one chunk's stacked per-step positions
    plus its summed overflow counter. wait() → (f32[S, N, 3], int)."""

    def __init__(self, pos_stack, overflow, num_particles: int | None):
        self._pos = pos_stack
        self._ovf = overflow
        self._n = num_particles  # None: frame stack is not per-particle
        self._host: tuple[np.ndarray, int] | None = None
        try:
            pos_stack.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass

    def wait(self) -> tuple[np.ndarray, int]:
        if self._host is None:
            pos = np.asarray(jax.device_get(self._pos))
            if self._n is not None:
                pos = pos[:, : self._n]
            self._host = (pos, int(jax.device_get(self._ovf)))
        return self._host


@dataclasses.dataclass
class ChunkHandle:
    """One dispatched chunk: the pre-chunk state (kept for rewind-on-
    overflow), the in-flight fetch, and the chunk's step count."""

    pre_state: FluidState
    fetch: AsyncChunkFetch
    n_steps: int


class Simulator:
    def __init__(
        self,
        cfg: SimConfig,
        backend: str = "auto",
        random_init: bool = False,
        seed: int = 0,
    ):
        cfg.validate()
        self.cfg = cfg
        self.backend = choose_backend() if backend == "auto" else backend
        self.random_init = random_init
        self.seed = seed
        self.state: FluidState | None = None
        self._position_host: np.ndarray | None = None
        self._pending_fetch: AsyncPositionFetch | None = None
        self._build_fns()

    # ------------------------------------------------------------------ setup
    def _build_fns(self) -> None:
        cfg = self.cfg
        self._step = make_step(cfg, self.backend)
        self._impulse = make_impulse(cfg)
        self._chunk_cache = {}
        if self.backend != "allpairs":
            backend = self.backend
            self._build = jax.jit(lambda s: build_phase(s, cfg))
            self._update = jax.jit(lambda s, cl: update_phase(s, cl, cfg, backend))
        else:
            self._build = None
            self._update = None

    def setup(self, state: FluidState | None = None) -> None:
        """Initialize particle state (Simulator::setup, cu:411-460). Pass a
        FluidState (e.g. from core/io.load_state) to resume a checkpoint
        instead of initializing fresh."""
        self.state = (
            state
            if state is not None
            else init_state(self.cfg, self.random_init, self.seed)
        )
        self._position_host = None

    # ------------------------------------------------------------- stepping
    def _grow_capacity(self) -> None:
        self.cfg = dataclasses.replace(
            self.cfg,
            tile_cand_capacity=self.cfg.tile_cand_capacity * 2,
            window_capacity=self.cfg.window_capacity * 2,
        )
        self._build_fns()

    def simulate(self, click: tuple[int, int] | None = None) -> None:
        """One untimed timestep (+ optional click impulse, cu:462-497).
        Replays with doubled window capacity if the fixed-size neighbor
        windows overflowed (never silently drops interactions)."""
        assert self.state is not None, "call setup() first"
        pre_pos = self.state.position
        for _ in range(8):  # capacity-growth retries
            new_state, aux = self._step(self.state)
            if int(aux.window_overflow) == 0:
                break
            self._grow_capacity()
        else:
            raise RuntimeError("window capacity growth failed to converge")
        if click is not None and click_in_box(*click):
            new_state = self._impulse(
                new_state, pre_pos, jnp.asarray(click, jnp.int32)
            )
        self.state = new_state
        self._position_host = None
        self.last_aux = aux

    def simulate_and_time(self, times: Times) -> None:
        """Timed timestep with the reference's three phase brackets
        (simulateAndTime, cu:499-546): grid build / SPH update / host copy.
        Phases are fenced with block_until_ready so each measures device time.
        """
        assert self.state is not None, "call setup() first"
        assert self._update is not None, "timed mode needs a cell-list backend"

        # Snapshot the phase accumulators: if this attempt overflows capacity
        # we re-trace and replay, and the failed attempt's seconds must not
        # contaminate the per-frame averages (iters only counts successes).
        build0, update0, memcpy0 = times.build_grid, times.sph_update, times.memcpy

        # Each phase is fenced with block_until_ready — the sync the
        # reference pays with cudaDeviceSynchronize (simulator.cu:505-545).
        t0 = time.perf_counter()
        cl = self._build(self.state)
        jax.block_until_ready(cl)
        t1 = time.perf_counter()
        times.build_grid += t1 - t0

        new_state, aux = self._update(self.state, cl)
        jax.block_until_ready((new_state, aux))
        t2 = time.perf_counter()
        times.sph_update += t2 - t1

        if int(aux.window_overflow) > 0:
            # Re-trace with more capacity and replay (untimed — a re-trace is
            # a compilation event, not a steady-state cost). Roll back the
            # failed attempt's accumulated seconds first.
            times.build_grid, times.sph_update, times.memcpy = (
                build0, update0, memcpy0
            )
            self._grow_capacity()
            self.simulate_and_time(times)
            return

        # Per-step D2H position copy, like cu:532-533, but DOUBLE-BUFFERED:
        # wait for the PREVIOUS step's in-flight copy (its transfer
        # overlapped this step's build+update phases), then start this
        # step's copy — the memcpy phase pays only the non-overlapped
        # remainder instead of a full synchronous transfer per step.
        if self._pending_fetch is not None:
            self._position_host = self._pending_fetch.wait()
        self._pending_fetch = AsyncPositionFetch(
            new_state.position, self.cfg.num_particles
        )
        t3 = time.perf_counter()
        times.memcpy += t3 - t2

        self.state = new_state
        times.iters += 1

    # ------------------------------------------------------- chunked stepping
    def _chunk_fn(self, n_steps: int, pack_pixels: bool = False):
        """Jitted `(state, cells i32[S,2], gains i32[S]) -> (state, positions
        f32[S,N,3], overflow)`: S timesteps chained in ONE dispatch via
        lax.scan, each optionally followed by a click impulse (gain 1) using
        that step's pre-positions — the same composition simulate(click=...)
        runs step-by-step, so the per-step position snapshots are bitwise
        identical to the sequential loop. This amortizes the dispatch and the
        overflow-counter fetch over S frames (the reference pays a full D2H
        sync every frame, /root/reference/src/simulator.cu:479-480).

        pack_pixels=True emits DEVICE-projected packed pixel coords
        (int32[S, N], sphjax/viz/project.py) instead of raw positions —
        4 bytes/particle/frame instead of 12 over the host link, the analog
        of the reference rendering on-device.
        pack_pixels="bitmap" goes further and rasterizes ON DEVICE into a
        bit-packed occupancy bitmap (uint8[S, H, W//8] — 60 KB/frame,
        N-independent; project.py::project_bitmap), the full analog of the
        reference's on-device render."""
        fn = self._chunk_cache.get((n_steps, pack_pixels))
        if fn is not None:
            return fn
        cfg = self.cfg
        step = BACKENDS[self.backend]

        @jax.jit
        def chunk(state, cells, gains):
            def body(s, inp):
                cell, gain = inp
                s2, aux = step(s, cfg)
                s2 = jax.lax.cond(
                    gain > 0,
                    lambda pre, st: st._replace(
                        velocity=st.velocity
                        + click_kick(pre, st.valid, cell, cfg)
                    ),
                    lambda pre, st: st,
                    s.position,
                    s2,
                )
                if pack_pixels == "bitmap":
                    from sphjax.viz.project import project_bitmap

                    # padding slots park at the origin, which projects
                    # inside the frame — rasterize the live rows only
                    snap = project_bitmap(
                        s2.position[: cfg.num_particles]
                    )
                elif pack_pixels:
                    from sphjax.viz.project import project_pixels_packed

                    snap = project_pixels_packed(s2.position)
                else:
                    snap = s2.position
                return s2, (snap, aux.window_overflow)

            s_f, (pos, ovf) = jax.lax.scan(body, state, (cells, gains))
            return s_f, pos, jnp.sum(ovf)

        self._chunk_cache[(n_steps, pack_pixels)] = chunk
        return chunk

    def dispatch_chunk(
        self, n_steps: int, clicks=None, pack_pixels: bool = False
    ) -> ChunkHandle:
        """Advance n_steps in one dispatch (speculatively: the handle's
        overflow flag arrives with the positions; on overflow call
        rewind_chunk and re-dispatch). clicks: {local_step_index: (px, py)}
        pixel coords, applied after their step like simulate(click=...)."""
        assert self.state is not None, "call setup() first"
        cells = np.zeros((n_steps, 2), np.int32)
        gains = np.zeros((n_steps,), np.int32)
        for j, px_py in (clicks or {}).items():
            if click_in_box(*px_py):
                cells[j] = click_cell_from_px(px_py[0], px_py[1], self.cfg)
                gains[j] = 1
        pre = self.state
        s_f, pos, ovf = self._chunk_fn(n_steps, pack_pixels)(
            pre, jnp.asarray(cells), jnp.asarray(gains)
        )
        self.state = s_f
        self._position_host = None
        self._pending_fetch = None
        return ChunkHandle(
            pre_state=pre,
            fetch=AsyncChunkFetch(
                pos, ovf,
                None if pack_pixels == "bitmap" else self.cfg.num_particles,
            ),
            n_steps=n_steps,
        )

    def rewind_chunk(self, handle: ChunkHandle, grow: bool = True) -> None:
        """Overflow recovery: restore the pre-chunk state (discarding this
        chunk's results and any chunk dispatched after it) and re-trace with
        doubled window capacity, like simulate()'s per-step retry."""
        self.state = handle.pre_state
        self._position_host = None
        self._pending_fetch = None
        if grow:
            self._grow_capacity()

    def simulate_chunk(self, n_steps: int, clicks=None) -> np.ndarray:
        """Synchronous chunked advance with the capacity-growth retry folded
        in: returns the f32[S, N, 3] per-step position stack."""
        for _ in range(8):
            handle = self.dispatch_chunk(n_steps, clicks)
            pos, ovf = handle.fetch.wait()
            if ovf == 0:
                return pos
            self.rewind_chunk(handle)
        raise RuntimeError("window capacity growth failed to converge")

    # --------------------------------------------------------------- queries
    def get_position(self) -> np.ndarray:
        """Host-side f32[N,3] position snapshot (getPosition, cu:407-409).
        Joins the in-flight async copy when one covers the current state;
        falls back to a synchronous fetch otherwise."""
        assert self.state is not None, "call setup() first"
        if self._pending_fetch is not None and self._pending_fetch.matches(
            self.state.position
        ):
            return self._pending_fetch.wait()
        if self._position_host is None:
            pos = np.asarray(jax.device_get(self.state.position))
            self._position_host = pos[: self.cfg.num_particles]
        return self._position_host

    def get_position_async(self) -> AsyncPositionFetch:
        """Start a device→host copy of the CURRENT positions and return the
        in-flight handle (SURVEY.md §5 comm backend: the free-mode loop
        dispatches step k+1 before waiting on step k's positions, so frame
        time is max(step, fetch) instead of step + fetch)."""
        assert self.state is not None, "call setup() first"
        self._pending_fetch = AsyncPositionFetch(
            self.state.position, self.cfg.num_particles
        )
        return self._pending_fetch

    def move_particles(self, click: tuple[int, int]) -> None:
        """Apply a click impulse outside the step loop — implements the
        reference's declared-but-undefined Simulator::moveParticles."""
        assert self.state is not None, "call setup() first"
        if not click_in_box(*click):
            return
        self.state = self._impulse(
            self.state, self.state.position, jnp.asarray(click, jnp.int32)
        )
        self._position_host = None
