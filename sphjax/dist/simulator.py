"""DistSimulator — the multi-chip front end, mirroring the single-chip
Simulator API (setup / simulate / get_position / simulate_and_time) over a
z-slab-sharded `jax.sharding.Mesh` (see dist/sharded.py for the step).

The reference has no distributed capability (SURVEY.md §2.5); this is the
scaling layer the survey specifies (millions of particles across the cards
of one host via halo exchange).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np
from jax.sharding import Mesh

from sphjax.bench.times import Times
from sphjax.core.config import SimConfig
from sphjax.core.init import init_state
from sphjax.core.state import FluidState
from sphjax.dist.sharded import (
    DistConfig,
    DistState,
    collect_state,
    distribute_state,
    make_sharded_step,
    make_sharded_timed,
)
from sphjax.engine.step import choose_backend


def default_dist_config(
    cfg: SimConfig, n_devices: int, slack: float = 2.0
) -> DistConfig:
    """Capacity heuristics: each slab gets `slack`× the uniform share (the
    fluid clusters under gravity along y, and slabs are along z, so z-density
    stays near-uniform; overflow is detected regardless). Halo ≈ the 2h ghost
    layer's share of a slab (sharded.py exchanges a TWO-radius layer so halo
    densities are exact without a second round); migration ≈ a few percent
    per step."""
    share = -(-cfg.num_particles // n_devices)
    rnd = lambda x: max(256, -(-int(x) // 256) * 256)
    dev_cap = rnd(share * slack)
    halo = min(
        rnd(max(share * 2 * cfg.h / (cfg.box_dim / n_devices), 256) * slack),
        dev_cap,
    )
    mig = min(rnd(max(share * 0.05, 128)), dev_cap // 2)
    return DistConfig(
        n_devices=n_devices,
        dev_capacity=dev_cap,
        halo_capacity=halo,
        migration_capacity=mig,
    )


def default_mesh3d_config(cfg: SimConfig, mesh_shape: tuple[int, int, int],
                          slack: float = 2.0):
    """Capacity heuristics for the 3-D brick mesh: per-axis halo scales with
    the brick's face shell (the 2h ghost layer's share along that axis,
    doubled again for the forwarded rows earlier phases contribute);
    migration a few percent per axis per step."""
    from sphjax.dist.mesh3d import Mesh3DConfig

    n_dev = int(np.prod(mesh_shape))
    share = -(-cfg.num_particles // n_dev)
    rnd = lambda x: max(256, -(-int(x) // 256) * 256)
    dev_cap = rnd(share * slack)
    halos = []
    migs = []
    for m in mesh_shape:
        width = cfg.box_dim / m
        halos.append(
            min(rnd(max(share * 4 * cfg.h / width, 256) * slack), dev_cap)
        )
        migs.append(min(rnd(max(share * 0.05, 128)), dev_cap // 2))
    return Mesh3DConfig(
        mesh_shape=tuple(mesh_shape),
        dev_capacity=dev_cap,
        halo_capacity=tuple(halos),
        migration_capacity=tuple(migs),
    )


class DistSimulator:
    """Drop-in multi-device variant of engine.Simulator, including free-mode
    click impulses (simulate(click=(px, py)) kicks velocities exactly like the
    single-chip engine, reference simulator.cu:329-367,482-489).

    mesh_shape=None (default) shards 1-D z-slabs over all devices;
    mesh_shape=(mz, my, mx) shards a 3-D brick mesh (dist/mesh3d.py).
    Both run the per-device pair passes of `backend` ("auto": the
    platform's production backend, engine.step.choose_backend)."""

    def __init__(
        self,
        cfg: SimConfig,
        devices=None,
        dcfg: DistConfig | None = None,
        random_init: bool = False,
        seed: int = 0,
        mesh_shape: tuple[int, int, int] | None = None,
        balance: bool = True,
        backend: str = "auto",
    ):
        cfg.validate()
        self.cfg = cfg
        # balance-aware partition: setup() re-partitions along the measured
        # initial occupancy (sharded.balanced_slab_planes for the 1-D mesh,
        # mesh3d.balanced_brick_planes per axis for 3-D bricks) unless the
        # caller pinned explicit planes or opted out
        self.balance = balance
        devices = devices if devices is not None else jax.devices()
        self.random_init = random_init
        self.seed = seed
        self.state: DistState | None = None
        self.last_aux = None
        self._timed = None  # lazy (build_fn, update_fn) for simulate_and_time
        self._runners: dict[int, object] = {}  # run(k) jit cache
        self.backend = choose_backend() if backend == "auto" else backend
        self.mesh_shape = mesh_shape
        if mesh_shape is None:
            self.dcfg = dcfg or default_dist_config(cfg, len(devices))
            self.mesh = Mesh(
                np.asarray(devices[: self.dcfg.n_devices]), (self.dcfg.axis_name,)
            )
            self._step = make_sharded_step(
                cfg, self.dcfg, self.mesh, backend=self.backend
            )
        else:
            from sphjax.dist.mesh3d import make_mesh, make_mesh3d_step

            assert dcfg is None, "pass capacities via default_mesh3d_config"
            n_dev = int(np.prod(mesh_shape))
            assert len(devices) >= n_dev, (
                f"mesh {mesh_shape} needs {n_dev} devices, have {len(devices)}"
            )
            self.mesh = make_mesh(devices[:n_dev], tuple(mesh_shape))
            self.dcfg = default_mesh3d_config(cfg, tuple(mesh_shape))
            self._step = make_mesh3d_step(
                cfg, self.dcfg, self.mesh, backend=self.backend
            )

    def setup(self, state: FluidState | None = None) -> None:
        """Distribute initial (or checkpoint-restored) state onto the mesh.
        If the initial distribution is more clustered than the uniform-share
        capacity heuristic assumed (e.g. the grid-init lattice fills one
        corner of the box, reference simulator.cu:438-453), dev_capacity is
        grown up-front to fit the measured per-device occupancy — the same
        measure-don't-guess policy as right_size, applied at t=0."""
        host_state = (
            state
            if state is not None
            else init_state(self.cfg, self.random_init, self.seed)
        )
        if self.balance:
            pos = np.asarray(host_state.position)[
                np.asarray(host_state.valid)
            ]
            if (
                self.mesh_shape is None
                and self.dcfg.slab_planes is None
                and self.dcfg.n_devices > 1
            ):
                from sphjax.dist.sharded import balanced_slab_planes

                planes = balanced_slab_planes(
                    pos[:, 2], self.cfg, self.dcfg.n_devices
                )
                self.dcfg = dataclasses.replace(
                    self.dcfg, slab_planes=planes
                )
                self._rebuild_step()
            elif (
                self.mesh_shape is not None
                and self.dcfg.axis_planes is None
                and int(np.prod(self.mesh_shape)) > 1
            ):
                from sphjax.dist.mesh3d import balanced_brick_planes

                planes = balanced_brick_planes(
                    pos, self.cfg, self.mesh_shape
                )
                self.dcfg = dataclasses.replace(
                    self.dcfg, axis_planes=planes
                )
                self._rebuild_step()
        self._fit_initial_capacity(host_state)
        if self.mesh_shape is None:
            self.state = distribute_state(
                host_state, self.cfg, self.dcfg, self.mesh
            )
        else:
            from sphjax.dist.mesh3d import distribute_state_3d

            self.state = distribute_state_3d(
                host_state, self.cfg, self.dcfg, self.mesh
            )

    def _rebuild_step(self) -> None:
        """Re-jit the step after a dcfg change (capacity growth, re-slab)."""
        self._timed = None
        self._runners.clear()
        if self.mesh_shape is None:
            self._step = make_sharded_step(
                self.cfg, self.dcfg, self.mesh, backend=self.backend
            )
        else:
            from sphjax.dist.mesh3d import make_mesh3d_step

            self._step = make_mesh3d_step(
                self.cfg, self.dcfg, self.mesh, backend=self.backend
            )

    def _fit_initial_capacity(self, host_state: FluidState) -> None:
        """Grow dev_capacity (×2 steps) until the host state's most-loaded
        device fits, rebuilding the step on change. Host-side arithmetic
        only — mirrors distribute_state's owner assignment."""
        pos = np.asarray(host_state.position)
        valid = np.asarray(host_state.valid)
        if self.mesh_shape is None:
            from sphjax.dist.sharded import slab_owner

            owner = slab_owner(pos[:, 2], self.cfg, self.dcfg)[valid]
            n_dev = self.dcfg.n_devices
        else:
            from sphjax.dist.mesh3d import brick_owner

            owner = brick_owner(pos, self.cfg, self.dcfg)[valid]
            n_dev = int(np.prod(self.mesh_shape))
        peak = int(np.bincount(owner, minlength=n_dev).max())
        cap = self.dcfg.dev_capacity
        if peak <= cap:
            return
        while cap < peak:
            cap *= 2
        self.dcfg = dataclasses.replace(self.dcfg, dev_capacity=cap)
        self._rebuild_step()

    def simulate(self, click: tuple[int, int] | None = None) -> None:
        assert self.state is not None, "call setup() first"
        from sphjax.interact.impulse import click_in_box

        active = click is not None and click_in_box(*click)
        click_px = np.asarray(click if active else (0, 0), np.int32)
        for _ in range(8):
            new_state, aux = self._step(
                self.state, click_px, np.asarray(active)
            )
            aux_host = jax.device_get(aux)
            if (
                int(aux_host.halo_overflow) == 0
                and int(aux_host.migration_overflow) == 0
                and int(aux_host.window_overflow) == 0
            ):
                break
            self._grow(aux_host)
        else:
            raise RuntimeError("dist capacity growth failed to converge")
        if int(aux_host.misrouted) > 0:
            # One-hop migration invariant: a particle may cross at most one
            # slab face per step. Unreachable under the physics (crossing two
            # slabs in one dt needs |v_z| > slab_width/dt = 125 at 8 devices;
            # the impulse kicks are ≤ ~10), so a trip here means state
            # corruption, not a tunable — fail loudly rather than let the
            # particle do wrong-slab physics.
            raise RuntimeError(
                f"{int(aux_host.misrouted)} particle(s) crossed more than one "
                "slab in a single step — one-hop migration invariant violated"
            )
        self.state = new_state
        self.last_aux = aux_host

    def _grow(self, aux) -> None:
        d = self.dcfg

        def dbl(v):
            return tuple(x * 2 for x in v) if isinstance(v, tuple) else v * 2

        if int(aux.halo_overflow) > 0:
            d = dataclasses.replace(d, halo_capacity=dbl(d.halo_capacity))
        if int(aux.migration_overflow) > 0:
            d = dataclasses.replace(
                d,
                migration_capacity=dbl(d.migration_capacity),
                dev_capacity=d.dev_capacity * 2,
            )
        if int(aux.window_overflow) > 0:
            self.cfg = dataclasses.replace(
                self.cfg, tile_cand_capacity=self.cfg.tile_cand_capacity * 2
            )
        self.dcfg = d
        # capacities changed: re-trace the timed phases + runners
        self._rebuild_step()

    def run(
        self,
        steps: int,
        chunk: int | None = None,
        rebalance_above: float | None = None,
    ) -> None:
        """Production loop: scan-chained sharded steps, ONE dispatch per
        `chunk` steps (default: all of them), aux checked once per chunk on
        host instead of every step (the multi-chip analog of the bench's
        single-chip lax.scan chain; replaces simulate()'s per-step
        device_get sync). On capacity overflow the chunk is re-run from its
        initial state with doubled capacities, so the physics that lands in
        self.state is never degraded. Works on both the 1-D slab mesh
        and the 3-D brick mesh.

        rebalance_above: if set (e.g. 1.15), check the aux occupancy census
        after each chunk and re-partition (rebalance()) when the measured
        load imbalance λ = max_dev_particles / (N / n_dev) exceeds it —
        dynamic load balancing at chunk granularity."""
        assert self.state is not None, "call setup() first"
        if self.mesh_shape is None:
            from sphjax.dist.sharded import make_sharded_run as make_run
        else:
            from sphjax.dist.mesh3d import make_mesh3d_run as make_run

        chunk = steps if chunk is None else max(1, chunk)
        done = 0
        # runner cache lives on the instance: a repeated run(k) must reuse
        # the jitted callable (re-tracing a 100-step scan chain costs
        # seconds). _grow invalidates it.
        runners = self._runners
        while done < steps:
            k = min(chunk, steps - done)
            for _ in range(8):
                if k not in runners:
                    runners[k] = make_run(
                        self.cfg, self.dcfg, self.mesh,
                        steps=k, backend=self.backend,
                    )
                new_state, aux = runners[k](self.state)
                aux_host = jax.device_get(aux)
                if (
                    int(aux_host.halo_overflow) == 0
                    and int(aux_host.migration_overflow) == 0
                    and int(aux_host.window_overflow) == 0
                ):
                    break
                self._grow(aux_host)
                runners.clear()  # capacities changed: re-trace
            else:
                raise RuntimeError("dist capacity growth failed to converge")
            if int(aux_host.misrouted) > 0:
                raise RuntimeError(
                    f"{int(aux_host.misrouted)} particle(s) crossed more "
                    "than one slab in a single step"
                )
            if int(aux_host.num_particles) != self.cfg.num_particles:
                raise RuntimeError(
                    f"particle conservation broken: "
                    f"{int(aux_host.num_particles)} != {self.cfg.num_particles}"
                )
            self.state = new_state
            self.last_aux = aux_host
            done += k
            if rebalance_above is not None and done < steps:
                n_dev = (
                    self.dcfg.n_devices if self.mesh_shape is None
                    else int(np.prod(self.mesh_shape))
                )
                lam = (
                    int(aux_host.max_dev_particles)
                    * n_dev / self.cfg.num_particles
                )
                if lam >= rebalance_above:
                    # rebalance() rebuilds the step and clears self._runners
                    # (the same dict as `runners`) when it re-partitions
                    self.rebalance()

    def simulate_and_time(self, times: Times) -> None:
        """Per-phase timed step — the reference's three-phase protocol
        (times.h:12-36) applied to the sharded engine:
          grid construction = halo exchange + cell-key payload sort,
          SPH update       = pair passes + integrate + migration,
          data transfer    = sharded→host position collect.
        Each phase is fenced with block_until_ready. Overflow-retry
        seconds are rolled back like the single-chip engine's. Both the 1-D
        slab mesh and the 3-D brick mesh run the phase-split path."""
        assert self.state is not None
        build0, update0, memcpy0 = (
            times.build_grid, times.sph_update, times.memcpy
        )
        if self._timed is None:
            if self.mesh_shape is None:
                self._timed = make_sharded_timed(
                    self.cfg, self.dcfg, self.mesh,
                    backend=self.backend,
                )
            else:
                from sphjax.dist.mesh3d import make_mesh3d_timed

                self._timed = make_mesh3d_timed(
                    self.cfg, self.dcfg, self.mesh,
                    backend=self.backend,
                )
        build_fn, update_fn = self._timed
        cell = np.zeros((2,), np.int32)
        inactive = np.zeros((), bool)

        t0 = time.perf_counter()
        inter, halo_ovf, oob, halo_send = build_fn(self.state)
        jax.block_until_ready((inter, halo_ovf))
        t1 = time.perf_counter()
        times.build_grid += t1 - t0

        new_state, aux = update_fn(
            inter, halo_ovf, oob, halo_send, cell, inactive
        )
        jax.block_until_ready((new_state, aux))
        t2 = time.perf_counter()
        aux_host = jax.device_get(aux)
        times.sph_update += t2 - t1

        if (
            int(aux_host.halo_overflow)
            or int(aux_host.migration_overflow)
            or int(aux_host.window_overflow)
        ):
            # re-trace with doubled capacities and replay, rolling back the
            # failed attempt's seconds (a re-trace is a compilation event,
            # not a steady-state cost — same policy as the single-chip
            # Simulator.simulate_and_time)
            times.build_grid, times.sph_update, times.memcpy = (
                build0, update0, memcpy0
            )
            self._grow(aux_host)
            self.simulate_and_time(times)
            return
        if int(aux_host.misrouted) > 0:
            raise RuntimeError(
                f"{int(aux_host.misrouted)} particle(s) crossed more than "
                "one slab in a single step"
            )
        self.state = new_state
        self.last_aux = aux_host

        pos = self.get_position()
        del pos
        times.memcpy += time.perf_counter() - t2
        times.iters += 1

    def right_size(
        self,
        warmup_steps: int = 10,
        margin: float = 1.3,
        restore: bool = True,
    ) -> None:
        """Measure-then-right-size the per-device capacities (the same
        philosophy as the single-chip engine's measured capacity presets):
        run `warmup_steps` on the current slack-sized capacities, read the
        peak per-device occupancy / halo rows / migration rows from the aux
        utilization stats, and rebuild the engine with capacities at the
        measured peaks × `margin` (rounded up to 256, never grown past the
        current values). Oversized static slack costs real sort width every
        step — the default slack=2.0 pays ~25% in sentinel-row sorts vs a
        hand-tuned 1.25 — so this replaces the guess with a measurement.
        Overflow detection still guards any later under-estimate (capacity
        growth re-traces). restore=True re-distributes the pre-warmup state
        so a timed run still measures the original trajectory."""
        assert self.state is not None, "call setup() first"
        host0 = self.to_host_state() if restore else None
        self.run(warmup_steps)
        aux = self.last_aux
        rnd = lambda x: max(256, -(-int(x) // 256) * 256)
        # a 1-device mesh cannot migrate (the boundary clamp keeps every
        # position inside the only slab), so occupancy is structurally
        # static — size it exactly; any headroom is pure dead-row sort and
        # kernel-tile width
        n_dev_total = (
            self.dcfg.n_devices if self.mesh_shape is None
            else int(np.prod(self.mesh_shape))
        )
        dev_margin = 1.0 if n_dev_total == 1 else margin
        dev = min(
            rnd(int(aux.max_dev_particles) * dev_margin),
            self.dcfg.dev_capacity,
        )
        halo = rnd(max(int(aux.max_halo_send), 1) * margin)
        mig = rnd(max(int(aux.max_migration_send), 1) * margin)
        if self.mesh_shape is None:
            # replace() preserves the balance-aware slab_planes partition
            self.dcfg = dataclasses.replace(
                self.dcfg,
                dev_capacity=dev,
                halo_capacity=min(halo, self.dcfg.halo_capacity),
                migration_capacity=min(mig, self.dcfg.migration_capacity),
            )
        else:
            self.dcfg = dataclasses.replace(
                self.dcfg,
                dev_capacity=dev,
                halo_capacity=tuple(
                    min(halo, c) for c in self.dcfg.halo_capacity
                ),
                migration_capacity=tuple(
                    min(mig, c) for c in self.dcfg.migration_capacity
                ),
            )
        self._rebuild_step()
        self.setup(host0 if restore else self.to_host_state())

    def rebalance(self, min_gain: float = 0.05) -> bool:
        """Re-partition the mesh along the CURRENT occupancy. The
        balance-aware planes are computed once from the initial state
        (setup), and drift as the fluid moves. This recomputes the occupancy-
        quantile planes from the live state and redistributes iff the
        re-partition would cut the max per-device occupancy by more than
        `min_gain` (relative). Pure re-assignment — the physics trajectory
        is unchanged (tested). Costs a host round-trip plus a step re-trace
        (the planes are jit constants), so it is for occasional use at
        drift scale, not per step: run(rebalance_above=...) automates the
        trigger from the aux census. Returns True if re-partitioned."""
        assert self.state is not None, "call setup() first"
        n_dev = (
            self.dcfg.n_devices if self.mesh_shape is None
            else int(np.prod(self.mesh_shape))
        )
        if n_dev == 1:
            return False
        host = self.to_host_state()
        pos = np.asarray(host.position)[np.asarray(host.valid)]
        if self.mesh_shape is None:
            from sphjax.dist.sharded import balanced_slab_planes, slab_owner

            planes = balanced_slab_planes(pos[:, 2], self.cfg, n_dev)
            if planes == self.dcfg.slab_planes:
                return False
            new_dcfg = dataclasses.replace(self.dcfg, slab_planes=planes)
            owner_cur = slab_owner(pos[:, 2], self.cfg, self.dcfg)
            owner_new = slab_owner(pos[:, 2], self.cfg, new_dcfg)
        else:
            from sphjax.dist.mesh3d import balanced_brick_planes, brick_owner

            planes = balanced_brick_planes(pos, self.cfg, self.mesh_shape)
            if planes == self.dcfg.axis_planes:
                return False
            new_dcfg = dataclasses.replace(self.dcfg, axis_planes=planes)
            owner_cur = brick_owner(pos, self.cfg, self.dcfg)
            owner_new = brick_owner(pos, self.cfg, new_dcfg)
        cur = int(np.bincount(owner_cur, minlength=n_dev).max())
        new = int(np.bincount(owner_new, minlength=n_dev).max())
        if cur < (1.0 + min_gain) * new:
            return False
        self.dcfg = new_dcfg
        self._rebuild_step()
        self.setup(host)  # redistribute under the new partition
        return True

    def to_host_state(self) -> FluidState:
        """Collect the sharded state into a single-chip FluidState on host —
        the shared checkpoint surface (CLI --save writes ONE format for both
        engines; core/io.save_state embeds the SimConfig)."""
        assert self.state is not None, "call setup() first"
        import jax.numpy as jnp

        got = collect_state(self.state, self.cfg.num_particles)
        if np.isnan(got["position"]).any():
            raise RuntimeError(
                "checkpoint collect incomplete: particle ids missing "
                "(conservation broken)"
            )
        n = self.cfg.num_particles
        npad = self.cfg.padded_num_particles

        def pad(a):
            out = np.zeros((npad,) + a.shape[1:], a.dtype)
            out[:n] = a
            return out

        return FluidState(
            position=jnp.asarray(pad(got["position"])),
            velocity=jnp.asarray(pad(got["velocity"])),
            force=jnp.zeros((npad, 3), jnp.float32),
            density=jnp.ones((npad,), jnp.float32),
            pressure=jnp.zeros((npad,), jnp.float32),
            valid=jnp.asarray(np.arange(npad) < n),
        )

    def get_position(self) -> np.ndarray:
        assert self.state is not None
        return collect_state(self.state, self.cfg.num_particles)["position"]

    def num_particles_alive(self) -> int:
        assert self.last_aux is not None, "step first"
        return int(self.last_aux.num_particles)
