"""DistSimulator front-end tests (8 virtual CPU devices)."""

import numpy as np
import pytest

from sphjax.bench.times import Times
from sphjax.core.config import default_config
from sphjax.dist.simulator import DistSimulator
from sphjax.engine.simulator import Simulator

pytestmark = pytest.mark.slow


def test_dist_simulator_matches_single(eight_devices):
    cfg = default_config(512, chunk_size=512)
    dsim = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21)
    dsim.setup()
    sim = Simulator(cfg, backend="cell_list", random_init=True, seed=21)
    sim.setup()
    for _ in range(5):
        dsim.simulate()
        sim.simulate()
    assert dsim.num_particles_alive() == cfg.num_particles
    np.testing.assert_allclose(
        dsim.get_position(), sim.get_position(), rtol=1e-4, atol=1e-4
    )


def test_dist_simulate_and_time(eight_devices):
    """The sharded timed path decomposes into the reference's three phases
    (grid construction / SPH update / data transfer, times.h:12-36) AND
    advances the same physics as the fused simulate() step."""
    cfg = default_config(512, chunk_size=512)
    dsim = DistSimulator(cfg, devices=eight_devices[:4], random_init=True,
                         seed=7)
    dsim.setup()
    ref = DistSimulator(cfg, devices=eight_devices[:4], random_init=True,
                        seed=7)
    ref.setup()
    times = Times()
    for _ in range(3):
        dsim.simulate_and_time(times)
        ref.simulate()
    assert times.iters == 3
    assert times.build_grid > 0  # halo exchange + payload sort, fenced
    assert times.sph_update > 0  # kernels + integrate + migrate, fenced
    assert times.memcpy > 0  # sharded→host position collect
    np.testing.assert_allclose(
        dsim.get_position(), ref.get_position(), rtol=0, atol=1e-6
    )


def test_dist_capacity_growth(eight_devices):
    from sphjax.dist.sharded import DistConfig

    cfg = default_config(512, chunk_size=512)
    tiny = DistConfig(
        n_devices=8, dev_capacity=512, halo_capacity=8, migration_capacity=64
    )
    dsim = DistSimulator(cfg, devices=eight_devices, dcfg=tiny, random_init=True, seed=2)
    dsim.setup()
    dsim.simulate()  # must transparently grow the halo buffers
    assert dsim.dcfg.halo_capacity > 8
    assert dsim.num_particles_alive() == cfg.num_particles


def test_dist_run_matches_stepwise(eight_devices):
    """The scan-chained production loop (one dispatch per chunk) must equal
    the per-step dispatch path exactly — same per-device programs, no
    host-sync-dependent behavior."""
    cfg = default_config(512, chunk_size=512)
    a = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21)
    a.setup()
    b = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21)
    b.setup()
    a.run(4, chunk=2)  # two chained dispatches
    for _ in range(4):
        b.simulate()
    assert a.num_particles_alive() == cfg.num_particles
    np.testing.assert_allclose(
        a.get_position(), b.get_position(), rtol=0, atol=1e-6
    )


def test_dist_run_capacity_growth(eight_devices):
    """Overflow inside a scan chunk must re-run the chunk from its initial
    state with grown capacities (physics never degraded)."""
    from sphjax.dist.sharded import DistConfig

    cfg = default_config(512, chunk_size=512)
    tiny = DistConfig(
        n_devices=8, dev_capacity=512, halo_capacity=8, migration_capacity=64
    )
    a = DistSimulator(cfg, devices=eight_devices, dcfg=tiny,
                      random_init=True, seed=2)
    a.setup()
    a.run(3)
    assert a.dcfg.halo_capacity > 8
    b = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=2)
    b.setup()
    b.run(3)
    np.testing.assert_allclose(
        a.get_position(), b.get_position(), rtol=0, atol=1e-6
    )


def test_dist_checkpoint_roundtrip(eight_devices):
    """DistState save → load onto a DIFFERENT mesh shape → resumed
    trajectory equals the uninterrupted one."""
    from jax.sharding import Mesh

    from sphjax.core.io import load_dist_state, save_dist_state
    from sphjax.dist.sharded import make_sharded_run

    import numpy as _np

    cfg = default_config(512, chunk_size=512)
    sim = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=13)
    sim.setup()
    sim.run(2)
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dist.npz")
        save_dist_state(path, sim.state, sim.cfg, sim.dcfg)
        # restore onto a 4-device mesh (different shape → re-distribution)
        mesh4 = Mesh(_np.array(eight_devices[:4]), ("z",))
        dstate, cfg2, dcfg2 = load_dist_state(path, mesh4)
        assert cfg2 == sim.cfg and dcfg2.n_devices == 4
        run4 = make_sharded_run(cfg2, dcfg2, mesh4, steps=2)
        resumed, aux = run4(dstate)
        assert int(aux.num_particles) == cfg.num_particles

    sim.run(2)  # uninterrupted continuation
    from sphjax.dist.sharded import collect_state

    got = collect_state(resumed, cfg.num_particles)["position"]
    np.testing.assert_allclose(
        got, sim.get_position(), rtol=1e-5, atol=1e-5
    )


def test_dist_run_mesh3d_matches_stepwise(eight_devices):
    """run() on the 3-D brick mesh equals its per-step dispatch path."""
    cfg = default_config(512, chunk_size=512)
    a = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21,
                      mesh_shape=(2, 2, 2))
    a.setup()
    b = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21,
                      mesh_shape=(2, 2, 2))
    b.setup()
    a.run(3)
    for _ in range(3):
        b.simulate()
    np.testing.assert_allclose(
        a.get_position(), b.get_position(), rtol=0, atol=1e-6
    )


def test_dist_mesh3d_simulate_and_time(eight_devices):
    """The 3-D brick mesh timed path reports the reference's three phases
    (times.h:12-36) separately — build (staged halo + sort), update
    (kernels + migrate), memcpy — and advances the same physics as the
    fused simulate() step (verdict-r4 #5)."""
    cfg = default_config(512, chunk_size=512)
    dsim = DistSimulator(cfg, devices=eight_devices, random_init=True,
                         seed=7, mesh_shape=(2, 2, 2))
    dsim.setup()
    ref = DistSimulator(cfg, devices=eight_devices, random_init=True,
                        seed=7, mesh_shape=(2, 2, 2))
    ref.setup()
    times = Times()
    for _ in range(3):
        dsim.simulate_and_time(times)
        ref.simulate()
    assert times.iters == 3
    assert times.build_grid > 0
    assert times.sph_update > 0
    assert times.memcpy > 0
    np.testing.assert_allclose(
        dsim.get_position(), ref.get_position(), rtol=0, atol=1e-6
    )


def test_dist_right_size(eight_devices):
    """right_size must shrink the default slack=2.0 capacities toward the
    measured peaks (the aux utilization stats) and, with restore=True,
    leave the trajectory identical to a never-resized run."""
    cfg = default_config(512, chunk_size=512)
    a = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21)
    a.setup()
    cap0 = a.dcfg.dev_capacity
    halo0 = a.dcfg.halo_capacity
    a.right_size(warmup_steps=5)
    assert a.dcfg.dev_capacity <= cap0
    assert a.dcfg.halo_capacity <= halo0
    assert a.dcfg.dev_capacity >= 256
    a.run(5)
    assert a.num_particles_alive() == cfg.num_particles

    b = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21)
    b.setup()
    b.run(5)
    np.testing.assert_allclose(
        a.get_position(), b.get_position(), rtol=1e-6, atol=1e-6
    )


def test_dist_balance_default(eight_devices):
    """DistSimulator.setup applies the balance-aware cell-aligned partition
    by default (slab_planes set from the initial z occupancy), preserves it
    through right_size, and balance=False keeps the legacy equal-width
    slabs. Physics parity under balance is covered by
    test_dist_simulator_matches_single (balance is the default there)."""
    cfg = default_config(512, chunk_size=512)
    a = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21)
    a.setup()
    planes = a.dcfg.slab_planes
    assert planes is not None and len(planes) == 9
    assert planes[0] == 0 and planes[-1] == cfg.num_cells_per_dim
    a.right_size(warmup_steps=3)
    assert a.dcfg.slab_planes == planes  # re-size must not drop the partition
    a.run(3)
    assert a.num_particles_alive() == cfg.num_particles

    b = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21,
                      balance=False)
    b.setup()
    assert b.dcfg.slab_planes is None

    # 3-D brick mesh: per-axis planes applied by default too
    c = DistSimulator(cfg, devices=eight_devices, random_init=True, seed=21,
                      mesh_shape=(2, 2, 2))
    c.setup()
    assert c.dcfg.axis_planes is not None
    assert all(len(p) == 3 for p in c.dcfg.axis_planes)
    c.run(3)
    assert c.num_particles_alive() == cfg.num_particles


def test_dist_simulator_mesh3d(eight_devices):
    """DistSimulator with a 3-D brick mesh matches the single-chip engine."""
    cfg = default_config(512, chunk_size=512)
    dsim = DistSimulator(
        cfg, devices=eight_devices, random_init=True, seed=21,
        mesh_shape=(2, 2, 2),
    )
    dsim.setup()
    sim = Simulator(cfg, backend="cell_list", random_init=True, seed=21)
    sim.setup()
    for _ in range(5):
        dsim.simulate()
        sim.simulate()
    assert dsim.num_particles_alive() == cfg.num_particles
    np.testing.assert_allclose(
        dsim.get_position(), sim.get_position(), rtol=1e-4, atol=1e-4
    )


def test_dist_rebalance(eight_devices):
    """Dynamic re-partitioning (rebalance): after the fluid drifts away
    from the setup-time occupancy profile, rebalance() must re-slab along
    the live occupancy (planes change, max occupancy never worse) WITHOUT
    perturbing the physics trajectory, and run(rebalance_above=...) must
    auto-trigger it from the aux census."""
    import numpy as np_
    cfg = default_config(512, chunk_size=512)

    def make(seed=3):
        s = DistSimulator(cfg, devices=eight_devices[:4], random_init=True,
                          seed=seed)
        s.setup()
        # uniform +z drift piles occupancy against the far wall over time,
        # going stale against the setup-time planes
        import jax.numpy as jnp
        vel = np_.zeros((s.to_host_state().num_slots, 3), np_.float32)
        vel[:, 2] = 3.0
        host = s.to_host_state()._replace(velocity=jnp.asarray(vel))
        s.setup(host)
        return s

    a = make()
    b = make()
    a.run(8, chunk=4)
    b.run(8, chunk=4)
    planes0 = a.dcfg.slab_planes
    did = a.rebalance(min_gain=0.0)
    if did:
        assert a.dcfg.slab_planes != planes0
    # physics identical to the never-rebalanced twin
    a.run(6, chunk=3)
    b.run(6, chunk=3)
    assert a.num_particles_alive() == cfg.num_particles
    np_.testing.assert_allclose(
        a.get_position(), b.get_position(), rtol=1e-5, atol=1e-5
    )

    # auto-trigger path: any measured imbalance above 1.0 fires the check;
    # b has advanced 8 + 6 = 14 steps by now — match it
    c = make()
    c.run(14, chunk=2, rebalance_above=1.0)
    assert c.num_particles_alive() == cfg.num_particles
    np_.testing.assert_allclose(
        c.get_position(), b.get_position(), rtol=1e-5, atol=1e-5
    )
