"""Fast sharded-engine checks on 2 virtual CPU devices (the full dist suite
in test_dist.py / test_dist_simulator.py / test_mesh3d.py is `slow`)."""

import numpy as np
from jax.sharding import Mesh

from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.dist.sharded import (
    DistConfig,
    collect_state,
    distribute_state,
    make_sharded_step,
)
from sphjax.dist.simulator import DistSimulator
from sphjax.engine.step import make_step


def _cfg_state():
    cfg = default_config(512, chunk_size=512)
    return cfg, init_state(cfg, random_init=True, seed=13)


def test_slab_dist_simulator_matches_cell_list(eight_devices):
    """DistSimulator with 1-D z-slabs on 2 devices advances the same
    per-particle trajectory as the single-device cell_list step."""
    cfg, st = _cfg_state()
    sim = DistSimulator(cfg, devices=eight_devices[:2])
    assert sim.backend == "cell_list"
    assert sim.mesh.devices.shape == (2,)
    sim.setup(st)
    sim.run(3)
    assert sim.num_particles_alive() == cfg.num_particles

    step = make_step(cfg, "cell_list")
    s = st
    for _ in range(3):
        s, _ = step(s)
    np.testing.assert_allclose(
        sim.get_position(), np.asarray(s.position)[: cfg.num_particles],
        rtol=0, atol=1e-4,
    )


def test_sharded_triton_kernels_match_xla(eight_devices):
    """The Triton pair-pass backend (interpret mode) inside shard_map on 2
    devices matches the sharded XLA step."""
    cfg, st = _cfg_state()
    mesh = Mesh(np.array(eight_devices[:2]), ("z",))
    dcfg = DistConfig(n_devices=2, dev_capacity=512, halo_capacity=256,
                      migration_capacity=128)
    dstate = distribute_state(st, cfg, dcfg, mesh)
    a, _ = make_sharded_step(cfg, dcfg, mesh)(dstate)
    b, aux = make_sharded_step(cfg, dcfg, mesh, backend="pallas_triton",
                               interpret=True)(dstate)
    assert int(aux.window_overflow) == 0
    ga = collect_state(a, cfg.num_particles)
    gb = collect_state(b, cfg.num_particles)
    np.testing.assert_allclose(gb["position"], ga["position"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gb["velocity"], ga["velocity"], rtol=1e-5,
                               atol=1e-5)
