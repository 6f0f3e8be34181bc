"""3-D brick-mesh sharding tests (2×2×2 over 8 virtual CPU devices): staged
z/y/x halo exchange + per-axis migration must match the single-device engine,
conserve particles, and route diagonal brick-corner crossers."""

import jax
import numpy as np
import pytest

from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.dist.mesh3d import (
    Mesh3DConfig,
    distribute_state_3d,
    make_mesh,
    make_mesh3d_step,
)
from sphjax.dist.sharded import collect_state
from sphjax.engine.step import make_step

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def setup():
    cfg = default_config(512, chunk_size=512)
    st = init_state(cfg, random_init=True, seed=13)
    return cfg, st


def _mcfg(shape=(2, 2, 2)):
    return Mesh3DConfig(
        mesh_shape=shape,
        dev_capacity=512,
        halo_capacity=(256, 256, 256),
        migration_capacity=(128, 128, 128),
    )


def _run(cfg, st, devs, shape, steps, click=None):
    mcfg = _mcfg(shape)
    mesh = make_mesh(devs[: int(np.prod(shape))], shape)
    dstate = distribute_state_3d(st, cfg, mcfg, mesh)
    step = make_mesh3d_step(cfg, mcfg, mesh)
    aux = None
    for i in range(steps):
        if click is not None and i == 0:
            dstate, aux = step(dstate, np.asarray(click, np.int32), np.asarray(True))
        else:
            dstate, aux = step(dstate)
    return dstate, aux


def test_mesh3d_matches_single_device(setup, eight_devices):
    cfg, st = setup
    steps = 10
    s = st
    single = make_step(cfg, "cell_list")
    for _ in range(steps):
        s, _ = single(s)

    for shape in ((2, 2, 2), (1, 2, 4), (8, 1, 1)):
        dstate, aux = _run(cfg, st, eight_devices, shape, steps)
        assert int(aux.halo_overflow) == 0, shape
        assert int(aux.migration_overflow) == 0, shape
        assert int(aux.window_overflow) == 0, shape
        assert int(aux.misrouted) == 0, shape
        assert int(aux.num_particles) == cfg.num_particles, shape
        got = collect_state(dstate, cfg.num_particles)
        assert not np.isnan(got["position"]).any(), shape
        np.testing.assert_allclose(
            got["position"], np.asarray(s.position)[: cfg.num_particles],
            rtol=1e-4, atol=1e-4, err_msg=f"mesh {shape}",
        )
        np.testing.assert_allclose(
            got["velocity"], np.asarray(s.velocity)[: cfg.num_particles],
            rtol=1e-3, atol=1e-3, err_msg=f"mesh {shape}",
        )


def test_mesh3d_diagonal_migration(setup, eight_devices):
    """Particles with velocity along all three axes must cross brick corners
    (one hop per axis within a step) and still land on the right owner with
    exact physics."""
    cfg, st = setup
    vel = np.zeros((st.num_slots, 3), np.float32)
    vel[:] = np.where(
        (np.arange(st.num_slots) % 2 == 0)[:, None],
        np.asarray([2.5, 2.5, 2.5], np.float32),
        np.asarray([-2.5, -2.5, -2.5], np.float32),
    )
    st = st._replace(velocity=np.asarray(vel))

    dstate, aux = _run(cfg, st, eight_devices, (2, 2, 2), 15)
    assert int(aux.num_particles) == cfg.num_particles
    assert int(aux.misrouted) == 0

    # pids must have moved between device blocks
    pid = np.asarray(jax.device_get(dstate.pid)).reshape(8, -1)
    valid = np.asarray(jax.device_get(dstate.valid)).reshape(8, -1)

    s = st
    single = make_step(cfg, "cell_list")
    for _ in range(15):
        s, _ = single(s)
    got = collect_state(dstate, cfg.num_particles)
    np.testing.assert_allclose(
        got["position"], np.asarray(s.position)[: cfg.num_particles],
        rtol=1e-4, atol=1e-4,
    )
    # every device should own someone (fluid spans the box initially)
    assert (valid.sum(axis=1) > 0).all()


def test_mesh3d_click_matches_single_chip(setup, eight_devices):
    cfg, st = setup
    click = (400, 300)
    single = make_step(cfg, "cell_list")
    s1, _ = single(st)
    from sphjax.interact.impulse import apply_click_impulse

    s1 = apply_click_impulse(s1, st.position, np.asarray(click, np.int32), cfg)
    dstate, _ = _run(cfg, st, eight_devices, (2, 2, 2), 1, click=click)
    got = collect_state(dstate, cfg.num_particles)
    np.testing.assert_allclose(
        got["velocity"], np.asarray(s1.velocity)[: cfg.num_particles],
        rtol=1e-4, atol=1e-4,
    )


def test_mesh3d_halo_overflow_detected(eight_devices):
    # grid init packs a dense 0.09-spaced sheet → tiny halo caps must trip
    cfg = default_config(4096, chunk_size=4096)
    st = init_state(cfg)
    mcfg = Mesh3DConfig(
        mesh_shape=(2, 2, 2), dev_capacity=4096,
        halo_capacity=(8, 8, 8), migration_capacity=(128, 128, 128),
    )
    mesh = make_mesh(eight_devices[:8], (2, 2, 2))
    dstate = distribute_state_3d(st, cfg, mcfg, mesh)
    step = make_mesh3d_step(cfg, mcfg, mesh)
    total = 0
    for _ in range(5):
        dstate, aux = step(dstate)
        total += int(aux.halo_overflow)
    assert total > 0


def test_mesh3d_balanced_planes_match_single_device(setup, eight_devices):
    """Explicit per-axis balance-aware brick planes (Mesh3DConfig.axis_planes
    — cell-space halo bands, ownership and migration predicates) must
    advance identical physics to the single-chip engine, with migration
    traffic crossing the plane faces on every axis."""
    cfg, st = setup
    from sphjax.dist.mesh3d import balanced_brick_planes, brick_owner

    # diagonal drift so all three axes see real migration + halo traffic
    vel = np.zeros((st.num_slots, 3), np.float32)
    vel[:] = np.where(
        (np.arange(st.num_slots) % 2 == 0)[:, None],
        np.asarray([2.5, 2.5, 2.5], np.float32),
        np.asarray([-2.5, -2.5, -2.5], np.float32),
    )
    st = st._replace(velocity=np.asarray(vel))

    pos = np.asarray(st.position)[np.asarray(st.valid)]
    shape = (2, 2, 2)
    planes = balanced_brick_planes(pos, cfg, shape)
    assert len(planes) == 3 and all(len(p) == 3 for p in planes)
    mcfg = Mesh3DConfig(
        mesh_shape=shape,
        dev_capacity=512,
        halo_capacity=(256, 256, 256),
        migration_capacity=(128, 128, 128),
        axis_planes=planes,
    )
    # host owner map must respect the planes (mirrors the device predicate)
    owner0 = brick_owner(pos, cfg, mcfg)
    assert owner0.min() >= 0 and owner0.max() < 8

    steps = 15
    mesh = make_mesh(eight_devices[:8], shape)
    dstate = distribute_state_3d(st, cfg, mcfg, mesh)
    step = make_mesh3d_step(cfg, mcfg, mesh)
    aux = None
    for _ in range(steps):
        dstate, aux = step(dstate)
    assert int(aux.halo_overflow) == 0
    assert int(aux.migration_overflow) == 0
    assert int(aux.misrouted) == 0
    assert int(aux.num_particles) == cfg.num_particles

    s = st
    single = make_step(cfg, "cell_list")
    for _ in range(steps):
        s, _ = single(s)
    got = collect_state(dstate, cfg.num_particles)
    np.testing.assert_allclose(
        got["position"], np.asarray(s.position)[: cfg.num_particles],
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        got["velocity"], np.asarray(s.velocity)[: cfg.num_particles],
        rtol=1e-3, atol=1e-3,
    )
