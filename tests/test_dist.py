"""Multi-device sharded engine tests on an 8-way virtual CPU mesh
(SURVEY.md §4e): the slab-sharded halo-exchange path must match the
single-device engine to float tolerance, conserve particles, and detect
capacity overflow instead of dropping particles."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.dist.sharded import (
    DistConfig,
    collect_state,
    distribute_state,
    make_sharded_step,
)
from sphjax.engine.step import make_step


pytestmark = pytest.mark.slow


def _mesh(devs, n, axis="z"):
    return Mesh(np.array(devs[:n]), (axis,))


@pytest.fixture(scope="module")
def setup(request):
    cfg = default_config(512, chunk_size=512)
    st = init_state(cfg, random_init=True, seed=13)
    return cfg, st


def _run_dist(cfg, st, devs, n_dev, steps):
    mesh = _mesh(devs, n_dev)
    dcfg = DistConfig(
        n_devices=n_dev, dev_capacity=512, halo_capacity=256, migration_capacity=128
    )
    dstate = distribute_state(st, cfg, dcfg, mesh)
    step = make_sharded_step(cfg, dcfg, mesh)
    aux = None
    for _ in range(steps):
        dstate, aux = step(dstate)
    return dstate, aux


def test_sharded_matches_single_device(setup, eight_devices):
    cfg, st = setup
    steps = 10

    s = st
    single = make_step(cfg, "cell_list")
    for _ in range(steps):
        s, _ = single(s)
    ref_pos = np.asarray(s.position)[: cfg.num_particles]
    ref_vel = np.asarray(s.velocity)[: cfg.num_particles]

    # 1: degenerate mesh (halo + migration elided — structurally absent);
    # 2: cell-aligned splice path (C % D == 0, no comb merge sort);
    # 8: general path (100 % 8 ≠ 0 → full-width merge sort)
    for n_dev in (1, 2, 8):
        dstate, aux = _run_dist(cfg, st, eight_devices, n_dev, steps)
        assert int(aux.halo_overflow) == 0
        assert int(aux.migration_overflow) == 0
        assert int(aux.window_overflow) == 0
        assert int(aux.misrouted) == 0
        got = collect_state(dstate, cfg.num_particles)
        assert not np.isnan(got["position"]).any()  # every particle accounted for
        np.testing.assert_allclose(got["position"], ref_pos, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["velocity"], ref_vel, rtol=1e-3, atol=1e-3)


def test_particle_conservation(setup, eight_devices):
    cfg, st = setup
    dstate, aux = _run_dist(cfg, st, eight_devices, 8, 20)
    assert int(aux.num_particles) == cfg.num_particles


def test_migration_happens(setup, eight_devices):
    """Across 20 steps of a falling splash some particles must cross slabs —
    verify pids move between device blocks."""
    cfg, st = setup
    # dispersed particles have zero pressure (ρ ≪ ρ₀) → give them z drift
    vel = np.zeros((st.num_slots, 3), np.float32)
    vel[:, 2] = np.where(np.arange(st.num_slots) % 2 == 0, 3.0, -3.0)
    st = st._replace(velocity=np.asarray(vel))
    mesh = _mesh(eight_devices, 8)
    dcfg = DistConfig(
        n_devices=8, dev_capacity=512, halo_capacity=256, migration_capacity=128
    )
    dstate = distribute_state(st, cfg, dcfg, mesh)
    pid0 = np.asarray(jax.device_get(dstate.pid)).reshape(8, -1)
    step = make_sharded_step(cfg, dcfg, mesh)
    for _ in range(20):
        dstate, _ = step(dstate)
    pid1 = np.asarray(jax.device_get(dstate.pid)).reshape(8, -1)
    valid1 = np.asarray(jax.device_get(dstate.valid)).reshape(8, -1)
    moved = 0
    home0 = {int(p): d for d in range(8) for p in pid0[d] if p >= 0}
    for d in range(8):
        for p in pid1[d][valid1[d]]:
            if home0[int(p)] != d:
                moved += 1
    assert moved > 0

    # physics stays correct under migration: match the single-device engine
    single = make_step(cfg, "cell_list")
    s = st
    for _ in range(20):
        s, _ = single(s)
    got = collect_state(dstate, cfg.num_particles)
    np.testing.assert_allclose(
        got["position"],
        np.asarray(s.position)[: cfg.num_particles],
        rtol=1e-4,
        atol=1e-4,
    )


def test_migration_skip_matches_forced_sort(setup, eight_devices, monkeypatch):
    """On cell-aligned meshes, migration-free steps skip the category sort
    via lax.cond (dist/sharded.py §6). The skip must be bit-exact against
    the always-sort path on collected (valid) state, both with zero
    migration traffic and with real slab-crossers (where some devices take
    the sort branch and others the skip branch in the same step)."""
    cfg, st = setup

    # z drift so slab-crossers exist (as in test_migration_happens)
    vel = np.zeros((st.num_slots, 3), np.float32)
    vel[:, 2] = np.where(np.arange(st.num_slots) % 2 == 0, 3.0, -3.0)
    drifting = st._replace(velocity=np.asarray(vel))

    def run(state, n_dev, steps, force_sort):
        if force_sort:
            monkeypatch.setenv("SPHJAX_DIST_FORCE_MIGSORT", "1")
        else:
            monkeypatch.delenv("SPHJAX_DIST_FORCE_MIGSORT", raising=False)
        mesh = _mesh(eight_devices, n_dev)
        dcfg = DistConfig(
            n_devices=n_dev, dev_capacity=512, halo_capacity=256,
            migration_capacity=128,
        )
        dstate = distribute_state(state, cfg, dcfg, mesh)
        step = make_sharded_step(cfg, dcfg, mesh)
        mig_seen = 0
        for _ in range(steps):
            dstate, aux = step(dstate)
            assert int(aux.migration_overflow) == 0
            assert int(aux.misrouted) == 0
            mig_seen = max(mig_seen, int(aux.max_migration_send))
        return collect_state(dstate, cfg.num_particles), mig_seen

    # D=4 divides C → aligned splice path, both branches reachable
    for state, want_migration in ((st, False), (drifting, True)):
        a, mig_a = run(state, 4, 15, force_sort=False)
        b, mig_b = run(state, 4, 15, force_sort=True)
        assert mig_a == mig_b
        if want_migration:
            assert mig_a > 0  # the sort branch really fired
        np.testing.assert_array_equal(a["position"], b["position"])
        np.testing.assert_array_equal(a["velocity"], b["velocity"])


def test_halo_overflow_detected(setup, eight_devices):
    """A tiny halo buffer must be *reported*, not silently dropped."""
    cfg, st = setup
    mesh = _mesh(eight_devices, 8)
    dcfg = DistConfig(
        n_devices=8, dev_capacity=512, halo_capacity=8, migration_capacity=128
    )
    dstate = distribute_state(st, cfg, dcfg, mesh)
    step = make_sharded_step(cfg, dcfg, mesh)
    total = 0
    for _ in range(5):
        dstate, aux = step(dstate)
        total += int(aux.halo_overflow)
    assert total > 0


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_triton_kernels_match_xla(setup, eight_devices, n_dev):
    """The Triton pair-pass backend (interpret mode on CPU) inside shard_map
    must match the XLA sharded step — on the aligned splice path (2
    devices) and the general merge path (8 devices, 100 % 8 ≠ 0)."""
    cfg, st = setup
    mesh = _mesh(eight_devices, n_dev)
    dcfg = DistConfig(
        n_devices=n_dev, dev_capacity=512, halo_capacity=256,
        migration_capacity=128,
    )
    dstate = distribute_state(st, cfg, dcfg, mesh)
    step_xla = make_sharded_step(cfg, dcfg, mesh)
    step_k = make_sharded_step(cfg, dcfg, mesh, backend="pallas_triton",
                               interpret=True)
    a, b = dstate, dstate
    for _ in range(3):
        a, _ = step_xla(a)
        b, aux_b = step_k(b)
        assert int(aux_b.window_overflow) == 0
    ga = collect_state(a, cfg.num_particles)
    gb = collect_state(b, cfg.num_particles)
    np.testing.assert_allclose(gb["position"], ga["position"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gb["velocity"], ga["velocity"], rtol=1e-5, atol=1e-5)


def test_balanced_slab_planes_properties():
    """balanced_slab_planes: valid cell-aligned partition (monotone, ≥2-cell
    gaps, spans [0, C]) whose per-slab occupancy is near-ideal even for a
    heavily skewed z snapshot where equal-width slabs are pathological."""
    from sphjax.core.config import default_config
    from sphjax.dist.sharded import balanced_slab_planes

    cfg = default_config(512, chunk_size=512)
    rng = np.random.default_rng(3)
    # 90% of particles piled into the bottom tenth of the box
    z = np.where(
        rng.uniform(size=4096) < 0.9,
        rng.uniform(0.1, 1.0, size=4096),
        rng.uniform(1.0, 9.9, size=4096),
    ).astype(np.float32)
    D = 4
    planes = balanced_slab_planes(z, cfg, D)
    C = cfg.num_cells_per_dim
    assert planes[0] == 0 and planes[-1] == C
    gaps = [b - a for a, b in zip(planes, planes[1:])]
    assert min(gaps) >= 2  # 2h ghost layer minimum

    zc = np.clip((z / np.float32(cfg.h)).astype(np.int32), 0, C - 1)
    occ = [
        int(np.sum((zc >= planes[d]) & (zc < planes[d + 1])))
        for d in range(D)
    ]
    ideal = len(z) / D
    # balance is cell-granular: a slab edge moves in whole cell planes, so
    # the quantile overshoot is bounded by one cell's occupancy
    cell_max = int(np.bincount(zc, minlength=C).max())
    assert max(occ) <= ideal + cell_max, occ
    eq_occ = np.bincount(np.clip(zc // (C // D), 0, D - 1), minlength=D)
    assert max(occ) < 0.5 * eq_occ.max()


def test_sharded_balanced_planes_match_single_device(setup, eight_devices):
    """Explicit balance-aware slab planes (cell-aligned at ANY device count
    — D=8 with C=100 would otherwise take the general full-width merge
    path) must advance identical physics to the single-chip engine, with
    the cell-space migration predicate keeping the splice invariant."""
    import dataclasses

    from sphjax.dist.sharded import balanced_slab_planes

    cfg, st = setup
    steps = 10
    s = st
    single = make_step(cfg, "cell_list")
    for _ in range(steps):
        s, _ = single(s)

    z = np.asarray(st.position)[np.asarray(st.valid), 2]
    planes = balanced_slab_planes(z, cfg, 8)
    assert len(planes) == 9
    mesh = _mesh(eight_devices, 8)
    dcfg = DistConfig(
        n_devices=8, dev_capacity=512, halo_capacity=256,
        migration_capacity=128, slab_planes=planes,
    )
    from sphjax.dist.sharded import _aligned

    assert _aligned(cfg, dcfg)  # explicit planes force the splice path
    dstate = distribute_state(st, cfg, dcfg, mesh)
    step = make_sharded_step(cfg, dcfg, mesh)
    aux = None
    for _ in range(steps):
        dstate, aux = step(dstate)
    assert int(aux.halo_overflow) == 0
    assert int(aux.migration_overflow) == 0
    assert int(aux.misrouted) == 0
    assert int(aux.num_particles) == cfg.num_particles
    got = collect_state(dstate, cfg.num_particles)
    np.testing.assert_allclose(
        got["position"], np.asarray(s.position)[: cfg.num_particles],
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        got["velocity"], np.asarray(s.velocity)[: cfg.num_particles],
        rtol=1e-3, atol=1e-3,
    )


def test_sharded_click_matches_single_chip(setup, eight_devices):
    """Free-mode parity (simulator.cu:329-367,482-489): a click during the
    sharded step must kick the same velocity field as the single-chip
    apply_click_impulse after the same step."""
    cfg, st = setup
    click = (400, 300)

    single = make_step(cfg, "cell_list")
    s1, _ = single(st)
    from sphjax.interact.impulse import apply_click_impulse

    s1 = jax.jit(lambda s: apply_click_impulse(s, st.position, np.asarray(click, np.int32), cfg))(s1)
    ref_vel = np.asarray(s1.velocity)[: cfg.num_particles]

    mesh = _mesh(eight_devices, 8)
    dcfg = DistConfig(
        n_devices=8, dev_capacity=512, halo_capacity=256, migration_capacity=128
    )
    dstate = distribute_state(st, cfg, dcfg, mesh)
    step = make_sharded_step(cfg, dcfg, mesh)
    dstate, _ = step(dstate, np.asarray(click, np.int32), np.asarray(True))
    got = collect_state(dstate, cfg.num_particles)
    # the click must actually kick someone (PUSH_STRENGTH ≫ gravity·dt)
    kicked = np.abs(got["velocity"] - ref_vel).max()
    np.testing.assert_allclose(got["velocity"], ref_vel, rtol=1e-4, atol=1e-4)
    s0, _ = single(st)  # step WITHOUT click differs → the kick was applied
    assert np.abs(np.asarray(s0.velocity)[: cfg.num_particles] - ref_vel).max() > 1.0

    # inactive click must be a no-op relative to the plain sharded step
    d0 = distribute_state(st, cfg, dcfg, mesh)
    a, _ = step(d0)
    b, _ = step(distribute_state(st, cfg, dcfg, mesh), np.asarray(click, np.int32), np.asarray(False))
    np.testing.assert_array_equal(
        collect_state(a, cfg.num_particles)["velocity"],
        collect_state(b, cfg.num_particles)["velocity"],
    )
