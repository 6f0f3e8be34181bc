"""Neighbor-structure tests: cell keys, sorted cell ranges,
window candidate generation, and the all-pairs ≡ cell-list invariant
(SURVEY.md §4b/d — the analog of printGridList's occupancy audit)."""

import jax.numpy as jnp
import numpy as np

from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.neighbors.cell_list import build_cell_list, window_candidates
from sphjax.neighbors.grid import cell_coords, compute_keys, flatten_rowmajor




def test_cell_coords_truncation():
    cfg = default_config(8)
    pos = jnp.asarray([[0.1, 0.25, 9.9]], jnp.float32)
    c = np.asarray(cell_coords(pos, cfg))[0]
    # f32: 0.1/0.1 = 1.0 → 1; 0.25/0.1 = 2.5 → 2; 9.9/0.1 = 98.999… → 98
    assert list(c) == [1, 2, 98]


def test_keys_sentinel_for_invalid():
    cfg = default_config(4)
    pos = jnp.asarray([[0.5, 0.5, 0.5]] * 4, jnp.float32)
    valid = jnp.asarray([True, True, False, False])
    keys = compute_keys(pos, valid, cfg)
    k = np.asarray(keys.key)
    assert (k[:2] < cfg.num_cells).all()
    assert (k[2:] == cfg.num_cells).all()


def test_oob_counted():
    cfg = default_config(3)
    pos = jnp.asarray([[0.5, 0.5, 0.5], [-0.2, 0.5, 0.5], [0.5, 11.0, 0.5]], jnp.float32)
    keys = compute_keys(pos, jnp.ones(3, bool), cfg)
    assert int(keys.oob_count) == 2


def test_cell_ranges_partition_particles():
    cfg = default_config(512, chunk_size=512)
    st = init_state(cfg, random_init=True, seed=1)
    cl = build_cell_list(st.position, st.valid, cfg)
    starts = np.asarray(cl.starts)
    # monotone, total valid count at the num_cells boundary
    assert (np.diff(starts) >= 0).all()
    assert starts[cfg.num_cells] == int(st.valid.sum())
    assert starts[-1] == st.num_slots
    # every sorted particle's key matches the range it falls in
    keys = np.asarray(cl.key_sorted)
    for i in [0, 100, 511]:
        k = keys[i]
        if k < cfg.num_cells:
            assert starts[k] <= i < starts[k + 1]


def test_window_candidates_cover_all_h_neighbors():
    """Every true r ≤ h neighbor must appear in some window (coverage —
    the property the physics depends on)."""
    cfg = default_config(256, chunk_size=256, window_capacity=64)
    st = init_state(cfg, random_init=True, seed=2)
    cl = build_cell_list(st.position, st.valid, cfg)
    sp = np.asarray(st.position)[np.asarray(cl.perm)]
    n = sp.shape[0]
    idx, mask, ovf = window_candidates(cl.key_sorted, cl.starts, n, cfg)
    assert int(ovf) == 0
    idx, mask = np.asarray(idx), np.asarray(mask)
    valid_sorted = np.asarray(cl.valid_sorted)
    for i in range(0, n, 17):
        if not valid_sorted[i]:
            continue
        cand = set(idx[i][mask[i]].ravel().tolist())
        d = np.linalg.norm(sp - sp[i], axis=1)
        true_nbrs = set(np.nonzero((d <= cfg.h) & valid_sorted)[0].tolist())
        assert true_nbrs <= cand, f"missing neighbors for particle {i}"


def test_windows_disjoint_no_double_count():
    """The 9 windows of one target never overlap (offsets differ by ≥ C−3)."""
    cfg = default_config(256, chunk_size=256)
    st = init_state(cfg, random_init=True, seed=4)
    cl = build_cell_list(st.position, st.valid, cfg)
    n = st.num_slots
    idx, mask, _ = window_candidates(cl.key_sorted, cl.starts, n, cfg)
    idx, mask = np.asarray(idx), np.asarray(mask)
    for i in range(0, n, 31):
        live = idx[i][mask[i]]
        assert len(live) == len(set(live.tolist()))


def test_rowmajor_matches_reference_flatten():
    cfg = default_config(8)
    cell = jnp.asarray([[3, 5, 7]], jnp.int32)
    assert int(flatten_rowmajor(cell, cfg)[0]) == 3 + 5 * 100 + 7 * 10000


def test_starts_table_semantics():
    """starts[k] = #keys < k, over keys with collisions, empty cells, and
    sentinel entries for invalid slots."""
    import jax

    cfg = default_config(512, num_cells_per_dim=8)
    rng = np.random.default_rng(7)
    key = jnp.asarray(
        rng.integers(0, cfg.num_cells + 1, size=737), jnp.int32
    )
    from sphjax.neighbors.cell_list import starts_table

    a = np.asarray(jax.jit(lambda k: starts_table(k, cfg))(key))
    ref = np.array(
        [np.sum(np.asarray(key) < k) for k in range(cfg.num_cells + 2)]
    )
    np.testing.assert_array_equal(a, ref)
