"""Checkpoint/resume round-trip (SURVEY.md §5 extension)."""

import numpy as np

from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.core.io import load_state, save_state
from sphjax.engine.step import make_step


def test_checkpoint_roundtrip(tmp_path):
    cfg = default_config(256, chunk_size=256)
    st = init_state(cfg, random_init=True, seed=5)
    step = make_step(cfg, "cell_list")
    for _ in range(3):
        st, _ = step(st)

    path = str(tmp_path / "ckpt.npz")
    save_state(path, st, cfg)
    st2, cfg2 = load_state(path)
    assert cfg2 == cfg
    for f in st._fields:
        np.testing.assert_array_equal(np.asarray(getattr(st, f)), np.asarray(getattr(st2, f)))

    # resuming produces the identical trajectory
    a, _ = step(st)
    b, _ = make_step(cfg2, "cell_list")(st2)
    np.testing.assert_array_equal(np.asarray(a.position), np.asarray(b.position))
