"""Diagnostics tests."""

import jax
import numpy as np

from sphjax.bench.diagnostics import compute_diagnostics, format_diagnostics
from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.engine.step import make_step


def test_diagnostics_values():
    cfg = default_config(256, chunk_size=256)
    st = init_state(cfg, random_init=True, seed=5)
    step = make_step(cfg, "cell_list")
    st, _ = step(st)
    d = jax.device_get(jax.jit(lambda s: compute_diagnostics(s, cfg))(st))
    assert int(d.num_valid) == 256
    assert float(d.kinetic_energy) > 0  # gravity accelerated the fluid
    v = np.asarray(st.velocity)[np.asarray(st.valid)]
    np.testing.assert_allclose(
        float(d.max_speed), np.linalg.norm(v, axis=1).max(), rtol=1e-5
    )
    assert float(d.mean_density) > cfg.eps
    assert int(d.occupied_cells) > 0
    assert int(d.max_cell_occupancy) >= 1
    line = format_diagnostics(d)
    assert "KE=" in line and "occ_max=" in line
