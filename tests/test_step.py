"""Engine step tests: both backends vs the independent NumPy oracle, backend
equivalence, invariants over a trajectory (SURVEY.md §4b/d)."""

import jax
import numpy as np
import pytest

from tests.oracle_numpy import oracle_step
from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.engine.step import make_step


@pytest.fixture(scope="module", params=["grid", "random"])
def setup(request):
    cfg = default_config(512, chunk_size=512)
    st = init_state(cfg, random_init=(request.param == "random"), seed=7)
    return cfg, st


def _np(x):
    return np.asarray(x)


def test_one_step_matches_oracle(setup):
    cfg, st = setup
    valid = _np(st.valid)
    ref = oracle_step(_np(st.position)[valid], _np(st.velocity)[valid], cfg)
    for backend in ["allpairs", "cell_list"]:
        new, aux = make_step(cfg, backend)(st)
        np.testing.assert_allclose(
            _np(new.density)[valid], ref["density"], rtol=1e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            _np(new.pressure)[valid], ref["pressure"], rtol=1e-4, atol=1e-3
        )
        np.testing.assert_allclose(
            _np(new.force)[valid], ref["force"], rtol=2e-3, atol=2e-3
        )
        np.testing.assert_allclose(
            _np(new.position)[valid], ref["position"], rtol=1e-5, atol=1e-5
        )
        np.testing.assert_allclose(
            _np(new.velocity)[valid], ref["velocity"], rtol=1e-4, atol=1e-4
        )


def test_backends_agree_over_trajectory(setup):
    cfg, st = setup
    step_ap = make_step(cfg, "allpairs")
    step_cl = make_step(cfg, "cell_list")
    s_ap, s_cl = st, st
    for _ in range(10):
        s_ap, _ = step_ap(s_ap)
        s_cl, aux = step_cl(s_cl)
        assert int(aux.window_overflow) == 0
        assert int(aux.oob_count) == 0
    valid = _np(st.valid)
    np.testing.assert_allclose(
        _np(s_ap.position)[valid], _np(s_cl.position)[valid], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        _np(s_ap.density)[valid], _np(s_cl.density)[valid], rtol=1e-4
    )


def test_invariants_over_trajectory(setup):
    """Particles stay in [h, box−h]; density ≥ EPS_F; padding slots frozen."""
    cfg, st = setup
    step = make_step(cfg, "cell_list")
    s = st
    pad_pos0 = _np(s.position)[~_np(s.valid)]
    for _ in range(25):
        s, aux = step(s)
    valid = _np(s.valid)
    pos = _np(s.position)[valid]
    assert pos.min() >= cfg.h - 1e-6
    assert pos.max() <= cfg.box_dim - cfg.h + 1e-6
    assert _np(s.density)[valid].min() >= cfg.eps
    np.testing.assert_array_equal(_np(s.position)[~valid], pad_pos0)


def test_step_is_jittable_and_donatable(setup):
    cfg, st = setup
    stepped = jax.jit(lambda s: make_step(cfg, "cell_list")(s))(st)
    assert stepped[0].position.shape == st.position.shape


def test_fluid_falls_under_gravity():
    cfg = default_config(256, chunk_size=256)
    st = init_state(cfg, random_init=True, seed=11)
    step = make_step(cfg, "cell_list")
    y0 = float(np.asarray(st.position)[np.asarray(st.valid), 1].mean())
    s = st
    for _ in range(30):
        s, _ = step(s)
    y1 = float(np.asarray(s.position)[np.asarray(s.valid), 1].mean())
    assert y1 < y0 - 0.1  # fluid falls
