"""Golden-trajectory regression tests (SURVEY.md §4c): fixed seed, K steps,
compare against stored state snapshots. Regenerate with
`python tests/test_golden.py` after an *intentional* physics change.

Two goldens: random init + cell_list (the original) and grid init +
cell_list (the reference's default -i mode). The Triton pair-pass backend
(interpret mode) must reproduce the random-init golden too — it pins the
kernel math to the same trajectory, not just the XLA tile path."""

import os

import numpy as np

from sphjax.core.config import default_config
from sphjax.core.init import init_state
from sphjax.engine.step import make_step, step_pallas_triton

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
STEPS = 15


def _run(init: str = "random", backend: str = "cell_list"):
    cfg = default_config(256, chunk_size=256)
    st = init_state(cfg, random_init=(init == "random"), seed=42)
    if backend == "pallas_triton":
        import jax

        step = jax.jit(lambda s: step_pallas_triton(s, cfg, interpret=True))
    else:
        step = make_step(cfg, backend)
    for _ in range(STEPS):
        st, aux = step(st)
    assert int(aux.window_overflow) == 0
    v = np.asarray(st.valid)
    return {
        "position": np.asarray(st.position)[v],
        "velocity": np.asarray(st.velocity)[v],
        "density": np.asarray(st.density)[v],
    }


CASES = {
    "traj_rand256_15.npz": dict(init="random", backend="cell_list"),
    "traj_grid256_15.npz": dict(init="grid", backend="cell_list"),
}


def _check(fname, **kw):
    got = _run(**kw)
    path = os.path.join(GOLDEN, fname)
    assert os.path.exists(path), f"golden {fname} missing — run tests/test_golden.py"
    with np.load(path) as ref:
        for k in got:
            np.testing.assert_allclose(
                got[k], ref[k], rtol=1e-5, atol=1e-6,
                err_msg=f"golden mismatch in {k} ({fname})",
            )


def test_golden_trajectory():
    _check("traj_rand256_15.npz", **CASES["traj_rand256_15.npz"])


def test_golden_trajectory_grid_init():
    _check("traj_grid256_15.npz", **CASES["traj_grid256_15.npz"])


def test_golden_trajectory_triton_kernels_interpret():
    _check("traj_rand256_15.npz", init="random", backend="pallas_triton")


if __name__ == "__main__":
    os.makedirs(GOLDEN, exist_ok=True)
    for fname, kw in CASES.items():
        np.savez_compressed(os.path.join(GOLDEN, fname), **_run(**kw))
        print(f"golden regenerated: {fname}")
