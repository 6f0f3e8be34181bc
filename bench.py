"""Benchmark: SPH timesteps per second on one GPU.

Protocol: the reference's `-m time` mode (100 timesteps, grid init,
/root/reference/src/main.cpp:68-76) at N = 262,144, through the production
backend (engine.step.choose_backend), chained on device with lax.scan. The
chain is compiled and run once before the timed window (compilation is
reported as set-up time); the window ends with block_until_ready.

Before timing, an on-device parity gate: K chained steps of the timed backend
against the XLA cell-list backend at N = 4096 (per particle), one step of
cell_list against the independent NumPy oracle (tests/oracle_numpy.py), and
one step of the timed backend against cell_list at the timed N —
≤1e-4 relative density and ≤1e-4 in positions. `--no-verify` skips it.

Every line names the device it ran on. With no GPU the bench fails; a CPU
rehearsal runs only when JAX_PLATFORMS=cpu is asked for explicitly, and its
line carries no rate.

    python bench.py                                   # N=262144, 100 steps
    python bench.py --n 1048576 --backend cell_list
    python bench.py --ab pallas_triton,cell_list --n 262144 --n 1048576
    python bench.py --dist 4 --n 1048576              # sharded engine, 4 cards

`--ab A,B` times the two backends in turns A, B, B, A in one process, at
each N, and prints one line per timed run plus a summary per N.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def _setup():
    from sphjax.bench.device import card_line, require_gpu
    from sphjax.utils.cache import enable_compile_cache

    device = require_gpu(allow_cpu_rehearsal=True)
    enable_compile_cache()
    card = card_line() if device["platform"] == "gpu" else "not available"
    print(f"card: {card}", file=sys.stderr)
    return device, card


def _init(cfg, init: str):
    from sphjax.core.init import init_state, lattice_capacity

    random_init = init == "random"
    if not random_init and cfg.num_particles > lattice_capacity(cfg):
        print(f"bench: N={cfg.num_particles} exceeds the grid-lattice ceiling "
              "— using random init", file=sys.stderr)
        random_init = True
    return init_state(cfg, random_init=random_init), random_init


def verify_parity(backend: str, verify_steps: int = 10, n: int = 4096) -> list[str]:
    """On-device physics parity at small N: `backend` vs cell_list over
    verify_steps chained steps, and cell_list vs the NumPy oracle for one
    step. Returns the failures (empty: pass)."""
    import jax
    import numpy as np

    from sphjax.bench.chain import compare_states, compile_chain
    from sphjax.core.config import default_config
    from sphjax.core.init import init_state
    from sphjax.engine.step import step_cell_list

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle_numpy import oracle_step

    cfg = default_config(n, chunk_size=min(4096, n))
    state0 = init_state(cfg)
    errors = []
    if backend != "cell_list":
        _, _, _, sa = compile_chain(cfg, backend, verify_steps, state0)
        _, _, _, sb = compile_chain(cfg, "cell_list", verify_steps, state0)
        errors += [f"{backend} vs cell_list ({verify_steps} steps) {e}"
                   for e in compare_states(sa, sb, n)]

    s1, _ = jax.device_get(jax.jit(lambda s: step_cell_list(s, cfg))(state0))
    v = np.asarray(state0.valid)
    ref = oracle_step(
        np.asarray(state0.position)[v], np.asarray(state0.velocity)[v], cfg
    )
    for name, got, want, rtol, atol in (
        ("density", np.asarray(s1.density)[v], ref["density"], 1e-4, 0.0),
        ("positions", np.asarray(s1.position)[v], ref["position"], 0.0, 1e-5),
    ):
        try:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        except AssertionError as e:
            errors.append(f"cell_list vs oracle {name}: {e}")
    return errors


def verify_headline(cfg, state0, backend: str) -> list[str]:
    """One step of `backend` vs cell_list at the timed N and config."""
    if backend == "cell_list":
        return []
    from sphjax.bench.chain import compare_states, compile_chain

    _, _, _, a = compile_chain(cfg, backend, 1, state0)
    _, _, _, b = compile_chain(cfg, "cell_list", 1, state0)
    return [f"headline {e}" for e in compare_states(a, b, cfg.num_particles)]


def _line(metric, steps, seconds, device, card, **extra):
    rate = steps / seconds if device["platform"] == "gpu" else None
    return {
        "metric": metric,
        "value": rate,
        "unit": "timesteps/s",
        "device": device,
        "card": card,
        **extra,
    }


def main_single(args, device, card) -> int:
    from sphjax.bench.chain import compile_chain, time_chain
    from sphjax.core.config import default_config
    from sphjax.engine.step import choose_backend

    backend = args.backend or choose_backend()
    rc = 0
    for n in args.n:
        cfg = default_config(n)
        state0, random_init = _init(cfg, args.init)
        parity = "skipped"
        if args.verify:
            errors = verify_parity(backend) + verify_headline(cfg, state0, backend)
            for e in errors:
                print(f"parity FAIL: {e}", file=sys.stderr)
            parity = "fail" if errors else "pass"
            rc |= bool(errors)
        cfg, compiled, compile_s, _ = compile_chain(cfg, backend, args.steps, state0)
        seconds = time_chain(compiled, state0)
        print(json.dumps(_line(
            f"sph_timesteps_per_sec_n{n}", args.steps, seconds, device, card,
            backend=backend, parity=parity, compile_s=compile_s,
            init="random" if random_init else "grid",
            tile_cand_capacity=cfg.tile_cand_capacity,
        )), flush=True)
    return rc


def main_ab(args, device, card) -> int:
    """Two backends timed in turns A, B, B, A at each N, in one process.
    No capacity growth here: each timed run reports its own overflow, and a
    run that overflowed fails the A/B (raise --tile-cand-capacity)."""
    import time

    import jax

    from sphjax.bench.chain import make_chain
    from sphjax.core.config import default_config

    a, b = args.ab.split(",")
    rc = 0
    for n in args.n:
        cfg = default_config(n, tile_cand_capacity=args.tile_cand_capacity)
        state0, random_init = _init(cfg, args.init)
        compiled = {}
        for backend in (a, b):
            t0 = time.perf_counter()
            compiled[backend] = make_chain(cfg, backend, args.steps).lower(
                state0).compile()
            print(f"n={n} {backend}: compiled in "
                  f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
        rates = {a: [], b: []}
        for backend in (a, b, b, a):
            t0 = time.perf_counter()
            _, ovf = jax.block_until_ready(compiled[backend](state0))
            seconds = time.perf_counter() - t0
            line = _line(f"sph_timesteps_per_sec_n{n}", args.steps, seconds,
                         device, card, backend=backend, overflow=int(ovf),
                         tile_cand_capacity=cfg.tile_cand_capacity,
                         init="random" if random_init else "grid")
            rates[backend].append(line["value"])
            rc |= int(ovf) > 0
            print(json.dumps(line), flush=True)
        if device["platform"] == "gpu":
            summary = {k: statistics.mean(v) for k, v in rates.items()}
            print(json.dumps({"ab_n": n, "mean_timesteps_per_sec": summary,
                              "device": device, "card": card}), flush=True)
    return rc


def main_dist(args, device, card) -> int:
    """The scan-chained sharded engine on `--dist` devices, one dispatch for
    the whole run, after a 3-step per-pid parity gate against the
    single-card cell_list chain. Capacities are right-sized from a 10-step
    warm-up (DistSimulator.right_size)."""
    import time

    import jax
    import numpy as np

    from sphjax.bench.chain import compile_chain
    from sphjax.core.config import default_config
    from sphjax.dist.simulator import DistSimulator

    ndev = args.dist
    devices = jax.devices()
    if len(devices) < ndev:
        raise SystemExit(f"need {ndev} devices, have {len(devices)}")
    rc = 0
    for n in args.n:
        cfg = default_config(n)
        state0, random_init = _init(cfg, args.init)
        sim = DistSimulator(cfg, devices=devices[:ndev], random_init=random_init,
                            backend=args.backend or "auto")
        sim.setup(state0)
        parity = "skipped"
        if args.verify:
            gate = 3
            saved = sim.state
            sim.run(gate)
            got = sim.get_position()
            sim.state = saved
            _, _, _, ref = compile_chain(cfg, "cell_list", gate, state0)
            ref_pos = np.asarray(jax.device_get(ref.position))[:n]
            try:
                np.testing.assert_allclose(got, ref_pos, rtol=0, atol=1e-4)
                parity = "pass"
            except AssertionError as e:
                print(f"dist parity FAIL: {e}", file=sys.stderr)
                parity, rc = "fail", 1
        sim.right_size(warmup_steps=10)  # restores the initial state
        start = sim.state
        sim.run(args.steps)  # compile + settle capacities on this trajectory
        sim.state = start
        t0 = time.perf_counter()
        sim.run(args.steps)  # ends in a host read of the aux: synchronous
        jax.block_until_ready(sim.state)
        seconds = time.perf_counter() - t0
        print(json.dumps(_line(
            f"sph_dist_timesteps_per_sec_n{n}_d{ndev}", args.steps, seconds,
            device, card, backend=sim.backend, parity=parity,
            dev_capacity=sim.dcfg.dev_capacity,
        )), flush=True)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, action="append",
                   help="particle count (repeatable; default 262144)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--backend", default=None,
                   help="step backend (default: the platform's production one)")
    p.add_argument("--init", choices=["grid", "random"], default="grid")
    p.add_argument("--ab", default=None, metavar="A,B",
                   help="time two backends in turns A, B, B, A")
    p.add_argument("--dist", type=int, default=0, metavar="NDEV",
                   help="time the sharded engine (1-D z-slabs) on NDEV devices")
    p.add_argument("--tile-cand-capacity", type=int, default=768,
                   help="--ab: cell_list's candidate capacity (fixed; an "
                   "overflowing run fails the A/B)")
    p.add_argument("--no-verify", dest="verify", action="store_false")
    args = p.parse_args(argv)
    args.n = args.n or [262_144]
    device, card = _setup()
    if args.ab:
        return main_ab(args, device, card)
    if args.dist:
        return main_dist(args, device, card)
    return main_single(args, device, card)


if __name__ == "__main__":
    raise SystemExit(main())
