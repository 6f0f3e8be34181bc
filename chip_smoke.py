"""Smoke test of the SPH engine on a GPU: the quickest proof that the system
still starts on the card.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded engines only

One card, in one process:
  1. device   — fail unless JAX's first device is a GPU; print the card's
                name and power limit (nvidia-smi).
  2. kernels  — at N = 262,144 and 1,048,576 (grid init, cell-sorted),
                compile the Triton density and force kernels (interpret=False)
                and compare them with the XLA tile passes on the same input:
                ρ at rtol 1e-4; forces at atol 1e-4·max|f| (opposite-signed
                pair forces summed in another order cancel, so an elementwise
                relative bound is ill-posed near zero). No matrix product is
                involved, so TF32 never enters. Prints the step's
                compiled.memory_analysis(). Then cell_list vs the NumPy
                oracle at N = 4096 (ρ rtol 1e-4, positions atol 1e-5).
  3. main path — the CLI's timed mode at 262,144 for 10 steps, in-process;
                then a 100-step scan-chained run at 262,144 and 1,048,576
                with the production backend, after a 10-step per-particle parity
                check against cell_list (positions atol 1e-4, ρ rtol 1e-4).
  4. free mode — 16,384 particles, 5 headless frames with one scripted
                click, PNGs through the stdlib encoder.

Four cards (--cards 4): at N = 1,048,576, DistSimulator with 1-D z-slabs
over 4 devices and then the (2, 2, 1) brick mesh; each is compared per pid
after 3 steps with the single-card cell_list chain on device 0 (positions
atol 1e-4), then runs 20 steps with conservation and zero-overflow checks,
then reports steps/s. Every sharded array must span all four devices.

Every phase prints its result; any failure exits non-zero. The last line is
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SIZES = (262_144, 1_048_576)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_kernels(sizes=SIZES, interpret: bool = False) -> None:
    """Triton pair kernels vs the XLA tile passes at each size."""
    import jax
    import jax.numpy as jnp

    from sphjax.bench.chain import grow
    from sphjax.core.config import default_config
    from sphjax.core.init import init_state
    from sphjax.engine.step import (
        _density_pass_sorted,
        _force_pass_sorted,
        build_phase,
        step_pallas_triton,
    )
    from sphjax.pallas.pair_passes import density_pairs, force_pairs
    from sphjax.physics.kernels import pressure_from_density

    for n in sizes:
        cfg = default_config(n)
        st = init_state(cfg)
        rng = np.random.default_rng(n)
        # the lattice starts at rest with zero pressure; random velocities
        # and pressures exercise both force terms on the same input
        st = st._replace(velocity=jnp.asarray(
            rng.normal(size=st.velocity.shape).astype(np.float32)))
        cl = jax.jit(lambda s, cfg=cfg: build_phase(s, cfg))(st)
        sp, sv = st.position[cl.perm], st.velocity[cl.perm]
        valid = np.asarray(cl.valid_sorted)

        t0 = time.perf_counter()
        dens = jax.jit(lambda sp, k, s, cfg=cfg: density_pairs(
            sp, k, s, cfg, interpret=interpret)).lower(
            sp, cl.key_sorted, cl.starts).compile()
        raw = dens(sp, cl.key_sorted, cl.starts)
        rho_k, _ = pressure_from_density(raw, cfg)

        ccfg = cfg
        while True:
            rho_x, _, ovf = jax.jit(lambda *a, c=ccfg: _density_pass_sorted(
                *a, c))(sp, cl.key_sorted, cl.valid_sorted, cl.starts)
            if int(ovf) == 0:
                break
            ccfg = grow(ccfg)
        rho_k, rho_x = np.asarray(rho_k)[valid], np.asarray(rho_x)[valid]
        rho_err = float(np.max(np.abs(rho_k - rho_x) / np.abs(rho_x)))

        p_s = jnp.where(cl.valid_sorted, jnp.asarray(
            rng.uniform(0.0, 50.0, size=sp.shape[0]).astype(np.float32)), 0.0)
        rho_in = jnp.asarray(np.where(valid, np.asarray(
            pressure_from_density(raw, cfg)[0]), 1.0))
        force = jax.jit(lambda *a, cfg=cfg: force_pairs(
            *a, cfg, interpret=interpret)).lower(
            sp, sv, rho_in, p_s, cl.key_sorted, cl.starts).compile()
        f_k = force(sp, sv, rho_in, p_s, cl.key_sorted, cl.starts)
        f_x = jax.jit(lambda *a, c=ccfg: _force_pass_sorted(*a, c))(
            sp, sv, rho_in, p_s, cl.key_sorted, cl.valid_sorted, cl.starts)
        jax.block_until_ready((f_k, f_x))
        compile_s = time.perf_counter() - t0
        f_k, f_x = np.asarray(f_k)[valid], np.asarray(f_x)[valid]
        f_max = float(np.max(np.abs(f_x)))
        f_err = float(np.max(np.abs(f_k - f_x)))

        step = jax.jit(lambda s, cfg=cfg: step_pallas_triton(
            s, cfg, interpret=interpret)).lower(st).compile()
        log(f"kernels n={n}: density max rel err {rho_err:.3e} (rtol 1e-4); "
            f"force max abs err {f_err:.3e} vs max|f| {f_max:.3e} "
            f"(atol {1e-4 * f_max:.3e}); compile+run {compile_s:.1f} s")
        log(f"kernels n={n}: step memory_analysis: {step.memory_analysis()}")
        check(rho_err <= 1e-4, f"density parity at n={n}")
        check(f_max > 0 and f_err <= 1e-4 * f_max, f"force parity at n={n}")


def phase_oracle(n: int = 4096) -> None:
    """cell_list vs the independent NumPy oracle, one step."""
    import jax

    from sphjax.core.config import default_config
    from sphjax.core.init import init_state
    from sphjax.engine.step import step_cell_list

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle_numpy import oracle_step

    cfg = default_config(n)
    st = init_state(cfg)
    s1, _ = jax.device_get(jax.jit(lambda s: step_cell_list(s, cfg))(st))
    v = np.asarray(st.valid)
    ref = oracle_step(np.asarray(st.position)[v], np.asarray(st.velocity)[v], cfg)
    np.testing.assert_allclose(np.asarray(s1.density)[v], ref["density"],
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(np.asarray(s1.position)[v], ref["position"],
                               rtol=0, atol=1e-5)
    log(f"oracle n={n}: cell_list matches the NumPy oracle (ρ rtol 1e-4, "
        "positions atol 1e-5)")


def phase_cli(n: int = 262_144) -> None:
    from sphjax.cli import main as cli_main

    rc = cli_main(["-n", str(n), "-i", "grid", "-m", "time", "--steps", "10"])
    check(rc == 0, f"CLI timed mode returned {rc}")
    log(f"cli n={n}: timed mode ok")


def phase_chains(card: str, sizes=SIZES, steps: int = 100,
                 gate_steps: int = 10) -> None:
    """100-step scan-chained runs with the production backend."""
    from sphjax.bench.chain import compare_states, compile_chain, time_chain
    from sphjax.core.config import default_config
    from sphjax.core.init import init_state
    from sphjax.engine.step import choose_backend

    backend = choose_backend()
    for n in sizes:
        cfg = default_config(n)
        st = init_state(cfg)
        _, _, _, a = compile_chain(cfg, backend, gate_steps, st)
        _, _, _, b = compile_chain(cfg, "cell_list", gate_steps, st)
        errors = compare_states(a, b, n)
        check(not errors, f"{backend} vs cell_list at n={n}: {errors}")
        cfg, run, compile_s, final = compile_chain(cfg, backend, steps, st)
        fin = np.asarray(final.position)[np.asarray(final.valid)]
        check(bool(np.isfinite(fin).all()), f"non-finite positions at n={n}")
        seconds = time_chain(run, st)
        log(f"chain n={n} backend={backend}: parity vs cell_list after "
            f"{gate_steps} steps ok; {steps} steps in {seconds:.4f} s = "
            f"{steps / seconds:.3f} steps/s (compile {compile_s:.1f} s) "
            f"[{card}]")


def phase_free_mode(n: int = 16_384, frames: int = 5) -> None:
    from sphjax.core.config import default_config
    from sphjax.engine.simulator import Simulator
    from sphjax.viz.render import run_free_mode

    out = os.path.join(REPO, "smoke_frames")  # git-ignored
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    sim = Simulator(default_config(n))
    sim.setup()
    run_free_mode(sim, frames=frames, out_dir=out, clicks={2: (400, 300)})
    files = sorted(os.listdir(out))
    check(files == [f"frame_{k:05d}.png" for k in range(frames)],
          f"free-mode frames: {files}")
    for f in files:
        with open(os.path.join(out, f), "rb") as fh:
            check(fh.read(8) == b"\x89PNG\r\n\x1a\n", f"{f} is not a PNG")
    log(f"free mode n={n}: {frames} PNG frames with one click ok")


def phase_four_cards(card: str, n: int = 1_048_576, gate_steps: int = 3,
                     run_steps: int = 20, n_dev: int = 4) -> None:
    """Both sharded engines on n_dev devices vs the single-card chain."""
    import jax

    from sphjax.bench.chain import compile_chain
    from sphjax.core.config import default_config
    from sphjax.core.init import init_state
    from sphjax.dist.simulator import DistSimulator

    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"need {n_dev} devices, have {len(jax.devices())}")
    cfg = default_config(n)
    st = init_state(cfg)
    _, _, _, ref = compile_chain(cfg, "cell_list", gate_steps, st)
    ref_pos = np.asarray(jax.device_get(ref.position))[:n]

    for mesh_shape in (None, (2, 2, 1)):
        name = "slabs" if mesh_shape is None else f"bricks {mesh_shape}"
        sim = DistSimulator(cfg, devices=devs, mesh_shape=mesh_shape)
        sim.setup(st)
        for field in sim.state:
            shard_devs = {s.device for s in field.addressable_shards}
            check(shard_devs == set(devs),
                  f"{name}: an array spans {len(shard_devs)} devices")
            check(all(s.data.shape[0] == sim.dcfg.dev_capacity
                      for s in field.addressable_shards),
                  f"{name}: an array is not split by device")
        sim.run(gate_steps)
        got = sim.get_position()
        err = float(np.max(np.abs(got - ref_pos)))
        log(f"4 cards {name}: {gate_steps} steps per pid vs single card: "
            f"max |Δx| {err:.3e} (atol 1e-4)")
        check(err <= 1e-4, f"{name}: per-pid parity")

        sim.setup(st)
        sim.run(run_steps, chunk=10)  # compile + settle capacities
        aux = sim.last_aux
        for counter in ("halo_overflow", "migration_overflow",
                        "window_overflow", "misrouted"):
            check(int(getattr(aux, counter)) == 0, f"{name}: {counter}")
        check(int(aux.num_particles) == n, f"{name}: conservation")
        sim.setup(st)
        t0 = time.perf_counter()
        sim.run(run_steps, chunk=10)
        jax.block_until_ready(sim.state)
        seconds = time.perf_counter() - t0
        log(f"4 cards {name}: {run_steps} steps conserve {n} particles, zero "
            f"overflow; {run_steps / seconds:.3f} steps/s "
            f"(backend={sim.backend}) [{card}]")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="GPU smoke test of the SPH engine")
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    from sphjax.bench.device import card_line, require_gpu
    from sphjax.utils.cache import enable_compile_cache

    info = require_gpu()
    card = card_line()
    log(f"device: {info}; card: {card}")
    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_four_cards(card)
    else:
        phase_kernels()
        phase_oracle()
        phase_cli()
        phase_chains(card)
        phase_free_mode()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
