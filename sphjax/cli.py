"""CLI front end — parity with the reference driver
(/root/reference/src/main.cpp:20-82):

    sph -n <NUM_PARTICLES> -i <random/grid> -m <free/time>

Same defaults (N=1000, grid init, time mode; main.cpp:21-23), same usage text
(main.cpp:12-18), same 100-iteration timed benchmark printing the Times table
(main.cpp:68-76). Extra flags (--steps, --backend, --seed, --out, --frames,
and the scaling surface --mesh) extend, never change, the reference surface.
"""

from __future__ import annotations

import argparse
import sys


def usage() -> str:
    return (
        "Program Options:\n"
        "  -n  <NUM_PARTICLES>    Number of particles to simulate\n"
        "  -i  <random/grid>      Initialization mode: random or grid\n"
        "  -m  <free/time>        Execution mode: free or timed\n"
        "  -?                     This message\n"
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sph", add_help=False, usage="sph -n <N> -i <random/grid> -m <free/time>"
    )
    p.add_argument("-n", type=int, default=1000, dest="num_particles")
    p.add_argument("-i", choices=["random", "grid"], default="grid", dest="init_mode")
    p.add_argument("-m", choices=["free", "time"], default="time", dest="exec_mode")
    p.add_argument("-?", "--help", action="store_true", dest="show_help")
    # extensions beyond the reference surface
    p.add_argument("--steps", type=int, default=100, help="timed-mode iterations")
    p.add_argument(
        "--warmup",
        type=int,
        default=1,
        help="timed-mode untimed warmup steps (excludes XLA compilation from "
        "the report; 0 reproduces the reference protocol exactly)",
    )
    p.add_argument(
        "--backend",
        choices=["auto", "pallas_triton", "cell_list", "allpairs"],
        default="auto",
        help="step backend (auto: pallas_triton on a GPU, cell_list on the CPU)",
    )
    p.add_argument("--seed", type=int, default=0, help="PRNG seed for -i random")
    p.add_argument("--frames", type=int, default=0, help="free mode: frame-dump count")
    p.add_argument("--out", type=str, default="frames", help="free mode: output dir")
    p.add_argument(
        "--click",
        type=str,
        default=None,
        help="free mode: 'frame:px,py' scripted click, repeatable",
        action="append",
    )
    p.add_argument("--window-capacity", type=int, default=None)
    # scaling-layer surface (SURVEY.md §2.5): spatial domain sharding
    p.add_argument(
        "--mesh",
        type=str,
        default=None,
        metavar="z|ZxYxX",
        help="shard the box across devices: 'z' = 1-D z-slabs over all "
        "devices, 'ZxYxX' (e.g. 2x2x2) = 3-D brick mesh",
    )
    p.add_argument(
        "--profile",
        type=str,
        default=None,
        metavar="DIR",
        help="timed mode: dump a jax.profiler trace to DIR",
    )
    p.add_argument(
        "--save",
        type=str,
        default=None,
        metavar="PATH",
        help="checkpoint the final state to PATH (.npz, self-describing; "
        "works for both the single-chip and --mesh engines)",
    )
    p.add_argument(
        "--load",
        type=str,
        default=None,
        metavar="PATH",
        help="resume from a checkpoint written by --save (restores N and "
        "the physics config; -n/-i are ignored with a note)",
    )
    p.add_argument(
        "--viz-chunk",
        type=int,
        default=None,
        metavar="S",
        help="free mode with --frames: steps per device dispatch (scan-"
        "chained, device-projected packed frame stream). Default: "
        "SPHJAX_VIZ_CHUNK or 1",
    )
    p.add_argument(
        "--gif",
        type=str,
        default=None,
        help="free mode with --frames: also assemble frames into this GIF "
        "(needs Pillow)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args_in = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    try:
        args = parser.parse_args(args_in)
    except SystemExit:
        print(usage(), end="")
        return 1
    if args.show_help:
        print(usage(), end="")
        return 1

    from sphjax.core.config import default_config
    from sphjax.utils.cache import enable_compile_cache

    enable_compile_cache()
    kw = {}
    if args.window_capacity is not None:
        kw["window_capacity"] = args.window_capacity
    loaded_state = None
    if args.load is not None:
        # resume: the checkpoint's SimConfig (N, physics, capacities) is
        # authoritative; explicit capacity flags still apply on top
        import dataclasses

        from sphjax.core.io import load_state

        loaded_state, cfg = load_state(args.load)
        if kw:
            cfg = dataclasses.replace(cfg, **kw)
        if args.num_particles != 1000 and args.num_particles != cfg.num_particles:
            print(
                f"sph: --load restores N={cfg.num_particles}; -n "
                f"{args.num_particles} ignored",
                file=sys.stderr,
            )
        random_init = False  # -i is irrelevant when resuming
    else:
        cfg = default_config(args.num_particles, **kw)

        # grid init caps at the 0.9h lattice ceiling (~1.29M in the 10³
        # box); past it fall back to random init with a note, like bench.py
        random_init = args.init_mode == "random"
        if not random_init:
            from sphjax.core.init import lattice_capacity

            cap = lattice_capacity(cfg)
            if args.num_particles > cap:
                print(
                    f"sph: N={args.num_particles} exceeds the {cap} "
                    "grid-lattice ceiling — using random init",
                    file=sys.stderr,
                )
                random_init = True

    if args.mesh is not None:
        from sphjax.dist.simulator import DistSimulator

        mesh_shape = None
        if args.mesh != "z":
            try:
                mesh_shape = tuple(int(v) for v in args.mesh.split("x"))
                assert len(mesh_shape) == 3
            except (ValueError, AssertionError):
                print(usage(), end="")
                return 1
        sim = DistSimulator(
            cfg,
            random_init=random_init,
            seed=args.seed,
            mesh_shape=mesh_shape,
            backend=args.backend,
        )
    else:
        from sphjax.engine.simulator import Simulator

        sim = Simulator(
            cfg,
            backend=args.backend,
            random_init=random_init,
            seed=args.seed,
        )
    sim.setup(loaded_state)

    if args.exec_mode == "time":
        import contextlib

        from sphjax.bench.times import Times, display_times

        profiler = contextlib.nullcontext()
        if args.profile:
            import jax

            profiler = jax.profiler.trace(args.profile)
        warm = Times()
        for _ in range(args.warmup):
            sim.simulate_and_time(warm)  # compile + capacity settle, untimed
        times = Times()
        with profiler:
            for _ in range(args.steps):
                sim.simulate_and_time(times)
        display_times(times)
    else:
        from sphjax.viz.render import run_free_mode

        clicks = {}
        for spec in args.click or []:
            frame, xy = spec.split(":")
            x, y = xy.split(",")
            clicks[int(frame)] = (int(x), int(y))
        run_free_mode(
            sim, frames=args.frames, out_dir=args.out, clicks=clicks,
            chunk=args.viz_chunk,
        )
        if args.gif and args.frames > 0:
            from sphjax.viz.render import frames_to_gif

            frames_to_gif(args.out, args.gif)
            print(f"wrote {args.gif}")

    if args.save is not None:
        from sphjax.core.io import save_state

        # ONE checkpoint format across engines: the sharded engine collects
        # to a host FluidState first (mesh-shape-independent resume)
        state = sim.to_host_state() if args.mesh is not None else sim.state
        save_state(args.save, state, sim.cfg)
        print(f"saved checkpoint: {args.save}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
