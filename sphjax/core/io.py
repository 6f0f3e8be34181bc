"""Checkpoint / resume — state save/load to .npz.

The reference has no checkpointing (SURVEY.md §5: state lives only in device
memory for the process lifetime); this is the small extension the
survey calls for. Config is embedded so a checkpoint is self-describing.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

from sphjax.core.config import SimConfig
from sphjax.core.state import FluidState


def save_state(path: str, state: FluidState, cfg: SimConfig) -> None:
    arrays = {f: np.asarray(jax.device_get(getattr(state, f))) for f in state._fields}
    arrays["__config__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_state(path: str) -> tuple[FluidState, SimConfig]:
    with np.load(path) as data:
        cfg = SimConfig(**json.loads(bytes(data["__config__"]).decode()))
        state = FluidState(
            **{f: jnp.asarray(data[f]) for f in FluidState._fields}
        )
    return state, cfg


def save_dist_state(path: str, dist_state, cfg: SimConfig, dcfg) -> None:
    """Checkpoint a sharded run: collect the per-device blocks to host,
    re-order globally by pid, and save as a self-describing .npz (global
    state + SimConfig + the DistConfig it ran under). The checkpoint is
    mesh-shape-independent — load_dist_state can restore onto a different
    device mesh by re-distributing."""
    import dataclasses as _dc

    from sphjax.dist.sharded import collect_state

    n = cfg.num_particles
    host = collect_state(dist_state, n)
    if np.isnan(host["position"]).any():
        raise ValueError(
            "dist checkpoint incomplete: some particle ids missing "
            "(conservation broken before save)"
        )
    arrays = {
        "position": host["position"],
        "velocity": host["velocity"],
        "__config__": np.frombuffer(
            json.dumps(_dc.asdict(cfg)).encode(), dtype=np.uint8
        ),
        "__dist_config__": np.frombuffer(
            json.dumps(_dc.asdict(dcfg)).encode(), dtype=np.uint8
        ),
    }
    np.savez_compressed(path, **arrays)


def load_dist_state(path: str, mesh, dcfg=None):
    """Restore a dist checkpoint onto `mesh` (any shape/size — the state is
    re-distributed from the global host copy). dcfg=None re-derives
    capacities for the new mesh via the default heuristics; passing a
    DistConfig overrides. Returns (DistState, SimConfig, DistConfig)."""
    from sphjax.core.state import FluidState as FS
    from sphjax.dist.sharded import DistConfig, distribute_state

    with np.load(path) as data:
        cfg = SimConfig(**json.loads(bytes(data["__config__"]).decode()))
        saved = json.loads(bytes(data["__dist_config__"]).decode())
        if saved.get("slab_planes") is not None:
            # JSON round-trips tuples as lists; DistConfig carries tuples
            saved["slab_planes"] = tuple(saved["slab_planes"])
        saved_dcfg = DistConfig(**saved)
        pos = np.asarray(data["position"], np.float32)
        vel = np.asarray(data["velocity"], np.float32)

    n_devices = mesh.devices.size
    if dcfg is None:
        if n_devices == saved_dcfg.n_devices:
            dcfg = saved_dcfg
        else:
            from sphjax.dist.simulator import default_dist_config

            dcfg = default_dist_config(cfg, n_devices)

    npad = cfg.padded_num_particles
    n = cfg.num_particles

    def pad(a, fill=0.0):
        out = np.full((npad,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    state = FS(
        position=jnp.asarray(pad(pos)),
        velocity=jnp.asarray(pad(vel)),
        force=jnp.zeros((npad, 3), jnp.float32),
        density=jnp.ones((npad,), jnp.float32),
        pressure=jnp.zeros((npad,), jnp.float32),
        valid=jnp.asarray(np.arange(npad) < n),
    )
    return distribute_state(state, cfg, dcfg, mesh), cfg, dcfg
