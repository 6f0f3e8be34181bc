"""sphjax — a smoothed-particle-hydrodynamics engine in JAX.

Built from scratch with the capabilities of the CUDA reference
(andrew-sha/CUDAFluidSimulator): N particles in a 10×10×10 box under gravity
with poly6 density, spiky pressure and viscosity forces, semi-implicit Euler
integration with reflective boundaries, uniform-grid neighbor search, a timed
100-step benchmark mode, and an interactive free mode with click-ripple
impulses — with a sort-based neighbor structure, fixed static shapes, a fused
jitted step, and spatial domain sharding over a device mesh.
"""

from sphjax.core.config import SimConfig, default_config
from sphjax.core.init import init_state
from sphjax.core.state import FluidState, make_state
from sphjax.engine.step import make_step, step_allpairs, step_cell_list

__all__ = [
    "SimConfig",
    "default_config",
    "FluidState",
    "make_state",
    "init_state",
    "make_step",
    "step_allpairs",
    "step_cell_list",
]

__version__ = "0.1.0"
