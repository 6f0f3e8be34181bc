"""Phase timing — parity with `struct Times` / `displayTimes`
(/root/reference/src/times.h:5-36).

Accumulates wall-clock seconds for the three phases the reference brackets
with cudaDeviceSynchronize (grid construction / SPH update / data transfer);
here each phase is fenced with jax.block_until_ready so it measures true
device time, the analog of the reference's sync-gated chrono timers
(simulator.cu:505-545).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Times:
    build_grid: float = 0.0
    sph_update: float = 0.0
    memcpy: float = 0.0
    iters: int = 0


def format_times(times: Times) -> str:
    """Reproduces displayTimes' iomanip layout (times.h:12-36): fixed 5
    decimals; header setw(12)/18/12; rows with the reference's exact widths."""
    avg_bg = times.build_grid / times.iters if times.iters else 0.0
    avg_su = times.sph_update / times.iters if times.iters else 0.0
    avg_mc = times.memcpy / times.iters if times.iters else 0.0
    lines = [
        f"{'Operation':<12}{'Per frame':>18}{'Total':>12}",
        "-" * 45,
        f"{'Grid construction':<11}{avg_bg:>11.5f}{times.build_grid:>15.5f}",
        f"{'SPH update':<12}{avg_su:>16.5f}{times.sph_update:>15.5f}",
        f"{'Data transfer':<12}{avg_mc:>15.5f}{times.memcpy:>15.5f}",
    ]
    return "\n".join(lines)


def display_times(times: Times) -> None:
    print(format_times(times))
