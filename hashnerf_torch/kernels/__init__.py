"""Hand-written CUDA kernels for Hopper (csrc/*.cu) and their wrappers.

Every wrapper launches through kernels/launch.py: one `Kernel` for each C
entry, and `device_kind`, the one rule for its route (plain version or
kernel). A Kernel counts its launches in utils/profiling.py's one store,
beside the program's counters (steps, grid updates, captures, host reads).
`launch_counts` reads that store and `reset_launch_counts` sets it to 0. A
CUDA graph's replay runs no Python: train/graphs.py adds what a graph
counted at its capture with `add_launches`.
"""
from __future__ import annotations

from typing import Dict

# importing the wrappers constructs, and so registers, every Kernel
from hashnerf_torch.kernels import (  # noqa: F401
    field_mlp, field_query, hash_encode, packed_encode, segment_accum,
)
from hashnerf_torch.kernels.launch import KERNELS
from hashnerf_torch.utils import profiling

# every name launch_counts reports
COUNTED = frozenset(profiling.counts())

launch_counts = profiling.counts
reset_launch_counts = profiling.reset_counters


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add `times` x counts to the store: what a CUDA graph's replays
    (train/graphs.py), which run no Python, launch and count."""
    for name, n in counts.items():
        profiling.count(name, n * times)
