"""Hand-written CUDA kernels for Hopper (csrc/*.cu) and their wrappers.

Each wrapper keeps a plain integer count of its launches (`fn.launches`),
raised only where it launches its kernel. `launch_counts` reads them with
the program's counters (utils/profiling.py: steps, grid updates, captures,
host reads), and `reset_launch_counts` sets both to 0. A CUDA graph's
replay runs no Python: train/graphs.py adds what a graph counted at its
capture with `add_launches`.
"""
from __future__ import annotations

from typing import Dict

from hashnerf_torch.kernels.field_mlp import field_mlp_fwd
from hashnerf_torch.kernels.field_query import (
    field_colour_input_bwd, field_colour_input_fwd, field_raw_bwd, field_raw_fwd,
)
from hashnerf_torch.kernels.hash_encode import (
    hash_encode_bwd, hash_encode_bwd_expand, hash_encode_fwd,
)
from hashnerf_torch.kernels.packed_encode import packed_encode_bwd, packed_encode_fwd
from hashnerf_torch.kernels.segment_accum import (
    segment_accumulate_k1, segment_accumulate_k4, segment_accumulate_k5,
)
from hashnerf_torch.utils import profiling

KERNELS = {
    "segment_accumulate_k1": segment_accumulate_k1,
    "hash_encode_fwd": hash_encode_fwd,
    "hash_encode_bwd_expand": hash_encode_bwd_expand,
    "segment_accumulate_k4": segment_accumulate_k4,
    "segment_accumulate_k5": segment_accumulate_k5,
    "hash_encode_bwd": hash_encode_bwd,
    "packed_encode_fwd": packed_encode_fwd,
    "packed_encode_bwd": packed_encode_bwd,
    "field_colour_input_fwd": field_colour_input_fwd,
    "field_colour_input_bwd": field_colour_input_bwd,
    "field_raw_fwd": field_raw_fwd,
    "field_raw_bwd": field_raw_bwd,
    "field_mlp_fwd": field_mlp_fwd,
}


# every name launch_counts reports
COUNTED = frozenset(KERNELS) | frozenset(profiling.COUNTERS)


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launches and each program counter, by name."""
    return {**{name: fn.launches for name, fn in KERNELS.items()}, **profiling.counters()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    profiling.reset_counters()


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add `times` x counts to the wrappers' and the program's counts: what
    a CUDA graph's replays (train/graphs.py), which run no Python, launch
    and count."""
    for name, n in counts.items():
        if name in KERNELS:
            KERNELS[name].launches += n * times
        else:
            profiling.count(name, n * times)
