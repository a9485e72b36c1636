"""Hand-written CUDA kernels for Hopper (csrc/*.cu) and their wrappers.

Each wrapper keeps a plain integer count of its launches (`fn.launches`),
raised only where it launches its kernel; `launch_counts` reads them and
`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from typing import Dict

from hashnerf_torch.kernels.hash_encode import hash_encode_bwd_expand, hash_encode_fwd
from hashnerf_torch.kernels.segment_accum import (
    segment_accumulate_k1, segment_accumulate_k4, segment_accumulate_k5,
)

KERNELS = {
    "segment_accumulate_k1": segment_accumulate_k1,
    "hash_encode_fwd": hash_encode_fwd,
    "hash_encode_bwd_expand": hash_encode_bwd_expand,
    "segment_accumulate_k4": segment_accumulate_k4,
    "segment_accumulate_k5": segment_accumulate_k5,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
