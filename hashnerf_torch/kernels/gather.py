"""Row gather whose backward is sort + K1.

Counterpart of hashnerf_tpu/kernels/gather_vjp.py (take_rows): forward is
`table[idx]` (index_select), backward accumulates the row gradients through
sorted_segment_accumulate instead of a scatter. Used by the TV loss.
permute_rows (used only by occupancy culling) comes with that slice.
"""
from __future__ import annotations

import torch

from hashnerf_torch.kernels.segment_accum import sorted_segment_accumulate


class TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        F = g.shape[-1]
        d_table = sorted_segment_accumulate(
            idx.reshape(-1), g.reshape(-1, F), ctx.num_rows
        )
        return d_table, None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T, F), integer idx (...,) -> (..., F)."""
    return TakeRows.apply(table, idx)
