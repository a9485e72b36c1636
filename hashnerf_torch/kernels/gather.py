"""Row gathers with their own backwards.

Counterpart of hashnerf_tpu/kernels/gather_vjp.py:
- take_rows: forward `table[idx]` (index_select), backward accumulates the
  row gradients through sorted_segment_accumulate (K5 on the card). Used
  by the TV losses and by packed_encode_ops (packed_encode's CPU route).
- permute_rows: forward `x[perm]` for a permutation whose inverse the
  caller holds, backward `g[inv_perm]`, with no accumulation. Used by the
  occupancy un-permute (render/occupancy.py). In JAX both directions are
  XLA gathers, not Pallas kernels; here they are index_select.
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


class PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g.index_select(0, inv_perm), None, None


def permute_rows(x: torch.Tensor, perm: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """x (N, C) -> x[perm]; perm must be a permutation of N with inverse
    inv_perm. The transpose of a permutation gather is the gather by the
    inverse permutation, so the backward is g[inv_perm]."""
    return PermuteRows.apply(x, perm, inv_perm)
