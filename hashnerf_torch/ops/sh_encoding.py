"""Real spherical-harmonics direction encoding, degrees 1-5.

Counterpart of hashnerf_tpu/ops/sh_encoding.py; out_dim = degree**2
(degree 4 -> 16, the flagship view encoding).
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def sh_out_dim(degree: int) -> int:
    return degree * degree


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis at unit directions d (..., 3) -> (..., degree**2).

    Each basis function's last product is written straight into its
    column of the output (no stack of degree**2 columns: one copy less),
    with the same operations in the same order as the JAX package. An
    `out=` product takes no gradient, so directions that require one get
    the same columns stacked instead."""
    if not (1 <= degree <= 5):
        raise ValueError(f"degree must be in [1, 5], got {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    stacked = [torch.full_like(x, C0)] if d.requires_grad and torch.is_grad_enabled() else None
    if stacked is None:
        out = d.new_empty(d.shape[:-1] + (degree * degree,))
        cols = iter(out.unbind(-1))
        next(cols).fill_(C0)

    def put(a, b):  # a * b into the next column
        if stacked is None:
            torch.mul(a, b, out=next(cols))
        else:
            stacked.append(a * b)

    if degree > 1:
        put(y, -C1)
        put(z, C1)
        put(x, -C1)
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        put(xy, C2[0])
        put(yz, C2[1])
        put(2.0 * zz - xx - yy, C2[2])
        put(xz, C2[3])
        put(xx - yy, C2[4])
    if degree > 3:
        put(C3[0] * y, 3 * xx - yy)
        put(C3[1] * xy, z)
        put(C3[2] * y, 4 * zz - xx - yy)
        put(C3[3] * z, 2 * zz - 3 * xx - 3 * yy)
        put(C3[4] * x, 4 * zz - xx - yy)
        put(C3[5] * z, xx - yy)
        put(C3[6] * x, xx - 3 * yy)
    if degree > 4:
        put(C4[0] * xy, xx - yy)
        put(C4[1] * yz, 3 * xx - yy)
        put(C4[2] * xy, 7 * zz - 1)
        put(C4[3] * yz, 7 * zz - 3)
        put(zz * (35 * zz - 30) + 3, C4[4])
        put(C4[5] * xz, 7 * zz - 3)
        put(C4[6] * (xx - yy), 7 * zz - 1)
        put(C4[7] * xz, xx - 3 * yy)
        put(xx * (xx - 3 * yy) - yy * (3 * xx - yy), C4[8])
    return out if stacked is None else torch.stack(stacked, dim=-1)
