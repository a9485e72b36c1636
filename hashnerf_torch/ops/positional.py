"""Classic NeRF sin/cos positional (Fourier) encoding.

Counterpart of hashnerf_tpu/ops/positional.py. The concat order is
[x, sin(f0 x), cos(f0 x), sin(f1 x), ...]. The frequency bands are computed
as the JAX package computes them, in numpy float64 (2.0 ** np.linspace),
then taken as Python floats: a torch.linspace band can be an ulp off.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PositionalConfig:
    num_freqs: int = 10
    max_freq_log2: int = 9  # the reference passes multires - 1
    input_dims: int = 3
    include_input: bool = True
    log_sampling: bool = True

    @property
    def out_dim(self) -> int:
        d = self.input_dims
        return (d if self.include_input else 0) + 2 * self.num_freqs * d

    @property
    def freq_bands(self) -> Tuple[float, ...]:
        if self.log_sampling:
            bands = 2.0 ** np.linspace(0.0, self.max_freq_log2, self.num_freqs)
        else:
            bands = np.linspace(2.0**0.0, 2.0**self.max_freq_log2, self.num_freqs)
        return tuple(float(f) for f in bands)


def positional_encode(x: torch.Tensor, cfg: PositionalConfig) -> torch.Tensor:
    """x (..., input_dims) -> (..., out_dim)."""
    parts = [x] if cfg.include_input else []
    for f in cfg.freq_bands:
        xf = x * f
        parts.append(torch.sin(xf))
        parts.append(torch.cos(xf))
    return torch.cat(parts, dim=-1)
