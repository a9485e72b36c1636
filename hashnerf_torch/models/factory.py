"""Model state (hash table + coarse/fine NeRFSmall) and the query function.

Counterpart of hashnerf_tpu/models/factory.py for the hash-grid path
(i_embed = 1, SH view encoding). The state is one nn.Module holding the
table and the MLPs:
  * the per-corner layout: one (L, 2^T, F) nn.Parameter, encoded by
    kernels/hash_encode.py's HashEncode (K2 forward, K6 backward);
  * `packed_layout`: an nn.ParameterDict {"dense", "fine"} encoded by
    ops/packed_grid.py's packed_encode (take_rows, backward K5).
With `share_fine` there is no fine net: the coarse net answers both passes.
Points outside the bbox get sigma (channel 3) zeroed, as in the JAX
query_fn. Positional encoding and the NeRF / NeRFGradient MLPs come in a
later slice (ROADMAP A1/A2).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from hashnerf_torch.kernels.hash_encode import hash_encode
from hashnerf_torch.models.nerf import NeRFSmall, NeRFSmallConfig
from hashnerf_torch.ops.hash_encoding import HashGridConfig, init_hash_table
from hashnerf_torch.ops.packed_grid import PackedGridConfig, init_packed_tables, packed_encode
from hashnerf_torch.ops.sh_encoding import sh_encode, sh_out_dim

EMBED_HASH = 1
EMBED_SH = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    i_embed: int = EMBED_HASH
    i_embed_views: int = EMBED_SH
    use_viewdirs: bool = True
    N_importance: int = 0
    sh_degree: int = 4
    # one net for both render passes: the state has no fine net
    share_fine: bool = False
    hash_grid: HashGridConfig = dataclasses.field(default_factory=HashGridConfig)
    compute_dtype: Optional[str] = None  # None (float32), "bfloat16" or "float16" MLPs
    # corner-packed table layout (ops/packed_grid.py)
    packed_layout: bool = False
    log2_blocks: int = -1  # packed fine rows per level; -1 = log2_hashmap_size - 3

    def __post_init__(self):
        if self.i_embed != EMBED_HASH or self.i_embed_views != EMBED_SH:
            raise NotImplementedError(
                "hashnerf_torch ports only the hash-grid point encoder with the "
                "SH view encoder (i_embed=1, i_embed_views=2); the others are "
                "ROADMAP A1/A2"
            )

    @property
    def packed_grid(self) -> PackedGridConfig:
        if self.log2_blocks != -1 and self.log2_blocks <= 0:
            # an explicit 0 is a config error, not a request for the default
            raise ValueError(f"log2_blocks must be > 0 or -1 (auto); got {self.log2_blocks}")
        h = self.hash_grid
        return PackedGridConfig(
            n_levels=h.n_levels,
            n_features_per_level=h.n_features_per_level,
            log2_hashmap_size=h.log2_hashmap_size,
            base_resolution=h.base_resolution,
            finest_resolution=h.finest_resolution,
            log2_blocks=self.log2_blocks if self.log2_blocks > 0 else h.log2_hashmap_size - 3,
        )

    def mlp_config(self) -> NeRFSmallConfig:
        return NeRFSmallConfig(
            input_ch=self.hash_grid.out_dim,
            input_ch_views=sh_out_dim(self.sh_degree) if self.use_viewdirs else 0,
            compute_dtype=self.compute_dtype,
        )


class NGPState(nn.Module):
    """All learnable state: hash_table ((L, 2^T, F), or {"dense", "fine"}
    under packed_layout), coarse, fine (or None)."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.packed_layout:
            self.packed_cfg = cfg.packed_grid
            self.hash_table = nn.ParameterDict({
                k: nn.Parameter(t)
                for k, t in init_packed_tables(self.packed_cfg, generator, device).items()
            })
        else:
            self.hash_table = nn.Parameter(init_hash_table(cfg.hash_grid, generator, device))
            self.register_buffer(
                "resolutions", cfg.hash_grid.resolutions_tensor(device), persistent=False
            )
        mcfg = cfg.mlp_config()
        self.coarse = NeRFSmall(mcfg, generator, device)
        has_fine = cfg.N_importance > 0 and not cfg.share_fine
        self.fine = NeRFSmall(mcfg, generator, device) if has_fine else None

    def table_parameters(self) -> List[nn.Parameter]:
        if isinstance(self.hash_table, nn.ParameterDict):
            return list(self.hash_table.values())
        return [self.hash_table]

    def net_parameters(self) -> List[nn.Parameter]:
        nets = [self.coarse] + ([self.fine] if self.fine is not None else [])
        return [p for n in nets for p in n.parameters()]


def query_fn(state: NGPState, pts, viewdirs, bbox, fine: bool = False) -> torch.Tensor:
    """Encode points (+ view directions), run the MLP, zero sigma outside
    the bbox. pts (R, S, 3), viewdirs (R, 3) or None, bbox (2, 3)
    -> raw (R, S, 4)."""
    R, S = pts.shape[0], pts.shape[1]
    flat = pts.reshape(-1, 3).contiguous()
    if state.cfg.packed_layout:
        embedded, keep = packed_encode(state.hash_table, flat, bbox[0], bbox[1], state.packed_cfg)
    else:
        embedded, keep = hash_encode(
            state.hash_table, flat, bbox[0].contiguous(), bbox[1].contiguous(), state.resolutions
        )
    if state.cfg.use_viewdirs and viewdirs is not None:
        dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
        embedded = torch.cat([embedded, sh_encode(dirs, state.cfg.sh_degree)], dim=-1)
    mlp = state.fine if (fine and state.fine is not None) else state.coarse
    raw = mlp(embedded)
    sigma = torch.where(keep, raw[..., 3], torch.zeros_like(raw[..., 3]))
    raw = torch.cat([raw[..., :3], sigma[..., None], raw[..., 4:]], dim=-1)
    return raw.reshape(R, S, raw.shape[-1])
