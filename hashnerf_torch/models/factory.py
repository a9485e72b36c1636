"""Model state (hash table + coarse/fine NeRFSmall) and the query function.

Counterpart of hashnerf_tpu/models/factory.py for the hash-grid path
(i_embed = 1, SH view encoding). The state is one nn.Module holding the
table and the MLPs:
  * the per-corner layout: one (L, 2^T, F) nn.Parameter, encoded by
    kernels/hash_encode.py's HashEncode (K2 forward, K6 backward);
  * `packed_layout`: an nn.ParameterDict {"dense", "fine"} encoded by
    ops/packed_grid.py's packed_encode (K7 forward, K8 backward on the card).
With `share_fine` there is no fine net: the coarse net answers both passes.
Points outside the bbox get sigma (channel 3) zeroed, as in the JAX
query_fn. query_fn encodes the view directions once a ray (R rows, not
R*S) and hands the MLP the encoded points, that per-ray encoding and S
(`forward_rays`); NeRFSmall widens it to the samples inside K9 and writes
the raw with field_raw (kernels/field_query.py), the keep mask included.
query_fn runs in an `hn.query` span, its encode in `hn.encode` and its MLP
in `hn.mlp` (utils/profiling.py); it counts `views_per_ray` and
`mlp_points`, the R * S points it hands the MLP.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from hashnerf_torch.kernels.hash_encode import hash_encode
from hashnerf_torch.models.nerf import NeRF, NeRFConfig, NeRFGradient, NeRFSmall, NeRFSmallConfig
from hashnerf_torch.ops.hash_encoding import HashGridConfig, init_hash_table
from hashnerf_torch.ops.packed_grid import PackedGridConfig, init_packed_tables, packed_encode
from hashnerf_torch.ops.positional import PositionalConfig, positional_encode
from hashnerf_torch.ops.sh_encoding import sh_encode, sh_out_dim
from hashnerf_torch.utils.profiling import annotate, count

# the reference's embedder ids
EMBED_IDENTITY = -1
EMBED_POSITIONAL = 0
EMBED_HASH = 1
EMBED_SH = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    i_embed: int = EMBED_HASH
    i_embed_views: int = EMBED_SH
    multires: int = 10
    multires_views: int = 4
    use_viewdirs: bool = True
    use_gradient: bool = False  # NeRFGradient (the NeRF family only)
    N_importance: int = 0
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    sh_degree: int = 4
    # one net for both render passes: the state has no fine net
    share_fine: bool = False
    hash_grid: HashGridConfig = dataclasses.field(default_factory=HashGridConfig)
    compute_dtype: Optional[str] = None  # None (float32) or a name compute_dtype_of takes
    # corner-packed table layout (ops/packed_grid.py)
    packed_layout: bool = False
    log2_blocks: int = -1  # packed fine rows per level; -1 = log2_hashmap_size - 3

    def __post_init__(self):
        if self.i_embed not in (EMBED_IDENTITY, EMBED_POSITIONAL, EMBED_HASH, EMBED_SH):
            raise ValueError(f"unknown i_embed {self.i_embed} (-1, 0, 1 or 2)")
        if self.use_viewdirs and self.i_embed_views not in (EMBED_IDENTITY, EMBED_POSITIONAL,
                                                            EMBED_SH):
            raise ValueError(f"unsupported i_embed_views {self.i_embed_views} (-1, 0 or 2)")

    @property
    def positional(self) -> PositionalConfig:
        return PositionalConfig(num_freqs=self.multires, max_freq_log2=self.multires - 1)

    @property
    def positional_views(self) -> PositionalConfig:
        return PositionalConfig(num_freqs=self.multires_views,
                                max_freq_log2=self.multires_views - 1)

    @property
    def input_ch(self) -> int:
        if self.i_embed == EMBED_HASH:
            return self.hash_grid.out_dim
        if self.i_embed == EMBED_SH:
            return sh_out_dim(self.sh_degree)
        return self.positional.out_dim if self.i_embed == EMBED_POSITIONAL else 3

    @property
    def input_ch_views(self) -> int:
        if not self.use_viewdirs:
            return 0
        if self.i_embed_views == EMBED_SH:
            return sh_out_dim(self.sh_degree)
        return self.positional_views.out_dim if self.i_embed_views == EMBED_POSITIONAL else 3

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

    def mlp_config(self, fine: bool = False):
        """The coarse (or fine) MLP's config: NeRFSmall's under the hash
        grid, else NeRF's."""
        if self.i_embed == EMBED_HASH:
            return NeRFSmallConfig(input_ch=self.input_ch, input_ch_views=self.input_ch_views,
                                   compute_dtype=self.compute_dtype)
        return NeRFConfig(
            D=self.netdepth_fine if fine else self.netdepth,
            W=self.netwidth_fine if fine else self.netwidth,
            input_ch=self.input_ch, input_ch_views=self.input_ch_views,
            output_ch=5 if self.N_importance > 0 else 4, use_viewdirs=self.use_viewdirs,
            compute_dtype=self.compute_dtype,
        )

    def make_mlp(self, fine: bool, generator=None, device=None) -> nn.Module:
        if self.i_embed == EMBED_HASH:
            return NeRFSmall(self.mlp_config(fine), generator, device)
        cls = NeRFGradient if self.use_gradient else NeRF
        return cls(self.mlp_config(fine), generator, device)


class NGPState(nn.Module):
    """All learnable state: hash_table ((L, 2^T, F), {"dense", "fine"}
    under packed_layout, or None without the hash grid), coarse, fine (or
    None)."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.i_embed != EMBED_HASH:
            self.hash_table = None
        elif cfg.packed_layout:
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
        self.coarse = cfg.make_mlp(False, generator, device)
        has_fine = cfg.N_importance > 0 and not cfg.share_fine
        self.fine = cfg.make_mlp(True, generator, device) if has_fine else None

    def table_parameters(self) -> List[nn.Parameter]:
        if self.hash_table is None:
            return []
        if isinstance(self.hash_table, nn.ParameterDict):
            return list(self.hash_table.values())
        return [self.hash_table]

    def net_parameters(self) -> List[nn.Parameter]:
        nets = [self.coarse] + ([self.fine] if self.fine is not None else [])
        return [p for n in nets for p in n.parameters()]

    def encode_hash(self, x: torch.Tensor, bbox: torch.Tensor):
        """The per-corner table's encode of points x (N, 3): (features
        (N, L*F), keep (N,)); K2 forward and K6 backward on the card. The
        level-sharded state (parallel/table_sharded.py) encodes its own
        levels and gathers the rest."""
        return hash_encode(self.hash_table, x, bbox[0].contiguous(), bbox[1].contiguous(),
                           self.resolutions)


def query_fn(state: NGPState, pts, viewdirs, bbox, fine: bool = False) -> torch.Tensor:
    """Encode points (+ view directions), run the MLP, zero sigma outside
    the bbox (the hash grid's keep mask). pts (R, S, 3), viewdirs (R, 3) or
    None, bbox (2, 3) -> raw (R, S, C): C 4, or NeRF's output_ch without
    viewdirs, or 7 for NeRFGradient."""
    with annotate("hn.query"):
        cfg = state.cfg
        R, S = pts.shape[0], pts.shape[1]
        flat = pts.reshape(-1, 3).contiguous()
        keep = None  # every point kept
        with annotate("hn.encode"):
            if cfg.i_embed == EMBED_IDENTITY:
                embedded = flat
            elif cfg.i_embed == EMBED_POSITIONAL:
                embedded = positional_encode(flat, cfg.positional)
            elif cfg.i_embed == EMBED_SH:
                embedded = sh_encode(flat, cfg.sh_degree)
            elif cfg.packed_layout:
                embedded, keep = packed_encode(state.hash_table, flat, bbox[0], bbox[1],
                                               state.packed_cfg)
            else:
                embedded, keep = state.encode_hash(flat, bbox)
        views = None
        if cfg.use_viewdirs and viewdirs is not None:
            # once a ray: the MLP widens the encoding to the ray's S samples
            count("views_per_ray")
            views = viewdirs
            if cfg.i_embed_views == EMBED_SH:
                views = sh_encode(viewdirs, cfg.sh_degree)
            elif cfg.i_embed_views == EMBED_POSITIONAL:
                views = positional_encode(viewdirs, cfg.positional_views)
        mlp = state.fine if (fine and state.fine is not None) else state.coarse
        count("mlp_points", R * S)
        with annotate("hn.mlp"):
            raw = mlp.forward_rays(embedded, views, S, keep)
        return raw.reshape(R, S, raw.shape[-1])
