"""Occupancy-grid sample culling (opt-in, --use_occupancy).

Counterpart of hashnerf_tpu/render/occupancy.py: a dense (R^3,) grid of
sigma EMAs over the scene bbox, updated every few steps (decay everywhere,
then a max at jittered sample cells queried from the live model); before
the network query, each pass keeps a static budget of its best-scoring
points and the culled ones read raw = 0 (sigma 0 is empty space).

Selection is exact and follows JAX's tie order. Ties are the common case:
every point outside the bbox scores -1, and all points of one cell share a
score, so the kept set is decided inside runs of equal scores.
- `cull_points` and `cull_per_ray` sort with a stable argsort of the
  negated scores, as JAX does (`jnp.argsort(-s, stable=True)`), on the CPU
  and on the card alike.
- The per-ray "topk" and "approx" selections take the same stable argsort.
  `lax.top_k` breaks ties toward the lower index, which is that order, and
  `torch.topk` promises no order among ties. `lax.approx_max_k` is exact
  top_k off the TPU, so on the card it selects the same set. So
  `per_ray_select` is only validated (OccupancyConfig).
- The top macro-blocks of the adaptive grid update are a stable argsort of
  the block maxima for the same reason.

Every random draw (update cells, block picks, offsets, jitter) can be
handed in through `OccUpdateDraws`; any draw left out comes from the
torch.Generator. query_with_culling's scores, cut and un-permute run in
`hn.cull` spans (utils/profiling.py); its query does not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from hashnerf_torch.kernels.gather import permute_rows
from hashnerf_torch.ops.sampling import linspace01
from hashnerf_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    """The fields and defaults of the JAX OccupancyConfig; see its comments
    for what each budget and mode measured on the TPU."""

    resolution: int = 128
    ema_decay: float = 0.95
    threshold: float = 1e-2
    update_every: int = 16
    n_update_samples: int = 1 << 16
    keep_fraction: float = 0.5
    warmup_steps: int = 256  # no culling until the grid has seen the field
    partition: str = "sort1"  # "sort2", "sort1" or "cumsum" (cull_points)
    adaptive_update: bool = False  # half the update cells near the surface
    per_ray: bool = False  # each ray keeps its own top-K samples
    per_ray_select: str = "sort"  # "sort", "topk" or "approx"
    keep_fraction_coarse: Optional[float] = None  # None = keep_fraction
    keep_fraction_eval: Optional[float] = None  # None = exact eval
    keep_fraction_eval_coarse: Optional[float] = None
    eval_transmittance: bool = False
    transmittance_cull: bool = False  # set by RenderConfig.eval_mode
    score_stride: int = 1  # score every k-th sample on the dilated grid
    block: int = 1  # global culling granularity in consecutive samples

    def __post_init__(self):
        # The strided scores rely on consecutive probes lying at most two
        # cells apart, so that each probe's 3^3 dilation covers the samples
        # between them. Beyond a stride of 2 that no longer holds at the
        # chair's sample spacing and occupied samples would be culled.
        if self.score_stride not in (1, 2):
            raise ValueError(
                f"occ_score_stride={self.score_stride}: only 1 or 2; the strided "
                "scores cover the samples between two probes with the grid's "
                "3^3 dilation, which needs the probes at most two cells apart"
            )
        # kept for the JAX flags; all three take the same stable argsort here
        if self.per_ray_select not in ("sort", "topk", "approx"):
            raise ValueError(f"per_ray_select {self.per_ray_select!r}")

    @property
    def n_cells(self) -> int:
        return self.resolution**3


class OccUpdateDraws(NamedTuple):
    """Injectable draws of one grid update (all optional).

    uniform_cells: (n,) cells in [0, R^3), or (n - n // 2,) with
      adaptive_update (JAX k_cell, or k_u under it);
    block_sel (n // 2,): positions in the list of top blocks (k_blk);
    offsets (n // 2, 3): cell offsets in [-1, R // 32] (k_off);
    jitter (n, 3) U[0,1): position inside each cell (k_jit).
    """

    uniform_cells: Optional[torch.Tensor] = None
    block_sel: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    jitter: Optional[torch.Tensor] = None


def init_occupancy_grid(cfg: OccupancyConfig, device=None) -> torch.Tensor:
    """Zeros: culling starts only after warmup, once updates filled it."""
    return torch.zeros((cfg.n_cells,), dtype=torch.float32, device=device)


def cell_index(pts: torch.Tensor, bbox: torch.Tensor, R: int) -> torch.Tensor:
    rel = (pts - bbox[0]) / (bbox[1] - bbox[0])
    ijk = torch.clamp((rel * R).to(torch.int32), 0, R - 1).to(torch.int64)
    return (ijk[..., 0] * R + ijk[..., 1]) * R + ijk[..., 2]


def _in_bbox(pts: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    return torch.all((pts >= bbox[0]) & (pts <= bbox[1]), dim=-1)


def occupancy_lookup(grid: torch.Tensor, pts: torch.Tensor, bbox: torch.Tensor,
                     cfg: OccupancyConfig) -> torch.Tensor:
    """bool (N,): the point's cell is above min(cfg.threshold, mean(grid))."""
    idx = cell_index(pts, bbox, cfg.resolution)
    thr = torch.clamp(torch.mean(grid), max=cfg.threshold)
    return grid[idx] > thr


def dilate_grid(grid: torch.Tensor, R: int) -> torch.Tensor:
    """3^3 max-pool (stride 1, SAME) of the flat (R^3,) grid."""
    g = F.max_pool3d(grid.reshape(1, 1, R, R, R), kernel_size=3, stride=1, padding=1)
    return g.reshape(-1)


def occupancy_scores_strided(grid_dilated: torch.Tensor, pts: torch.Tensor,
                             bbox: torch.Tensor, cfg: OccupancyConfig) -> torch.Tensor:
    """(R, S) scores from one dilated-grid fetch per score_stride samples
    of the ray-ordered pts (R, S, 3); samples outside the bbox score -1."""
    Rr, S = pts.shape[0], pts.shape[1]
    st = cfg.score_stride
    probes = torch.clamp(pts[:, ::st], bbox[0], bbox[1])  # (Rr, P, 3)
    cell = cell_index(probes.reshape(-1, 3), bbox, cfg.resolution)
    s_p = grid_dilated[cell].reshape(Rr, probes.shape[1])
    s_full = torch.repeat_interleave(s_p, st, dim=1)[:, :S]
    return torch.where(_in_bbox(pts, bbox), s_full, torch.full_like(s_full, -1.0))


def occupancy_scores(grid: torch.Tensor, pts: torch.Tensor, bbox: torch.Tensor,
                     cfg: OccupancyConfig) -> torch.Tensor:
    """float (N,): each point's cell EMA; points outside the bbox -1."""
    s = grid[cell_index(pts, bbox, cfg.resolution)]
    return torch.where(_in_bbox(pts, bbox), s, torch.full_like(s, -1.0))


def _cell_ijk(cells: torch.Tensor, R: int) -> torch.Tensor:
    return torch.stack([cells // (R * R), (cells // R) % R, cells % R], dim=-1)


def sample_update_cells(grid: torch.Tensor, cfg: OccupancyConfig,
                        draws: Optional[OccUpdateDraws] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Cell indices (int64) of one grid update.

    Uniform unless cfg.adaptive_update (and R % 32 == 0). Then the first
    n - n // 2 are uniform and the rest importance-sampled: the grid's 32^3
    macro-block maxima, the 1024 strongest blocks (stable order), a block
    drawn in proportion to its maximum, and a cell of that block grown by
    one cell on each side."""
    draws = draws or OccUpdateDraws()
    R, n, dev = cfg.resolution, cfg.n_update_samples, grid.device
    adaptive = cfg.adaptive_update and R % 32 == 0
    n_half = n // 2 if adaptive else 0
    uniform = draws.uniform_cells
    if uniform is None:
        uniform = torch.randint(0, cfg.n_cells, (n - n_half,), generator=generator, device=dev)
    uniform = uniform.to(device=dev, dtype=torch.int64)
    if not adaptive:
        return uniform

    B, S = 32, R // 32
    blocks = grid.reshape(B, S, B, S, B, S).amax(dim=(1, 3, 5)).reshape(-1)  # (32768,)
    top_idx = torch.argsort(-blocks, stable=True)[:1024]
    top_val = blocks[top_idx]
    sel = draws.block_sel
    if sel is None:
        probs = torch.softmax(torch.log(torch.clamp(top_val, min=0.0) + 1e-8), dim=0)
        sel = torch.multinomial(probs, n_half, replacement=True, generator=generator)
    blk = top_idx[sel.to(device=dev, dtype=torch.int64)]
    off = draws.offsets
    if off is None:
        off = torch.randint(-1, S + 1, (n_half, 3), generator=generator, device=dev)
    ijk = torch.clamp(_cell_ijk(blk, B) * S + off.to(device=dev, dtype=torch.int64), 0, R - 1)
    imp = (ijk[:, 0] * R + ijk[:, 1]) * R + ijk[:, 2]
    return torch.cat([uniform, imp])


@torch.no_grad()
def update_occupancy_grid(grid: torch.Tensor, bbox: torch.Tensor, cfg: OccupancyConfig,
                          sigma_fn: Callable[[torch.Tensor], torch.Tensor],
                          draws: Optional[OccUpdateDraws] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """EMA decay, then a max at the sampled cells of relu(sigma_fn(pts)),
    pts jittered inside each cell. sigma_fn: (N, 3) -> (N,)."""
    draws = draws or OccUpdateDraws()
    R = cfg.resolution
    cells = sample_update_cells(grid, cfg, draws, generator)
    u = draws.jitter
    if u is None:
        u = torch.rand((cfg.n_update_samples, 3), generator=generator, device=grid.device)
    ijk = _cell_ijk(cells, R).to(torch.float32)
    # a tensor divisor: CUDA PyTorch multiplies by a Python number's
    # reciprocal, which is not the quotient for R other than a power of two
    rel = (ijk + u.to(grid.device)) / torch.full_like(ijk, float(R))
    pts = bbox[0] + rel * (bbox[1] - bbox[0])
    sigma = torch.relu(sigma_fn(pts)).to(grid.dtype)
    return (grid * cfg.ema_decay).scatter_reduce_(0, cells, sigma, "amax", include_self=True)


def cull_per_ray(scores: torch.Tensor, K: int) -> torch.Tensor:
    """(R, K) int64: each ray's K best-scoring samples, ties toward the
    lower index, in ascending sample order: JAX's cull_per_ray under every
    per_ray_select (see the module docstring)."""
    kept = torch.argsort(-scores, dim=-1, stable=True)[..., :K]
    return torch.sort(kept, dim=-1).values


def _invert_permutation(order: torch.Tensor) -> torch.Tensor:
    """inv[order[j]] = j, by a scatter of distinct indices."""
    n = order.shape[0]
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(n, dtype=order.dtype, device=order.device))


def cull_points(occ: torch.Tensor, keep_k: int, mode: str = "sort1"):
    """Static-shape partition, best first: (kept_idx (K,), order (N,),
    inv_perm (N,)), all int64. A bool `occ` puts occupied points first, a
    float one sorts by descending score; both stable. inv_perm maps each
    point to its position in `order`.

    mode: "sort2" inverts `order` with a second argsort, "sort1" with a
    scatter, "cumsum" is `cull_points_cumsum`."""
    if mode == "cumsum":
        return cull_points_cumsum(occ, keep_k)
    if mode not in ("sort1", "sort2"):
        raise ValueError(f"partition {mode!r}")
    key = (~occ).to(torch.uint8) if occ.dtype == torch.bool else -occ
    order = torch.argsort(key, stable=True)
    if mode == "sort2":
        inv_perm = torch.argsort(order, stable=True)
    else:
        inv_perm = _invert_permutation(order)
    return order[:keep_k], order, inv_perm


def cull_points_cumsum(scores: torch.Tensor, keep_k: int, n_edges: int = 512):
    """Threshold partition: the lowest of n_edges evenly spaced score edges
    whose >= population fits the budget, then a stable partition of the
    points at or above it (index order) before the others. The marginal
    budget is filled in index order, as in JAX.

    JAX counts each edge's population with an (n_edges, N) comparison; a
    sort and a binary search give the same counts without it."""
    n = scores.shape[0]
    lo, hi = torch.min(scores), torch.max(scores)
    edges = lo + (hi - lo) * linspace01(n_edges, device=scores.device, dtype=scores.dtype)
    below = torch.searchsorted(torch.sort(scores).values, edges, right=False)
    count_ge = n - below
    fits = count_ge <= keep_k
    first = torch.argmax(fits.to(torch.int32))
    thr = torch.where(torch.any(fits), edges[first], edges[-1])

    mask = scores >= thr
    cm = torch.cumsum(mask.to(torch.int64), dim=0)
    ii = torch.arange(n, dtype=torch.int64, device=scores.device)
    dest = torch.where(mask, cm - 1, cm[-1] + (ii - cm))
    order = _invert_permutation(dest)
    return order[:keep_k], order, dest


def _query_kept(query, kept_idx: torch.Tensor, layout) -> torch.Tensor:
    """query(idx) -> raws of the kept items idx, for every item of kept_idx
    (k,). Under a data-parallel layout each rank queries its contiguous
    share of ceil(k / n) items (padded with item 0, whose extra raws are
    dropped) and the shares are gathered back in rank order; the gather's
    backward sums every rank's cotangent into each share
    (parallel/mesh.py::gather_shares)."""
    if layout is None or layout.data_group is None:
        return query(kept_idx)
    from hashnerf_torch.parallel.mesh import gather_shares

    k, n = kept_idx.shape[0], layout.n_data
    per = -(-k // n)
    if per * n != k:
        kept_idx = torch.cat([kept_idx, kept_idx.new_zeros(per * n - k)])
    mine = kept_idx[layout.data_index * per:(layout.data_index + 1) * per]
    return gather_shares(query(mine), layout)[:k]


def query_with_culling(query_fn, state, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                       bbox: torch.Tensor, grid: torch.Tensor, cfg: OccupancyConfig,
                       keep_k: int, fine: bool = False,
                       scores: Optional[torch.Tensor] = None, layout=None) -> torch.Tensor:
    """query_fn on the keep_k best-scoring of pts (Rr, S, 3) only; the rest
    get raw = 0. Returns (Rr, S, C).

    With cfg.block = B > 1 (S and keep_k multiples of B), runs of B
    consecutive samples of a ray are scored by their maximum and kept or
    culled together. `scores` (Rr*S,) skips the grid lookup when the caller
    has them. Given a data-parallel layout (parallel/mesh.py), pts are the
    whole batch's on every rank: every rank takes the one cut, queries its
    share of the kept blocks (or points) and gathers the others' raws, so
    that every rank returns the one-process raws (_query_kept)."""
    Rr, S = pts.shape[0], pts.shape[1]
    flat = pts.reshape(-1, 3)
    n = flat.shape[0]
    B = cfg.block
    blocks = B > 1 and S % B == 0 and keep_k % B == 0
    with annotate("hn.cull"):
        if scores is None:
            scores = occupancy_scores(grid, flat, bbox, cfg)
        else:
            scores = scores.reshape(-1)
        if blocks:
            nb, kb = n // B, keep_k // B
            kept_idx, order, inv_perm = cull_points(scores.reshape(nb, B).amax(dim=-1), kb,
                                                    mode=cfg.partition)
        else:
            kept_idx, order, inv_perm = cull_points(scores, keep_k, mode=cfg.partition)

    if blocks:
        def query(idx):
            dirs = None
            if viewdirs is not None:
                # a block never straddles two rays
                dirs = viewdirs[idx // (S // B)]  # (k, 3)
            return query_fn(state, flat.reshape(nb, B, 3)[idx], dirs, bbox, fine=fine)

        raw_kept = _query_kept(query, kept_idx, layout)  # (kb, B, C)
        C = raw_kept.shape[-1]
        with annotate("hn.cull"):
            raw_perm = torch.cat([raw_kept.reshape(kb, B * C),
                                  raw_kept.new_zeros((nb - kb, B * C))], dim=0)
            return permute_rows(raw_perm, inv_perm, order).reshape(Rr, S, C)

    def query(idx):
        if viewdirs is not None:
            # per-point directions: each kept point is a ray of one sample
            return query_fn(state, flat[idx][:, None, :], viewdirs[idx // S], bbox,
                            fine=fine).reshape(idx.shape[0], -1)
        return query_fn(state, flat[idx][None], None, bbox, fine=fine).reshape(idx.shape[0], -1)

    raw_kept = _query_kept(query, kept_idx, layout)
    C = raw_kept.shape[-1]
    with annotate("hn.cull"):
        # row j of raw_perm belongs to point order[j]; point i sits at inv_perm[i]
        raw_perm = torch.cat([raw_kept, raw_kept.new_zeros((n - keep_k, C))], dim=0)
        return permute_rows(raw_perm, inv_perm, order).reshape(Rr, S, C)
