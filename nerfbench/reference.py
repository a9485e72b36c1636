"""The plain reference: the benchmarked training step and render in plain
PyTorch, at the configuration's published widths.

It imports nothing of the program under test. It is a frozen copy of the
program's plain routes, written out op by op so that it rounds as they do:
ray sampling, the ray-box clip, stratified and hierarchical sampling
(`sample_pdf`), the hash-grid encode (per corner, or the corner-packed
layout), the spherical-harmonics view encoding, the NeRFSmall MLPs (float32,
or with operands rounded to a narrower type), volume compositing with the
entropy sparsity term, block occupancy culling, the total-variation
regularizers and RAdam. Every random number of a training step is drawn
from a generator in the order the step draws them, so that a generator in
the state the program's was in gives the reference the program's batch and
jitter. A step that trains from a ray pool takes the pool's rows instead,
made from the scene (`Reference.pool_rows`), and draws the rest.

Every function takes plain tensors: the benchmark makes the weights from
the seed and hands the same ones to both sides.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LOW32 = 0xFFFFFFFF
PRIMES = (1, 2654435761, 805459861)
# corner n of a voxel: offsets (n >> 2, (n >> 1) & 1, n & 1)
BOX = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]
# NeRFSmall, as (out, in) weights without biases: the sigma net
# L*F (32) -> 64 -> 1 + 15, the color net (16 SH + 15 geo) -> 64 -> 64 -> 3
COLOR_NET = ((64, 31), (64, 64), (3, 64))
NET_LAYERS = ("sigma.0", "sigma.1", "color.0", "color.1", "color.2")
ADAM_BETAS = (0.9, 0.99)


# --------------------------------------------------------------------------
# Sizes
# --------------------------------------------------------------------------
def level_resolutions(base: int, finest: int, n_levels: int) -> Tuple[int, ...]:
    """floor(base * b**i) with b = exp((ln finest - ln base) / (L - 1)), in
    float32 (Instant-NGP's geometric progression of grid resolutions)."""
    base_f, fin_f = np.float32(base), np.float32(finest)
    b = np.float32(np.exp((np.log(fin_f, dtype=np.float32) - np.log(base_f, dtype=np.float32))
                          / np.float32(n_levels - 1)))
    return tuple(int(np.floor(base_f * b ** np.float32(i))) for i in range(n_levels))


class Grid:
    """The encoding's sizes from a configuration's settings."""

    def __init__(self, s: dict):
        self.L = s["n_levels"]
        self.F = s["n_features_per_level"]
        self.log2T = s["log2_hashmap_size"]
        self.T = 1 << self.log2T
        self.base = s.get("base_resolution", 16)
        self.finest = s["finest_res"]
        self.res = level_resolutions(self.base, self.finest, self.L)
        self.packed = bool(s.get("packed_layout", False))
        n_dense = 0
        if self.packed:
            for r in self.res:
                if (r + 1) ** 3 > self.T:
                    break
                n_dense += 1
        self.dense_res = self.res[:n_dense]
        self.fine_res = self.res[n_dense:]
        self.dense_offsets = [0]
        for r in self.dense_res:
            self.dense_offsets.append(self.dense_offsets[-1] + (r + 1) ** 3)
        lb = s.get("log2_blocks", -1)
        self.log2_blocks = lb if lb > 0 else self.log2T - 3
        self.n_block_rows = 1 << self.log2_blocks

    @property
    def out_dim(self) -> int:
        return self.L * self.F

    def table_shapes(self) -> Dict[str, tuple]:
        if not self.packed:
            return {"table": (self.L, self.T, self.F)}
        out = {}
        if self.dense_res:
            out["dense"] = (self.dense_offsets[-1], self.F)
        if self.fine_res:
            out["fine_table"] = (len(self.fine_res) * self.n_block_rows, 27 * self.F)
        return out


def net_shapes(in_dim: int = 32) -> Tuple[tuple, ...]:
    """NeRFSmall's layers (out, in) over an encoding of in_dim features."""
    return ((64, in_dim), (16, 64)) + COLOR_NET


def leaf_shapes(s: dict) -> Dict[str, tuple]:
    """Every trained tensor of the configuration, by the benchmark's names:
    the table(s), then the coarse net's layers, then the fine net's."""
    g = Grid(s)
    out = dict(g.table_shapes())
    nets = ["coarse"] + (["fine"] if s["N_importance"] > 0 and not s.get("share_fine") else [])
    for net in nets:
        for name, shape in zip(NET_LAYERS, net_shapes(g.out_dim)):
            out[f"{net}.{name}"] = shape
    return out


def is_table(name: str) -> bool:
    return "." not in name


def initial_weights(s: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights a run starts from, made on the device from the seed, one
    draw a tensor: tables U(-1e-4, 1e-4) (Instant-NGP's initialization),
    each layer U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (nn.Linear's bound)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape in leaf_shapes(s).items():
        bound = 1e-4 if is_table(name) else 1.0 / math.sqrt(shape[1])
        out[name] = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
            -bound, bound, generator=gen)
    return out


# --------------------------------------------------------------------------
# Encodings
# --------------------------------------------------------------------------
def spatial_hash(c: torch.Tensor, log2_size: int) -> torch.Tensor:
    """Teschner's hash of int64 coordinates (..., 3), in 32 bits."""
    acc = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for i in range(c.shape[-1]):
        acc = acc ^ ((c[..., i] * (PRIMES[i] & LOW32)) & LOW32)
    return acc & ((1 << log2_size) - 1)


def corner_weights(w: torch.Tensor) -> List[torch.Tensor]:
    """The 8 trilinear weights of fractions w (N, 3), in BOX order."""
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    return [(wx if i else 1.0 - wx) * (wy if j else 1.0 - wy) * (wz if k else 1.0 - wz)
            for i, j, k in BOX]


def _clip(x, bmin, bmax):
    keep = torch.all((x >= bmin) & (x <= bmax), dim=-1)
    return torch.minimum(torch.maximum(x, bmin), bmax), keep


def hash_corners(xc: torch.Tensor, bmin, bmax, res: int, log2T: int):
    """Level-local rows (N, 8) and weights [8 x (N,)] of the per-corner
    hash grid at resolution res; geometry in the order grid = extent / res,
    rel = (x - bmin) / grid, floor, minv = b * grid + bmin, w = (x - minv) / grid."""
    grid = (bmax - bmin) / torch.full_like(bmin, float(res))
    rel = (xc - bmin) / grid
    bl = torch.floor(rel).to(torch.int32)
    minv = bl.to(xc.dtype) * grid + bmin
    w = (xc - minv) / grid
    offs = torch.tensor(BOX, dtype=torch.int64, device=xc.device)
    rows = spatial_hash(bl.to(torch.int64)[:, None, :] + offs[None], log2T)
    return rows, corner_weights(w)


def packed_voxel(xc: torch.Tensor, bmin, bmax, res: int):
    """Voxel (N, 3) int64, clipped to the grid, and the 8 weights at rel - b."""
    grid = (bmax - bmin) / torch.full_like(bmin, float(res))
    rel = (xc - bmin) / grid
    b = torch.clamp(torch.floor(rel).to(torch.int64), 0, res - 1)
    return b, corner_weights(rel - b.to(rel.dtype))


def dense_rows(b: torch.Tensor, res: int, offset: int) -> torch.Tensor:
    """Rows (N, 8) of a dense level's vertex table at the voxel's corners."""
    offs = torch.tensor(BOX, dtype=torch.int64, device=b.device)
    v = b[:, None, :] + offs[None]
    return (v[..., 0] * (res + 1) + v[..., 1]) * (res + 1) + v[..., 2] + offset


def fine_rows_slots(b: torch.Tensor, g: "Grid", li: int):
    """Slab row (N,) of a fine level (hash of the 2x2x2 macro-block) and
    the 8 live slots (N, 8) of the voxel's corners in its 3x3x3 slab."""
    row = spatial_hash(b >> 1, g.log2_blocks) + li * g.n_block_rows
    p = b & 1
    base = p[:, 0] * 9 + p[:, 1] * 3 + p[:, 2]
    slot = torch.tensor([i * 9 + j * 3 + k for i, j, k in BOX], dtype=torch.int64, device=b.device)
    return row, base[:, None] + slot[None]


def encode(tables: Dict[str, torch.Tensor], x: torch.Tensor, bbox: torch.Tensor, g: Grid):
    """Features (N, L*F) in level order and the in-box mask (N,)."""
    bmin, bmax = bbox[0], bbox[1]
    xc, keep = _clip(x, bmin, bmax)
    feats = []
    if not g.packed:
        table = tables["table"]
        for l, res in enumerate(g.res):
            rows, cw = hash_corners(xc, bmin, bmax, res, g.log2T)
            emb = table[l][rows]  # (N, 8, F)
            feats.append(sum(cw[c][:, None] * emb[:, c] for c in range(8)))
        return torch.cat(feats, -1), keep
    for li, res in enumerate(g.dense_res):
        b, cw = packed_voxel(xc, bmin, bmax, res)
        emb = tables["dense"][dense_rows(b, res, g.dense_offsets[li])]
        feats.append(sum(cw[c][:, None] * emb[:, c] for c in range(8)))
    if g.fine_res:
        slabs = tables["fine_table"].reshape(-1, 27, g.F)
        for li, res in enumerate(g.fine_res):
            b, cw = packed_voxel(xc, bmin, bmax, res)
            row, slots = fine_rows_slots(b, g, li)
            emb = slabs[row[:, None], slots]  # (N, 8, F)
            feats.append(sum(cw[c][:, None] * emb[:, c] for c in range(8)))
    return torch.cat(feats, -1), keep


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 values) at unit d (N, 3)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    out = [torch.full_like(x, 0.28209479177387814),
           -0.4886025119029199 * y, 0.4886025119029199 * z, -0.4886025119029199 * x,
           1.0925484305920792 * xy, -1.0925484305920792 * yz,
           0.31539156525252005 * (2.0 * zz - xx - yy), -1.0925484305920792 * xz,
           0.5462742152960396 * (xx - yy),
           -0.5900435899266435 * y * (3 * xx - yy), 2.890611442640554 * xy * z,
           -0.4570457994644658 * y * (4 * zz - xx - yy),
           0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy),
           -0.4570457994644658 * x * (4 * zz - xx - yy), 1.445305721320277 * z * (xx - yy),
           -0.5900435899266435 * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def mlp(w: List[torch.Tensor], x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """NeRFSmall: x (N, L*F + 16) -> (N, 4) = [rgb logits, sigma]. With
    dtype, each layer's input and weight are rounded to it and multiplied
    in float32."""
    def lin(h, wt):
        if dtype is None:
            return F.linear(h, wt)
        return F.linear(h.to(dtype).float(), wt.to(dtype).float())

    d = w[0].shape[1]
    h = torch.relu(lin(x[:, :d], w[0]))
    h = lin(h, w[1])
    sigma, geo = h[:, :1], h[:, 1:]
    h = torch.cat([x[:, d:d + 16], geo], -1)
    h = torch.relu(lin(h, w[2]))
    h = torch.relu(lin(h, w[3]))
    return torch.cat([lin(h, w[4]), sigma], -1)


# --------------------------------------------------------------------------
# Sampling and compositing
# --------------------------------------------------------------------------
def linspace01(n: int, device) -> torch.Tensor:
    """i / (n - 1) with a tensor divisor, then exactly 1."""
    i = torch.arange(n - 1, device=device, dtype=torch.float32)
    return torch.cat([i / torch.full_like(i, float(n - 1)),
                      torch.ones(1, device=device, dtype=torch.float32)])


def ray_box(rays_o, rays_d, bbox, near, far):
    """[near, far] tightened to the ray's bbox crossing (slab test); a ray
    that misses collapses to [near, near + 1e-3]."""
    inv = torch.where(rays_d.abs() > 1e-10, 1.0 / rays_d, torch.full_like(rays_d, 1e10))
    t1 = (bbox[0] - rays_o) * inv
    t2 = (bbox[1] - rays_o) * inv
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    lo = torch.minimum(torch.maximum(tmin, near), far)
    hi = torch.minimum(torch.maximum(tmax, near), far)
    hit = tmax > torch.clamp(tmin, min=0.0)
    return (torch.where(hit, lo, near),
            torch.where(hit, torch.maximum(hi, lo + 1e-4), near + 1e-3))


def sample_pdf(bins, weights, n: int, u: Optional[torch.Tensor]):
    """Inverse-CDF samples of the piecewise-constant pdf of weights; u None
    takes the deterministic u = linspace(0, 1, n)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = linspace01(n, cdf.device).expand(cdf.shape[:-1] + (n,))
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def composite(raw, z, rays_d, white_bkgd: bool):
    """(rgb (R, 3), weights (R, S), entropy sparsity (R,))."""
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
                          -1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, -1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    p = torch.cat([weights, 1.0 - acc[..., None] + 1e-6], dim=-1)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    fi = torch.finfo(p.dtype)
    sparsity = -torch.sum(p * torch.log(torch.clamp(p, fi.tiny, 1.0 - fi.eps)), dim=-1)
    return rgb_map, weights, sparsity


def pixel_rays(K: torch.Tensor, c2w: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Rays (rays_o, rays_d), each (N, 3), at pixels (ys, xs) of the camera
    c2w (3, 4), or of each pixel's own camera (N, 3, 4): pinhole rays in
    the blender convention, directions not normalized."""
    dirs = torch.stack([(xs.float() - K[0, 2]) / K[0, 0], -(ys.float() - K[1, 2]) / K[1, 1],
                        -torch.ones_like(xs, dtype=torch.float32)], -1)
    rays_d = torch.sum(dirs[:, None, :] * c2w[..., :3, :3], -1)
    return c2w[..., :3, -1].expand(rays_d.shape), rays_d


def keep_k(n: int, kf: float) -> int:
    """A pass's global budget: int(n * kf) rounded up to 128, at most n."""
    return min(n, -(-int(n * kf) // 128) * 128)


def occupancy_scores(grid, pts, bbox, R: int):
    """Each point's cell of the (R^3,) grid; points outside the box -1."""
    rel = (pts - bbox[0]) / (bbox[1] - bbox[0])
    ijk = torch.clamp((rel * R).to(torch.int32), 0, R - 1).to(torch.int64)
    s = grid[(ijk[..., 0] * R + ijk[..., 1]) * R + ijk[..., 2]]
    inside = torch.all((pts >= bbox[0]) & (pts <= bbox[1]), dim=-1)
    return torch.where(inside, s, torch.full_like(s, -1.0))


def keep_at(s: dict, step: int) -> float:
    """The fine keep fraction at global step `step` (the keep schedule)."""
    keep = s["occ_keep_fraction"]
    for tok in (s.get("occ_keep_schedule") or "").split(","):
        if tok:
            at, frac = tok.split(":")
            if step >= int(at):
                keep = float(frac)
    return keep


# --------------------------------------------------------------------------
# The model: weights, settings and the scene's tensors
# --------------------------------------------------------------------------
class Reference:
    """The reference of one configuration.

    `dtype` rounds the MLP operands (None: float32 products, or the
    configuration's compute_dtype); `half_batch` takes each image loss over
    the first half of the rays only (a planted fault)."""

    def __init__(self, s: dict, scene: dict, device, dtype: Optional[torch.dtype] = "config",
                 half_batch: bool = False):
        self.s = s
        self.g = Grid(s)
        self.sc = scene  # images (N,H,W,3), poses (N,3,4), K (3,3), bbox (2,3), near, far
        self.device = device
        if dtype == "config":
            cd = s.get("compute_dtype") or "float32"
            dtype = None if cd == "float32" else getattr(torch, cd)
        self.dtype = dtype
        self.half_batch = half_batch
        self.share = bool(s.get("share_fine")) or s["N_importance"] == 0

    # -- one query of the field --
    def query(self, p, pts, viewdirs, fine: bool):
        R, S = pts.shape[0], pts.shape[1]
        feats, keep = encode(p, pts.reshape(-1, 3), self.sc["bbox"], self.g)
        dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
        x = torch.cat([feats, sh_encode(dirs)], -1)
        net = "coarse" if (self.share or not fine) else "fine"
        raw = mlp([p[f"{net}.{n}"] for n in NET_LAYERS], x, self.dtype)
        sigma = torch.where(keep, raw[:, 3], torch.zeros_like(raw[:, 3]))
        return torch.cat([raw[:, :3], sigma[:, None]], -1).reshape(R, S, 4)

    def query_culled(self, p, pts, viewdirs, scores, k: int, fine: bool):
        """The k best-scoring points, in blocks of occ_block consecutive
        samples of a ray (scored by their maximum, stable order); the rest
        read raw 0."""
        R, S = pts.shape[0], pts.shape[1]
        B = self.s["occ_block"]
        nb = R * S // B
        kept = torch.argsort(-scores.reshape(nb, B).amax(-1), stable=True)[:k // B]
        raw_k = self.query(p, pts.reshape(nb, B, 3)[kept], viewdirs[kept // (S // B)], fine)
        raw = torch.zeros((nb, B, 4), dtype=raw_k.dtype, device=raw_k.device)
        return raw.index_put((kept,), raw_k).reshape(R, S, 4)

    # -- one batch of rays --
    def render_rays(self, p, rays_o, rays_d, viewdirs, gen=None, occ=None):
        """gen: training (perturbed, its draws from gen); None: eval. occ =
        (grid, fine keep, coarse keep) culls both passes."""
        s, sc = self.s, self.sc
        R, Ns, Ni = rays_o.shape[0], s["N_samples"], s["N_importance"]
        dev = rays_o.device
        t_strat = u_pdf = None
        if gen is not None:
            t_strat = torch.rand((R, Ns), generator=gen, device=dev)
            if Ni > 0:
                u_pdf = torch.rand((R, Ni), generator=gen, device=dev)
        near = torch.full((R,), float(sc["near"]), device=dev)
        far = torch.full((R,), float(sc["far"]), device=dev)
        if s.get("aabb_clip"):
            near, far = ray_box(rays_o, rays_d, sc["bbox"], near, far)
        t = linspace01(Ns, dev)
        z = near[:, None] * (1.0 - t) + far[:, None] * t
        if t_strat is not None:
            mids = 0.5 * (z[..., 1:] + z[..., :-1])
            upper = torch.cat([mids, z[..., -1:]], -1)
            lower = torch.cat([z[..., :1], mids], -1)
            z = lower + (upper - lower) * t_strat

        def points(zz):
            return rays_o[:, None, :] + rays_d[:, None, :] * zz[..., None]

        R_occ = s.get("occ_resolution", 128)
        if occ is not None:
            grid, keep_f, keep_c = occ
            sc_c = occupancy_scores(grid, points(z).reshape(-1, 3), sc["bbox"], R_occ).reshape(z.shape)
            raw = self.query_culled(p, points(z), viewdirs, sc_c, keep_k(R * Ns, keep_c), False)
        else:
            raw = self.query(p, points(z), viewdirs, False)
        rgb0, w0, sp0 = composite(raw, z, rays_d, s["white_bkgd"])
        if Ni == 0:
            return rgb0, None, sp0, None
        zs = sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), w0[..., 1:-1], Ni, u_pdf).detach()
        if occ is not None:
            s_new = occupancy_scores(grid, points(zs).reshape(-1, 3), sc["bbox"], R_occ).reshape(zs.shape)
            z, perm = torch.sort(torch.cat([z, zs], -1), dim=-1, stable=True)
            sc_f = torch.gather(torch.cat([sc_c, s_new], -1), -1, perm)
            raw = self.query_culled(p, points(z), viewdirs, sc_f, keep_k(R * (Ns + Ni), keep_f), True)
        else:
            z = torch.sort(torch.cat([z, zs], -1), dim=-1).values
            raw = self.query(p, points(z), viewdirs, True)
        rgb, _, sp = composite(raw, z, rays_d, s["white_bkgd"])
        return rgb, rgb0, sp, sp0

    # -- training --
    def batch(self, gen, precrop: bool):
        """One step's rays: an image uniform over the training views, then
        N_rand of its pixels without replacement (the first of a stable
        argsort of uniform keys), within the centre crop while precrop."""
        sc, n = self.sc, self.s["N_rand"]
        dev = self.device
        N, H, W = sc["images"].shape[:3]
        pick = torch.randint(0, N, (1,), generator=gen, device=dev)
        y0, x0, nH, nW = 0, 0, H, W
        if precrop:
            f = self.s["precrop_frac"]
            dH, dW = int(H // 2 * f), int(W // 2 * f)
            y0, x0, nH, nW = H // 2 - dH, W // 2 - dW, 2 * dH, 2 * dW
        keys = torch.rand(nH * nW, generator=gen, device=dev)
        sel = torch.argsort(keys, stable=True)[:n]
        ys, xs = y0 + sel // nW, x0 + sel % nW
        rays_o, rays_d = pixel_rays(sc["K"], sc["poses"].index_select(0, pick)[0], ys, xs)
        target = sc["images"].reshape(-1, 3).index_select(0, (pick * H + ys) * W + xs)
        return rays_o, rays_d, rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True), target

    def pool_rows(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Rows ids of the ray pool the scene trains from, made from the
        scene: its "pool" columns, or else pixel ids of its training views,
        in image, row, column order, with each pixel's ray and colour (the
        layout of the program's image pool)."""
        sc = self.sc
        if "pool" in sc:
            return {name: col.index_select(0, ids) for name, col in sc["pool"].items()}
        H, W = sc["images"].shape[1:3]
        img, pix = ids // (H * W), ids % (H * W)
        rays_o, rays_d = pixel_rays(sc["K"], sc["poses"].index_select(0, img), pix // W, pix % W)
        return {"rays_o": rays_o, "rays_d": rays_d,
                "target": sc["images"].reshape(-1, 3).index_select(0, ids)}

    def loss(self, p, gen, precrop: bool, tv: bool, occ=None, rows=None):
        """One step's loss; its batch is `rows` (rays_o, rays_d, target) where
        given, else drawn from gen as the image sampler draws it."""
        s = self.s
        if rows is None:
            rays_o, rays_d, viewdirs, target = self.batch(gen, precrop)
        else:
            rays_o, rays_d, target = rows["rays_o"], rows["rays_d"], rows["target"]
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        rgb, rgb0, sp, sp0 = self.render_rays(p, rays_o, rays_d, viewdirs, gen, occ)
        use = slice(0, rays_o.shape[0] // 2) if self.half_batch else slice(None)

        def mse(x):
            return torch.mean((x[use] - target[use]) ** 2)

        loss = mse(rgb)
        if rgb0 is not None:
            loss = loss + mse(rgb0)
        sparsity = sp.sum() + (sp0.sum() if sp0 is not None else 0.0)
        loss = loss + s["sparse_loss_weight"] * sparsity
        if tv:
            loss = loss + s["tv_loss_weight"] * self.tv(p, gen)
        return loss

    def tv(self, p, gen):
        """The hash grid's random-cuboid total variation (the packed
        layout's: exact cuboids of its dense levels, slab differences of
        random block rows of its fine levels)."""
        g, dev = self.g, self.device
        total = torch.zeros((), dtype=torch.float32, device=dev)

        def geometry(level: int):
            b = math.exp((math.log(g.finest) - math.log(g.base)) / (g.L - 1))
            res = int(math.floor(g.base * b ** level))
            return res, int(math.floor(min(max(res / 10.0, g.base - 1), 50)))

        def cube_tv(cube, size):
            return (torch.sum((cube[1:] - cube[:-1]) ** 2) + torch.sum((cube[:, 1:] - cube[:, :-1]) ** 2)
                    + torch.sum((cube[:, :, 1:] - cube[:, :, :-1]) ** 2)) / size

        if not g.packed:
            corners = []
            for l in range(g.L):
                res, cube = geometry(l)
                corners.append(torch.randint(0, res - cube, (3,), generator=gen, device=dev))
            flat = p["table"].reshape(g.L * g.T, g.F)
            for l in range(g.L):
                _, cube = geometry(l)
                idx = corners[l][None, :] + torch.arange(cube + 1, device=dev)[:, None]
                c = torch.stack(torch.meshgrid(idx[:, 0], idx[:, 1], idx[:, 2], indexing="ij"), -1)
                rows = spatial_hash(c, g.log2T) + l * g.T
                total = total + cube_tv(flat.index_select(0, rows.reshape(-1)).reshape(
                    cube + 1, cube + 1, cube + 1, g.F), cube)
            return total
        corners = []
        for li, res in enumerate(g.dense_res):
            _, cube = geometry(li)
            hi = max(res - min(cube, res), 1)
            corners.append(torch.randint(0, hi, (3,), generator=gen, device=dev))
        n_fine = len(g.fine_res)
        k_rows = max(4096 // n_fine, 512) if n_fine else 0
        rows = torch.randint(0, g.n_block_rows, (n_fine, k_rows), generator=gen, device=dev)
        for li, res in enumerate(g.dense_res):
            _, cube = geometry(li)
            cube = min(cube, res)
            idx = corners[li][None, :] + torch.arange(cube + 1, device=dev)[:, None]
            gx, gy, gz = torch.meshgrid(idx[:, 0], idx[:, 1], idx[:, 2], indexing="ij")
            v = (gx * (res + 1) + gy) * (res + 1) + gz + g.dense_offsets[li]
            total = total + cube_tv(p["dense"].index_select(0, v.reshape(-1)).reshape(
                cube + 1, cube + 1, cube + 1, g.F), cube)
        if n_fine:
            weights = []
            for fi in range(n_fine):
                _, cube = geometry(len(g.dense_res) + fi)
                weights.append((float(cube) ** 3 / (k_rows * 18.0)) / cube)
            r = rows + g.n_block_rows * torch.arange(n_fine, device=dev)[:, None]
            slabs = p["fine_table"].index_select(0, r.reshape(-1)).reshape(n_fine, k_rows, 3, 3, 3, g.F)
            per_level = (torch.sum((slabs[:, :, 1:] - slabs[:, :, :-1]) ** 2, dim=(1, 2, 3, 4, 5))
                         + torch.sum((slabs[:, :, :, 1:] - slabs[:, :, :, :-1]) ** 2, dim=(1, 2, 3, 4, 5))
                         + torch.sum((slabs[..., 1:, :] - slabs[..., :-1, :]) ** 2, dim=(1, 2, 3, 4, 5)))
            total = total + torch.dot(per_level, torch.tensor(weights, dtype=torch.float32, device=dev))
        return total

    def radam(self, p, st, grads):
        """One RAdam step (betas 0.9 / 0.99; the table without weight decay
        at eps 1e-15, the nets with decoupled decay 1e-6 at eps 1e-8; no
        update while N_sma < 5; lr = lrate * 0.1^(t / (decay * 1000)) at the
        count t before the step)."""
        b1, b2 = ADAM_BETAS
        s = self.s
        groups = {"net": [n for n in p if not is_table(n)], "table": [n for n in p if is_table(n)]}
        with torch.no_grad():
            for gname, names in groups.items():
                eps, wd = (1e-8, 1e-6) if gname == "net" else (1e-15, 0.0)
                step = st["step"][gname]
                for n in names:
                    gr = grads[n]
                    st["m"][n].mul_(b1).add_(gr * (1 - b1))
                    g2 = gr * (1 - b2)
                    g2.mul_(gr)
                    st["v"][n].mul_(b2).add_(g2)
                lr = s["lrate"] * torch.pow(0.1, step / torch.full_like(step, float(s["lrate_decay"] * 1000)))
                t = step + 1.0
                omb2 = -torch.expm1(t * math.log(b2))
                beta2_t = 1.0 - omb2
                n_max = 2.0 / (1.0 - b2) - 1.0
                n_sma = n_max - 2.0 * t * beta2_t / omb2
                rect = torch.sqrt(omb2 * (n_sma - 4.0) / (n_max - 4.0) * (n_sma - 2.0) / n_sma
                                  * n_max / (n_max - 2.0))
                bias1 = -torch.expm1(t * math.log(b1))
                use = n_sma >= 5.0
                zero = torch.zeros_like(t)
                adaptive = torch.where(use, rect / bias1, zero)
                for n in names:
                    delta = st["m"][n] * adaptive
                    delta = delta / (torch.sqrt(st["v"][n]) + eps)
                    if wd != 0.0:
                        delta = delta + p[n] * torch.where(use, torch.full_like(t, wd), zero)
                    p[n].add_(delta * (-lr))
                st["step"][gname] = step + 1.0

    def train_steps(self, p, st, gen, step0: int, n: int, precrop: bool, occ_grid=None,
                    rows: Optional[Dict[str, torch.Tensor]] = None):
        """n training steps from global step step0, in place on the weights
        p and the optimizer state st {"m", "v", "step": {"net", "table"}}.
        rows: the n x N_rand rows of a ray pool the steps take, in turn
        (None: each step draws its batch from the images). Returns (losses,
        the gradients of the first step)."""
        s = self.s
        losses, first = [], None
        for k in range(n):
            step = step0 + k
            tv = step <= 1000 and s["tv_loss_weight"] > 0
            occ = None
            if occ_grid is not None:
                occ = (occ_grid, keep_at(s, step), s["occ_keep_coarse"])
            batch = None
            if rows is not None:
                batch = {c: v[k * s["N_rand"]:(k + 1) * s["N_rand"]] for c, v in rows.items()}
            leaves = {name: t.detach().requires_grad_(True) for name, t in p.items()}
            loss = self.loss(leaves, gen, precrop, tv, occ, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {name: (gr if gr is not None else torch.zeros_like(p[name]))
                     for name, gr in zip(leaves, grads)}
            if first is None:
                first = {name: gr.clone() for name, gr in grads.items()}
            self.radam(p, st, grads)
            losses.append(float(loss.detach()))
        return losses, first

    # -- rendering --
    @torch.no_grad()
    def render_frame(self, p, c2w: torch.Tensor, H: int, W: int, chunk: int = 4096):
        """The whole (H, W) view from c2w (3, 4), exact: no jitter, every
        sample queried. Returns rgb (H, W, 3)."""
        K, dev = self.sc["K"], self.device
        i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev),
                              torch.arange(H, dtype=torch.float32, device=dev), indexing="xy")
        dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)], -1)
        rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1).reshape(-1, 3)
        rays_o = c2w[:3, -1].expand(rays_d.shape)
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        out = [self.render_rays(p, rays_o[a:a + chunk], rays_d[a:a + chunk],
                                viewdirs[a:a + chunk])[0] for a in range(0, H * W, chunk)]
        return torch.cat(out).reshape(H, W, 3)
