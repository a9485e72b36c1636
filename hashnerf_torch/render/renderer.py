"""Volume renderer: stratified + hierarchical ray-march, chunked rendering.

Counterpart of hashnerf_tpu/render/renderer.py: `render` warps a
forward-facing scene's rays to NDC (`ndc`) after taking their view
directions; `aabb_clip` tightens each ray's [near, far] to the bbox; with an occupancy
config and a grid, each pass queries only its budget of best-scoring
samples (render/occupancy.py), globally (in blocks) or per ray;
`fast_merge` draws the importance samples sorted (JAX then merges them with
the stratified ones by rank; the port sorts either way). The JAX renderer
splits one key into k_strat, k_noise0, k_pdf and k_noise1; here each of
those draws is a tensor in
`RenderDraws` that the caller may hand in, and any draw left out is taken
from the torch.Generator.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from hashnerf_torch.ops.rays import get_ndc_rays, get_rays, ray_aabb_near_far
from hashnerf_torch.ops.sampling import (
    merge_sorted, perturb_z_vals, sample_pdf, sorted_uniform, stratified_z_vals,
)
from hashnerf_torch.ops.volume import raw2outputs
from hashnerf_torch.render.occupancy import (
    OccupancyConfig, cull_per_ray, dilate_grid, occupancy_scores, occupancy_scores_strided,
    query_with_culling,
)
from hashnerf_torch.utils.io import save_psnr_pickle, save_render_figures


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    N_samples: int = 64
    N_importance: int = 0
    perturb: bool = True
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    ndc: bool = False  # render() warps its rays to NDC (forward-facing scenes)
    use_viewdirs: bool = True
    aabb_clip: bool = False  # off = reference-exact z ranges
    # occupancy culling; None = exact evaluation of every sample
    occupancy: Optional[OccupancyConfig] = None
    # importance draws from sorted uniforms (another RNG stream, the same
    # law). Passes culled by an occupancy grid draw as without it.
    fast_merge: bool = False

    def eval_mode(self) -> "RenderConfig":
        """perturb off, noise off; with occupancy.keep_fraction_eval set,
        the eval budgets replace the training ones (and
        eval_transmittance turns on the transmittance cull)."""
        cfg = dataclasses.replace(self, perturb=False, raw_noise_std=0.0)
        occ = self.occupancy
        if occ is not None and occ.keep_fraction_eval is not None:
            cfg = dataclasses.replace(cfg, occupancy=dataclasses.replace(
                occ,
                keep_fraction=occ.keep_fraction_eval,
                keep_fraction_coarse=occ.keep_fraction_eval_coarse,
                transmittance_cull=occ.eval_transmittance,
            ))
        return cfg


class RenderDraws(NamedTuple):
    """Injectable random draws of one render_rays call (all optional).

    t_strat (R, N_samples) U[0,1): stratified jitter (JAX k_strat);
    noise0 (R, S0) N(0,1): coarse sigma noise (k_noise0), S0 the samples
      the coarse pass composites (N_samples, or K under per-ray culling);
    u_pdf (R, N_importance) U[0,1): importance-sampling draws (k_pdf);
    u_sorted (R, N_importance): fast_merge's sorted uniforms (k_pdf);
    noise1 (R, S1) N(0,1): fine sigma noise (k_noise1).
    """

    t_strat: Optional[torch.Tensor] = None
    noise0: Optional[torch.Tensor] = None
    u_pdf: Optional[torch.Tensor] = None
    u_sorted: Optional[torch.Tensor] = None
    noise1: Optional[torch.Tensor] = None


def keep_k(n: int, kf: float) -> int:
    """Global budget: int(n * kf) rounded up to a multiple of 128, at most n."""
    return min(n, -(-int(n * kf) // 128) * 128)


def keep_per_ray(S: int, kf: float) -> int:
    """Per-ray budget: int(S * kf) rounded up to a multiple of 8, in [1, S]."""
    return min(S, max(1, -(-int(S * kf) // 8) * 8))


def render_rays(
    state,
    query_fn: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    near,
    far,
    bbox: torch.Tensor,
    cfg: RenderConfig,
    draws: Optional[RenderDraws] = None,
    generator: Optional[torch.Generator] = None,
    occ_grid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Core per-batch ray march. rays_o/rays_d (R, 3); near/far (R,) or
    scalars; bbox (2, 3). Coarse-pass outputs are keyed rgb0/depth0/acc0/
    sparsity_loss0 when hierarchical sampling is on. With cfg.occupancy and
    occ_grid both set, each pass is culled to its keep budget."""
    draws = draws or RenderDraws()
    R = rays_o.shape[0]
    near = torch.as_tensor(near, dtype=rays_o.dtype, device=rays_o.device).expand(R)
    far = torch.as_tensor(far, dtype=rays_o.dtype, device=rays_o.device).expand(R)
    if cfg.aabb_clip:
        near, far = ray_aabb_near_far(rays_o, rays_d, bbox, near, far)

    occ = cfg.occupancy if occ_grid is not None else None
    per_ray = occ is not None and occ.per_ray

    def keep_fraction(fine: bool) -> float:
        if not fine and occ.keep_fraction_coarse is not None:
            return occ.keep_fraction_coarse
        return occ.keep_fraction

    grid_dilated = None
    if occ is not None and occ.score_stride > 1:
        grid_dilated = dilate_grid(occ_grid, occ.resolution)

    def score_z(z):
        """Occupancy score of every sample point at depths z (R, S)."""
        p = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        if grid_dilated is not None:
            return occupancy_scores_strided(grid_dilated, p, bbox, occ)
        return occupancy_scores(occ_grid, p.reshape(-1, 3), bbox, occ).reshape(z.shape)

    def march(z_vals, noise, fine, scores=None):
        """One pass: query and composite. Returns (VolumeOutputs, weights on
        the full z grid). Per-ray culling queries each ray's top-K samples,
        in z order, and composites them with their original intervals; the
        weights go back onto the full grid for the fine pass's PDF."""
        if not per_ray:
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            if occ is None:
                raw = query_fn(state, pts, viewdirs, bbox, fine=fine)
            else:
                n = pts.shape[0] * pts.shape[1]
                raw = query_with_culling(query_fn, state, pts, viewdirs, bbox, occ_grid, occ,
                                         keep_k(n, keep_fraction(fine)), fine=fine,
                                         scores=scores)
            out = raw2outputs(raw, z_vals, rays_d, cfg.raw_noise_std, cfg.white_bkgd,
                              noise=noise, generator=generator)
            return out, out.weights

        S = z_vals.shape[-1]
        K = keep_per_ray(S, keep_fraction(fine))
        if scores is None:
            scores = score_z(z_vals)
        idx = cull_per_ray(scores, K)  # (R, K), z order
        z_k = torch.gather(z_vals, -1, idx)
        dists_full = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                                torch.full_like(z_vals[..., :1], 1e10)], -1)
        pts_k = rays_o[:, None, :] + rays_d[:, None, :] * z_k[..., None]
        raw = query_fn(state, pts_k, viewdirs, bbox, fine=fine)
        out = raw2outputs(raw, z_k, rays_d, cfg.raw_noise_std, cfg.white_bkgd,
                          noise=noise, generator=generator,
                          dists=torch.gather(dists_full, -1, idx))
        w_full = torch.zeros_like(z_vals, dtype=out.weights.dtype).scatter(-1, idx, out.weights)
        return out, w_full

    z_vals = stratified_z_vals(near, far, cfg.N_samples, cfg.lindisp)
    if cfg.perturb:
        z_vals = perturb_z_vals(z_vals, draws.t_strat, generator)

    scores_c = score_z(z_vals) if occ is not None else None
    out, w_full = march(z_vals, draws.noise0, fine=False, scores=scores_c)

    ret = {}
    if cfg.N_importance > 0:
        ret.update(
            rgb0=out.rgb_map, depth0=out.depth_map, acc0=out.acc_map,
            sparsity_loss0=out.sparsity_loss,
        )
        z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        det = not cfg.perturb
        u_pdf = None if det else draws.u_pdf  # JAX draws nothing when det
        if occ is not None:
            # Score only the new samples and carry both score sets through
            # one sort keyed on z (JAX's multi-operand lax.sort; a stable
            # torch.sort and gathers here: equal z values would be the only
            # difference, and neither sort promises their order).
            z_samples = sample_pdf(z_vals_mid, w_full[..., 1:-1], cfg.N_importance, det=det,
                                   u=u_pdf, generator=generator).detach()
            z_cat = torch.cat([z_vals, z_samples], -1)
            s_cat = torch.cat([scores_c, score_z(z_samples)], -1)
            z_vals, perm = torch.sort(z_cat, dim=-1, stable=True)
            scores_f = torch.gather(s_cat, -1, perm)
            if occ.transmittance_cull:
                # Early ray termination as a score threshold (eval only):
                # T at each coarse sample, +inf at the new ones; after the
                # sort a running minimum carries each sample the T of the
                # last coarse sample at or before it. Samples behind
                # T < 1e-3 drop to score 0, below every live score.
                cw = torch.cumsum(w_full, dim=-1)
                t_coarse = 1.0 - torch.cat([torch.zeros_like(cw[..., :1]), cw[..., :-1]], -1)
                payload = torch.cat([t_coarse, torch.full_like(z_samples, float("inf"))], -1)
                t_fill = torch.cummin(torch.gather(payload, -1, perm), dim=-1).values
                scores_f = torch.where((t_fill < 1e-3) & (scores_f > 0),
                                       torch.zeros_like(scores_f), scores_f)
            out, _ = march(z_vals, draws.noise1, fine=True, scores=scores_f)
        else:
            u = u_pdf
            if cfg.fast_merge and not det:
                # JAX's sorted draws (k_pdf), for its rank merge; the
                # merge below is a sort either way
                u = draws.u_sorted
                if u is None:
                    u = sorted_uniform((R, cfg.N_importance), generator, device=z_vals.device,
                                       dtype=z_vals.dtype)
            z_samples = sample_pdf(z_vals_mid, w_full[..., 1:-1], cfg.N_importance, det=det,
                                   u=u, generator=generator).detach()
            z_vals = merge_sorted(z_vals, z_samples)
            out, _ = march(z_vals, draws.noise1, fine=True)
        ret["z_std"] = torch.std(z_samples, dim=-1, correction=0)

    ret.update(
        rgb_map=out.rgb_map, depth_map=out.depth_map, acc_map=out.acc_map,
        disp_map=out.disp_map, sparsity_loss=out.sparsity_loss,
    )
    return ret


def render(
    state,
    query_fn: Callable,
    H: int,
    W: int,
    K,
    bbox: torch.Tensor,
    cfg: RenderConfig,
    c2w,
    chunk: int = 1024 * 32,
    near: float = 0.0,
    far: float = 1.0,
    generator: Optional[torch.Generator] = None,
    occ_grid: Optional[torch.Tensor] = None,
):
    """Chunked rendering of the full (H, W) image seen from c2w.

    PyTorch runs eagerly, so the chunks are a host loop (the JAX package
    scans them in one program). Under cfg.ndc the rays are warped to NDC
    with focal K[0][0], after their view directions are taken. As in JAX,
    the rays are padded with zero
    rays to a whole number of chunks: a culled pass spends its budget over
    the whole chunk. Pass occ_grid to cull at eval too. Runs without
    autograd. Returns (rgb_map, depth_map, acc_map, extras), each shaped
    (H, W, ...).
    """
    rays_o, rays_d = get_rays(H, W, K, torch.as_tensor(c2w, device=bbox.device))
    sh = rays_d.shape
    viewdirs = None
    if cfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        viewdirs = viewdirs.reshape(-1, 3)
    if cfg.ndc:
        rays_o, rays_d = get_ndc_rays(H, W, float(K[0][0]), 1.0, rays_o, rays_d)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    N = rays_o.shape[0]
    chunk = min(chunk, N) or N
    pad = -N % chunk

    def pad0(x):
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x

    rays_o, rays_d = pad0(rays_o), pad0(rays_d)
    viewdirs = pad0(viewdirs) if viewdirs is not None else None
    if cfg.occupancy is None:
        occ_grid = None

    parts: Dict[str, list] = {}
    with torch.no_grad():
        for s in range(0, N + pad, chunk):
            e = s + chunk
            ret = render_rays(
                state, query_fn, rays_o[s:e], rays_d[s:e],
                viewdirs[s:e] if viewdirs is not None else None,
                near, far, bbox, cfg, generator=generator, occ_grid=occ_grid,
            )
            for k, v in ret.items():
                parts.setdefault(k, []).append(v)
    out = {k: torch.cat(v, 0)[:N].reshape(sh[:-1] + v[0].shape[1:]) for k, v in parts.items()}
    extract = ("rgb_map", "depth_map", "acc_map")
    extras = {k: v for k, v in out.items() if k not in extract}
    return out["rgb_map"], out["depth_map"], out["acc_map"], extras


def render_path(
    state,
    query_fn: Callable,
    poses,
    hwf,
    K,
    bbox: torch.Tensor,
    cfg: RenderConfig,
    chunk: int = 1024 * 32,
    near: float = 0.0,
    far: float = 1.0,
    gt_imgs=None,
    savedir: Optional[str] = None,
    render_factor: int = 0,
    occ_grid: Optional[torch.Tensor] = None,
):
    """Render poses in eval mode (culled by occ_grid when given); returns
    (rgbs, depths, psnrs) as numpy, depth normalized by (near, far).

    render_factor k > 0 renders at H // k x W // k with focal / k (and
    then computes no PSNR). savedir receives the figures and, with PSNRs,
    their pickle (utils/io.py)."""
    H, W, focal = hwf
    H, W = int(H), int(W)
    if render_factor != 0:
        H = H // render_factor
        W = W // render_factor
        focal = focal / render_factor
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    rgbs, depths, psnrs = [], [], []
    for i, c2w in enumerate(poses):
        c2w = torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32, device=bbox.device)
        rgb, depth, _, _ = render(
            state, query_fn, H, W, K, bbox, cfg.eval_mode(),
            chunk=chunk, c2w=c2w, near=near, far=far, occ_grid=occ_grid,
        )
        rgb = rgb.cpu().numpy()
        rgbs.append(rgb)
        depths.append((depth.cpu().numpy() - near) / (far - near))
        if gt_imgs is not None and render_factor == 0:
            psnrs.append(float(-10.0 * np.log10(np.mean(np.square(rgb - np.asarray(gt_imgs[i]))))))
    rgbs, depths = np.stack(rgbs, 0), np.stack(depths, 0)
    if savedir is not None:
        save_render_figures(savedir, rgbs, depths)
        if psnrs:
            save_psnr_pickle(savedir, psnrs)
    return rgbs, depths, psnrs
