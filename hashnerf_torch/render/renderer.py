"""Volume renderer: stratified + hierarchical ray-march, chunked rendering.

Counterpart of hashnerf_tpu/render/renderer.py without occupancy culling,
fast_merge and NDC (ROADMAP A7.1, A7.2, A3); `aabb_clip` tightens each ray's
[near, far] to the bbox before the stratified samples. The JAX renderer splits one key into k_strat, k_noise0,
k_pdf and k_noise1; here each of those draws is a tensor in `RenderDraws`
that the caller may hand in, and any draw left out is taken from the
torch.Generator.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from hashnerf_torch.ops.rays import get_rays, ray_aabb_near_far
from hashnerf_torch.ops.sampling import perturb_z_vals, sample_pdf, stratified_z_vals
from hashnerf_torch.ops.volume import raw2outputs


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    N_samples: int = 64
    N_importance: int = 0
    perturb: bool = True
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    use_viewdirs: bool = True
    aabb_clip: bool = False  # off = reference-exact z ranges

    def eval_mode(self) -> "RenderConfig":
        """perturb off, noise off."""
        return dataclasses.replace(self, perturb=False, raw_noise_std=0.0)


class RenderDraws(NamedTuple):
    """Injectable random draws of one render_rays call (all optional).

    t_strat (R, N_samples) U[0,1): stratified jitter (JAX k_strat);
    noise0 (R, N_samples) N(0,1): coarse sigma noise (k_noise0);
    u_pdf (R, N_importance) U[0,1): importance-sampling draws (k_pdf);
    noise1 (R, N_samples + N_importance) N(0,1): fine sigma noise (k_noise1).
    """

    t_strat: Optional[torch.Tensor] = None
    noise0: Optional[torch.Tensor] = None
    u_pdf: Optional[torch.Tensor] = None
    noise1: Optional[torch.Tensor] = None


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
) -> Dict[str, torch.Tensor]:
    """Core per-batch ray march. rays_o/rays_d (R, 3); near/far (R,) or
    scalars; bbox (2, 3). Coarse-pass outputs are keyed rgb0/depth0/acc0/
    sparsity_loss0 when hierarchical sampling is on."""
    draws = draws or RenderDraws()
    R = rays_o.shape[0]
    near = torch.as_tensor(near, dtype=rays_o.dtype, device=rays_o.device).expand(R)
    far = torch.as_tensor(far, dtype=rays_o.dtype, device=rays_o.device).expand(R)
    if cfg.aabb_clip:
        near, far = ray_aabb_near_far(rays_o, rays_d, bbox, near, far)

    def march(z_vals, noise, fine):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        raw = query_fn(state, pts, viewdirs, bbox, fine=fine)
        return raw2outputs(
            raw, z_vals, rays_d, cfg.raw_noise_std, cfg.white_bkgd,
            noise=noise, generator=generator,
        )

    z_vals = stratified_z_vals(near, far, cfg.N_samples, cfg.lindisp)
    if cfg.perturb:
        z_vals = perturb_z_vals(z_vals, draws.t_strat, generator)

    out = march(z_vals, draws.noise0, fine=False)

    ret = {}
    if cfg.N_importance > 0:
        ret.update(
            rgb0=out.rgb_map, depth0=out.depth_map, acc0=out.acc_map,
            sparsity_loss0=out.sparsity_loss,
        )
        z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(
            z_vals_mid, out.weights[..., 1:-1], cfg.N_importance,
            det=not cfg.perturb, u=draws.u_pdf, generator=generator,
        ).detach()
        z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], -1), dim=-1)
        out = march(z_vals, draws.noise1, fine=True)
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
):
    """Chunked rendering of the full (H, W) image seen from c2w.

    PyTorch runs eagerly, so the chunks are a host loop (the JAX package
    scans them in one program). Runs without autograd. Returns (rgb_map,
    depth_map, acc_map, extras), each shaped (H, W, ...).
    """
    rays_o, rays_d = get_rays(H, W, K, torch.as_tensor(c2w, device=bbox.device))
    sh = rays_d.shape
    viewdirs = None
    if cfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        viewdirs = viewdirs.reshape(-1, 3)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    N = rays_o.shape[0]

    parts: Dict[str, list] = {}
    with torch.no_grad():
        for s in range(0, N, chunk):
            e = min(s + chunk, N)
            ret = render_rays(
                state, query_fn, rays_o[s:e], rays_d[s:e],
                viewdirs[s:e] if viewdirs is not None else None,
                near, far, bbox, cfg, generator=generator,
            )
            for k, v in ret.items():
                parts.setdefault(k, []).append(v)
    out = {k: torch.cat(v, 0).reshape(sh[:-1] + v[0].shape[1:]) for k, v in parts.items()}
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
):
    """Render poses in eval mode; returns (rgbs, depths, psnrs) as numpy,
    depth normalized by (near, far). Saving figures and videos is
    ROADMAP A3."""
    H, W, _ = hwf
    rgbs, depths, psnrs = [], [], []
    for i, c2w in enumerate(poses):
        c2w = torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32, device=bbox.device)
        rgb, depth, _, _ = render(
            state, query_fn, int(H), int(W), K, bbox, cfg.eval_mode(),
            chunk=chunk, c2w=c2w, near=near, far=far,
        )
        rgb = rgb.cpu().numpy()
        rgbs.append(rgb)
        depths.append((depth.cpu().numpy() - near) / (far - near))
        if gt_imgs is not None:
            psnrs.append(float(-10.0 * np.log10(np.mean(np.square(rgb - np.asarray(gt_imgs[i]))))))
    return np.stack(rgbs, 0), np.stack(depths, 0), psnrs
