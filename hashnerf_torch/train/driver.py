"""Training driver: the train step, the Trainer and the training loop.

Counterpart of hashnerf_tpu/train/driver.py for the per-image
(`no_batching`) path: losses = fine MSE + coarse MSE + entropy sparsity + TV
while global_step <= 1000, RAdam with two parameter groups and exponential
LR decay, periodic print / checkpoint / test-set render. Besides the
reference-exact step it takes the packed layout (with its own TV),
`share_fine`, bf16 MLPs, `aabb_clip`, `fast_merge` and occupancy culling
with its grid's lifecycle: updates every `update_every` steps, culling from
`warmup_steps` on once the grid holds density, the keep schedule, and the
eval budgets.

PyTorch runs the step eagerly; the JAX package compiles it into one XLA
program. Every random draw of a step (stratified jitter, sigma noise,
importance samples, TV cuboids and rows, and those of a grid update) can be
handed in through `TrainDraws` and `OccUpdateDraws`, which is how the tests
give the port the draws JAX took from its keys.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from hashnerf_torch import resolve_device
from hashnerf_torch.data.scene import Scene
from hashnerf_torch.models.factory import ModelConfig, NGPState, query_fn
from hashnerf_torch.ops.hash_encoding import HashGridConfig
from hashnerf_torch.ops.rays import get_rays
from hashnerf_torch.render.occupancy import (
    OccupancyConfig, OccUpdateDraws, init_occupancy_grid, update_occupancy_grid,
)
from hashnerf_torch.render.renderer import (
    RenderConfig, RenderDraws, render, render_path, render_rays,
)
from hashnerf_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from hashnerf_torch.train.config import check_supported
from hashnerf_torch.train.losses import total_variation_loss_all_levels, total_variation_loss_packed
from hashnerf_torch.train.radam import RAdam
from hashnerf_torch.utils.io import save_loss_history, save_psnr_pickle
from hashnerf_torch.utils.metrics import img2mse, mse2psnr


class TrainDraws(NamedTuple):
    """Injectable draws of one train step; anything left None is drawn
    from the Trainer's torch.Generator."""

    render: RenderDraws = RenderDraws()
    # (L, 3) cuboid corners; under packed_layout (Ld, 3), of the dense levels
    tv_min_vertices: Optional[torch.Tensor] = None
    tv_fine_rows: Optional[torch.Tensor] = None  # packed_layout: (Lf, k_rows), level-local


def model_config_from_args(args) -> ModelConfig:
    return ModelConfig(
        i_embed=args.i_embed,
        i_embed_views=args.i_embed_views,
        use_viewdirs=args.use_viewdirs,
        N_importance=args.N_importance,
        share_fine=args.share_fine,
        hash_grid=HashGridConfig(
            n_levels=args.n_levels,
            n_features_per_level=args.n_features_per_level,
            log2_hashmap_size=args.log2_hashmap_size,
            finest_resolution=args.finest_res,
        ),
        compute_dtype=args.compute_dtype,
        packed_layout=args.packed_layout,
        log2_blocks=args.log2_blocks,
    )


def _positive_or_none(v: float) -> Optional[float]:
    return v if v > 0 else None


def render_config_from_args(args, lindisp: bool = False) -> RenderConfig:
    """The JAX package turns aabb_clip off for NDC scenes; the port has no
    NDC scenes yet (ROADMAP A6)."""
    occupancy = None
    if args.use_occupancy:
        occupancy = OccupancyConfig(
            resolution=args.occ_resolution,
            keep_fraction=args.occ_keep_fraction,
            update_every=args.occ_update_every,
            warmup_steps=args.occ_warmup,
            partition=args.occ_partition,
            adaptive_update=args.occ_adaptive_update,
            per_ray=args.occ_per_ray,
            per_ray_select=args.occ_per_ray_select,
            block=args.occ_block,
            keep_fraction_coarse=_positive_or_none(args.occ_keep_coarse),
            keep_fraction_eval=_positive_or_none(args.occ_keep_eval),
            keep_fraction_eval_coarse=_positive_or_none(args.occ_keep_eval_coarse),
            eval_transmittance=args.occ_eval_transmittance,
            score_stride=args.occ_score_stride,
        )
        # the block must divide both passes' sample counts and 128 (the
        # rounding of the keep budget), or culling would fall back to single
        # points without a word
        B = occupancy.block
        if B > 1 and not occupancy.per_ray:
            S_fine = args.N_samples + args.N_importance
            if args.N_samples % B or S_fine % B or 128 % B:
                raise ValueError(
                    f"--occ_block={B} must divide N_samples ({args.N_samples}), "
                    f"N_samples+N_importance ({S_fine}), and 128 (the keep-"
                    "budget rounding); pick a power-of-two block that divides "
                    "all three or use --occ_block 1"
                )
        if args.fast_merge:
            print(
                "[config] note: with --use_occupancy, --fast_merge applies only to "
                "renders without an active occupancy grid (the warmup steps, and "
                "eval renders that are not culled); culled passes merge their z "
                "values with the occupancy path's score-carrying sort"
            )
    return RenderConfig(
        N_samples=args.N_samples,
        N_importance=args.N_importance,
        perturb=args.perturb > 0.0,
        raw_noise_std=args.raw_noise_std,
        white_bkgd=args.white_bkgd,
        lindisp=lindisp,
        use_viewdirs=args.use_viewdirs,
        aabb_clip=args.aabb_clip,
        occupancy=occupancy,
        fast_merge=args.fast_merge,
    )


def make_lr_schedule(lrate: float, lrate_decay: int):
    """lr(t) = lrate * 0.1^(t / (decay*1000))."""
    decay_steps = lrate_decay * 1000

    def sched(step: int) -> float:
        return lrate * 0.1 ** (step / decay_steps)

    return sched


def make_optimizer(args, state: NGPState) -> RAdam:
    """RAdam with two groups: the MLPs (wd 1e-6, eps 1e-8) and the hash
    table, or both packed tables (wd 0, eps 1e-15), both betas (0.9, 0.99)."""
    return RAdam(
        [
            {"params": state.net_parameters(), "eps": 1e-8, "weight_decay": 1e-6},
            {"params": state.table_parameters(), "eps": 1e-15, "weight_decay": 0.0},
        ],
        lr=make_lr_schedule(args.lrate, args.lrate_decay),
        betas=(0.9, 0.99),
    )


def make_loss_fn(args, render_cfg: RenderConfig, bbox: torch.Tensor,
                 model_cfg: ModelConfig, with_tv: bool = True):
    """The training loss: image + coarse image + entropy sparsity (+ TV, the
    packed TV under packed_layout).

    loss_fn(state, batch, tv_weight, draws=None, generator=None, occ_grid=None)
      -> (loss, (psnr, img_loss)); occ_grid culls the render.
    """
    sparse_w = args.sparse_loss_weight

    def loss_fn(state, batch, tv_weight, draws: Optional[TrainDraws] = None,
                generator: Optional[torch.Generator] = None,
                occ_grid: Optional[torch.Tensor] = None):
        draws = draws or TrainDraws()
        ret = render_rays(
            state, query_fn, batch["rays_o"], batch["rays_d"], batch.get("viewdirs"),
            batch["near"], batch["far"], bbox, render_cfg,
            draws=draws.render, generator=generator, occ_grid=occ_grid,
        )
        img_loss = img2mse(ret["rgb_map"], batch["target"])
        loss = img_loss
        psnr = mse2psnr(img_loss)
        if "rgb0" in ret:
            loss = loss + img2mse(ret["rgb0"], batch["target"])
        sparsity = ret["sparsity_loss"].sum()
        if "sparsity_loss0" in ret:
            sparsity = sparsity + ret["sparsity_loss0"].sum()
        loss = loss + sparse_w * sparsity
        if with_tv:
            if model_cfg.packed_layout:
                tv = total_variation_loss_packed(
                    state.hash_table, state.packed_cfg, draws.tv_min_vertices,
                    draws.tv_fine_rows, generator,
                )
            else:
                hcfg = model_cfg.hash_grid
                tv = total_variation_loss_all_levels(
                    state.hash_table, hcfg.base_resolution, hcfg.finest_resolution,
                    hcfg.log2_hashmap_size, draws.tv_min_vertices, generator,
                )
            loss = loss + tv_weight * tv
        return loss, (psnr, img_loss)

    return loss_fn


class Trainer:
    """Owns the model state, the optimizer and the train step."""

    def __init__(self, args, scene: Scene, device=None, seed: int = 0):
        self.args = args
        self.scene = scene
        self.device = resolve_device(device if device is not None else args.device)
        self.model_cfg = model_config_from_args(args)
        self.render_cfg = render_config_from_args(args, lindisp=args.lindisp)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = NGPState(self.model_cfg, self.generator, self.device)
        self.optimizer = make_optimizer(args, self.state)
        self.global_step = 0
        self.history = []  # (iter, loss, psnr) at every i_print

        self.bbox = torch.as_tensor(scene.bbox_array(), device=self.device)
        self.near, self.far = scene.near, scene.far
        self._images = torch.as_tensor(scene.images, dtype=torch.float32, device=self.device)
        self._poses = torch.as_tensor(scene.poses[:, :3, :4], dtype=torch.float32, device=self.device)
        # annealed keep budget "STEP:FRAC,...": from each STEP on, FRAC
        self.keep_schedule = None
        if args.occ_keep_schedule and self.render_cfg.occupancy is not None:
            pairs = [tok.split(":") for tok in str(args.occ_keep_schedule).split(",")]
            self.keep_schedule = sorted((int(a), float(b)) for a, b in pairs)
        self._loss_fns = {}
        # the grid starts empty; culling waits until an update found density
        # somewhere, or it would cull everything
        occ = self.render_cfg.occupancy
        self.occ_grid = init_occupancy_grid(occ, self.device) if occ is not None else None
        self._occ_ready = False
        self.last_occ_keep = None

    def _keep_at(self, step: int) -> float:
        """The fine keep fraction at `step` (the last schedule entry <= step)."""
        keep = self.render_cfg.occupancy.keep_fraction
        for b, f in self.keep_schedule or ():
            if step >= b:
                keep = f
        return keep

    def _render_cfg_for(self, keep: Optional[float]) -> RenderConfig:
        """render_cfg with the fine keep budget overridden (the schedule)."""
        occ = self.render_cfg.occupancy
        if keep is None or occ is None or keep == occ.keep_fraction:
            return self.render_cfg
        return dataclasses.replace(
            self.render_cfg, occupancy=dataclasses.replace(occ, keep_fraction=keep))

    def _loss_fn(self, with_tv: bool, keep: Optional[float]):
        fn = self._loss_fns.get((with_tv, keep))
        if fn is None:
            fn = self._loss_fns[(with_tv, keep)] = make_loss_fn(
                self.args, self._render_cfg_for(keep), self.bbox, self.model_cfg, with_tv=with_tv)
        return fn

    def occ_update(self, grid: torch.Tensor, draws: Optional[OccUpdateDraws] = None) -> torch.Tensor:
        """One grid update: density-only queries of the live model at the
        sampled cells (fine net, view direction +z), without autograd."""
        occ = self.render_cfg.occupancy
        fine = self.render_cfg.N_importance > 0
        use_dirs = self.render_cfg.use_viewdirs

        def sigma_fn(pts):
            dirs = None
            if use_dirs:
                dirs = torch.zeros_like(pts)
                dirs[:, 2] = 1.0
            return query_fn(self.state, pts[:, None, :], dirs, self.bbox, fine=fine)[:, 0, 3]

        return update_occupancy_grid(grid, self.bbox, occ, sigma_fn, draws, self.generator)

    def step(self, batch: Dict[str, torch.Tensor], draws: Optional[TrainDraws] = None,
             occ_draws: Optional[OccUpdateDraws] = None):
        """One optimization step. batch: rays_o/rays_d/near/far/target
        (+viewdirs). occ_draws feed the grid update that follows the step,
        if one does. Returns detached loss / psnr / img_loss tensors; sets
        last_occ_keep to the (fine, coarse) keep fractions the step culled
        at, or None."""
        # TV only during warmup (the reference zeroes it after iter 1000)
        tv_w = self.args.tv_loss_weight if self.global_step <= 1000 else 0.0
        occ = self.render_cfg.occupancy
        keep = self._keep_at(self.global_step) if self.keep_schedule else None
        loss_fn = self._loss_fn(tv_w > 0, keep)
        if "viewdirs" not in batch and self.render_cfg.use_viewdirs:
            d = batch["rays_d"]
            batch = dict(batch, viewdirs=d / torch.linalg.norm(d, dim=-1, keepdim=True))
        active = occ is not None and self.global_step >= occ.warmup_steps and self._occ_ready
        self.optimizer.zero_grad(set_to_none=True)
        loss, (psnr, img_loss) = loss_fn(self.state, batch, tv_w, draws, self.generator,
                                         occ_grid=self.occ_grid if active else None)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        self.last_occ_keep = None
        if active:
            fine_kf = self._render_cfg_for(keep).occupancy.keep_fraction
            coarse_kf = occ.keep_fraction_coarse
            self.last_occ_keep = (fine_kf, fine_kf if coarse_kf is None else coarse_kf)

        if occ is not None and self.global_step % occ.update_every == 0:
            self.occ_grid = self.occ_update(self.occ_grid, occ_draws)
            if not self._occ_ready:
                # one host read an update, until the field shows density
                self._occ_ready = float(self.occ_grid.max()) > 0.0
        return {"loss": loss.detach(), "psnr": psnr.detach(), "img_loss": img_loss.detach()}

    def sample_image(self, img_i: int, n_rand: int, precrop: bool,
                     sel: Optional[torch.Tensor] = None):
        """n_rand random pixels of one image, without replacement. `sel`
        (n_rand,) picks the pixels (flat indices into the, possibly
        cropped, grid) instead of the draw from the Trainer's generator."""
        sc = self.scene
        H, W = sc.H, sc.W
        rays_o, rays_d = get_rays(H, W, sc.K, self._poses[img_i])
        if precrop:
            dH = int(H // 2 * self.args.precrop_frac)
            dW = int(W // 2 * self.args.precrop_frac)
            ys = torch.arange(H // 2 - dH, H // 2 + dH, device=self.device)
            xs = torch.arange(W // 2 - dW, W // 2 + dW, device=self.device)
        else:
            ys = torch.arange(H, device=self.device)
            xs = torch.arange(W, device=self.device)
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        yy, xx = yy.reshape(-1), xx.reshape(-1)
        if sel is None:
            sel = torch.randperm(yy.shape[0], generator=self.generator, device=self.device)[:n_rand]
        sel = torch.as_tensor(sel, device=self.device)
        y, x = yy[sel], xx[sel]
        return {
            "rays_o": rays_o[y, x],
            "rays_d": rays_d[y, x],
            "target": self._images[img_i][y, x],
            "near": torch.full((n_rand,), self.near, dtype=torch.float32, device=self.device),
            "far": torch.full((n_rand,), self.far, dtype=torch.float32, device=self.device),
        }

    # Eval renders are exact by default: the training budget clips geometry
    # on full-image ray grids. Culled eval is opt-in, by this switch (the
    # training budgets) or by --occ_keep_eval (its own budgets).
    eval_cull: bool = False

    @property
    def eval_occ_grid(self) -> Optional[torch.Tensor]:
        occ = self.render_cfg.occupancy
        if occ is None or not self._occ_ready:
            return None
        if self.eval_cull or occ.keep_fraction_eval is not None:
            return self.occ_grid
        return None

    def render_image(self, c2w, chunk: Optional[int] = None):
        sc = self.scene
        return render(
            self.state, query_fn, sc.H, sc.W, sc.K, self.bbox,
            self.render_cfg.eval_mode(), chunk=chunk or self.args.chunk,
            c2w=torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32, device=self.device),
            near=self.near, far=self.far, occ_grid=self.eval_occ_grid,
        )

    def render_test_path(self, poses, gt_imgs=None, savedir: Optional[str] = None):
        sc = self.scene
        rgbs, depths, psnrs = render_path(
            self.state, query_fn, poses, sc.hwf, sc.K, self.bbox, self.render_cfg,
            chunk=self.args.chunk, near=self.near, far=self.far, gt_imgs=gt_imgs,
            occ_grid=self.eval_occ_grid,
        )
        if savedir is not None:
            os.makedirs(savedir, exist_ok=True)
            np.save(os.path.join(savedir, "rgbs.npy"), rgbs)
            if psnrs:
                save_psnr_pickle(savedir, psnrs)
        return rgbs, depths, psnrs

    def save(self, path: str) -> None:
        save_checkpoint(path, self.global_step, self.state, self.optimizer)

    def try_restore(self, savedir: str, ft_path: Optional[str] = None) -> bool:
        path = latest_checkpoint(savedir, ft_path)
        if path is None:
            return False
        print(f"Reloading from {path}")
        self.global_step = load_checkpoint(path, self.state, self.optimizer)
        return True


def train_loop(args, scene: Scene, n_iters: Optional[int] = None, log_fn=print,
               device=None) -> Trainer:
    """The per-image training loop with periodic print, checkpoint and
    test-set render; returns the Trainer."""
    check_supported(args)
    trainer = Trainer(args, scene, device=device)
    savepath = os.path.join(args.basedir, args.expname)
    os.makedirs(savepath, exist_ok=True)
    if not args.no_reload:
        trainer.try_restore(savepath, args.ft_path)

    n_iters = n_iters or args.N_iters
    loss_list, psnr_list, time_list = [], [], []
    time0 = time.time()
    np_rng = np.random.default_rng(0)
    for i in range(trainer.global_step + 1, n_iters + 1):
        img_i = int(np_rng.choice(scene.i_train))
        batch = trainer.sample_image(img_i, args.N_rand, precrop=i < args.precrop_iters)
        metrics = trainer.step(batch)

        if i % args.i_weights == 0:
            trainer.save(os.path.join(savepath, "{:06d}.ckpt".format(i)))
            log_fn(f"Saved checkpoints at {savepath}")

        if args.i_testset > 0 and i % args.i_testset == 0 and len(scene.i_test) > 0:
            testsavedir = os.path.join(savepath, "testset_{:06d}".format(i))
            _, _, psnrs = trainer.render_test_path(
                scene.poses[scene.i_test], gt_imgs=scene.images[scene.i_test],
                savedir=testsavedir,
            )
            log_fn(f"Saved test set to {testsavedir} (PSNR {np.mean(psnrs):.3f})")

        if i % args.i_print == 0:
            loss_v, psnr_v = float(metrics["loss"]), float(metrics["psnr"])
            log_fn(f"[TRAIN] Iter: {i} Loss: {loss_v}  PSNR: {psnr_v}")
            trainer.history.append((i, loss_v, psnr_v))
            loss_list.append(loss_v)
            psnr_list.append(psnr_v)
            time_list.append(time.time() - time0)
            save_loss_history(savepath, loss_list, psnr_list, time_list)
    return trainer
