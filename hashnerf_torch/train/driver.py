"""Training driver: the train step, the Trainer and the training loop.

Counterpart of hashnerf_tpu/train/driver.py: losses = fine MSE + coarse
MSE + entropy sparsity + TV while global_step <= 1000, RAdam with two
parameter groups and exponential LR decay, periodic print / checkpoint /
spiral video / test-set figures. Batches come from one training image at a
time (`no_batching`) or, by default, from a shuffled pool of every training
ray on the device (ray batching); on a forward-facing scene (`scene.ndc`)
the loss warps its rays to NDC.
Besides the reference-exact step it takes the packed layout (with its own TV),
`share_fine`, bf16 MLPs, `aabb_clip`, `fast_merge` and occupancy culling
with its grid's lifecycle: updates every `update_every` steps, culling from
`warmup_steps` on once the grid holds density, the keep schedule, and the
eval budgets.

`Trainer.step` runs one step eagerly. `Trainer.run_steps` runs many, in
the blocks of the JAX package's scanned `run_steps` / `run_steps_pool`
(`--steps_per_dispatch`): each block samples its rays on the device (from
the images, or the next rows of the ray pool) and, on a GPU, replays CUDA
graphs of the step and of the grid update (train/graphs.py) with no host
sync inside the block; on the CPU the same block body runs eagerly. Every
random draw of an eager step (stratified jitter, sigma noise, importance
samples, TV cuboids and rows, and those of a grid update) can be handed in
through `TrainDraws` and `OccUpdateDraws`, which is how the tests give the
port the draws JAX took from its keys.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hashnerf_torch import resolve_device
from hashnerf_torch.data.scene import Scene
from hashnerf_torch.models.factory import ModelConfig, NGPState, query_fn
from hashnerf_torch.ops.hash_encoding import HashGridConfig
from hashnerf_torch.ops.rays import get_ndc_rays, get_rays, get_rays_at
from hashnerf_torch.render.occupancy import (
    OccupancyConfig, OccUpdateDraws, init_occupancy_grid, update_occupancy_grid,
)
from hashnerf_torch.render.renderer import (
    RenderConfig, RenderDraws, render, render_path, render_rays,
)
from hashnerf_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from hashnerf_torch.train.config import check_supported
from hashnerf_torch.train.graphs import GraphCache
from hashnerf_torch.train.losses import total_variation_loss_all_levels, total_variation_loss_packed
from hashnerf_torch.train.radam import RAdam
from hashnerf_torch.utils.io import save_loss_history, save_video
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


def render_config_from_args(args, ndc: bool = False, lindisp: bool = False) -> RenderConfig:
    """The render settings of args; ndc for a forward-facing scene, which
    turns aabb_clip off (its bbox lies in NDC space)."""
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
        ndc=ndc,
        use_viewdirs=args.use_viewdirs,
        aabb_clip=args.aabb_clip and not ndc,
        occupancy=occupancy,
        fast_merge=args.fast_merge,
    )


def make_lr_schedule(lrate: float, lrate_decay: int):
    """lr(t) = lrate * 0.1^(t / (decay*1000)), a float32 tensor computed as
    the JAX schedule computes it (a float32 power); t a tensor (RAdam's step
    count, on the device) or a number."""
    decay_steps = lrate_decay * 1000

    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        return lrate * torch.pow(0.1, step / torch.full_like(step, float(decay_steps)))

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
                 model_cfg: ModelConfig, with_tv: bool = True, hwf=None):
    """The training loss: image + coarse image + entropy sparsity (+ TV, the
    packed TV under packed_layout). Under render_cfg.ndc the batch's rays
    are warped to NDC with hwf = (H, W, focal) first; its viewdirs stay the
    world directions (the caller takes them before the warp).

    loss_fn(state, batch, tv_weight, draws=None, generator=None, occ_grid=None)
      -> (loss, (psnr, img_loss)); occ_grid culls the render.
    """
    if render_cfg.ndc and hwf is None:
        raise ValueError("make_loss_fn: render_cfg.ndc needs hwf = (H, W, focal)")
    sparse_w = args.sparse_loss_weight

    def loss_fn(state, batch, tv_weight, draws: Optional[TrainDraws] = None,
                generator: Optional[torch.Generator] = None,
                occ_grid: Optional[torch.Tensor] = None):
        draws = draws or TrainDraws()
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        if render_cfg.ndc:
            H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
            rays_o, rays_d = get_ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
        ret = render_rays(
            state, query_fn, rays_o, rays_d, batch.get("viewdirs"),
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
        # a forward-facing scene renders in NDC, where lindisp has no say
        self.render_cfg = render_config_from_args(
            args, ndc=scene.ndc, lindisp=args.lindisp and not scene.ndc)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = NGPState(self.model_cfg, self.generator, self.device)
        self.optimizer = make_optimizer(args, self.state)
        self.global_step = 0
        self.history = []  # (iter, loss, psnr) at every i_print

        self.bbox = torch.as_tensor(scene.bbox_array(), device=self.device)
        self.near, self.far = scene.near, scene.far
        # the scene on the device, for ray sampling there
        self._images = torch.as_tensor(scene.images, dtype=torch.float32, device=self.device)
        self._poses = torch.as_tensor(scene.poses[:, :3, :4], dtype=torch.float32, device=self.device)
        self._K = torch.as_tensor(scene.K, dtype=torch.float32, device=self.device)
        self._i_train = torch.as_tensor(np.asarray(scene.i_train), dtype=torch.int64, device=self.device)
        # ray batching: the first pool row of the next step, and a step's row
        # offsets; pool blocks advance the former on the device
        self._pool_offset = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._pool_rows = torch.arange(args.N_rand, device=self.device)
        # annealed keep budget "STEP:FRAC,...": from each STEP on, FRAC
        self.keep_schedule = None
        if args.occ_keep_schedule and self.render_cfg.occupancy is not None:
            pairs = [tok.split(":") for tok in str(args.occ_keep_schedule).split(",")]
            self.keep_schedule = sorted((int(a), float(b)) for a, b in pairs)
        self._loss_fns = {}
        # the grid starts empty; culling waits until an update found density
        # somewhere, or it would cull everything. Updates write it in place:
        # captured graphs read it at its one address.
        occ = self.render_cfg.occupancy
        self.occ_grid = init_occupancy_grid(occ, self.device) if occ is not None else None
        self._occ_ready = False
        self.last_occ_keep = None
        # on a GPU, the CUDA graphs that run_steps' blocks replay
        self._graphs: Optional[GraphCache] = None

    def _keep_at(self, step: int) -> Tuple[float, Optional[int]]:
        """(the fine keep fraction at `step`, the next schedule step after
        it or None)."""
        occ = self.render_cfg.occupancy
        keep, nxt = (occ.keep_fraction if occ is not None else 0.0), None
        for b, f in self.keep_schedule or ():
            if step >= b:
                keep = f
            elif nxt is None:
                nxt = b
        return keep, nxt

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
                self.args, self._render_cfg_for(keep), self.bbox, self.model_cfg, with_tv=with_tv,
                hwf=self.scene.hwf)
        return fn

    def _update_grid(self, draws: Optional[OccUpdateDraws] = None) -> None:
        """One grid update, written into the grid in place: density-only
        queries of the live model at the sampled cells (fine net, view
        direction +z), without autograd."""
        occ = self.render_cfg.occupancy
        fine = self.render_cfg.N_importance > 0
        use_dirs = self.render_cfg.use_viewdirs

        def sigma_fn(pts):
            dirs = None
            if use_dirs:
                dirs = torch.zeros_like(pts)
                dirs[:, 2] = 1.0
            return query_fn(self.state, pts[:, None, :], dirs, self.bbox, fine=fine)[:, 0, 3]

        self.occ_grid.copy_(update_occupancy_grid(self.occ_grid, self.bbox, occ, sigma_fn, draws,
                                                  self.generator))

    def _keep_fractions(self, keep: Optional[float]) -> Tuple[float, float]:
        """(fine, coarse) keep fractions of a culled step at fine budget keep."""
        occ = self._render_cfg_for(keep).occupancy
        coarse = occ.keep_fraction_coarse
        return occ.keep_fraction, occ.keep_fraction if coarse is None else coarse

    def _train_one(self, batch: Dict[str, torch.Tensor], tv_w: float, keep: Optional[float],
                   occ_grid: Optional[torch.Tensor], draws: Optional[TrainDraws] = None):
        """The step body that step() and run_steps' blocks share: forward,
        backward and RAdam on one batch. Returns detached metrics."""
        loss_fn = self._loss_fn(tv_w > 0, keep)
        if "viewdirs" not in batch and self.render_cfg.use_viewdirs:
            d = batch["rays_d"]
            batch = dict(batch, viewdirs=d / torch.linalg.norm(d, dim=-1, keepdim=True))
        self.optimizer.zero_grad(set_to_none=True)
        loss, (psnr, img_loss) = loss_fn(self.state, batch, tv_w, draws, self.generator,
                                         occ_grid=occ_grid)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(), "psnr": psnr.detach(), "img_loss": img_loss.detach()}

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
        keep = self._keep_at(self.global_step)[0] if self.keep_schedule else None
        active = occ is not None and self.global_step >= occ.warmup_steps and self._occ_ready
        metrics = self._train_one(batch, tv_w, keep, self.occ_grid if active else None, draws)
        self.global_step += 1
        self.last_occ_keep = self._keep_fractions(keep) if active else None

        if occ is not None and self.global_step % occ.update_every == 0:
            self._update_grid(occ_draws)
            if not self._occ_ready:
                # one host read an update, until the field shows density
                self._occ_ready = float(self.occ_grid.max()) > 0.0
        return metrics

    def _precrop_window(self, precrop: bool) -> Tuple[int, int, int, int]:
        """(y0, x0, rows, cols) of the pixels a step draws from."""
        H, W = self.scene.H, self.scene.W
        if not precrop:
            return 0, 0, H, W
        dH = int(H // 2 * self.args.precrop_frac)
        dW = int(W // 2 * self.args.precrop_frac)
        return H // 2 - dH, W // 2 - dW, 2 * dH, 2 * dW

    def _sample(self, img: torch.Tensor, n_rand: int, precrop: bool,
                sel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """n_rand pixels of image img ((1,) int64 on the device) without
        replacement: sel (flat indices into the, possibly cropped, window),
        else the first n_rand of a stable argsort of uniform keys drawn
        from the Trainer's generator. Rays at those pixels only."""
        y0, x0, nH, nW = self._precrop_window(precrop)
        if sel is None:
            keys = torch.rand(nH * nW, generator=self.generator, device=self.device)
            sel = torch.argsort(keys, stable=True)[:n_rand]
        sel = torch.as_tensor(sel, device=self.device).to(torch.int64)
        ys, xs = y0 + sel // nW, x0 + sel % nW
        rays_o, rays_d = get_rays_at(self._K, self._poses.index_select(0, img)[0], ys, xs)
        H, W = self.scene.H, self.scene.W
        pix = (img * H + ys) * W + xs
        batch = {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "target": self._images.reshape(-1, 3).index_select(0, pix),
            "near": torch.full((n_rand,), self.near, dtype=torch.float32, device=self.device),
            "far": torch.full((n_rand,), self.far, dtype=torch.float32, device=self.device),
        }
        if self.render_cfg.use_viewdirs:
            batch["viewdirs"] = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return batch

    def sample_image(self, img_i: int, n_rand: int, precrop: bool,
                     sel: Optional[torch.Tensor] = None):
        """n_rand random pixels of image img_i, without replacement. `sel`
        (n_rand,) picks the pixels (flat indices into the, possibly
        cropped, grid) instead of the draw from the Trainer's generator."""
        img = torch.full((1,), int(img_i), dtype=torch.int64, device=self.device)
        return self._sample(img, n_rand, precrop, sel)

    def sample_batch(self, precrop: bool) -> Dict[str, torch.Tensor]:
        """One step's batch, drawn on the device as the JAX package's scanned
        step draws it (`sample_batch` of _build_block): a training image
        uniform over i_train, then N_rand of its pixels, no host read."""
        pick = torch.randint(0, self._i_train.numel(), (1,), generator=self.generator,
                             device=self.device)
        return self._sample(self._i_train.index_select(0, pick), self.args.N_rand, precrop)

    # ------------------------------------------------------------------ #
    # Ray batching: a shuffled pool of every training ray, on the device
    # ------------------------------------------------------------------ #
    def build_ray_pool(self, shuffle: bool = True) -> torch.Tensor:
        """(N * H * W, 3, 3) float32 rows [origin, direction, rgb] of every
        pixel of the N training images, built on the device: in image, row,
        column order (the JAX package's unshuffled pool), then shuffled by
        shuffle_pool."""
        sc = self.scene
        rows = []
        for i in np.asarray(sc.i_train):
            rays_o, rays_d = get_rays(sc.H, sc.W, self._K, self._poses[int(i)])
            rows.append(torch.stack([rays_o, rays_d, self._images[int(i)]], -2))
        pool = torch.stack(rows).reshape(-1, 3, 3)
        del rows
        if shuffle:
            self.shuffle_pool(pool)
        return pool

    def shuffle_pool(self, pool: torch.Tensor) -> None:
        """Shuffle the pool's rows in place: one randperm on the Trainer's
        generator, a gather into scratch and a copy back. Captured pool
        blocks read the pool at its one address, so it is never rebound."""
        perm = torch.randperm(pool.shape[0], generator=self.generator, device=self.device)
        pool.copy_(pool.index_select(0, perm))

    def _pool_batch(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        n = rows.shape[0]
        return {
            "rays_o": rows[:, 0],
            "rays_d": rows[:, 1],
            "target": rows[:, 2],
            "near": torch.full((n,), self.near, dtype=torch.float32, device=self.device),
            "far": torch.full((n,), self.far, dtype=torch.float32, device=self.device),
        }

    def sample_pool(self, pool: torch.Tensor, i_batch: int, n_rand: int) -> Dict[str, torch.Tensor]:
        """Rows [i_batch, i_batch + n_rand) of the pool as a batch (fewer at
        its end), copied out of it: the pool may be shuffled before the
        step."""
        return self._pool_batch(pool[i_batch:i_batch + n_rand].clone())

    # ------------------------------------------------------------------ #
    # Many steps a launch (--steps_per_dispatch)
    # ------------------------------------------------------------------ #
    def training_state(self) -> List[torch.Tensor]:
        """Every tensor a step or a grid update changes in place: the
        parameters, RAdam's state (created here if no step made it yet) and
        the occupancy grid."""
        self.optimizer.init_state()
        out = list(self.state.parameters())
        out += [t for st in self.optimizer.state.values() for t in st.values() if torch.is_tensor(t)]
        if self.occ_grid is not None:
            out.append(self.occ_grid)
        return out

    def _build_block(self, b: int, use_tv: bool, occ_mode: Optional[str], precrop: bool,
                     keep: Optional[float], pool: Optional[torch.Tensor] = None):
        """A function that runs b steps (and, with occ_mode, a grid update
        after every update_every of them) and returns the last step's
        metrics: the counterpart of JAX's scanned block. Each step samples
        its batch on the device, or, given the ray pool, takes the pool's
        next N_rand rows from the device offset _pool_offset and advances
        it. On a GPU it replays the captured step and update graphs (a
        capture or replay that fails raises); on the CPU it runs the same
        bodies eagerly."""
        tv_w = self.args.tv_loss_weight if use_tv else 0.0
        grid = self.occ_grid if occ_mode == "cull" else None
        upd = self.render_cfg.occupancy.update_every if occ_mode is not None else 0

        if pool is None:
            def batch():
                return self.sample_batch(precrop)
        else:
            def batch():
                rows = pool.index_select(0, self._pool_offset + self._pool_rows)
                self._pool_offset.add_(self.args.N_rand)
                return self._pool_batch(rows)

        def one():
            return self._train_one(batch(), tv_w, keep, grid)

        if self.device.type != "cuda":
            def block():
                for j in range(b):
                    m = one()
                    if upd and (j + 1) % upd == 0:
                        self._update_grid()
                return m

            return block

        if self._graphs is None:
            self._graphs = GraphCache(self.generator, self.training_state())
        source = () if pool is None else ("pool", pool.data_ptr(), pool.shape[0])
        step_graph = self._graphs.get(("step", use_tv, grid is not None, precrop, keep) + source, one)
        update_graph = self._graphs.get(("update",), self._update_grid) if upd else None

        def block():
            for j in range(b):
                step_graph.replay()
                if j == b - 1:
                    # before any other replay: graphs share one memory pool
                    m = {k: v.clone() for k, v in step_graph.outputs.items()}
                if upd and (j + 1) % upd == 0:
                    update_graph.replay()
            return m

        return block

    def _run_block(self, b: int, use_tv: bool, occ_mode: Optional[str], precrop: bool,
                   keep: Optional[float], pool: Optional[torch.Tensor] = None, offset: int = 0):
        if pool is None:
            block = self._build_block(b, use_tv, occ_mode, precrop, keep)
        else:
            # a capture's warm-up step reads its rows from the offset too
            self._pool_offset.fill_(offset)
            block = self._build_block(b, use_tv, occ_mode, precrop, keep, pool)
            self._pool_offset.fill_(offset)
        metrics = block()
        self.last_occ_keep = self._keep_fractions(keep) if occ_mode == "cull" else None
        return metrics

    def _block_plan(self, n_steps: int, block_size: int):
        """The JAX package's static block plan of its run_steps and
        run_steps_pool (both run_steps here): yields (b, use_tv, occ_mode,
        keep) for each block in turn, b = 0 for one eager step. Blocks end
        at the TV cutoff (rounded up to the update grid under occupancy), at
        the occupancy warmup's end (readiness read once a block, on the
        host) and at the next keep-schedule step; a block of grid updates
        is capped at update_every, and a remainder under update_every runs
        as single steps. The caller runs each block, and moves global_step past it,
        before it asks for the next."""
        args = self.args
        occ = self.render_cfg.occupancy
        remaining = n_steps
        while remaining > 0:
            use_tv = self.global_step <= 1000 and args.tv_loss_weight > 0
            k = remaining
            if use_tv:
                tv_left = 1001 - self.global_step
                if occ is not None:
                    # the TV window ends on the update grid (JAX's choice)
                    tv_left = -(-tv_left // occ.update_every) * occ.update_every
                k = min(k, tv_left)

            occ_mode = None
            if occ is not None:
                if not self._occ_ready:
                    self._occ_ready = float(self.occ_grid.max()) > 0.0
                active = self.global_step >= occ.warmup_steps and self._occ_ready
                occ_mode = "cull" if active else "update"
                if not active and self.global_step < occ.warmup_steps:
                    k = min(k, occ.warmup_steps - self.global_step)

            keep = None
            if occ_mode == "cull" and self.keep_schedule:
                keep, nxt = self._keep_at(self.global_step)
                if nxt is not None:
                    k = min(k, nxt - self.global_step)

            b = min(k, block_size)
            if occ_mode is not None:
                if occ_mode == "update":
                    b = min(b, occ.update_every)
                b = (b // occ.update_every) * occ.update_every
            if b == 0:
                # under update_every steps to a boundary: single steps
                for _ in range(min(k, occ.update_every if occ is not None else 1)):
                    yield 0, use_tv, occ_mode, keep
                    remaining -= 1
                continue
            yield b, use_tv, occ_mode, keep
            remaining -= b

    def run_steps(self, n_steps: int, block_size: int = 0, precrop: bool = False,
                  pool: Optional[torch.Tensor] = None, offset: int = 0):
        """Run n_steps optimization steps in the blocks of _block_plan,
        block_size (default args.steps_per_dispatch, at least 1) steps at
        most. Each step samples its batch on the device from the images or,
        given the ray pool, takes its next N_rand rows from row `offset` on
        (the caller reshuffles the pool between epochs; offset + n_steps *
        N_rand must not pass its end). Returns the last step's metrics."""
        n_rand, done, metrics = self.args.N_rand, 0, None
        if pool is not None and offset + n_steps * n_rand > pool.shape[0]:
            raise ValueError(f"run_steps: {n_steps} steps of {n_rand} rays from row {offset} "
                             f"pass the pool's end ({pool.shape[0]} rows)")
        for b, use_tv, occ_mode, keep in self._block_plan(
                n_steps, block_size or max(1, self.args.steps_per_dispatch)):
            at = offset + done * n_rand
            if b == 0:
                metrics = self.step(self.sample_batch(precrop) if pool is None
                                    else self.sample_pool(pool, at, n_rand))
                done += 1
                continue
            metrics = self._run_block(b, use_tv, occ_mode, precrop, keep, pool, at)
            self.global_step += b
            done += b
        return metrics

    def capture_first_step(self, block_size: int, precrop: bool = False,
                           pool: Optional[torch.Tensor] = None, offset: int = 0):
        """The first step of the block of block_size that run_steps would
        start at global_step, from a new capture (cached graphs dropped):
        its batch as run_steps takes it, no grid update, global_step not
        moved. What a captured step computes at its capture, to hold
        against step(); the parameters' .grad are the capture's. Returns
        its metrics; raises if the plan's block there is not block_size."""
        b, use_tv, occ_mode, keep = next(self._block_plan(block_size, block_size))
        if b != block_size:
            raise ValueError(f"capture_first_step: the block from step {self.global_step} "
                             f"is {b} steps, not {block_size}")
        self._graphs = None
        return self._run_block(1, use_tv, occ_mode, precrop, keep, pool, offset)

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

    def render_test_path(self, poses, gt_imgs=None, savedir: Optional[str] = None,
                         render_factor: int = 0):
        """render_path over poses; savedir receives the figures and the
        PSNR pickle."""
        sc = self.scene
        return render_path(
            self.state, query_fn, poses, sc.hwf, sc.K, self.bbox, self.render_cfg,
            chunk=self.args.chunk, near=self.near, far=self.far, gt_imgs=gt_imgs,
            savedir=savedir, render_factor=render_factor, occ_grid=self.eval_occ_grid,
        )

    def save(self, path: str) -> None:
        save_checkpoint(path, self.global_step, self.state, self.optimizer)

    def try_restore(self, savedir: str, ft_path: Optional[str] = None) -> bool:
        path = latest_checkpoint(savedir, ft_path)
        if path is None:
            return False
        print(f"Reloading from {path}")
        self.global_step = load_checkpoint(path, self.state, self.optimizer)
        # RAdam's state tensors were replaced: the graphs hold the old ones
        self._graphs = None
        return True


def train_loop(args, scene: Scene, n_iters: Optional[int] = None, log_fn=print,
               device=None) -> Trainer:
    """The training loop with periodic print, checkpoint, spiral video and
    test-set figures; returns the Trainer. With ray batching (the default;
    off with --no_batching) each step takes the next N_rand rows of a ray
    pool on the device, reshuffled in place at the end of each epoch; else
    N_rand pixels of one training image. With --steps_per_dispatch K > 1 the
    steps between two events (print, checkpoint, video, test set, the
    precrop boundary, the pool's end) run as run_steps blocks of K, as the JAX loop's scanned spans run them; else one step at
    a time, its image picked on the host."""
    check_supported(args)
    trainer = Trainer(args, scene, device=device)
    savepath = os.path.join(args.basedir, args.expname)
    os.makedirs(savepath, exist_ok=True)
    if not args.no_reload:
        trainer.try_restore(savepath, args.ft_path)

    n_iters = n_iters or args.N_iters
    spd = max(1, args.steps_per_dispatch)
    use_batching = not args.no_batching
    pool = trainer.build_ray_pool() if use_batching else None
    i_batch = 0
    loss_list, psnr_list, time_list = [], [], []
    time0 = time.time()
    np_rng = np.random.default_rng(0)

    def span_end(i: int) -> int:
        """The last step of a span from step i: the next event's."""
        end = n_iters
        for e in (args.i_print, args.i_weights, args.i_video, args.i_testset):
            if e and e > 0:
                end = min(end, ((i - 1) // e + 1) * e)
        return end

    i = trainer.global_step + 1
    while i <= n_iters:
        if use_batching and spd > 1:
            end = min(span_end(i), i + (pool.shape[0] - i_batch) // args.N_rand - 1)
            if end < i:
                trainer.shuffle_pool(pool)
                i_batch = 0
                continue
            metrics = trainer.run_steps(end - i + 1, block_size=spd, pool=pool, offset=i_batch)
            i_batch += (end - i + 1) * args.N_rand
            i = end
        elif use_batching:
            batch = trainer.sample_pool(pool, i_batch, args.N_rand)
            i_batch += args.N_rand
            if i_batch >= pool.shape[0]:
                trainer.shuffle_pool(pool)
                i_batch = 0
            metrics = trainer.step(batch)
        elif spd > 1:
            end = span_end(i)
            precrop = i < args.precrop_iters
            if precrop:
                end = min(end, args.precrop_iters - 1)
            metrics = trainer.run_steps(end - i + 1, block_size=spd, precrop=precrop)
            i = end
        else:
            img_i = int(np_rng.choice(scene.i_train))
            batch = trainer.sample_image(img_i, args.N_rand, precrop=i < args.precrop_iters)
            metrics = trainer.step(batch)

        if i % args.i_weights == 0:
            trainer.save(os.path.join(savepath, "{:06d}.ckpt".format(i)))
            log_fn(f"Saved checkpoints at {savepath}")

        if args.i_video > 0 and i % args.i_video == 0 and len(scene.render_poses) > 0:
            rgbs, depths, _ = trainer.render_test_path(scene.render_poses)
            moviebase = os.path.join(savepath, "{}_spiral_{:06d}_".format(args.expname, i))
            save_video(moviebase + "rgb.mp4", rgbs)
            save_video(moviebase + "disp.mp4", depths / max(np.max(depths), 1e-8))
            log_fn(f"Saved video {moviebase}")

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
        i += 1
    return trainer
