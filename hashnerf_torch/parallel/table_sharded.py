"""The level-sharded hash table: a (data, model) layout whose model ranks
each hold L / N_model levels of the table and their RAdam moments.

Counterpart of hashnerf_tpu/parallel/table_sharded.py. Rays are split over
the data axis and levels over the model axis. Each rank encodes its rays
at its own levels (K2 forward, K6 backward on the card: the kernels take
any L and a `resolutions` tensor), and the model group all-gathers the
features, concatenated in level order (a (N, L_local * F) activation, not
the table). Every model rank of a data row then runs the same MLPs on the
same features, so each holds the same whole feature gradient: the
gather's backward takes the rank's own level columns, with no sum over
the model axis (a sum would scale the table's gradient by N_model). The
MLPs' gradients and each level shard's are then summed over the data
group, as in data parallelism. TV is off in this mode, as in the JAX
package's (it would gather the whole table; the reference stops TV after
iteration 1000). Its checkpoints hold the whole table (train/checkpoint.py:
save_sharded, restore_sharded), so any layout restores them.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from hashnerf_torch.kernels.hash_encode import hash_encode
from hashnerf_torch.models.factory import EMBED_HASH, ModelConfig, NGPState
from hashnerf_torch.ops.hash_encoding import HashGridConfig
from hashnerf_torch.parallel.mesh import Layout, _make_layout, all_gather
from hashnerf_torch.train.checkpoint import latest_checkpoint, restore_sharded, save_sharded
from hashnerf_torch.train.driver import Trainer, make_optimizer


def make_table_mesh(n_data: int, n_model: int) -> Layout:
    """The (data, model) layout of the world's n_data * n_model ranks."""
    return _make_layout(n_data, n_model)


def level_range(layout: Layout, n_levels: int):
    """[start, stop) of this rank's levels."""
    if n_levels % layout.n_model:
        raise ValueError(f"n_levels {n_levels} must divide by the model axis {layout.n_model}")
    per = n_levels // layout.n_model
    return layout.model_index * per, (layout.model_index + 1) * per


def shard_table(layout: Layout, table: torch.Tensor) -> torch.Tensor:
    """This rank's levels of an (L, 2^T, F) table."""
    start, stop = level_range(layout, table.shape[0])
    return table[start:stop]


class _GatherLevels(torch.autograd.Function):
    """(N, L_local * F) features of this rank's levels -> (N, L * F) of all
    levels, in level order; backward: this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, feats, layout: Layout):
        ctx.layout = layout
        n, (N, C) = layout.n_model, feats.shape
        out = torch.empty((n * N, C), dtype=feats.dtype, device=feats.device)
        all_gather(out, feats.contiguous(), layout.model_group)
        return out.view(n, N, C).permute(1, 0, 2).reshape(N, n * C)

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        N = g.shape[0]
        return g.reshape(N, layout.n_model, -1)[:, layout.model_index].contiguous(), None


def gather_levels(feats: torch.Tensor, layout: Layout) -> torch.Tensor:
    return feats if layout.n_model == 1 else _GatherLevels.apply(feats, layout)


def make_sharded_encoder(layout: Layout, cfg: HashGridConfig):
    """encode(table_local, x, bbox_min, bbox_max) -> (feats (N, L*F), keep
    (N,)): table_local this rank's levels, x this rank's rows."""
    start, stop = level_range(layout, cfg.n_levels)
    res = {}

    def encode(table_local, x, bbox_min, bbox_max):
        r = res.get(x.device)
        if r is None:
            r = res[x.device] = cfg.resolutions_tensor(x.device)[start:stop].contiguous()
        feats, keep = hash_encode(table_local, x, bbox_min, bbox_max, r)
        return gather_levels(feats, layout), keep

    return encode


class LevelShardedState(NGPState):
    """An NGPState holding this model rank's levels of the per-corner table
    (initialized as the whole table would be, from the same generator, then
    cut) and the whole MLPs."""

    def __init__(self, cfg: ModelConfig, layout: Layout, generator: Optional[torch.Generator] = None,
                 device=None):
        if cfg.i_embed != EMBED_HASH or cfg.packed_layout:
            raise ValueError("the level-sharded table needs the per-corner hash grid "
                             "(not --packed_layout, not the NeRF family)")
        super().__init__(cfg, generator, device)
        self.layout = layout
        start, stop = level_range(layout, cfg.hash_grid.n_levels)
        self.hash_table = nn.Parameter(self.hash_table.detach()[start:stop].clone())
        self.resolutions = self.resolutions[start:stop].clone()

    def encode_hash(self, x: torch.Tensor, bbox: torch.Tensor):
        feats, keep = hash_encode(self.hash_table, x, bbox[0].contiguous(), bbox[1].contiguous(),
                                  self.resolutions)
        return gather_levels(feats, self.layout), keep


class TableShardedTrainer(Trainer):
    """A Trainer whose table is level-sharded over the layout's model axis
    and whose rays are split over its data axis: each rank's step is the
    data-parallel step (every random number of the global step drawn in
    lockstep, the rank's rows kept; parallel/train_sharded.py) on a
    LevelShardedState. TV and occupancy culling are off. Its checkpoints
    are written whole by rank 0 and placed onto any layout on restore."""

    def __init__(self, layout: Layout, args, scene, device=None, seed: int = 0):
        if args.packed_layout:
            raise ValueError("the level-sharded table needs the per-corner table, "
                             "not --packed_layout")
        args = copy.copy(args)
        args.num_devices, args.tv_loss_weight, args.use_occupancy = 0, 0.0, False
        super().__init__(args, scene, device=device, seed=seed)
        # the state again, as the one-device trainer draws it, then cut
        self.generator.manual_seed(seed)
        self.state = LevelShardedState(self.model_cfg, layout, self.generator, self.device)
        self.optimizer = make_optimizer(args, self.state)
        self.layout = layout

    def _whole(self):
        """A whole-table state and its optimizer, for checkpoints."""
        state = NGPState(self.model_cfg, None, self.device)
        opt = make_optimizer(self.args, state)
        opt.init_state()
        self.optimizer.init_state()
        return state, opt

    def _pairs(self, state, opt):
        """(whole, live, placement) of every parameter, moment and step
        count: the table's levels and moments on "model"."""
        pairs = []
        for (name, t), live in zip(state.named_parameters(), self.state.parameters()):
            kind = "model" if name == "hash_table" else "replicated"
            pairs.append((t, live, kind))
            ts, ls = opt.state[t], self.optimizer.state[live]
            pairs += [(ts["exp_avg"], ls["exp_avg"], kind),
                      (ts["exp_avg_sq"], ls["exp_avg_sq"], kind),
                      (ts["step"], ls["step"], "replicated")]
        return pairs

    def save(self, path: str) -> None:
        state, opt = self._whole()
        placement = {name: ("model" if name == "hash_table" else "replicated")
                     for name, _ in state.named_parameters()}
        save_sharded(path, self.global_step, self.layout, state, opt, self._pairs, placement)

    def try_restore(self, savedir: str, ft_path: Optional[str] = None) -> bool:
        path = latest_checkpoint(savedir, ft_path)
        if path is None:
            return False
        state, opt = self._whole()
        self.global_step = restore_sharded(path, self.layout, state, opt, self._pairs)
        self.restored_from = path
        self._graphs = None
        return True


def make_table_sharded_trainer(layout: Layout, args, scene, device=None,
                               seed: int = 0) -> TableShardedTrainer:
    """The table-sharded trainer on this rank (JAX's returns its state,
    optimizer state and jitted step; here the Trainer holds them)."""
    return TableShardedTrainer(layout, args, scene, device=device, seed=seed)


def save_table_sharded(path: str, trainer: TableShardedTrainer) -> None:
    """Checkpoint the table-sharded trainer (every rank calls it: the
    levels are gathered to rank 0, which writes)."""
    trainer.save(path)


def restore_table_sharded(path: str, trainer: TableShardedTrainer) -> int:
    """Restore a checkpoint of any layout (the port's or the JAX package's,
    save_table_sharded's included) onto the trainer's; returns its
    global_step."""
    if not trainer.try_restore(None, ft_path=path):
        raise FileNotFoundError(path)
    return trainer.global_step
