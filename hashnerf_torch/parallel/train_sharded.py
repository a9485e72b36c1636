"""Data-parallel training steps: replicated parameters with a gradient
all-reduce, and ZeRO-1 with a bf16 wire.

Counterpart of hashnerf_tpu/parallel/train_sharded.py. There XLA partitions
one jitted step over a ("data",) mesh and inserts the gradient psums; here
each rank runs the step body on its rows of the global batch and sums
what it must over the layout's data group:

* `sharded_step` (the Trainer's step under --num_devices, and
  `make_sharded_train_step`; JAX's `shard_train_batch` is
  parallel/mesh.py's `shard_batch`): every rank draws the whole batch's random
  numbers from one generator in lockstep and keeps its rows, weights each
  mean over its rays by its share of them and TV (a term of the table
  alone) by 1/N, so the ranks' losses sum to the one-device loss; the
  gradients and the metrics are then all-reduced (SUM), and every rank
  runs the same optimizer step on the same replicated parameters. Under
  global occupancy culling (JAX's one stable argsort over the whole
  batch's block scores) every rank renders the whole batch: it takes the
  one cut, queries its contiguous share of the kept blocks, all-gathers
  the others' raws (whose backward reduce-scatters the summed cotangents
  into each share) and composites every ray, and takes the loss on its
  own rows.
* ZeRO-1 (`chunk_params`, `init_dp_zero`, `make_dp_zero_train_step`): each
  parameter is padded and split into N flat float32 master chunks, a rank
  holding one, and the optimizer's moments exist only as those chunks. A
  step all-gathers the parameters in `broadcast_dtype`, runs forward and
  backward on the rank's rows with the rank's own draws (JAX's
  fold_in(key, axis_index)), reduce-scatters g / N in `grad_dtype` and
  steps the optimizer on its chunk. With a bf16 wire a rank sends P/2 bytes
  each way a step (P the float32 parameter bytes), against the 2P of the
  float32 all-reduce.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from hashnerf_torch.parallel.mesh import (
    Layout, all_gather, all_reduce, reduce_scatter, row_range, shard_batch,
)
from hashnerf_torch.render.renderer import RenderConfig, draw_render, shard_draws
from hashnerf_torch.utils.metrics import mse2psnr


def with_viewdirs(batch: Dict[str, torch.Tensor], use_viewdirs: bool) -> Dict[str, torch.Tensor]:
    if "viewdirs" in batch or not use_viewdirs:
        return batch
    d = batch["rays_d"]
    return dict(batch, viewdirs=d / torch.linalg.norm(d, dim=-1, keepdim=True))


def reduce_gradients(params, group) -> None:
    """SUM every parameter's gradient over group (no group: one rank)."""
    if group is None:
        return
    for p in params:
        if p.grad is not None:
            all_reduce(p.grad, group)


def sharded_step(layout: Layout, loss_fn: Callable, render_cfg: RenderConfig, state, optimizer,
                 batch: Dict[str, torch.Tensor], tv_weight: float, draws=None,
                 generator: Optional[torch.Generator] = None,
                 occ_grid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One data-parallel step of this rank on the global batch; draws (a
    TrainDraws) are the global step's, drawn here from generator (render
    draws for the whole batch, as render_rays would take them; TV's inside
    loss_fn, the same on every rank) unless given. Returns the summed
    loss and img_loss, and the psnr of the whole batch."""
    if draws is None:
        from hashnerf_torch.train.driver import TrainDraws

        draws = TrainDraws()
    R = batch["rays_o"].shape[0]
    start, stop = row_range(layout, R)
    rd = draws.render
    if all(d is None for d in rd):
        rd = draw_render(render_cfg, R, generator, batch["rays_o"].device, occ_grid is not None,
                         batch["rays_o"].dtype)
    optimizer.zero_grad(set_to_none=True)
    occ = render_cfg.occupancy
    if occ_grid is not None and occ is not None and not occ.per_ray:
        # global culling: the whole batch and its draws; one cut, each
        # rank's share of the kept points, every ray composited, the loss
        # on this rank's rows
        loss, (_, img_loss) = loss_fn(state, batch, tv_weight / layout.n_data,
                                      draws._replace(render=rd), generator, occ_grid=occ_grid,
                                      ray_share=(stop - start) / R, layout=layout)
    else:
        rows = {k: v[start:stop] for k, v in batch.items()}
        loss, (_, img_loss) = loss_fn(state, rows, tv_weight / layout.n_data,
                                      draws._replace(render=shard_draws(rd, start, stop)),
                                      generator, occ_grid=occ_grid, ray_share=(stop - start) / R)
    loss.backward()
    reduce_gradients(state.parameters(), layout.data_group)
    optimizer.step()
    sums = torch.stack([loss.detach(), img_loss.detach()])
    if layout.data_group is not None:
        all_reduce(sums, layout.data_group, metrics=True)
    return {"loss": sums[0], "psnr": mse2psnr(sums[1]), "img_loss": sums[1]}


def make_sharded_train_step(layout: Layout, loss_fn: Callable, optimizer,
                            render_cfg: RenderConfig):
    """step(state, batch, tv_weight, draws=None, generator=None,
    occ_grid=None) -> metrics: sharded_step with these fixed. Per-ray
    culling (occ_grid) shards with no collective of its own; global
    culling gathers each pass's kept raws from the ranks' shares
    (parallel/mesh.py::gather_shares)."""
    def step(state, batch, tv_weight, draws=None, generator=None, occ_grid=None):
        return sharded_step(layout, loss_fn, render_cfg, state, optimizer,
                            with_viewdirs(batch, render_cfg.use_viewdirs), tv_weight, draws,
                            generator, occ_grid)

    return step


# --------------------------------------------------------------------------- #
# ZeRO-1
# --------------------------------------------------------------------------- #

def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _chunk(x: torch.Tensor, n: int) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = -(-flat.numel() // n) * n
    return torch.nn.functional.pad(flat, (0, pad - flat.numel())).reshape(n, pad // n)


def chunk_params(tree, n: int):
    """Each tensor of a tree (dicts, lists, tuples) -> (n, padded / n)
    float32: flattened, zero-padded to a multiple of n, one row a rank."""
    return _tree_map(lambda x: _chunk(x, n), tree)


def unchunk_params(chunked, template):
    """Inverse of chunk_params, given the original tensors' shapes and
    dtypes."""
    return _tree_map(lambda c, t: c.reshape(-1)[:t.numel()].reshape(t.shape).to(t.dtype),
                     chunked, template)


def zero_params(state) -> List[torch.Tensor]:
    """The parameters ZeRO-1 chunks, in the optimizer's group order: the
    MLPs', then the table's."""
    return list(state.net_parameters()) + list(state.table_parameters())


def init_dp_zero(layout: Layout, state, args):
    """(master, optimizer): this rank's float32 master chunk of every
    parameter of state (zero_params' order), and the optimizer of
    make_optimizer over them, its two RAdam groups (MLPs, table) kept; its
    moments are made now, as chunks."""
    from hashnerf_torch.train.driver import make_optimizer

    n, r = layout.n_data, layout.data_index
    with torch.no_grad():
        net = [_chunk(p, n)[r].clone() for p in state.net_parameters()]
        table = [_chunk(p, n)[r].clone() for p in state.table_parameters()]
    optimizer = make_optimizer(args, params=(net, table))
    optimizer.init_state()
    return net + table, optimizer


def make_dp_zero_train_step(layout: Layout, loss_fn: Callable, state,
                            grad_dtype: torch.dtype = torch.bfloat16,
                            broadcast_dtype: torch.dtype = torch.bfloat16):
    """step(master, optimizer, batch, tv_weight=0.0, generator=None) ->
    metrics (each the mean over the ranks): the ZeRO-1 step. state is the
    NGPState the forward runs on, its parameters rewritten each step from
    the gathered masters; batch the global batch, of which this rank takes
    its rows; generator this rank's own (rank_generator)."""
    n, group = layout.n_data, layout.data_group
    params = zero_params(state)
    use_viewdirs = state.cfg.use_viewdirs

    def step(master: List[torch.Tensor], optimizer, batch, tv_weight: float = 0.0,
             generator: Optional[torch.Generator] = None):
        # 1) the whole parameters from the masters, cast to the wire's type
        # first so that the gather moves its bytes
        with torch.no_grad():
            for p, c in zip(params, master):
                full = torch.empty(n * c.numel(), dtype=broadcast_dtype, device=c.device)
                all_gather(full, c.to(broadcast_dtype), group)
                p.copy_(full[:p.numel()].view(p.shape))
        # 2) forward and backward on this rank's rows
        for p in params:
            p.grad = None
        rows = shard_batch(layout, with_viewdirs(batch, use_viewdirs))
        loss, (psnr, img_loss) = loss_fn(state, rows, tv_weight, None, generator)
        loss.backward()
        # 3) g / N crosses the wire once, reduce-scattered in grad_dtype
        for p, c in zip(params, master):
            flat = torch.zeros(n * c.numel(), dtype=grad_dtype, device=c.device)
            if p.grad is not None:
                flat[:p.numel()] = (p.grad / n).reshape(-1).to(grad_dtype)
            shard = torch.empty(c.numel(), dtype=grad_dtype, device=c.device)
            reduce_scatter(shard, flat, group)
            c.grad = shard.float()
        # 4) the optimizer on this rank's chunks alone
        optimizer.step()
        m = torch.stack([loss.detach(), psnr.detach(), img_loss.detach()])
        all_reduce(m, group, metrics=True)
        m = m / n
        return {"loss": m[0], "psnr": m[1], "img_loss": m[2]}

    return step


def rank_generator(seed: int, layout: Layout, device) -> torch.Generator:
    """A generator of this data rank's own stream (JAX folds the axis
    index into its key): the ranks of a ZeRO-1 step draw apart."""
    g = torch.Generator(device=device)
    g.manual_seed(seed * 1_000_003 + layout.data_index)
    return g


def zero_placed(master, optimizer, template_state, template_opt):
    """(template tensor, live tensor, placement) pairs of ZeRO-1's state for
    train/checkpoint.py's sharded save and restore: every parameter and
    both moments "data"-chunked, the step counts replicated."""
    pairs = []
    for t, c in zip(zero_params(template_state), master):
        pairs.append((t, c, "data"))
        ts, cs = template_opt.state[t], optimizer.state[c]
        pairs += [(ts["exp_avg"], cs["exp_avg"], "data"),
                  (ts["exp_avg_sq"], cs["exp_avg_sq"], "data"),
                  (ts["step"], cs["step"], "replicated")]
    return pairs


def _zero_whole(state, master, optimizer, args):
    """An optimizer of state's layout, and pairs_of for the sharded save and
    restore."""
    from hashnerf_torch.train.driver import make_optimizer

    whole_opt = make_optimizer(args, state)
    whole_opt.init_state()
    return whole_opt, lambda s, o: zero_placed(master, optimizer, s, o)


def save_dp_zero(path: str, global_step: int, layout: Layout, state, master, optimizer,
                 args) -> None:
    """Checkpoint a ZeRO-1 run (every rank calls it): the master chunks and
    moments gathered whole into state and an optimizer of its layout,
    written by rank 0 with each parameter's placement ("data")."""
    from hashnerf_torch.train.checkpoint import save_sharded

    whole_opt, pairs_of = _zero_whole(state, master, optimizer, args)
    save_sharded(path, global_step, layout, state, whole_opt, pairs_of,
                 {name: "data" for name, _ in state.named_parameters()})


def restore_dp_zero(path: str, layout: Layout, state, master, optimizer, args) -> int:
    """Restore a checkpoint of any layout into this rank's master chunks
    and moments (and state); returns its global_step."""
    from hashnerf_torch.train.checkpoint import restore_sharded

    whole_opt, pairs_of = _zero_whole(state, master, optimizer, args)
    return restore_sharded(path, layout, state, whole_opt, pairs_of)
