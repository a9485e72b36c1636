"""Process groups for multi-device training, and the helpers that split a
batch over them.

Counterpart of hashnerf_tpu/parallel/mesh.py. The JAX package lays its
devices out as a `Mesh` whose axes XLA partitions over; here each device is
one process (a rank) of a `torch.distributed` process group, and a mesh is
a `Layout`: ranks laid out (data, model), the model axis inner (ranks that
share a host share a model row), with one process group along each axis
for each rank. The backend is NCCL for CUDA devices and gloo for the CPU.

`launch` runs a function on N ranks it spawns itself (as JAX's
one-process `--num_devices` needs no launcher); a run that `torchrun`
started reads its rank and world from the environment instead
(`initialize_distributed`). Collectives that a training step runs go
through the counting wrappers below (`all_reduce`, `all_gather`,
`reduce_scatter`, and `gather_shares`, an all-gather whose backward is a
reduce-scatter): like the kernel wrappers, each keeps a count of its
calls and of its payload bytes, which a CUDA graph's replays add to
(train/graphs.py).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# A rank that waits longer than this at a collective raises.
TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(device, local_rank: int) -> torch.device:
    """The device a rank runs on: cuda:{local_rank} under NCCL; every rank
    on one card (cuda:0) when the card is shared over gloo; else device."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is not None:
        return device
    return torch.device("cuda", local_rank % max(1, torch.cuda.device_count()))


def dist_env() -> bool:
    """Whether the environment names a world (torchrun, or launch)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize_distributed(device=None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           backend: Optional[str] = None) -> torch.device:
    """Bring up the default process group once per process; returns the
    rank's device. Arguments default to the environment torchrun sets
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR / MASTER_PORT: init_method
    `env://`); init_method may name a `file://` or `tcp://` store. The
    backend is NCCL for a CUDA device (each rank on cuda:{local_rank}), else
    gloo. Under NCCL, more ranks than cards raises ValueError."""
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cuda" if device is None else device)
    if dist.is_initialized():
        backend = dist.get_backend()
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dev = rank_device(device, local_rank)
    if backend == "nccl":
        if world_size > torch.cuda.device_count():
            raise ValueError(f"{world_size} NCCL ranks > {torch.cuda.device_count()} CUDA "
                             "devices (NCCL takes one card a rank)")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank, timeout=TIMEOUT, **kw)
    return dev


@dataclasses.dataclass
class Layout:
    """This rank's place in an (n_data, n_model) layout of the world's
    ranks: rank = data_index * n_model + model_index. data_group holds the
    ranks of this rank's model index (they split the rays), model_group
    those of its data index (they split the table's levels)."""

    n_data: int
    n_model: int
    rank: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def axes(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}


def _make_layout(n_data: int, n_model: int) -> Layout:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed (or run under launch)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) layout needs {n_data * n_model} ranks, "
                         f"the world has {world}")
    d, m = divmod(rank, n_model)
    # An axis that spans the world uses the default group; an axis of one
    # rank has none. Otherwise every rank creates every group of the axis,
    # in one order (new_group is collective).
    def axis_groups(n_groups: int, members):
        if n_groups == 1:
            return [dist.group.WORLD]
        if n_groups == world:
            return [None] * n_groups
        return [dist.new_group(members(i)) for i in range(n_groups)]

    data_group = axis_groups(n_model, lambda mi: [di * n_model + mi for di in range(n_data)])[m]
    model_group = axis_groups(n_data, lambda di: [di * n_model + mi for mi in range(n_model)])[d]
    return Layout(n_data, n_model, rank, d, m, data_group, model_group)


def make_mesh(n_devices: int = 0) -> Layout:
    """A 1-D data layout over the world's ranks (n_devices: all of them
    when 0)."""
    return _make_layout(n_devices or dist.get_world_size(), 1)


def make_dcn_mesh(n_hosts: int, model_per_host: int = 1) -> Layout:
    """A 2-D (data, model) layout for several hosts: the model axis inside
    a host (its collectives are each step's feature gathers), the data axis
    across hosts (the gradient all-reduce). Ranks of one host are
    consecutive, as torchrun numbers them."""
    world = dist.get_world_size()
    if world % n_hosts or (world // n_hosts) % model_per_host:
        raise ValueError(f"{world} ranks do not split into {n_hosts} hosts of "
                         f"{model_per_host}-rank model groups")
    return _make_layout(world // model_per_host, model_per_host)


def row_range(layout: Layout, n_rows: int):
    """[start, stop) of this rank's contiguous rows of n_rows, split as
    evenly as the rows allow over the data axis (the first n_rows % n_data
    ranks take one more)."""
    if n_rows < layout.n_data:
        raise ValueError(f"{n_rows} rows cannot be split over {layout.n_data} data ranks")
    q, r = divmod(n_rows, layout.n_data)
    d = layout.data_index
    start = d * q + min(d, r)
    return start, start + q + (1 if d < r else 0)


def shard_rays(layout: Layout, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of x (its leading axis split over data)."""
    start, stop = row_range(layout, x.shape[0])
    return x[start:stop]


def shard_batch(layout: Layout, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's rows of every per-ray tensor of a batch."""
    return {k: shard_rays(layout, v) for k, v in batch.items()}


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Broadcast tensors from rank src to every rank, in place."""
    for t in tensors:
        dist.broadcast(t, src)


# --------------------------------------------------------------------------- #
# Collectives a step runs, counted
# --------------------------------------------------------------------------- #

def _counted(fn):
    fn.calls = 0
    fn.bytes = 0
    return fn


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@_counted
def all_reduce(t: torch.Tensor, group=None, metrics: bool = False) -> None:
    """In-place SUM over group. metrics marks a step's metrics (loss,
    img_loss, psnr), whose bytes collective_bytes also lists apart."""
    dist.all_reduce(t, group=group)
    all_reduce.calls += 1
    all_reduce.bytes += _nbytes(t)
    if metrics:
        all_reduce.metric_bytes += _nbytes(t)


all_reduce.metric_bytes = 0


@_counted
def all_gather(out: torch.Tensor, t: torch.Tensor, group=None) -> None:
    """out (n * len(t), ...) = the group's t, in rank order."""
    dist.all_gather_into_tensor(out, t, group=group)
    all_gather.calls += 1
    all_gather.bytes += _nbytes(out)


@_counted
def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group=None) -> None:
    """out = this rank's chunk of the group's SUM of t (n * len(out), ...)."""
    dist.reduce_scatter_tensor(out, t, group=group)
    reduce_scatter.calls += 1
    reduce_scatter.bytes += _nbytes(out)


class _GatherShares(torch.autograd.Function):
    """Forward: the group's shares, concatenated in rank order (all_gather).
    Backward: every rank's cotangent of the whole, SUMMED, and this rank's
    share of it (reduce_scatter), since a share feeds every rank's loss."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group, n: int) -> torch.Tensor:
        ctx.group, ctx.n = group, n
        out = t.new_empty((n * t.shape[0], *t.shape[1:]))
        all_gather(out, t.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        share = g.new_empty((g.shape[0] // ctx.n, *g.shape[1:]))
        reduce_scatter(share, g.contiguous(), ctx.group)
        return share, None, None


def gather_shares(t: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The data group's equal shares t (k, ...) as one (n_data * k, ...)
    tensor, in data-rank order; its gradient is the SUM of every rank's
    gradient of the whole, taken at this rank's share. Global culling's
    kept raws (render/occupancy.py::query_with_culling)."""
    return _GatherShares.apply(t, layout.data_group, layout.n_data)


COLLECTIVES = {"all_reduce": all_reduce, "all_gather": all_gather,
               "reduce_scatter": reduce_scatter}


def collective_counts() -> Dict[str, int]:
    return {name: fn.calls for name, fn in COLLECTIVES.items()}


def collective_bytes() -> Dict[str, int]:
    """Payload bytes of each kind since the last reset, in the convention
    of hlo_collective_summary (hashnerf_tpu/tools/bench_scaling.py:53-69):
    an all-reduce or all-gather counts the whole output a rank holds, a
    reduce-scatter its 1/n output shard. "all_reduce_metrics" repeats
    apart the all-reduces marked as a step's metrics, which "all_reduce"
    includes."""
    return {**{name: fn.bytes for name, fn in COLLECTIVES.items()},
            "all_reduce_metrics": all_reduce.metric_bytes}


def collective_tally() -> Dict[str, int]:
    """The counts and, under "<name>_bytes", the bytes: what a CUDA graph
    records of its capture and adds back on each replay (add_collectives)."""
    return {**collective_counts(), **{f"{k}_bytes": v for k, v in collective_bytes().items()}}


def reset_collective_counts() -> None:
    """Counts and bytes to 0."""
    for fn in COLLECTIVES.values():
        fn.calls = 0
        fn.bytes = 0
    all_reduce.metric_bytes = 0


def add_collectives(tally: Dict[str, int], times: int = 1) -> None:
    """Add a collective_tally's differences (counts or bytes) times over."""
    for key, n in tally.items():
        if key == "all_reduce_metrics_bytes":
            all_reduce.metric_bytes += n * times
        elif key.endswith("_bytes"):
            COLLECTIVES[key[:-len("_bytes")]].bytes += n * times
        else:
            COLLECTIVES[key].calls += n * times


def world_backend(world: int, device) -> str:
    """The backend of `world` ranks on device: NCCL, a card a rank, when
    the cards suffice; gloo otherwise, its ranks on the CPU or sharing
    card 0 (gloo takes CUDA tensors for every collective the port runs)."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


# --------------------------------------------------------------------------- #
# Spawning the ranks
# --------------------------------------------------------------------------- #

def _rank_entry(rank: int, fn: Callable, world: int, store: str, device, backend,
                args: tuple) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = initialize_distributed(device, f"file://{store}", world, rank, backend)
    try:
        out = fn(rank, world, dev, *args)
        torch.save(out, os.path.join(os.path.dirname(store), f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, device="cpu", args: tuple = (),
           backend: Optional[str] = None) -> List[Any]:
    """Run fn(rank, world, device, *args) on `world` ranks spawned here, one
    process each, under one process group (a file store in a temporary
    directory, so parallel launches never share a port); returns each
    rank's result, in rank order. fn must be importable (a module-level
    function) and its result picklable. A rank that raises makes launch
    raise, after the others are stopped."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="hashnerf_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_rank_entry, args=(fn, world, store, str(device), backend, args),
                           nprocs=world, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(world)]
