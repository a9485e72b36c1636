"""CUDA graphs of the training step: many steps a launch.

Counterpart of the scanned blocks of hashnerf_tpu/train/driver.py
(`Trainer._build_block`). There XLA compiles K steps into one program. Here
each step body (ray sampling, forward, backward, RAdam) is captured once as a
CUDA graph, and Trainer.run_steps replays it K times back to back, with no
host sync inside the block; the occupancy-grid update is a graph of its own,
replayed after every `update_every` steps. A replay launches the captured
kernels without Python, which is what the eager step spends its time on.

What a capture asks of the code it captures:
  * no host read of a device value and no host-to-device copy inside the
    step (the step's constants are copied to the device once, before);
  * every tensor that outlives a replay (the parameters, RAdam's state, the
    occupancy grid) at one address, updated in place;
  * random draws from the Trainer's generator, registered with each graph,
    so that every replay draws new numbers: those the eager step would draw
    from the same generator state.

All graphs share one memory pool, since they never run at once. One graph's
outputs may therefore lie in memory another uses for its temporaries: a
block reads its step's outputs before it replays anything else.

Launch counts: the kernel wrappers count in Python, which a capture runs
once and a replay never. A capture notes each wrapper's count, takes it off
again (a capture launches nothing), and every replay adds it. The
collectives of a data-parallel step (parallel/mesh.py: NCCL's, which a
graph captures) are counted the same way.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from hashnerf_torch import kernels
from hashnerf_torch.parallel import mesh


def _counts() -> Dict[str, int]:
    return {**kernels.launch_counts(), **mesh.collective_tally()}


def _add(counts: Dict[str, int], times: int = 1) -> None:
    kernels.add_launches({k: n for k, n in counts.items() if k in kernels.KERNELS}, times)
    mesh.add_collectives({k: n for k, n in counts.items() if k not in kernels.KERNELS}, times)


class CapturedGraph:
    """fn captured as one CUDA graph. fn returns a dict of tensors (the
    outputs each replay rewrites) or None."""

    def __init__(self, fn: Callable[[], Optional[Dict[str, torch.Tensor]]], pool,
                 generator: torch.Generator, state: List[torch.Tensor]):
        # One eager run on a side stream first (PyTorch's rule for capture:
        # it makes lazy state, library handles and workspaces), then undo
        # what it did to `state` and to the generator.
        saved = [t.detach().clone() for t in state]
        rng = generator.get_state()
        before = None
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)

            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(generator)
            before = _counts()
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn() or {}
        finally:
            # a capture launches nothing, whether it worked or raised
            after = _counts()
            self.launches = {} if before is None else {
                k: after[k] - before[k] for k in after if after[k] != before[k]}
            _add(self.launches, -1)
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)
            generator.set_state(rng)

    def replay(self) -> None:
        self.graph.replay()
        _add(self.launches)


class GraphCache:
    """A Trainer's captured graphs by key, in one memory pool. `state`:
    the tensors the captured functions update in place."""

    def __init__(self, generator: torch.Generator, state: List[torch.Tensor]):
        self.pool = torch.cuda.graph_pool_handle()
        self.generator = generator
        self.state = state
        self.graphs: Dict[tuple, CapturedGraph] = {}

    def get(self, key: tuple, fn: Callable) -> CapturedGraph:
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = CapturedGraph(fn, self.pool, self.generator, self.state)
        return graph
