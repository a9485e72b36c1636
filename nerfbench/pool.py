"""The ray pool that a configuration trains from when its argv leaves out
--no_batching, as the port's own loops train by default.

  * An image pool (the scene gives "images"): Trainer.build_ray_pool, every
    pixel of the training views as a row [origin, direction, colour] in
    image, row, column order, shuffled by a randperm on the trainer's
    generator, and reshuffled so at each epoch's end (train_loop).
  * A column pool (the scene gives "pool"): Trainer.build_column_pool over
    the scene's ray columns, shuffled by the permutations of
    np.random.default_rng(seed) through Trainer.shuffle_pool (main_st3d).

PoolCursor holds the pool, the row the next step starts at, and every
shuffle made so far. A span ends at the next i_print event or at the
pool's last whole batch, whichever comes first, and is one
Trainer.run_steps(n, block_size, pool=, offset=) call. Where no whole batch
is left, the pool is reshuffled in place and the cursor goes back to row 0,
as both loops do; inside a window, users pay for it. There is no precrop
with a pool (train_loop's rule).

The check: `record(n)` notes where the next n steps' rows stand (the
offset and the shuffles), and `source_ids` works out from that record,
without the program's pool, which rows of the benchmark's own inputs they
are; the reference makes them from the scene (Reference.pool_rows).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function


class PoolCursor:
    """A ray pool on the device and where the next step's rows start."""

    def __init__(self, trainer, pool: torch.Tensor, rng: Optional[np.random.Generator]):
        """rng: the host permutations of a column pool; None shuffles on the
        trainer's generator (an image pool)."""
        self.trainer, self.pool, self.rng = trainer, pool, rng
        self.n_rand = trainer.args.N_rand
        self.offset = 0
        self.shuffles = []  # ("generator", its state) or ("rng", its state), before each shuffle

    def shuffle(self) -> None:
        """Shuffle the pool in place and start again at row 0."""
        with record_function("nb.pool_shuffle"):
            if self.rng is None:
                self.shuffles.append(("generator", self.trainer.generator.get_state()))
                self.trainer.shuffle_pool(self.pool)
            else:
                self.shuffles.append(("rng", self.rng.bit_generator.state))
                self.trainer.shuffle_pool(self.pool, self.rng.permutation(self.pool.shape[0]))
        self.offset = 0

    def steps_left(self) -> int:
        """The whole batches left before the pool's end."""
        return (self.pool.shape[0] - self.offset) // self.n_rand

    def span_end(self, i: int, i_print: int) -> int:
        """The last step of the span from step i: the next i_print event or
        the pool's last whole batch, whichever comes first; the pool is
        reshuffled first where no whole batch is left."""
        if self.steps_left() == 0:
            self.shuffle()
        return min(((i - 1) // i_print + 1) * i_print, i + self.steps_left() - 1)

    def run(self, n: int, block_size: int):
        """n steps from the cursor in one run_steps call; returns its metrics."""
        m = self.trainer.run_steps(n, block_size=block_size, pool=self.pool, offset=self.offset)
        self.offset += n * self.n_rand
        return m

    def sample(self) -> Dict[str, torch.Tensor]:
        """The pool's next batch as an eager step takes it (sample_pool); the
        cursor does not move."""
        if self.steps_left() == 0:
            self.shuffle()
        return self.trainer.sample_pool(self.pool, self.offset, self.n_rand)

    def record(self, n_steps: int) -> dict:
        """Where the rows of the next n_steps steps stand: the pool's size,
        the shuffles so far and the offset. Where fewer whole batches are
        left, the pool is reshuffled first, as the loop would."""
        if self.steps_left() < n_steps:
            self.shuffle()
        return {"size": self.pool.shape[0], "shuffles": list(self.shuffles),
                "offset": self.offset, "rows": n_steps * self.n_rand}


def make_pool(trainer, sc: dict, seed: int) -> PoolCursor:
    """The pool of a configuration that trains from one: the scene's "pool"
    columns (the depth and gradient targets only where the argv asks for
    them, as main_st3d passes them), else its images."""
    if "pool" in sc:
        args = trainer.args
        use = {"target_depth": args.use_depth, "target_grad": args.use_gradient}
        columns = {k: (v.cpu().numpy() if use.get(k, True) else None)
                   for k, v in sc["pool"].items()}
        cursor = PoolCursor(trainer, trainer.build_column_pool(columns),
                            np.random.default_rng(seed))
        cursor.shuffle()
        return cursor
    state = trainer.generator.get_state()
    cursor = PoolCursor(trainer, trainer.build_ray_pool(), None)
    cursor.shuffles.append(("generator", state))
    return cursor


def source_ids(rec: dict, device) -> torch.Tensor:
    """The rows of the benchmark's inputs that a record's rows are (pixels
    in image, row, column order, or the scene's column rows): the pool's
    order worked out again from the start by replaying its shuffles."""
    n = rec["size"]
    ids = torch.arange(n, device=device)
    for kind, state in rec["shuffles"]:
        if kind == "generator":
            gen = torch.Generator(device=device)
            gen.set_state(state)
            perm = torch.randperm(n, generator=gen, device=device)
        else:
            rng = np.random.Generator(np.random.PCG64())
            rng.bit_generator.state = state
            perm = torch.as_tensor(rng.permutation(n), device=device)
        ids = ids.index_select(0, perm)
    return ids[rec["offset"]:rec["offset"] + rec["rows"]]
