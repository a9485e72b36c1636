"""Write a checkpoint of the JAX package, and a view it rendered, for the
port to read.

Trains the JAX Trainer for 8 steps on the CPU at the widths of
configs/synthetic_smoke.txt with --log2_hashmap_size 11, on the procedural
scene of `make_synthetic_scene()`, its hash table first scaled from
U(-1e-4, 1e-4) to U(-1, 1) so that the 8 steps leave a field with
structure to render (tests/test_torch_train.py does the same). RAdam moves
from step 6, so the checkpoint holds live moments. Writes into
tests/golden/jax_smoke_ckpt/:
  000008.ckpt  the JAX package's checkpoint (train/checkpoint.py);
  view.npz     flags (the command-line flags of the run), c2w (3, 4) of the
               first test view, and the rgb (H, W, 3) and depth (H, W) the
               JAX package rendered there (Trainer.render_image, eval mode).
tests/test_torch_jax_ckpt.py and chip_smoke.py restore the checkpoint in the
port and render the same view.

Usage: JAX_PLATFORMS=cpu python tests/golden/make_jax_ckpt_fixture.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "golden", "jax_smoke_ckpt")
FLAGS = ["--config", "configs/synthetic_smoke.txt", "--log2_hashmap_size", "11", "--no_reload"]
N_STEPS = 8


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hashnerf_tpu.data.synthetic import make_synthetic_scene
    from hashnerf_tpu.train.config import parse_args
    from hashnerf_tpu.train.driver import Trainer

    os.chdir(ROOT)
    args = parse_args(FLAGS)
    scene = make_synthetic_scene()
    trainer = Trainer(args, scene)
    trainer.state = trainer.state._replace(hash_table=trainer.state.hash_table * 1e4)
    rng = np.random.default_rng(0)
    for i in range(1, N_STEPS + 1):
        img_i = int(rng.choice(scene.i_train))
        m = trainer.step(trainer.sample_image(img_i, args.N_rand, precrop=i < args.precrop_iters))
        print(f"step {i} loss {float(m['loss'])}")
    os.makedirs(OUT, exist_ok=True)
    trainer.save(os.path.join(OUT, "{:06d}.ckpt".format(N_STEPS)))
    c2w = np.asarray(scene.poses[scene.i_test[0]])[:3, :4].astype(np.float32)
    rgb, depth, _, _ = trainer.render_image(c2w)
    np.savez(os.path.join(OUT, "view.npz"), flags=np.array(FLAGS), c2w=c2w,
             rgb=np.asarray(rgb, np.float32), depth=np.asarray(depth, np.float32))
    print("wrote", OUT)


if __name__ == "__main__":
    main()
