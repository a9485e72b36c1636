"""CLI entry point of the port:

    python -m hashnerf_torch.run_nerf --config configs/chair.txt --datadir DIR [--device cpu]

Counterpart of run_nerf.py's `main`: parse the flags (raising for any flag
that selects something not yet ported), load the scene, name the
experiment and dump its args, then either train (`train_loop`) or, with
--render_only, restore the latest checkpoint (the port's or the JAX
package's) and render the test set (--render_test) or the demo path into
`renderonly_{test|path}_{step:06d}/`, figures and a video. `--dataset_type
st3d` runs the panorama loop instead (`main_st3d`, `eval_test_omninerf`).
Runs on CUDA unless --device names another device.

With --num_devices N > 1 it trains data-parallel on N ranks: it spawns them
itself (NCCL, a card each, on CUDA; gloo with --device cpu), or, started
by torchrun (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR set), it is one of
them:

    torchrun --nproc_per_node N -m hashnerf_torch.run_nerf --config ... --num_devices N

Rank 0 alone writes logs, checkpoints, test sets and videos; --render_only
runs on rank 0 alone.
"""
from __future__ import annotations

import os

import numpy as np


def _rank_main(rank: int, world: int, device, argv):
    """One spawned rank: main(argv) in it; returns what the parent gets
    back of its Trainer."""
    trainer = main(argv)
    return {"rank": rank, "global_step": trainer.global_step, "history": trainer.history,
            "restored_from": trainer.restored_from, "last_occ_keep": trainer.last_occ_keep}


def _distributed(args):
    """(go, layout): bring up this rank's process group when the
    environment names a world (torchrun, or a spawned rank), and its 1-D
    data layout over --num_devices ranks (by default the world's size; one
    rank too). --render_only runs in one process (rank 0 under torchrun):
    go is False on another rank, which has nothing to do."""
    from hashnerf_torch.parallel.mesh import dist_env, initialize_distributed, make_mesh

    if args.render_only:
        args.num_devices = 0
        return _rank0(), None
    if not dist_env():
        return True, None
    args.device = str(initialize_distributed(args.device))
    args.num_devices = args.num_devices or int(os.environ["WORLD_SIZE"])
    return True, make_mesh(args.num_devices)


def _rank0() -> bool:
    return int(os.environ.get("RANK", "0")) == 0


def main(argv=None):
    """Returns the Trainer; with --num_devices N > 1 and no world in the
    environment, the N ranks' {rank, global_step, history, restored_from,
    last_occ_keep}
    (each rank's Trainer stays in its process); on a rank other than 0 of
    a --render_only run under torchrun, None."""
    from hashnerf_torch.data import load_scene
    from hashnerf_torch.parallel.mesh import dist_env, launch
    from hashnerf_torch.train.config import check_supported, create_expname, parse_args
    from hashnerf_torch.train.driver import Trainer, train_loop
    from hashnerf_torch.utils.io import dump_args, save_video

    args = parse_args(argv)
    check_supported(args)
    n = args.num_devices or 0
    if n > 1 and not args.render_only and not dist_env():
        from hashnerf_torch import resolve_device
        from hashnerf_torch.train.driver import check_num_devices

        device = resolve_device(args.device)
        check_num_devices(n, args.N_rand, device.type == "cuda")
        return launch(_rank_main, n, device, (argv,))
    go, layout = _distributed(args)
    if not go:
        return None
    if args.dataset_type == "st3d":
        return main_st3d(args, layout)
    scene = load_scene(args.dataset_type, args.datadir, args)
    args.expname = create_expname(args)
    savepath = os.path.join(args.basedir, args.expname)
    os.makedirs(savepath, exist_ok=True)
    if _rank0():
        dump_args(savepath, vars(args), args.config)

    if args.render_only:
        trainer = Trainer(args, scene, device=args.device)
        restored = trainer.try_restore(savepath, args.ft_path)
        print("RENDER ONLY (restored checkpoint)" if restored else "RENDER ONLY (fresh init)")
        if args.render_test:
            poses, gt = scene.poses[scene.i_test], scene.images[scene.i_test]
        else:
            poses, gt = scene.render_poses, None
        testsavedir = os.path.join(
            savepath,
            "renderonly_{}_{:06d}".format("test" if args.render_test else "path", trainer.global_step),
        )
        os.makedirs(testsavedir, exist_ok=True)
        rgbs, _, psnrs = trainer.render_test_path(
            poses, gt_imgs=gt, savedir=testsavedir, render_factor=args.render_factor
        )
        save_video(os.path.join(testsavedir, "video.mp4"), rgbs)
        print("Done rendering", testsavedir)
        return trainer

    return train_loop(args, scene, device=args.device, layout=layout)


def main_st3d(args, layout=None):
    """Panorama training (run_nerf.py's main_st3d): the loader's train rays
    as a ray pool on the device, shuffled by np.random.default_rng(0)'s
    permutations as the JAX loop shuffles them, near 0, far 2, the bbox
    [-2, 2]^3; N_iters at its default 50,000 means 200,000. Spans end at
    i_print, i_weights, i_testset and the pool's end, where the pool is
    reshuffled in place; with --steps_per_dispatch K > 1 a span runs as
    run_steps blocks of K (CUDA graphs on the card), else one step at a
    time. Under data parallelism (layout) rank 0 alone writes. Returns the
    Trainer."""
    import time

    import torch.distributed

    from hashnerf_torch.data.st3d import load_st3d_data, st3d_scene
    from hashnerf_torch.train.config import create_expname
    from hashnerf_torch.train.driver import Trainer
    from hashnerf_torch.utils.io import dump_args, save_loss_history

    rays, rays_test, H, W = load_st3d_data(args.datadir, args.stage)
    near, far = 0.0, 2.0
    print(f"Near Far bounds are: {near}, {far}")
    args.expname = create_expname(args)
    savepath = os.path.join(args.basedir, args.expname)
    os.makedirs(savepath, exist_ok=True)
    if _rank0():
        dump_args(savepath, vars(args), args.config)

    trainer = Trainer(args, st3d_scene(H, W, near, far), device=args.device, layout=layout)
    if not args.no_reload:
        trainer.try_restore(savepath, args.ft_path)
    pool = trainer.build_column_pool({
        "rays_o": rays.o, "rays_d": rays.d, "target": rays.rgb,
        "target_depth": rays.depth if args.use_depth else None,
        "target_grad": rays.g if args.use_gradient else None,
    })
    pool_size = rays.rgb.shape[0]
    del rays
    rng = np.random.default_rng(0)
    trainer.shuffle_pool(pool, rng.permutation(pool_size))

    n_rand, spd = args.N_rand, max(1, args.steps_per_dispatch)
    n_iters = args.N_iters if args.N_iters != 50000 else 200000
    loss_list, psnr_list, time_list = [], [], []
    time0 = time.time()
    i_batch = 0
    i = trainer.global_step + 1
    while i <= n_iters:
        end = n_iters
        for e in (args.i_print, args.i_weights, args.i_testset):
            if e and e > 0:
                end = min(end, ((i - 1) // e + 1) * e)
        end = min(end, i + (pool_size - i_batch) // n_rand - 1)
        if end < i:
            trainer.shuffle_pool(pool, rng.permutation(pool_size))
            i_batch = 0
            continue
        n = end - i + 1
        if spd > 1:
            metrics = trainer.run_steps(n, block_size=spd, pool=pool, offset=i_batch)
        else:
            for k in range(n):
                metrics = trainer.step(trainer.sample_pool(pool, i_batch + k * n_rand, n_rand))
        i_batch += n * n_rand
        i = end

        if i % args.i_weights == 0:
            trainer.save(os.path.join(savepath, "{:06d}.ckpt".format(i)))
        if args.i_testset > 0 and i % args.i_testset == 0:
            if trainer.is_main:
                eval_test_omninerf(trainer, rays_test, H, W,
                                   os.path.join(savepath, "testset_{:06d}".format(i)))
            if trainer.layout is not None:
                torch.distributed.barrier()
        if i % args.i_print == 0:
            loss_v, psnr_v = float(metrics["loss"]), float(metrics["psnr"])
            trainer.history.append((i, loss_v, psnr_v))
            loss_list.append(loss_v)
            psnr_list.append(psnr_v)
            time_list.append(time.time() - time0)
            if trainer.is_main:
                print(f"[TRAIN] Iter: {i} Loss: {loss_v}  PSNR: {psnr_v}")
                save_loss_history(savepath, loss_list, psnr_list, time_list)
        i += 1
    return trainer


def eval_test_omninerf(trainer, rays_test, H: int, W: int, savedir: str):
    """Render the test panoramas (the last --st3d_eval_views of them, 0 =
    all; the ground-truth one is last), write the ground-truth view's MSE
    and PSNR to statistics.txt and the views but the last, there and back,
    to video2.gif. With one view rendered there is no such view, and no GIF
    is written (the JAX package fails there). Returns (rgbs, mse, psnr)."""
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.render.renderer import render
    from hashnerf_torch.utils.io import save_gif

    os.makedirs(savedir, exist_ok=True)
    n_views = rays_test.rgb.shape[0] // (H * W)
    k = trainer.args.st3d_eval_views
    first = max(0, n_views - k) if k > 0 else 0
    rgbs = []
    for v in range(first, n_views):
        sl = slice(v * H * W, (v + 1) * H * W)
        rgb, _, _, _ = render(
            trainer.state, query_fn, H, W, None, trainer.bbox, trainer.render_cfg.eval_mode(),
            chunk=trainer.args.chunk, near=trainer.near, far=trainer.far,
            rays=(rays_test.o[sl], rays_test.d[sl]),
        )
        rgbs.append(rgb.cpu().numpy().reshape(H, W, 3))
    rgbs = np.stack(rgbs, 0)
    gt = rays_test.rgb[-H * W:].reshape(H, W, 3)
    mse = float(np.mean((rgbs[-1] - gt) ** 2))
    psnr = -10.0 * np.log10(mse)
    print(f"ground truth loss: {mse}, psnr: {psnr}")
    with open(os.path.join(savedir, "statistics.txt"), "w") as f:
        f.write(f"loss: {mse}, psnr: {psnr}")
    if len(rgbs) > 1:
        boom = np.concatenate([rgbs[:-1], rgbs[:-1][::-1]])
        save_gif(os.path.join(savedir, "video2.gif"), boom)
    print("Saved test set")
    return rgbs, mse, psnr


if __name__ == "__main__":
    main()
