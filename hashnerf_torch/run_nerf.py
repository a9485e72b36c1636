"""CLI entry point of the port:

    python -m hashnerf_torch.run_nerf --config configs/chair.txt --datadir DIR [--device cpu]

Counterpart of run_nerf.py's `main`: parse the flags (raising for any flag
that selects something not yet ported), load the scene, name the
experiment and dump its args, then either train (`train_loop`) or, with
--render_only, restore the latest checkpoint (the port's or the JAX
package's) and render the test set (--render_test) or the demo path into
`renderonly_{test|path}_{step:06d}/`, figures and a video. Runs on CUDA
unless --device names another device.
"""
from __future__ import annotations

import os


def main(argv=None):
    from hashnerf_torch.data import load_scene
    from hashnerf_torch.train.config import check_supported, create_expname, parse_args
    from hashnerf_torch.train.driver import Trainer, train_loop
    from hashnerf_torch.utils.io import dump_args, save_video

    args = parse_args(argv)
    check_supported(args)
    scene = load_scene(args.dataset_type, args.datadir, args)
    args.expname = create_expname(args)
    savepath = os.path.join(args.basedir, args.expname)
    os.makedirs(savepath, exist_ok=True)
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

    return train_loop(args, scene, device=args.device)


if __name__ == "__main__":
    main()
