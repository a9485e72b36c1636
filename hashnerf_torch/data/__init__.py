from hashnerf_torch.data.scene import RayBundle, Scene
from hashnerf_torch.data.synthetic import make_synthetic_scene


def load_scene(dataset_type: str, datadir: str, args) -> "Scene":
    """Dispatch on dataset_type (run_nerf.py's). st3d has no Scene: its
    loop (run_nerf.main_st3d) loads rays with data/st3d.py."""
    if dataset_type == "blender":
        from hashnerf_torch.data.blender import load_blender_scene

        return load_blender_scene(datadir, args.half_res, args.testskip, args.white_bkgd)
    if dataset_type == "llff":
        from hashnerf_torch.data.llff import load_llff_scene

        return load_llff_scene(
            datadir, args.factor, spherify=args.spherify,
            llffhold=args.llffhold, no_ndc=args.no_ndc,
        )
    if dataset_type == "scannet":
        from hashnerf_torch.data.scannet import load_scannet_scene

        return load_scannet_scene(datadir, args.scannet_sceneID, args.half_res)
    if dataset_type == "deepvoxels":
        from hashnerf_torch.data.deepvoxels import load_deepvoxels_scene

        return load_deepvoxels_scene(args.shape, datadir, args.testskip)
    if dataset_type == "LINEMOD":
        from hashnerf_torch.data.linemod import load_linemod_scene

        return load_linemod_scene(datadir, args.half_res, args.testskip, args.white_bkgd)
    if dataset_type == "synthetic":
        return make_synthetic_scene()
    raise ValueError(f"Unknown dataset type {dataset_type!r}")
