from hashnerf_torch.data.scene import Scene
from hashnerf_torch.data.synthetic import make_synthetic_scene


def load_scene(dataset_type: str, datadir: str, args) -> "Scene":
    """Dispatch on dataset_type: the blender and llff loaders and the
    procedural scene are ported; scannet, deepvoxels, LINEMOD and st3d are
    ROADMAP A6."""
    if dataset_type == "blender":
        from hashnerf_torch.data.blender import load_blender_scene

        return load_blender_scene(datadir, args.half_res, args.testskip, args.white_bkgd)
    if dataset_type == "llff":
        from hashnerf_torch.data.llff import load_llff_scene

        return load_llff_scene(
            datadir, args.factor, spherify=args.spherify,
            llffhold=args.llffhold, no_ndc=args.no_ndc,
        )
    if dataset_type == "synthetic":
        return make_synthetic_scene()
    raise NotImplementedError(
        f"hashnerf_torch: dataset_type {dataset_type!r} is not ported yet "
        "(ROADMAP A6: scannet, deepvoxels, LINEMOD, st3d)"
    )
