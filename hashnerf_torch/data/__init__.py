from hashnerf_torch.data.scene import Scene
from hashnerf_torch.data.synthetic import make_synthetic_scene


def load_scene(dataset_type: str, datadir: str, args) -> "Scene":
    """Dispatch on dataset_type. Only the procedural scene is ported; the
    blender, llff, scannet, deepvoxels, LINEMOD and st3d loaders are
    ROADMAP A5/A6."""
    if dataset_type == "synthetic":
        return make_synthetic_scene()
    raise NotImplementedError(
        f"hashnerf_torch: dataset_type {dataset_type!r} is not ported yet "
        "(ROADMAP A5: blender; A6: llff, scannet, deepvoxels, LINEMOD, st3d)"
    )
