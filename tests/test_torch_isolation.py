"""The PyTorch port stands alone: no file of hashnerf_torch/ (nor
chip_smoke.py) imports jax or the JAX package, and importing every module of
the port loads no jax."""
import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hashnerf_tpu"}


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "hashnerf_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


# the modules of slice 9 (the NeRF family, st3d and three loaders): each is
# walked by the import checks below
SLICE9 = ["ops/positional.py", "train/adam.py", "data/st3d.py", "data/scannet.py",
          "data/deepvoxels.py", "data/linemod.py", "tools/generate_equirect_data.py"]
# the modules of slice 10 (multi-device training)
SLICE10 = ["parallel/__init__.py", "parallel/mesh.py", "parallel/train_sharded.py",
           "parallel/table_sharded.py", "parallel/dryrun.py", "tools/multihost_smoke.py"]
# the modules slice 12 added (the A9 tools) or changed (the collectives'
# bytes, the three entry points that ran on the CPU by default)
SLICE12 = ["tools/run_all_checkpoints.py", "tools/make_gif.py", "tools/plot_losses.py",
           "tools/pose_visualizer.py", "tools/blender_render_poses.py", "tools/render_bench.py",
           "tools/profile_step.py", "bench_quality.py", "tools/quality_summary.py",
           "tools/parity_curve.py", "graft_entry.py", "tools/bench_scaling.py",
           "parallel/mesh.py", "parallel/dryrun.py", "tools/multihost_smoke.py"]
# the modules K7 and K8 (the packed encode) added or changed
PACKED_KERNEL_MODULES = ["kernels/packed_encode.py", "kernels/__init__.py", "ops/packed_grid.py"]


def test_port_files_exist():
    files = _port_files()
    assert len(files) > 20
    assert os.path.join(ROOT, "hashnerf_torch", "kernels", "segment_accum.py") in files
    assert os.path.join(ROOT, "hashnerf_torch", "ops", "packed_grid.py") in files
    for rel in SLICE9 + SLICE10 + SLICE12 + PACKED_KERNEL_MODULES:
        assert os.path.join(ROOT, "hashnerf_torch", *rel.split("/")) in files, rel
    # the CUDA sources the kernel modules build
    for src in ("segment_accum.cu", "hash_encode.cu", "scatter_add.cu", "packed_encode.cu",
                "scatter_common.cuh", "red_probe.cu"):
        assert os.path.isfile(os.path.join(ROOT, "hashnerf_torch", "csrc", src)), src


def test_slice9_modules_import_alone():
    """Each module of slice 9, imported in a fresh interpreter on its own,
    loads no jax and none of the JAX package (cv2 only when an mp3d set
    asks for it)."""
    mods = ["hashnerf_torch." + rel[:-3].replace("/", ".") for rel in SLICE9]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | {'cv2'})!r})\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


def test_slice10_modules_import_alone():
    """Each module of slice 10, imported in a fresh interpreter on its own,
    loads no jax and none of the JAX package, and starts no process group."""
    mods = ["hashnerf_torch." + rel[:-3].replace("/", ".").replace(".__init__", "")
            for rel in SLICE10]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print('OK')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


def test_slice12_modules_import_alone():
    """Each module of slice 12, imported in a fresh interpreter on its own,
    loads no jax, none of the JAX package and no matplotlib (the host
    plots import it when they draw), and starts no process group."""
    mods = ["hashnerf_torch." + rel[:-3].replace("/", ".") for rel in SLICE12]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | {'matplotlib'})!r})\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print('OK')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


def test_packed_kernel_modules_import_alone():
    """The modules of K7 and K8, imported in a fresh interpreter on their own,
    load no jax and none of the JAX package, and build or load no kernel
    library (a kernel is built at its first launch); csrc/packed_encode.cu
    names neither."""
    mods = ["hashnerf_torch." + rel[:-3].replace("/", ".").replace(".__init__", "")
            for rel in PACKED_KERNEL_MODULES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | {'triton'})!r})\n"
        "assert not bad, bad\n"
        "from hashnerf_torch.kernels import build\n"
        "assert not build._LIBS, build._LIBS\n"
        "print('OK')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")
    src = open(os.path.join(ROOT, "hashnerf_torch", "csrc", "packed_encode.cu")).read()
    assert not any(f"#include <{m}" in src or f'#include "{m}' in src for m in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hashnerf_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(hashnerf_torch.__path__, 'hashnerf_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert len(mods) > 20, mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('OK', len(mods))\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")
