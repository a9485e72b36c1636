"""The import guard, and that the yardstick, every model family and every
scene kind import nothing of the port."""
import os
import subprocess
import sys

from nerfbench import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_whole_top_level_names():
    names = ["hashnerf_torch", "hashnerf_torch.kernels", "hashnerf_tpux", "jaxtyping",
             "torch", "flax.linen", "jax.numpy", "jaxlib", "hashnerf_tpu.ops"]
    assert guard.forbidden_modules(names) == ["flax.linen", "hashnerf_tpu.ops", "jax.numpy",
                                              "jaxlib"]


def test_the_port_passes_and_a_planted_jax_package_import_fails():
    ok = _run("import hashnerf_torch.train.driver, nerfbench.harness\n"
              "from nerfbench import guard\nguard.check('test')\nprint('passed')")
    assert ok.returncode == 0 and "passed" in ok.stdout, ok.stderr
    bad = _run("import hashnerf_torch.train.driver, hashnerf_tpu\n"
               "from nerfbench import guard\nguard.check('test')\nprint('passed')")
    assert bad.returncode == 3 and "passed" not in bad.stdout
    assert "hashnerf_tpu" in bad.stderr


def test_the_yardstick_imports_nothing_of_the_port():
    r = _run("import sys\nimport nerfbench.reference, nerfbench.counts, nerfbench.pool, "
             "nerfbench.trace, nerfbench.traffic, nerfbench.spec\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('hashnerf_torch', 'hashnerf_tpu', 'jax')))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _names(kind: str):
    return sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "nerfbench", kind))
                  if f.endswith(".py"))


def test_every_family_and_scene_imports_nothing_of_the_port():
    families, scenes = _names("families"), _names("scenes")
    assert "ngp" in families and "ring" in scenes
    r = _run("import sys\nfrom nerfbench import spec\n"
             f"for f in {families!r}:\n    spec.family_of({{'family': f}})\n"
             f"for k in {scenes!r}:\n    spec.scene_of({{'scene': {{'kind': k}}}})\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('hashnerf_torch', 'hashnerf_tpu', 'jax', 'jaxlib', 'flax')))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
