"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or the JAX package, and the chip script refuses to run
without a GPU or outside the repository."""
import os
import pkgutil
import shutil
import subprocess
import sys

import repro_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

BLOCKER = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
        del sys.modules[mod]
'''


def _run(code: str, cwd: str = REPO, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.kernels.fantastic4_fused_mlp" in names
    code = BLOCKER + (
        "import repro_torch\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "print('imported', len(sys.modules))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
