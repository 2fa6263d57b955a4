"""The port imports torch and never jax, and nothing of the JAX package:
importing every module of `swarm_tpu_torch` (in a fresh interpreter) must
load neither jax nor any `swarm_tpu` module, and no source of the port,
of chip_smoke.py or of kernel_ab.py (whose profiler timing chip_smoke.py
uses) imports either or names torch.compile."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
def banned():
    return {m for m in sys.modules
            if m.split(".")[0] in ("jax", "swarm_tpu")}
before = banned()
import swarm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(swarm_tpu_torch.__path__,
                                               "swarm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
after = banned()
assert not before, sorted(before)
assert not after, sorted(after)
print(len(names))
"""


def test_import_all_modules_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _sources():
    yield from sorted((ROOT / "swarm_tpu_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"
    yield ROOT / "kernel_ab.py"


def test_no_jax_import_and_no_torch_compile_in_sources():
    for path in _sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                names = []
            for name in names:
                assert name.split(".")[0] not in ("jax", "swarm_tpu"), \
                    (path, name)
        assert "torch.compile" not in path.read_text(), path
