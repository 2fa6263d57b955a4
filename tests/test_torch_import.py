"""The port imports torch and never jax, and nothing of the JAX package or
of its tools: importing every module of `swarm_tpu_torch` (in a fresh
interpreter) must load neither jax nor any `swarm_tpu` or `tools` module,
and no source of the port, of chip_smoke.py or of kernel_ab.py (whose
profiler timing chip_smoke.py uses) imports any of them or names
torch.compile."""

import ast
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
def banned():
    return {m for m in sys.modules
            if m.split(".")[0] in ("jax", "swarm_tpu", "tools")}
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
                assert name.split(".")[0] not in (
                    "jax", "swarm_tpu", "tools", "__graft_entry__"), \
                    (path, name)
        assert "torch.compile" not in path.read_text(), path


def test_native_loader_names_no_path_of_the_jax_package():
    """The port's ctypes loader builds and loads its own library from its
    own sources: no string in its code (docstrings aside) names
    `swarm_tpu/` (the JAX package's `native/liboracle.so` included), and
    every path it uses lies inside `swarm_tpu_torch/`."""
    path = ROOT / "swarm_tpu_torch" / "native" / "__init__.py"
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and ast.get_docstring(n) is not None}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            assert "swarm_tpu/" not in node.value, node.value
            assert "swarm_tpu" + "\\" not in node.value, node.value
    out = subprocess.run(
        [sys.executable, "-c", "from swarm_tpu_torch import native as n; "
         "print(n._SO); print(n._SRC); print(n._SRC_CODEC)"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    port = (ROOT / "swarm_tpu_torch").resolve()
    for p in out.stdout.split():
        assert Path(p).resolve().is_relative_to(port), p
