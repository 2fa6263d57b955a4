"""The port's import surface against the JAX package's, name by name.

Every public top-level name of every `swarm_tpu/**.py` (functions,
classes, constants; in an `__init__.py` also every name it imports, the
package's exports) must exist in the port's module or package of the same
path. The names that have no direct port are one explicit map below, each
entry naming the port's counterpart (resolved here) or the ROADMAP item
that explains it (found in ROADMAP.md). The JAX sources are read with
`ast`: nothing of jax is imported for the comparison.

Importing every package of the port on a host without a card loads no jax
and nothing of `swarm_tpu`, initialises no CUDA and builds nothing:
kernels and the native library are built at first use.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_parity import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "swarm_tpu"

# JAX-only names: (JAX module path, name) -> the port's counterpart
# ("module:attribute") or the ROADMAP item that explains it.
COUNTERPARTS = {
    # a JAX device mesh and PartitionSpecs; the port runs one process per
    # device on torch.distributed
    ("parallel/mesh.py", "AGENTS_AXIS"): "swarm_tpu_torch.parallel.mesh:RankLayout",
    ("parallel/mesh.py", "make_mesh"): "swarm_tpu_torch.parallel.mesh:make_layout",
    ("parallel/__init__.py", "make_mesh"): "swarm_tpu_torch.parallel:make_layout",
    ("parallel/sharded.py", "state_specs"): "swarm_tpu_torch.parallel.sharded:shard_state",
    ("parallel/__init__.py", "state_specs"): "swarm_tpu_torch.parallel:shard_state",
    # the Pallas kernels' entry points: hand-written CUDA kernels
    ("ops/beam_raster_pallas.py", "free_raster_pallas"): "swarm_tpu_torch.ops.beam_raster_cuda:free_raster",
    ("ops/beam_raster_pallas.py", "room_raster_pallas"): "swarm_tpu_torch.ops.room_raster_cuda:room_raster",
    ("ops/beam_raster_pallas.py", "beam_raster_pallas"): "swarm_tpu_torch.ops.exact_raster_cuda:beam_raster",
    # dead code of the reference, no caller
    ("engine/sim.py", "v2v_nearest_cm"): "ROADMAP C5",
    ("ops/beam_raster.py", "group_min_ranges"): "ROADMAP C5",
}
# JAX modules with no module of the same path in the port
MODULES = {
    "ops/beam_raster_pallas.py": "swarm_tpu_torch.ops.beam_raster_cuda",
    "utils/cache.py": "ROADMAP utils/cache.py",   # JAX's compilation cache
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _public_names(path: Path):
    """Public top-level names of a module; for an __init__.py also the
    names it imports."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                names += [e.id for e in elts if isinstance(e, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


def _port_module(rel: str) -> str:
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["swarm_tpu_torch"] + parts)


def _resolve(target: str):
    """A counterpart: "module:attr" must resolve; "ROADMAP <text>" must be
    found in ROADMAP.md."""
    if target.startswith("ROADMAP "):
        assert target[len("ROADMAP "):] in (ROOT / "ROADMAP.md").read_text(), \
            target
        return
    mod, _, attr = target.partition(":")
    obj = importlib.import_module(mod)
    if attr:
        assert hasattr(obj, attr), target


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_a_counterpart(rel):
    names = _public_names(JAX_PKG / rel)
    if rel in MODULES:
        _resolve(MODULES[rel])
        for name in names:
            if (rel, name) in COUNTERPARTS:
                _resolve(COUNTERPARTS[(rel, name)])
        return
    port = importlib.import_module(_port_module(rel))
    missing = [n for n in names if not hasattr(port, n)]
    for name in missing:
        assert (rel, name) in COUNTERPARTS, \
            f"{_port_module(rel)} lacks {name} (swarm_tpu/{rel})"
        _resolve(COUNTERPARTS[(rel, name)])
    # every entry of the map is still needed
    listed = {n for (r, n) in COUNTERPARTS if r == rel}
    assert listed <= set(missing), sorted(listed - set(missing))


_PROBE = """
import importlib, os, pkgutil, sys
import torch
from swarm_tpu_torch.ops import cuda_build
root = os.path.dirname(cuda_build.BUILD_DIR)
def built():
    out = set()
    for d, _, files in os.walk(cuda_build.BUILD_DIR):
        out |= {os.path.join(d, f) for f in files}
    return out
before = built()
import swarm_tpu_torch
pkgs = ["swarm_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(swarm_tpu_torch.__path__,
                                          "swarm_tpu_torch.") if m.ispkg]
for name in pkgs:
    importlib.import_module(name)
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "swarm_tpu"))
assert not banned, banned
assert not torch.cuda.is_initialized()
assert built() == before, sorted(built() - before)
print(len(pkgs))
"""


def test_importing_every_package_builds_nothing_and_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14
