"""Build and load of the port's CUDA sources (`swarm_tpu_torch/csrc/`).

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers: seconds, not minutes), in the
gitignored `swarm_tpu_torch/build/`, at first use. The library's name
carries a hash of the source, of every shared header in `csrc/` and of the
flags, so an edit rebuilds it. `build_all` starts one nvcc per source at
once. The wrappers load a library with `ctypes` and pass device pointers
and the current stream as Python ints.

Flags: `sm_90a` (Hopper), `--fmad=false` so that every add and multiply
rounds on its own, as the plain torch versions issue them; IEEE division
and square root are nvcc's defaults without `--use_fast_math`. ptxas's
report of registers and spills per kernel instance is kept in `ptxas`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_libs = {}
_lock = threading.Lock()
# name -> ptxas's register and spill summary of the build made by this
# process (none when the library was already built)
ptxas = {}
# name -> [(kernel instance, registers, bytes spilled)] of the same build
ptxas_instances = {}


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into build/ unless a library of the same
    source, headers and flags is there; return the library's path."""
    from torch.utils.cpp_extension import CUDA_HOME

    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source(name)] + sorted(glob.glob(os.path.join(CSRC,
                                                               "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    if CUDA_HOME is None:
        raise RuntimeError(f"no CUDA toolkit found to build {name}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    run = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"),
                          *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
                          source(name)], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{run.stderr}")
    ptxas[name] = _ptxas_summary(run.stderr)
    ptxas_instances[name] = _ptxas_instances(run.stderr)
    os.replace(tmp, out)
    return out


def _ptxas_summary(log: str) -> str:
    """The range of registers per thread and of spilled bytes over the
    kernel instances of one `-Xptxas -v` log."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} instances, {min(regs)}-{max(regs)} registers, "
            f"{min(spills, default=0)}-{max(spills, default=0)} bytes "
            f"spilled")


def _instance_label(mangled: str) -> str:
    """`free_raster_kernel<0,1,bf16>` for a mangled kernel template
    instance: integers, bools as 0 / 1, float as f32, __nv_bfloat16 as
    bf16; `exact_raster_kernel` for a kernel that is no template."""
    m = re.search(r"([A-Za-z_]+_kernel)I(.*?)EEv", mangled)
    if not m:
        plain = re.search(r"\d([A-Za-z][A-Za-z_]*_kernel)E", mangled)
        return plain.group(1) if plain else mangled
    args = re.findall(r"L[ib](\d+)E|(?<![\d_])(f)(?=E|L|\d|$)|"
                      r"\d+(__nv_bfloat16)", m.group(2) + "E")
    names = [a or ("f32" if f else "bf16") for a, f, _ in args]
    return f"{m.group(1)}<{','.join(names)}>"


def _ptxas_instances(log: str) -> list:
    """[(kernel instance, registers, bytes spilled)] of one `-Xptxas -v`
    log, one entry per compiled kernel."""
    out = []
    for chunk in re.split(r"Compiling entry function '", log)[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((_instance_label(chunk.split("'", 1)[0]),
                    int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else 0))
    return out


def build_all(names) -> dict:
    """Build every source at once (one nvcc each). Returns {name: (library
    path, seconds)}."""
    def one(name):
        t0 = time.perf_counter()
        return name, (build(name), time.perf_counter() - t0)

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        return dict(ex.map(one, names))


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built at first use);
    `bind(lib)` sets its functions' argtypes once."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build(name))
            bind(lib)
            _libs[name] = lib
        return _libs[name]
