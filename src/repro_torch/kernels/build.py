"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` exports a plain C interface and compiles
into its own shared library for Hopper (``sm_90a``); the headers beside
them (``csrc/*.cuh``) hold what the kernels share. The library goes to
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source, the headers and the flags,
so an edited source rebuilds and an unchanged one loads at once. Builds
happen at first use, never at import; :func:`build_all` starts one nvcc per
source, all at once. A failed build raises: there is no fall back to a
kernel's plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ann_topk", "ann_topk_quant", "ann_topk_ivf")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Built:
    path: Path
    log: str | None = None      # nvcc's output (ptxas report); None if cached
    seconds: float = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels build on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Built]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together."""
    out = {n: Built(library_path(n)) for n in names}
    todo = [n for n, built in out.items() if not built.path.exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = out[n].path.with_name(f"{out[n].path.name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].log, out[n].seconds = log, time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out[n].path)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name].path))
        _loaded[name] = lib
    return lib
