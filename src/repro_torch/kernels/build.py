"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` exports a plain C interface and compiles
into its own shared library for Hopper (``sm_90a``). The library goes to
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads at once. Builds happen
at first use, never at import. A failed build raises: there is no fall
back to a kernel's plain version.
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
SOURCES = ("ann_topk",)
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
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Built]:
    """Compile every library in ``names`` that is not built yet."""
    out = {n: Built(library_path(n)) for n in names}
    for n, built in out.items():
        if built.path.exists():
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = built.path.with_name(f"{built.path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        built.log, built.seconds = proc.stdout, time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA build failed: {n}.cu (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, built.path)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name].path))
        _loaded[name] = lib
    return lib
