"""Build and load the CUDA kernels in `repro_torch/csrc/`.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library
with a plain C interface, loaded with `ctypes`.  Nothing includes
PyTorch's headers, so a build takes seconds.  Libraries go to
`build/repro_torch_kernels/` at the repository root, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one is reused (a shared `csrc/*.cuh` header counts as part of every
source).  Nothing is built at import: the first launch of a
kernel builds it, and `build_all()` builds every source at once, one
`nvcc` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
SOURCES = ("cim_gemv", "swiglu_gemv", "paged_flash_decode",
           "paged_flash_verify", "flash_decode")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _lib_path(name: str) -> Path:
    """Library path keyed by the source, the shared headers and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.name = tmp, out, name
    return proc


def _finish(proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(proc.tmp)
        raise RuntimeError(f"nvcc failed for {proc.name}.cu:\n{log}")
    os.replace(proc.tmp, proc.out)      # atomic: no half-written library


def build_all(names=SOURCES) -> List[str]:
    """Build every library not built yet, all `nvcc`s in parallel.
    Returns the names that were compiled (empty when all were cached)."""
    procs = [_start(n, _lib_path(n)) for n in names
             if not _lib_path(n).exists()]
    try:
        for p in procs:
            _finish(p)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.name for p in procs]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def stream_handle() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
