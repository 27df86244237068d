"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source compiles with nvcc for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into `_kernels_build/` beside this file (listed
in .gitignore).  Libraries are keyed by a hash of their source, the
shared headers and the flags, so an edited source rebuilds and an
unchanged one is reused.  All missing libraries build in parallel, one
nvcc process per source.  A failed build raises with nvcc's output.

The wrappers load a library with `library(name, signatures)` and call
its C functions through ctypes: pointers (and the CUDA stream) as
c_void_p, integers as c_int; each C function returns the launch's
cudaError_t, which the wrapper turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
#: nvcc's output (register and shared-memory use per kernel) by source
#: name, for reporting
build_log: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _so_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, all at once."""
    todo = [(src, _so_path(src)) for src in sorted(CSRC.glob("*.cu"))]
    todo = [(src, so) for src, so in todo if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, so, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[src.name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {src.name}:\n{out}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu`, with argtypes set
    from `signatures` ({function: [ctypes types]}) and int results."""
    with _LOCK:
        if name not in _LIBS:
            src = CSRC / f"{name}.cu"
            so = _so_path(src)
            if not so.exists():
                build_all()
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
