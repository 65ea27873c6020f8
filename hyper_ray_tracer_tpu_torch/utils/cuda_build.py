"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the root of the checkout.  The file name carries a
hash of the source and the flags, so an edited source builds anew and an
unchanged one is loaded as is.  Nothing falls back: a missing ``nvcc`` or
a failed build raises.

The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
is kept next to the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}  # name -> ctypes.CDLL; a loaded library cannot unload


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return it."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True, timeout=600)
        Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
