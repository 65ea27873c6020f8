"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the root of the checkout.  The file name carries a
hash of the source, of every file it includes by a quoted ``#include``
(the shared ``csrc/*.cuh`` headers, followed recursively) and of the
flags, so an edited source or header builds anew and an unchanged one is
loaded as is.  Nothing falls back: a missing ``nvcc`` or
a failed build raises.

The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
is kept next to the library as ``<library>.log``.

``check_arg`` and ``launch`` are what every kernel wrapper does around
its C entry point: validate each tensor it passes, and call the entry
point on the current stream, raising when the launch was refused.
``launch`` also traces it under the kernel's tag (``K1`` ... ``K6``):
a span of that name around the host side of the launch, and the
counters ``<tag>.launches`` and ``<tag>.lanes`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .profiling import count, span

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}  # name -> ctypes.CDLL; a loaded library cannot unload
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


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


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every file it includes with a quoted
    ``#include`` (resolved beside the including file), recursively."""
    todo, seen = [CSRC_DIR / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path not in seen:
            seen.append(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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


def check_arg(kernel: str, name: str, x, shape, dtype, device):
    """Raise unless tensor ``x`` is on ``device`` with ``dtype`` and
    ``shape`` and contiguous: what a kernel's pointer arithmetic assumes."""
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {x.dtype}, expected "
                        f"{dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


def launch(kernel: str, fn, device, *args, tag: str, lanes: int):
    """Call entry point ``fn(*args, stream)`` on ``device``'s current
    stream; it returns ``cudaGetLastError()``, and a non-zero code (a
    launch the card refused) raises.  The call runs in the span ``tag``
    and counts one in ``<tag>.launches`` and ``lanes``, the rays or
    lanes the kernel runs on, in ``<tag>.lanes``."""
    with span(tag), torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")
    count(f"{tag}.launches")
    count(f"{tag}.lanes", lanes)
