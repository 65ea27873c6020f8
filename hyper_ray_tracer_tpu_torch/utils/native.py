"""Build the C++ BVH builder from the checkout and bind it with ctypes.

``native/bvh_builder.cpp`` (the JAX package's host-side builder, read
here, never edited) is compiled on first use with ``c++ -O3 -std=c++17
-fPIC -shared -ffp-contract=off`` into a shared library under
``build/native/`` at the root of the checkout.  The file name carries a
hash of the source and of the flags, so an edited source builds anew and
an unchanged one is loaded as is.  No ``-march=native``: the builder must
produce the arrays of ``models/bvh_build._build_numpy`` bit for bit, and
the flags that decide its arithmetic stay fixed.  The prebuilt
``native/libhrt_native.so`` is never loaded.

Nothing falls back: a missing compiler or a failed build raises, and the
message names ``build_bvh(..., use_native=False)``, the NumPy builder.
Importing this module runs no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "bvh_builder.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")
_HINT = "; build_bvh(..., use_native=False) builds the tree with NumPy"

_lib = None  # the loaded library; a loaded library cannot unload


def find_cxx() -> str:
    """Path of the C++ compiler: $CXX, then c++ and g++ on PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, c++ or g++ on PATH); "
                       "the native BVH builder cannot be built" + _HINT)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhrt_bvh-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the builder unless its library exists; return it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = find_cxx()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed to build {SOURCE.name} (exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}" + _HINT)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, its entry point bound."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32 = ctypes.POINTER(ctypes.c_float)
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.hrt_build_bvh.restype = ctypes.c_int
        lib.hrt_build_bvh.argtypes = [f32, f32, ctypes.c_int, ctypes.c_int,
                                      f32, f32, i32, i32, i32,
                                      ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def build_bvh_arrays(aabb_min, aabb_max, leaf_size: int):
    """``models/bvh_build._build_numpy``'s result from the native builder:
    (bounds_min, bounds_max, leaf_first, leaf_count, skip, perm)."""
    lib = load()
    n = aabb_min.shape[0]
    amin = np.ascontiguousarray(aabb_min, np.float32)
    amax = np.ascontiguousarray(aabb_max, np.float32)
    cap = 2 * n
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    first, count, skip = (np.empty(cap, np.int32) for _ in range(3))
    perm = np.empty(n, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    f32, i32 = ctypes.c_float, ctypes.c_int32
    nn = lib.hrt_build_bvh(p(amin, f32), p(amax, f32), n, leaf_size,
                           p(bmin, f32), p(bmax, f32), p(first, i32),
                           p(count, i32), p(skip, i32),
                           p(perm, ctypes.c_int64))
    if nn < 0:
        raise RuntimeError(f"the native BVH builder refused {n} primitives "
                           f"at leaf size {leaf_size}" + _HINT)
    return (bmin[:nn].copy(), bmax[:nn].copy(), first[:nn].copy(),
            count[:nn].copy(), skip[:nn].copy(), perm)
