"""The native (C++) Voronoi cell builder, loaded through ctypes.

Twin of skirt_tpu/native/__init__.py (`build`, `load`, `voronoi_cells`;
the Walker alias builder belongs to the dust-emission slice S3).
ref: the reference's Voro++ layer (SKIRTcore/VoronoiMesh.cpp:324-363).

The library builds with g++ at first use, never at import, into
`skirt_tpu_torch/_build/` (listed in .gitignore), keyed by a hash of the
source and the flags.  The flags are skirt_tpu's own: other flags may
contract other products into FMAs and move the volumes' last bits.  A
build is written under a temporary name and renamed into place.  Without
a toolchain `voronoi_cells` returns None and the caller falls back to
scipy ridges with Monte Carlo volumes; the reason is kept in
`load_error`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "voronoi.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib = None
load_error = None


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libskirt_voronoi_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile voronoi.cpp with g++ (cached by content and flags)."""
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, so.name)
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    return so


def load():
    """The loaded library (built first if needed), or None when it cannot
    be built or loaded (the reason in `load_error`)."""
    global _lib, load_error
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        load_error = str(e)
        return None
    lib.voronoi_build.restype = ctypes.c_int
    lib.voronoi_build.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return _lib


def voronoi_cells(sites, box):
    """Exact Voronoi cells: (volumes, centroids, neighbour data, neighbour
    offsets) in CSR form, or None without the library.

    sites: (n, 3) float64; box: (xmin, ymin, zmin, xmax, ymax, zmax)."""
    lib = load()
    if lib is None:
        return None
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int64)
    sites = np.ascontiguousarray(sites, dtype=np.float64)
    box = np.ascontiguousarray(box, dtype=np.float64)
    n = sites.shape[0]
    volumes = np.empty(n)
    centroids = np.empty((n, 3))
    offsets = np.empty(n + 1, dtype=np.int64)
    cap = max(32 * n, 1024)
    for _ in range(3):
        data = np.empty(cap, dtype=np.int64)
        rc = lib.voronoi_build(
            sites.ctypes.data_as(dptr), ctypes.c_int64(n),
            box.ctypes.data_as(dptr), volumes.ctypes.data_as(dptr),
            centroids.ctypes.data_as(dptr), data.ctypes.data_as(iptr),
            ctypes.c_int64(cap), offsets.ctypes.data_as(iptr))
        if rc == 0:
            return volumes, centroids, data[:offsets[n]], offsets
        cap = int(offsets[n]) + 16
    return None
