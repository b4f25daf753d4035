"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile with nvcc into one shared library with a plain C
interface, loaded through ctypes.  The build runs at first use, never at
import: the CPU tests import every module of the package on machines
without nvcc.  The library is keyed by a hash of the sources and flags
and lands in `skirt_tpu_torch/_build/` (listed in .gitignore); a build
is written under a temporary name and renamed into place, so a cut
build never leaves a half-written library behind.

Each C entry point returns `cudaGetLastError()` after its launch; the
Python wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false keeps a*b+c as two roundings, the way the plain PyTorch
# versions compute it (one elementwise op at a time), so a kernel and its
# plain version round alike
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None
build_log = ""


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile csrc/*.cu into _build/libskirt_kernels_<hash>.so (cached)."""
    global build_log
    so = BUILD_DIR / f"libskirt_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


class PolyArgs(ctypes.Structure):
    """Mirror of `struct PolyArgs` in csrc/fused_poly.cu (same order)."""
    MAX_LEAD = 8
    MAX_W = 128
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "u", "oc", "L", "L0", "px", "py", "pz", "dx", "dy", "dz",
            "alive", "ns", "bc",
            "opx", "opy", "opz", "odx", "ody", "odz", "oalive", "ons",
            "oLn", "oLp", "odepi", "odepv", "oIp", "ocos", "obc", "ofresh")]
        + [(name, ctypes.c_int) for name in (
            "N", "W", "npanels", "np_peel", "nlead", "min_scatt", "K",
            "scattering_peeloff", "nx", "ny", "nz")]
        + [(name, ctypes.c_float) for name in (
            "xi", "inv_np", "inv_pp", "inv_minred", "invL")]
        + [(name, ctypes.c_float * 3) for name in (
            "box_lo", "box_hi", "loc_lo", "loc_inv")]
        + [("lead_k", (ctypes.c_float * 3) * MAX_LEAD),
           ("lead_inv", (ctypes.c_float * 3) * MAX_LEAD),
           ("lead_moving", (ctypes.c_int * 3) * MAX_LEAD),
           ("dens", ctypes.c_float * 8),
           ("samp", ctypes.c_float * 4)])


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.skirt_binned_add.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.skirt_binned_add.restype = ctypes.c_int
        lib.skirt_binned_route.argtypes = [ctypes.c_int]
        lib.skirt_binned_route.restype = ctypes.c_int
        lib.skirt_poly_event.argtypes = [
            ctypes.POINTER(PolyArgs), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.skirt_poly_event.restype = ctypes.c_int
        lib.skirt_poly_args_size.argtypes = []
        lib.skirt_poly_args_size.restype = ctypes.c_int
        if lib.skirt_poly_args_size() != ctypes.sizeof(PolyArgs):
            raise RuntimeError("PolyArgs layout differs between Python "
                               "and csrc/fused_poly.cu")
        _lib = lib
    return _lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
