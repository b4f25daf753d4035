"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile with nvcc into one shared library with a plain C
interface, loaded through ctypes: one nvcc process per `.cu` file, all
started together, then one link.  The build runs at first use, never at
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

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false keeps a*b+c as two roundings, the way the plain PyTorch
# versions compute it (one elementwise op at a time), so a kernel and its
# plain version round alike
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    """Compile csrc/*.cu into _build/libskirt_kernels_<hash>.so (cached):
    one nvcc per source, all running at once, then one link."""
    global build_log
    so = BUILD_DIR / f"libskirt_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        cus = [p for p in sources() if p.suffix == ".cu"]
        objs = [os.path.join(work, p.stem + ".o") for p in cus]
        procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(p)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cus, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        failed = [p.name for p, proc in zip(cus, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = os.path.join(work, so.name)
        proc = subprocess.run([nvcc(), "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{build_log}")
        os.replace(tmp, so)
    return so


# The event kernels' one-pass routes hold at most MAXP panels, MAX_LEAD
# observer directions (Geom.lead_*), and K3 and K7 a few dust components
# and (K3) a table of at most MAX_TABLE floats; past any of these the C entry
# points take the kernels' chunked routes (csrc/common.cuh), which need
# the scratch and buffers below.
MAX_LEAD = 8
MAXP = 32
CH = 32                 # panels a chunk on the chunked routes
LEAD_FLOATS = 9         # a leader's row of the chunked routes' lead buffer


def nchunks(P: int) -> int:
    return -(-int(P) // CH)


_buffers: dict = {}


def device_floats(values, device):
    """A float32 tensor of `values` on `device`, copied once per distinct
    tuple (the chunked routes' leader and density buffers)."""
    key = (tuple(float(v) for v in values), str(device))
    t = _buffers.get(key)
    if t is None:
        if len(_buffers) > 64:
            _buffers.clear()
        t = _buffers[key] = torch.tensor(key[0], dtype=torch.float32,
                                         device=device)
    return t


def lead_rows(leaders) -> list:
    """The chunked routes' leader buffer as a flat list: per direction
    its float32 components, their inverses (0 where the component is
    not moving) and the moving flags, as _geom_args fills Geom.lead_*."""
    out = []
    for kvec in leaders:
        moving = [abs(d) > 1e-30 for d in kvec]
        out += [float(np.float32(d)) for d in kvec]
        out += [float(np.float32(1.0 / d)) if m else 0.0
                for d, m in zip(kvec, moving)]
        out += [1.0 if m else 0.0 for m in moving]
    return out


class Geom(ctypes.Structure):
    """Mirror of `struct Geom` in csrc/common.cuh (same order): the grid
    box and locate, the observer directions, the density and sampler
    constants shared by the event kernels."""
    _fields_ = (
        [(name, ctypes.c_int) for name in ("nx", "ny", "nz")]
        + [("invL", ctypes.c_float)]
        + [(name, ctypes.c_float * 3) for name in (
            "box_lo", "box_hi", "loc_lo", "loc_inv")]
        + [("lead_k", (ctypes.c_float * 3) * MAX_LEAD),
           ("lead_inv", (ctypes.c_float * 3) * MAX_LEAD),
           ("lead_moving", (ctypes.c_int * 3) * MAX_LEAD),
           ("dens", ctypes.c_float * 8),
           ("samp", ctypes.c_float * 4)])


class PolyArgs(ctypes.Structure):
    """Mirror of `struct PolyArgs` in csrc/fused_poly.cu (same order); the
    Geom's fields read and write as the struct's own."""
    MAX_LEAD = MAX_LEAD
    MAX_W = 128
    _anonymous_ = ("geo",)
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "u", "oc", "L", "L0", "px", "py", "pz", "dx", "dy", "dz",
            "alive", "ns", "bc",
            "opx", "opy", "opz", "odx", "ody", "odz", "oalive", "ons",
            "oLn", "oLp", "odepi", "odepv", "oIp", "ocos", "obc", "ofresh")]
        + [(name, ctypes.c_int) for name in (
            "N", "W", "npanels", "np_peel", "nlead", "min_scatt", "K",
            "scattering_peeloff")]
        + [(name, ctypes.c_float) for name in (
            "xi", "inv_np", "inv_pp", "inv_minred")]
        + [("geo", Geom),
           ("cend", ctypes.c_void_p), ("lead", ctypes.c_void_p)])


class MonoArgs(ctypes.Structure):
    """Mirror of `struct MonoArgs` in csrc/fused_mono.cu (same order); the
    Geom's fields read and write as the struct's own."""
    MAX_LEAD = MAX_LEAD
    # the one-pass route's components and table floats (its tables sit in
    # 48 KB of shared memory); the chunked route takes any
    MAX_COMP = 2
    MAX_TABLE = 12288
    _anonymous_ = ("geo",)
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "u", "tab", "px", "py", "pz", "dx", "dy", "dz", "L", "alive",
            "ns", "ell", "L0", "bc",
            "opx", "opy", "opz", "odx", "ody", "odz", "oL", "oalive", "ons",
            "odepi", "odepv", "otau", "ocos", "oph", "obc", "ofresh")]
        + [(name, ctypes.c_int) for name in (
            "N", "nlambda", "H", "npanels", "np_peel", "nlead", "min_scatt",
            "K", "scattering_peeloff", "u_comp")]
        + [(name, ctypes.c_float) for name in (
            "xi", "one_m_xi", "inv_np", "inv_pp", "inv_minred")]
        + [("dens1", ctypes.c_float * 8),
           ("geo", Geom),
           ("cend", ctypes.c_void_p), ("lead", ctypes.c_void_p),
           ("dens_h", ctypes.c_void_p)])


class TableArgs(ctypes.Structure):
    """Mirror of `struct TableArgs` in csrc/fused_table.cu (same order);
    only the Geom's arithmetic-locate fields are read (by K4; `direct`
    selects K4d, which writes odepd instead of odepi)."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "u", "kr", "px", "py", "pz", "dx", "dy", "dz", "L", "alive",
            "ns", "ell", "L0", "t0", "dt", "alb", "g",
            "opx", "opy", "opz", "odx", "ody", "odz", "oL", "oalive", "ons",
            "odepi", "odepv", "odepd")]
        + [(name, ctypes.c_int) for name in (
            "N", "nlambda", "npanels", "min_scatt", "direct")]
        + [(name, ctypes.c_float) for name in (
            "xi", "one_m_xi", "inv_minred")]
        + [("geo", Geom), ("cend", ctypes.c_void_p)])


class TablePolyArgs(ctypes.Structure):
    """Mirror of `struct TablePolyArgs` in csrc/fused_table_poly.cu (same
    order); only the Geom's arithmetic-locate fields are read (by K6;
    `direct` selects K6d, which also writes odepd; `pol` selects K6p,
    which also writes oIs and oIt)."""
    MAX_W = 128
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "u", "r", "oc", "L", "L0", "px", "py", "pz", "dx", "dy", "dz",
            "alive", "ns", "t0", "dt",
            "opx", "opy", "opz", "odx", "ody", "odz", "oalive", "ons",
            "oLn", "oLp", "odepi", "odepv", "odepd", "oIs", "oIt")]
        + [(name, ctypes.c_int) for name in (
            "N", "W", "npanels", "min_scatt", "sum_block", "direct", "pol")]
        + [(name, ctypes.c_float) for name in (
            "xi", "one_m_xi", "inv_W", "inv_minred")]
        + [("geo", Geom), ("cend", ctypes.c_void_p)])


class TableMultiArgs(ctypes.Structure):
    """Mirror of `struct TableMultiArgs` in csrc/fused_table_multi.cu (same
    order); only the Geom's arithmetic-locate fields are read."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "u", "kr", "ks", "px", "py", "pz", "dx", "dy", "dz", "L",
            "alive", "ns", "ell", "L0", "t0", "dt",
            "opx", "opy", "opz", "oL", "oalive", "ocell", "odepi", "odepv")]
        + [(name, ctypes.c_int) for name in (
            "N", "nlambda", "npanels", "min_scatt")]
        + [(name, ctypes.c_float) for name in (
            "xi", "one_m_xi", "inv_minred")]
        + [("geo", Geom), ("cend", ctypes.c_void_p)])


class TablePolyMultiArgs(ctypes.Structure):
    """Mirror of `struct TablePolyMultiArgs` in
    csrc/fused_table_poly_multi.cu (same order); only the Geom's
    arithmetic-locate fields are read."""
    MAX_W = 128
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "u", "r", "oc", "L", "L0", "px", "py", "pz", "dx", "dy", "dz",
            "alive", "ns", "t0", "dt",
            "opx", "opy", "opz", "odx", "ody", "odz", "oalive", "ons",
            "oLn", "oLp", "odepi", "odepv")]
        + [(name, ctypes.c_int) for name in (
            "N", "W", "H", "npanels", "min_scatt", "sum_block")]
        + [(name, ctypes.c_float) for name in (
            "xi", "one_m_xi", "inv_W", "inv_minred")]
        + [("geo", Geom), ("cend", ctypes.c_void_p)])


# (entry-point stem, argument struct, source) of the event kernels that take
# one struct: skirt_<stem>_event(args, labs, stream) and
# skirt_<stem>_args_size()
_TABLE_EVENTS = (("table", TableArgs, "fused_table.cu"),
                 ("table_multi", TableMultiArgs, "fused_table_multi.cu"),
                 ("table_poly", TablePolyArgs, "fused_table_poly.cu"),
                 ("table_poly_multi", TablePolyMultiArgs,
                  "fused_table_poly_multi.cu"))


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
        lib.skirt_binned_blocked_add.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.skirt_binned_blocked_add.restype = ctypes.c_int
        lib.skirt_binned_blocked_limits.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.skirt_binned_blocked_limits.restype = ctypes.c_int
        lib.skirt_probe_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.skirt_probe_gather.restype = ctypes.c_int
        lib.skirt_probe_onehot_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.skirt_probe_onehot_gather.restype = ctypes.c_int
        lib.skirt_probe_mm.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.skirt_probe_mm.restype = ctypes.c_int
        lib.skirt_poly_event.argtypes = [
            ctypes.POINTER(PolyArgs), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.skirt_poly_event.restype = ctypes.c_int
        lib.skirt_mono_event.argtypes = [
            ctypes.POINTER(MonoArgs), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.skirt_mono_event.restype = ctypes.c_int
        for name, struct, _ in _TABLE_EVENTS:
            fn = getattr(lib, f"skirt_{name}_event")
            fn.argtypes = [ctypes.POINTER(struct), ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name, struct, src in (("poly", PolyArgs, "fused_poly.cu"),
                                  ("mono", MonoArgs, "fused_mono.cu"),
                                  *_TABLE_EVENTS):
            size = getattr(lib, f"skirt_{name}_args_size")
            size.argtypes = []
            size.restype = ctypes.c_int
            if size() != ctypes.sizeof(struct):
                raise RuntimeError(f"{struct.__name__} layout differs "
                                   f"between Python and csrc/{src}")
        _lib = lib
    return _lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def aligned(t, nbytes: int):
    """t itself when contiguous and its data nbytes-aligned (the kernels'
    vector loads need it), else a contiguous copy (freshly allocated, so
    aligned)."""
    if t.is_contiguous() and t.data_ptr() % nbytes == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
