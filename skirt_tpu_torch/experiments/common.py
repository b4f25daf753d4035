"""Timing and bounds shared by the probe drivers and chip_smoke.py (CUDA
only; importing it needs no card)."""

from __future__ import annotations

import subprocess
import time

# the H100 SXM's published rates (the least-time model of bound_ms): HBM3,
# float32 outside the tensor cores, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2, chunk=64):
    """Mean device time of fn() over reps back-to-back calls, by CUDA
    events, in chunks of at most `chunk` calls.  A sleep kernel queued
    before each chunk holds the device while the host enqueues it, so the
    wrappers' host time opens no gaps; a chunk stays well inside the
    launch queue, or the host would wait on it and time itself."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total, done = 0.0, 0
    while done < reps:
        k = min(chunk, reps - done)
        # ~2e9 cycles per second; at most 2 s of sleep
        torch.cuda._sleep(int(min(1.5 * k * host, 2.0) * 2e9))
        start.record()
        for _ in range(k):
            fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
        done += k
    return total / reps


def nbytes(*tensors):
    """Bytes of tensors, lists of tensors and dicts of them (None skipped)."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def bound(nbyte, ops, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by) for a call that moves nbyte bytes and does ops
    operations at ops_per_s."""
    t_bytes = nbyte / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def measure(record, kernel, plain, library=None, reps=10):
    """Add kernel / plain / library device ms to a record (in place)."""
    record["ms"] = cuda_ms(kernel, reps=reps)
    record["plain_ms"] = cuda_ms(plain, reps=max(1, reps // 2))
    record["library_ms"] = (cuda_ms(library, reps=reps)
                            if library is not None else None)
    return record


def line(r) -> str:
    """One printed line of a variant's record."""
    def ms(v):
        return "n/a" if v is None else f"{v:.4f} ms"
    name = r["name"]
    if r.get("pallas"):
        name += f" [{'; '.join(r['pallas'])}]"
    parts = [f"{name} ({r['replaces']})", r["shape"],
             f"max_abs_err {r['max_abs_err']:.3e}"]
    if "ms" in r:
        parts += [f"kernel {ms(r['ms'])}", f"plain {ms(r['plain_ms'])}",
                  f"library {ms(r['library_ms'])}",
                  f"bound {ms(r['bound_ms'])} ({r['bound_by']})"]
        if "bound_ms_fp32" in r:
            parts.append(f"at 67 TFLOP/s {ms(r['bound_ms_fp32'])}")
        if "onehot_floor_ms" in r:
            parts.append(f"one-hot floor {ms(r['onehot_floor_ms'])}")
    return ", ".join(parts)


def require_cuda():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("this probe runs only on a CUDA device")
