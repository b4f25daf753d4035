"""How `correct` is decided: one run() of the window, drawn from the
seed, against the plain reference (reference/expdisk.py).

The reference runs its own packets, drawn from a seed of its own, for a
sample of the wavelengths drawn from the run's seed (`reference.
wavelengths` of them, evenly spaced from a drawn offset, with
`reference.packets` packets each), so the two sides agree in expectation
and differ by Monte Carlo noise.  The numbers compared are the widest
gaps over those wavelengths:

    sed_gap    max over each instrument's SED and each wavelength of
               |F_prog - F_ref| / F_ref
    frame_gap  the frame summed over the wavelengths, in FRAME_BLOCKS
               blocks of pixels: max |prog - ref| / max ref
    labs_gap   the absorbed energy per cell summed over the wavelengths,
               in LABS_BLOCKS blocks of cells: max |prog - ref| / max ref

Each has its limit in the cell's file (`limits`); a gap that is not a
finite number fails."""

import hashlib
import random

import numpy as np

FRAME_BLOCKS = (4, 4)        # (y, x)
LABS_BLOCKS = (8, 8, 4)      # (x, y, z)


def compared_wavelengths(cell: dict, cfg: dict, seed: int) -> list[int]:
    n = cfg["wavelengths"]["count"]
    w = min(cell["reference"]["wavelengths"], n)
    stride = n // w
    off = random.Random(f"rtbench-wavelengths:{int(seed)}").randrange(stride)
    return [off + stride * k for k in range(w)]


def reference_seed(seed: int) -> int:
    h = hashlib.sha256(f"rtbench-reference:{int(seed)}".encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def reference(cell: dict, cfg: dict, seed: int, device, **kw) -> dict:
    """The reference's tallies for this run's seed (reference.expdisk's
    layout); `kw` goes to `simulate` (the control's dtype)."""
    from .reference import expdisk

    return expdisk.simulate(cfg, compared_wavelengths(cell, cfg, seed),
                            cell["reference"]["packets"],
                            reference_seed(seed), device, **kw)


def program_view(acc: dict, cfg: dict, ells) -> dict:
    """The port's float64 host tallies of one run() in the reference's
    layout, at the compared wavelengths."""
    nl = cfg["wavelengths"]["count"]
    sed, frame = [], []
    for ins, t in zip(cfg["instruments"], acc["instruments"]):
        sed.append(np.asarray(t["Ftot"], np.float64)[ells])
        if ins["kind"] == "frame":
            cube = np.asarray(t["ftot"], np.float64).reshape(
                nl, ins["ny"], ins["nx"])
            frame.append(cube[ells])
        else:
            frame.append(None)
    labs = np.asarray(acc["labs"], np.float64).reshape(-1, nl)[:, ells]
    return {"sed": sed, "frame": frame, "labs": labs}


def _blocks(a: np.ndarray, counts) -> np.ndarray:
    """Sums over equal blocks: `counts` blocks along each axis."""
    shape = []
    for n, c in zip(a.shape, counts):
        c = min(c, n)
        if n % c:
            raise ValueError(f"{n} does not split into {c} blocks")
        shape += [c, n // c]
    return a.reshape(shape).sum(axis=tuple(range(1, 2 * a.ndim, 2)))


def _gap(p, r, relative_each=False) -> float:
    p = np.asarray(p, np.float64)
    r = np.asarray(r, np.float64)
    if p.shape != r.shape or not np.all(np.isfinite(p)) or np.max(r) <= 0:
        return float("inf")
    if relative_each:
        if np.any(r <= 0):
            return float("inf")
        return float(np.max(np.abs(p - r) / r))
    return float(np.max(np.abs(p - r)) / np.max(r))


def gaps(prog: dict, ref: dict, cfg: dict) -> dict:
    """{name: gap} of the port's view against the reference's."""
    out = {"sed_gap": max(_gap(p, r, True)
                          for p, r in zip(prog["sed"], ref["sed"]))}
    frames = [(p, r) for p, r in zip(prog["frame"], ref["frame"])
              if r is not None]
    if frames:
        out["frame_gap"] = max(
            _gap(_blocks(p.sum(0), FRAME_BLOCKS) if p is not None else None,
                 _blocks(r.sum(0), FRAME_BLOCKS)) for p, r in frames)
    g = cfg["grid"]
    shape = (g["nx"], g["ny"], g["nz"])
    out["labs_gap"] = _gap(
        _blocks(prog["labs"].sum(1).reshape(shape), LABS_BLOCKS),
        _blocks(ref["labs"].sum(1).reshape(shape), LABS_BLOCKS))
    return out


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every gap finite and at or
    under its limit, and every limit's gap present."""
    rows, ok = {}, True
    for name, limit in limits.items():
        v = found.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        rows[name] = {"value": v if v is not None and np.isfinite(v)
                      else None, "limit": limit}
    return ok, rows
