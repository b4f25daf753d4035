"""How `correct` is decided: one run() of the window, drawn from the
seed, against the plain reference that the configuration names
(`reference`: a module of reference/, whose contract reference/
__init__.py states).

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
               in the configuration's blocks of space (`labs_blocks`):
               max |prog - ref| / max ref

Each side puts each of its own cells into the block that holds the
cell's centre, so the two sides may tally on cells of any layout, and
need not share one; a configuration chooses blocks that none of its
cells straddles.  Each gap has its limit in the cell's file (`limits`);
a gap that is not a finite number fails, and so does a labs tally whose
rows do not match its centres, or a centre outside the blocks' box."""

import hashlib
import importlib
import random

import numpy as np

FRAME_BLOCKS = (4, 4)        # (y, x)


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
    """The reference's tallies for this run's seed: `simulate` of the
    module rtbench.reference.<cfg["reference"]>; `kw` goes to it (the
    control's dtype)."""
    mod = importlib.import_module(
        f"{__package__}.reference.{cfg['reference']}")
    return mod.simulate(cfg, compared_wavelengths(cell, cfg, seed),
                        cell["reference"]["packets"], reference_seed(seed),
                        device, **kw)


def program_view(acc: dict, cfg: dict, ells, centers) -> dict:
    """The port's float64 host tallies of one run() in the reference's
    layout, at the compared wavelengths, with `centers` (ncells, 3), the
    kpc centres of the cells its labs rows belong to."""
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
    return {"sed": sed, "frame": frame, "labs": labs,
            "centers": np.asarray(centers, np.float64)}


def _blocks(a: np.ndarray, counts) -> np.ndarray:
    """Sums over equal blocks: `counts` blocks along each axis."""
    shape = []
    for n, c in zip(a.shape, counts):
        c = min(c, n)
        if n % c:
            raise ValueError(f"{n} does not split into {c} blocks")
        shape += [c, n // c]
    return a.reshape(shape).sum(axis=tuple(range(1, 2 * a.ndim, 2)))


def labs_blocks(labs, centers, spec: dict):
    """The absorbed energy of each cell, summed over the compared
    wavelengths, added into the block of `spec` (the configuration's
    `labs_blocks`: `counts` equal blocks along x, y and z over the box
    `lo_kpc` to `hi_kpc`) that holds the cell's centre: a flat array of
    the blocks, x-major.  None where the centres are not one finite
    (x, y, z) a labs row, or one lies outside the box."""
    e = np.asarray(labs, np.float64).sum(1)
    c = np.asarray(centers, np.float64)
    if c.shape != (e.shape[0], 3) or not np.all(np.isfinite(c)):
        return None
    counts = np.asarray(spec["counts"], np.int64)
    lo = np.asarray(spec["lo_kpc"], np.float64)
    hi = np.asarray(spec["hi_kpc"], np.float64)
    k = np.floor((c - lo) / (hi - lo) * counts).astype(np.int64)
    if np.any(k < 0) or np.any(k >= counts):
        return None
    return np.bincount(np.ravel_multi_index(k.T, counts), weights=e,
                       minlength=int(counts.prod()))


def _gap(p, r, relative_each=False) -> float:
    if p is None or r is None:
        return float("inf")
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
    spec = cfg["labs_blocks"]
    out["labs_gap"] = _gap(
        labs_blocks(prog["labs"], prog["centers"], spec),
        labs_blocks(ref["labs"], ref["centers"], spec))
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
