"""The polychromatic scattering peel into the SED instruments (kernel PS).

For every SED instrument i of a poly driver at once, with j(i) its
leader (observer direction):

    Ftot_i[w] += sum_n a_n c_{w,n} exp(-kext_w I_{j(i),n})

c = Ln on fresh (relaunched) lanes, else Lp HG(g_w, cos_{j,n}); a the
lanes' alive flag.  `peel_sed_plain` is the plain PyTorch version, the
arithmetic of engine/common.py::peel_poly's per-instrument loop with
SEDInstrument._detect_poly; `peel_sed_add` runs it on CPU tensors and
launches the hand-written kernel of csrc/peel_sed.cu on CUDA tensors,
counted in `peel_sed_add.launches`.  skirt_tpu computes this peel in
XLA (skirt_tpu/engine/fused_table_poly.py, fused_poly.py), not a Pallas
kernel: the kernel displaces no counterpart.

The cosines come as an (L, N) tensor (K1's) or as `LeaderCosines`, the
lanes' (N, 3) directions toward the leaders, which the kernel turns into
cosines itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import kernels
from ..numerics import f32
from .binned import device_limits


def hg(g, cosa):
    """The Henyey-Greenstein phase function at cosine cosa."""
    t = 1.0 + g * g - 2.0 * g * cosa
    return (1.0 - g) * (1.0 + g) / torch.sqrt(t * t * t)


class LeaderCosines:
    """cos(j): the (N,) float32 cosines of the lanes' directions (N, 3)
    toward leader j (a unit vector of `leaders`, rounded to float32)."""

    __slots__ = ("direction", "leaders")

    def __init__(self, direction, leaders):
        self.direction = direction
        self.leaders = leaders

    def __call__(self, j):
        kx, ky, kz = (f32(v) for v in self.leaders[j])
        d = self.direction
        return d[:, 0] * kx + d[:, 1] * ky + d[:, 2] * kz


def rows_of(rows):
    """An (L, N) tensor of L (N,) rows: `rows` itself when a tensor, the
    tensor the rows are views of when they are its consecutive rows (as
    `unbind(0)` gives them: no copy, no launch), else their stack."""
    if torch.is_tensor(rows):
        return rows
    base = rows[0]._base
    if (base is not None and base.dim() == 2 and base.is_contiguous()
            and base.shape[0] == len(rows)
            and all(r._base is base and r.data_ptr() == base[j].data_ptr()
                    and r.shape == base.shape[1:]
                    for j, r in enumerate(rows))):
        return base
    return torch.stack(list(rows))


_wls: dict = {}


def _wls_key(W, device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return int(W), dev


def wavelengths(W: int, device):
    """The (W,) int64 wavelength indices 0 .. W - 1 on `device`, made once
    a device: on the card the one `wls` that peel_sed_add accepts, which
    it checks by identity (reading the values back would wait for the
    card)."""
    key = _wls_key(W, device)
    t = _wls.get(key)
    if t is None:
        t = _wls[key] = torch.arange(key[0], device=key[1])
    return t


def peel_sed_plain(ftots, lead, wls, Lp, Ln, alive, fresh, g, minus_kext,
                   I, cos):
    """The plain version of `peel_sed_add` on any device: per SED
    instrument i, the (W, N) peel contributions toward leader lead[i]
    summed over the lanes into ftots[i] at the wavelengths wls, in the
    arithmetic and order of engine/common.py::peel_poly's loop and
    SEDInstrument._detect_poly (an instrument that shares its leader
    with an earlier one adds the same sums)."""
    g, mk = g[:, None], minus_kext[:, None]
    sums = {}
    for ftot, j in zip(ftots, lead):
        if j not in sums:
            cosj = cos[j] if torch.is_tensor(cos) else cos(j)
            cw = Lp * hg(g, cosj[None])
            if fresh is not None:
                cw = torch.where(fresh[None], Ln, cw)
            cw = torch.where(alive[None], cw, 0.0)
            sums[j] = (cw * torch.exp(mk * I[j][None])).sum(dim=1)
        ftot.index_add_(0, wls, sums[j])


# csrc/peel_sed.cu's launch: THREADS threads a block, each with ACC float32
# sums (its block's slots x wavelengths); a block takes up to GROUP slots
# (distinct leaders) and ACC / (their power of two) wavelengths; up to
# MAX_SED instruments and MAX_SLOT slots a launch; PER_SM blocks an SM
THREADS = 256
ACC = 32
GROUP = 8
MAX_SED = 32
MAX_SLOT = 32
PER_SM = 2


class PeelSedPlan(NamedTuple):
    group: int      # slots a block (the last group may hold fewer)
    ns: int         # the kernel's instance: group rounded up to 1, 2, 4, 8
    sgroups: int    # slot groups, along blockIdx.y
    wsplit: int     # wavelength chunks of ACC / ns, along blockIdx.y too
    blocks: int     # blocks along x: rows of partial sums the finish adds


@functools.lru_cache(maxsize=256)
def peel_sed_plan(n: int, W: int, nslot: int, sms: int) -> PeelSedPlan:
    """The kernel's grid for n lanes, W wavelengths and nslot distinct
    leaders on a card of `sms` SMs: slot groups of at most GROUP, each
    block a group and a chunk of wavelengths, and along x as many blocks
    as fill the card at PER_SM blocks an SM (at most one a THREADS
    lanes).  Cached: the drivers ask for the same shape every
    iteration."""
    sgroups = -(-nslot // GROUP)
    group = -(-nslot // sgroups)
    ns = 1 << (group - 1).bit_length()
    wsplit = -(-W // (ACC // ns))
    blocks = max(1, min(-(-n // THREADS), PER_SM * sms // (sgroups * wsplit)))
    return PeelSedPlan(group, ns, sgroups, wsplit, blocks)


def _check(ftots, lead, wls, Lp, Ln, alive, fresh, g, minus_kext, I, cos):
    """TypeError for a wrong dtype, ValueError for anything else the
    kernel does not take; nothing is launched."""
    if Lp.dim() != 2:
        raise ValueError(f"peel_sed_add: Lp (W, N), not {tuple(Lp.shape)}")
    W, N = Lp.shape
    dirs = isinstance(cos, LeaderCosines)
    if not dirs and not torch.is_tensor(cos):
        raise TypeError("peel_sed_add: cos is an (L, N) tensor or "
                        "LeaderCosines")
    cos_t = cos.direction if dirs else cos
    floats = {"Lp": Lp, "g": g, "minus_kext": minus_kext, "I": I,
              "cos": cos_t, **({} if fresh is None else {"Ln": Ln})}
    flags = {"alive": alive, **({} if fresh is None else {"fresh": fresh})}
    if any(t.dtype != torch.float32 for t in floats.values()) \
            or any(t.dtype != torch.bool for t in flags.values()) \
            or any(t.dtype != torch.float32 for t in ftots) \
            or wls.dtype != torch.int64:
        raise TypeError("peel_sed_add takes float32 tallies and values, "
                        "bool flags and int64 wavelengths")
    ts = [*floats.values(), *flags.values(), *ftots, wls]
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("peel_sed_add: contiguous tensors only")
    dev = Lp.device
    if any(t.device != dev for t in ts):
        raise ValueError("peel_sed_add: tensors on different devices")
    L = I.shape[0] if I.dim() == 2 else -1
    want = {"Ln": (W, N), "alive": (N,), "fresh": (N,), "g": (W,),
            "minus_kext": (W,), "I": (L, N),
            "cos": (N, 3) if dirs else (L, N)}
    bad = {k: tuple(t.shape) for k, t in {**floats, **flags}.items()
           if k in want and tuple(t.shape) != want[k]}
    if L < 1 or bad or (dirs and len(cos.leaders) != L):
        raise ValueError(f"peel_sed_add: Lp (W, N) = ({W}, {N}) needs "
                         f"{want}, not {bad or tuple(I.shape)}")
    if not ftots or len(ftots) != len(lead) \
            or any(tuple(f.shape) != (W,) for f in ftots) \
            or any(not 0 <= int(j) < L for j in lead):
        raise ValueError(f"peel_sed_add: one ({W},) tally per instrument "
                         f"and its leader in [0, {L})")
    if tuple(wls.shape) != (W,) or not (
            wls is _wls.get(_wls_key(W, dev)) if dev.type == "cuda"
            else torch.equal(wls, torch.arange(W))):
        raise ValueError("peel_sed_add: wls must be the wavelengths 0 .. "
                         "W - 1 (on the card the tensor of "
                         "peel_sed.wavelengths)")


def peel_sed_add(ftots, lead, wls, Lp, Ln, alive, fresh, g, minus_kext, I,
                 cos):
    """ftots[i][w] += sum_n alive_n c_{w,n} exp(minus_kext_w I[lead[i], n])
    for each SED instrument i, c = Ln on fresh lanes, else Lp times the
    HG phase weight of g_w at the lanes' cosines toward leader lead[i].

    ftots: the instruments' (W,) float32 tallies, updated in place; lead:
    their leaders (ints); wls: the wavelengths 0 .. W - 1 (`wavelengths`);
    Lp (W, N) float32; Ln (W, N) float32 (unread, may be None, without
    `fresh`); alive, fresh (N,) bool (fresh may be None); g, minus_kext
    (W,) float32; I (L, N) float32; cos (L, N) float32 or LeaderCosines
    with (N, 3) float32 directions and L leaders.  Contiguous tensors on
    one device, refused before any launch (TypeError for a dtype,
    ValueError for the rest).  CPU tensors take `peel_sed_plain`; CUDA
    tensors launch the kernel, one launch per MAX_SED instruments
    (none for N = 0), counted in `peel_sed_add.launches`."""
    _check(ftots, lead, wls, Lp, Ln, alive, fresh, g, minus_kext, I, cos)
    if Lp.device.type == "cpu":
        peel_sed_plain(ftots, lead, wls, Lp, Ln, alive, fresh, g,
                       minus_kext, I, cos)
        return ftots
    if Lp.device.type != "cuda":
        raise ValueError(f"peel_sed_add: unsupported device {Lp.device}")
    if Lp.shape[1] == 0:
        return ftots
    for i in range(0, len(ftots), MAX_SED):
        _peel_sed_cuda(ftots[i:i + MAX_SED], lead[i:i + MAX_SED], Lp, Ln,
                       alive, fresh, g, minus_kext, I, cos)
    return ftots


_work: dict = {}


def _workspace(device, stream, nparts):
    """(ticket, partials) of the kernel on one stream: an int32 ticket at
    zero (each launch leaves it so) and nparts float32 partials, kept and
    grown as launches need."""
    key = (device, stream)
    ticket, parts = _work.get(key, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if parts is None or parts.numel() < nparts:
        parts = torch.empty(nparts, dtype=torch.float32, device=device)
    _work[key] = (ticket, parts)
    return ticket, parts


@functools.lru_cache(maxsize=64)
def _fixed_fields(lead, kdirs, N, W, sms):
    """The bytes of a launch's fixed fields (the plan, the slots: the
    distinct leaders of `lead` in order of first use, and with `kdirs`,
    the leaders' unit vectors, their float32 directions) and the plan,
    made once a shape: the drivers launch the same every iteration."""
    rows = list(dict.fromkeys(lead))
    plan = peel_sed_plan(N, W, len(rows), sms)
    a = kernels.PeelSedArgs()
    a.slot_of[:len(lead)] = [rows.index(j) for j in lead]
    a.row[:len(rows)] = rows
    if kdirs is not None:
        for s, j in enumerate(rows):
            a.kdir[s][:] = [f32(v) for v in kdirs[j]]
    a.N, a.W, a.nsed, a.nslot = N, W, len(lead), len(rows)
    a.group, a.wsplit = plan.group, plan.wsplit
    a.epad = -(-len(rows) * W // 4) * 4
    return bytes(a), plan


def _peel_sed_cuda(ftots, lead, Lp, Ln, alive, fresh, g, minus_kext, I,
                   cos):
    """One launch for up to MAX_SED instruments: their distinct leaders
    are the kernel's slots."""
    W, N = Lp.shape
    dirs = isinstance(cos, LeaderCosines)
    fixed, plan = _fixed_fields(
        tuple(int(j) for j in lead),
        tuple(map(tuple, cos.leaders)) if dirs else None, N, W,
        device_limits(Lp.device)[1])
    a = kernels.PeelSedArgs.from_buffer_copy(fixed)
    stream = kernels.stream_of(Lp)
    ticket, parts = _workspace(Lp.device, stream, plan.blocks * a.epad)
    a.Lp, a.alive, a.g, a.mk, a.I = (t.data_ptr() for t in (
        Lp, alive, g, minus_kext, I))
    if fresh is not None:
        a.Ln, a.fresh = Ln.data_ptr(), fresh.data_ptr()
    if dirs:
        a.dir = cos.direction.data_ptr()
    else:
        a.cos = cos.data_ptr()
    a.part, a.ticket = parts.data_ptr(), ticket.data_ptr()
    a.ftot[:len(ftots)] = [f.data_ptr() for f in ftots]
    kernels.check(kernels.library().skirt_peel_sed(
        ctypes.byref(a), plan.ns, plan.blocks, plan.sgroups, stream),
        "peel_sed kernel")
    peel_sed_add.launches += 1


peel_sed_add.launches = 0
