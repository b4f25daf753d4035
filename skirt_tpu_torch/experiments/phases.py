"""Where an event kernel spends its time: timestamps at fixed points.

On a CUDA machine, from the repository root:

    python -m skirt_tpu_torch.experiments.phases k1|k3|k5|k6|k7
        [--csrc DIR] [--width W[,W...]] [--comp H] [--threads G[,G...]]

It copies the kernel's source (csrc/fused_poly.cu for K1, fused_mono.cu
for K3, fused_table_multi.cu for K5, fused_table_poly.cu for K6,
fused_table_poly_multi.cu for K7; from DIR, another tree's csrc/, when
given) and csrc/common.cuh into a temporary directory, adds a `prof`
pointer at the end of the kernel's argument struct and stamps %globaltimer
into it at fixed points of the kernel:
  - a kernel with two or more top-level __syncthreads() (K1, K6, K7): the
    block's thread 0 after each of them, at the kernel's start and, after
    one more barrier, at its end;
  - a kernel that runs one thread per lane with at most the one barrier
    of its table load (K3, K5; K6 and K7 in their first designs): each
    warp's first active thread at the lines of the first of ANCHORS'
    sets whose lines the source holds all of, which mark the ends of the
    design's phases.
It builds that copy with the package's nvcc flags and runs it through the
kernel's wrapper (the wrapper's struct and library swapped for the
stamped ones) on the inputs chip_smoke.py times:
  k1  N = 32,768, W = 128, 32 / 8 panels, refill K = 128 (seed 7, three
      events of the plain version chained first);
  k3  N = 2^21, one of W = 4 wavelengths per lane (--width), H = 1
      (--comp 2: the two-component model), 32 / 8 panels, refill K = 128
      (seed 7, three events of the plain version chained first);
  k5  the two-component model's mono lanes, N = 2^17, 24 panels, H = 2
      (the first event of chip_smoke.py phase 7's first seed);
  k6  config 3's torus at W = 2 on 2^17 lanes (--width 8: 2^16 lanes,
      K6d's lane count; 24 or 128: 2^15 lanes), 16 panels (the first event
      of phase 8's first seed at that width);
  k7  the two-component model at W = 2 on 2^17 lanes (--width 24 or 128:
      2^15 lanes), H = 2, 24 panels (the first event of phase 9's seed),
      for each width of the list;
  with --threads (k6, k7), once for each G of the list, the launch
  held to the instance of G threads a lane (the kernel's `launch_g`; 0
  the kernel's own choice; a G too narrow for W is refused and reported
  so);
checks every output bit for bit against the plain version; and prints
the kernel's device ms (the stores of the stamps included), the mean
life of a block (or warp), how many were resident at once (summed lives
over the span), when they started and ended (percentiles from the first
start), and each phase's mean duration in ns with the line that ends it.
Then it builds the unstamped source alone and prints, for each
instance of the kernel, what ptxas reports (registers, spills, stack
frame) and what `cuobjdump -sass` shows: the instruction count, the MUFU,
local-memory and CALL instructions among them, and each loop (a backward
branch) with its length.  The stamps' resolution is that of %globaltimer
(tens of ns on the H100).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import kernels, rng
from .common import card_line, cuda_ms, require_cuda

SLOTS = 16

# kernel: (source, argument struct, kernel signature, C entry point)
KERNELS = {
    "k1": ("fused_poly.cu", "PolyArgs", "poly_event_kernel(",
           "skirt_poly_event"),
    "k3": ("fused_mono.cu", "MonoArgs", "mono_event_kernel(",
           "skirt_mono_event"),
    "k5": ("fused_table_multi.cu", "TableMultiArgs",
           "table_multi_event_kernel(", "skirt_table_multi_event"),
    "k6": ("fused_table_poly.cu", "TablePolyArgs",
           "table_poly_event_kernel(", "skirt_table_poly_event"),
    "k7": ("fused_table_poly_multi.cu", "TablePolyMultiArgs",
           "table_poly_multi_event_kernel(", "skirt_table_poly_multi_event"),
}

# one-thread-per-lane designs: a stamp goes before each line that starts
# with one of these (after it, for those marked "after"), in the order the
# thread passes them; they are looked for between the argument struct and
# the launch code, so a lane's code may sit in a device function of its own.
# A kernel may have several sets, one per design: the first set whose lines
# the source holds all of is used.  K5's first set is its present design,
# its second the first one; K6's and K7's match only their first designs
# (one thread per lane): they serve --csrc on a tree that still holds them,
# the later designs being stamped at their barriers.
ANCHORS = {
    "k3": ((("  for (int i = threadIdx.x; i < 3 * H * NL; i += blockDim.x)",
             "before"),
            ("  if (n >= a.N) return;", "after"),
            ("    const float taupath = cum;", "before"),
            ("  if (LABS) {\n    a.odepi[n] = depi;", "before"),
            ("  // -- local mixture", "before"),
            ("  // -- Henyey-Greenstein scatter", "before"),
            ("  a.ons[n] = nscatt;", "after")),),
    "k5": ((("  if (n >= a.N) return;", "after"),
            ("    __pipeline_wait_prior(0);", "after"),
            ("    lane_finish<LABS, CHUNKED>(", "before"),
            ("  if (LABS) {\n    a.odepi[n] = depi;", "before"),
            ("  a.ocell[n] = cell;", "after")),
           (("  if (n >= a.N) return;", "after"),
            ("    const float taupath = cum;", "before"),
            ("    // -- scattered-luminosity update", "before"),
            ("    int i_hit = 0;", "before"),
            ("  if (LABS) {\n    a.odepi[n] = depi;", "before"),
            ("  a.ocell[n] = cell;", "after"))),
    "k6": ((("  const int W = a.W;", "before"),
            ("  if (n >= a.N) return;", "after"),
            ("    I_tot = path_column(a, n, delta, cums);", "after"),
            ("    // -- mixture-driver forced propagation", "before"),
            ("    // -- per-wavelength mixture ratios", "before"),
            ("    // -- peel and onward weights", "before"),
            ("    alive = any_ln && (I_tot > TINY);", "before"),
            ("  a.ons[n] = nscatt;", "after")),),
    "k7": ((("  const int W = a.W;", "before"),
            ("  if (n >= a.N) return;", "after"),
            ("    const float tau_c = cumc;", "before"),
            ("    // -- w pass 1", "before"),
            ("    // -- w pass 2", "before"),
            ("    // -- w pass 3", "before"),
            ("    alive = any_ln && (tau_c > TINY);", "before"),
            ("  a.ons[n] = nscatt;", "after")),),
}

TIMER = '''#include "common.cuh"
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define PROF(p) if (threadIdx.x == 0) a.prof[blockIdx.x * %(S)d + (p)] = gtimer()
#define PROFW(p) do { const unsigned m_ = __activemask(); \\
  if ((threadIdx.x & 31) == __ffs(m_) - 1) \\
    a.prof[((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * %(S)d + (p)] = \\
        gtimer(); } while (0)''' % {"S": SLOTS}


def _body_span(src: str, sig: str) -> tuple[int, int]:
    """Start of the kernel's body and of the line of its closing brace."""
    k0 = src.index(sig)
    k0 = src.index("{\n", k0) + 2
    return k0, src.index("\n}\n", k0) + 1


def anchor_set(src: str, kernel: str, r0: int, k1: int):
    """The first of the kernel's ANCHORS sets whose every line src holds
    between r0 and k1."""
    for anchors in ANCHORS.get(kernel, ()):
        if all(src.find("\n" + text, r0, k1) >= 0 for text, _ in anchors):
            return anchors
    missing = [text for anchors in ANCHORS.get(kernel, ((),))
               for text, _ in anchors if src.find("\n" + text, r0, k1) < 0]
    raise RuntimeError(f"{kernel}: anchor {missing[0]!r} not found" if missing
                       else f"{kernel}: no anchors")


def stamped_source(src: str, kernel: str) -> tuple[str, list, bool]:
    """The source with the stamps; the line in `src` that ends each phase;
    and whether the stamps are per block (barriers) or per warp."""
    _, struct, sig, _ = KERNELS[kernel]
    k0, k1 = _body_span(src, sig)
    body = src[k0:k1]
    barrier = "\n  __syncthreads();\n"
    per_block = body.count(barrier) >= 2
    if per_block:
        first_line = src.count("\n", 0, k0) + 1
        parts = body.split(barrier)
        lines = [first_line + body[:m.start()].count("\n") + 1
                 for m in re.finditer(re.escape(barrier), body)]
        if len(parts) > SLOTS - 1:
            raise RuntimeError("more barriers than stamp slots")
        out = "  PROF(0);\n" + parts[0]
        for i, p in enumerate(parts[1:], 1):
            out += barrier + "  PROF(%d);\n" % i + p
        out += "  __syncthreads();\n  PROF(%d);\n" % len(parts)
        src = src[:k0] + out + src[k1:]
    else:
        r0 = src.index("};", src.index(f"struct {struct} {{"))
        anchors = anchor_set(src, kernel, r0, k1)
        at, lines = [], []
        for p, (text, where) in enumerate(anchors):
            i = src.find("\n" + text, r0, k1) + 1
            if where == "after":
                i = src.index("\n", i + len(text)) + 1
            lines.append(src.count("\n", 0, i) + 1)
            at.append((i, p))
        for i, p in sorted(at, reverse=True):
            src = src[:i] + "  PROFW(%d);\n" % p + src[i:]
    src = re.sub(r"(struct %s \{.*?)\n\};" % struct,
                 r"\1\n  unsigned long long* prof;\n};", src, count=1,
                 flags=re.S)
    src = src.replace('#include "common.cuh"', TIMER, 1)
    return src, lines, per_block


# each kernel's launch dispatch, where force_threads puts its choice of
# instance: (the dispatch's first lines, launch_g's template arguments
# before G and after it)
DISPATCH = {
    "k6": ("template <bool LABS, bool DIRECT, bool POL, bool CHUNKED>\n"
           "int launch(const TablePolyArgs& a, cudaStream_t s) {\n",
           "LABS, DIRECT, POL", ", CHUNKED"),
    "k7": ("template <int H, bool LABS>\n"
           "int launch(const TablePolyMultiArgs& a, cudaStream_t s) {\n",
           "H, LABS", ""),
}


def force_threads(src: str, threads, kernel: str = "k7") -> str:
    """The kernel's source with a global `phases_threads` that, when set to
    one of `threads`, sends every launch to the instance of that many
    threads a lane (refused where W exceeds the G * wpt<G>() wavelengths
    it holds), and otherwise leaves the kernel's own choice."""
    launch, targs, tail = DISPATCH[kernel]
    if src.count(launch) != 1:
        raise RuntimeError(f"{kernel.upper()}'s launch dispatch not found")
    hook = "".join(
        f"  if (phases_threads == {g})\n"
        f"    return a.W > {g} * wpt<{g}>() ? (int)cudaErrorInvalidValue\n"
        f"                                : launch_g<{targs}, {g}{tail}>"
        f"(a, s);\n"
        for g in threads if g)
    src = src.replace(launch, launch + hook)
    return src.replace('#include "common.cuh"',
                       '#include "common.cuh"\n'
                       'extern "C" {\nint phases_threads = 0;\n}', 1)


def _build(work: Path, name: str, src: str, common: str) -> tuple[Path, str]:
    (work / name).write_text(src)
    (work / "common.cuh").write_text(common)
    so = work / (Path(name).stem + ".so")
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared",
                           "-o", str(so), str(work / name)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    return so, proc.stdout + proc.stderr


def _demangle(names):
    try:
        proc = subprocess.run([str(Path(kernels.nvcc()).parent / "cu++filt")],
                              input="\n".join(names), capture_output=True,
                              text=True, timeout=60)
        out = proc.stdout.splitlines()
        if proc.returncode == 0 and len(out) == len(names):
            return out
    except OSError:
        pass
    return list(names)


def sass_report(so: Path, sig: str) -> list[str]:
    """Per kernel instance: instructions, MUFU, LDL/STL, CALL, loops."""
    cuobjdump = str(Path(kernels.nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : (\S+)\n", text)
    names = funcs[1::2]
    pretty = _demangle(names)
    rows = []
    for name, pre, body in zip(names, pretty, funcs[2::2]):
        if sig.rstrip("(") not in pre:
            continue
        ins, labels = [], {}
        pending = []
        for ln in body.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", ln)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if m:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                ins.append((addr, m.group(2).strip()))
        ops = [op for _, op in ins if not op.startswith("NOP")]
        count = {k: sum(1 for op in ops if re.match(pat, op))
                 for k, pat in (("MUFU", r"(@\S+ )?MUFU"),
                                ("LDL/STL", r"(@\S+ )?(LDL|STL)"),
                                ("CALL", r"(@\S+ )?CALL"))}
        loops = []
        for i, (addr, op) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", op)
            if not m:
                continue
            tgt = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                                16)
            if tgt is not None and tgt <= addr:
                loops.append(sum(1 for a, o in ins if tgt <= a <= addr
                                 and not o.startswith("NOP")))
        rows.append(f"  {pre.rsplit('(', 1)[0]}: {len(ops)} instructions, "
                    f"MUFU {count['MUFU']}, LDL/STL {count['LDL/STL']}, "
                    f"CALL {count['CALL']}, "
                    f"loops (instructions each) {loops}")
    return rows


def _inputs(kernel, width, comp):
    """(wrapper, plain, args) of the timed call."""
    if kernel == "k1":
        from bench_torch import _build as build
        from ..engine import fused_poly as m
        from ..testing import event_case
        run_batch, _, _, L0 = build(nlambda=128, ncells=32, packets=32768,
                                    refill_batches=128, quadrature_panels=32,
                                    peel_panels=8, device="cuda")
        n = L0.shape[0]
        spec, u, oc, L, l0, state = event_case(run_batch.spec, n, 7, "cuda")
        for it in range(3):
            if it:
                u = rng.uniform_open(rng.event_key(7, it),
                                     (spec.n_uniform, n), "cuda")
            out = m.poly_event_plain(spec, u, oc, L, l0, state)
            state = list(out["state"]) + [out["bc"]]
            L = out["Ln"]
        return (m.poly_event, m.poly_event_plain,
                (spec, u, oc, L, l0, state), f"N = {n}, W = 128")
    if kernel == "k3":
        from bench_torch import _build as build
        from ..engine import fused as m
        from ..testing import mono_event_case
        n = 1 << (21 if comp == 1 else 18)
        run_batch, *_ = build(nlambda=width or 4, ncells=32, packets=n,
                              refill_batches=128, quadrature_panels=32,
                              peel_panels=8, polychromatic=False, ncomp=comp,
                              device="cuda")
        spec, u, state = mono_event_case(run_batch.spec, n, 7, "cuda")
        for it in range(3):
            if it:
                u = rng.uniform_open(rng.event_key(7, it),
                                     (spec.n_uniform, n), "cuda")
            out = m.mono_event_plain(spec, u, state)
            state = list(out["state"]) + state[9:11] + [out["bc"]]
        return (m.mono_event, m.mono_event_plain, (spec, u, state),
                f"N = {n}, W = {width or 4}, H = {comp}")
    import dataclasses

    from bench_torch import _octree_build
    from ..engine import fused_table as mt
    from ..engine import fused_table_poly as m
    from ..testing import (table_event_inputs, table_multi_state,
                           table_poly_state)

    def cut(spec):
        return dataclasses.replace(spec, min_scatt=1,
                                   inv_minred=float(np.float32(1 / 100)))
    if kernel == "k5":
        n = 1 << 17
        run_batch, *_, model = _octree_build(n, device="cuda", multi=True,
                                             polychromatic=False)
        spec = cut(run_batch.spec)
        inp = table_event_inputs(model[1], n, spec.n_uniform, 2, seed=51,
                                 npanels=spec.npanels, small_tau=0.02,
                                 outside=0.02, device="cuda")
        kr, ks, state = table_multi_state(inp, model[1])
        return (mt.table_multi_event, mt.table_multi_event_plain,
                (spec, inp["u"], kr, ks, state),
                f"N = {n}, P = {spec.npanels}, H = 2")
    if kernel == "k6":
        W = width or 2
        n = 1 << {2: 17, 8: 16}.get(W, 15)
        run_batch, *_, model = _octree_build(n, device="cuda", nlambda=W,
                                             polychromatic=True)
        spec = cut(run_batch.spec)
        inp = table_event_inputs(model[1], n, spec.n_uniform, W,
                                 seed={2: 31, 8: 81, 24: 34, 128: 35}.get(W,
                                                                         31),
                                 npanels=spec.npanels, small_tau=0.02,
                                 outside=0.02, device="cuda")
        oc = torch.as_tensor(spec.oc, device="cuda")
        return (m.table_poly_event, m.table_poly_event_plain,
                (spec, inp["u"], inp["rows"], oc, inp["L"], inp["L0"],
                 table_poly_state(inp)),
                f"N = {n}, W = {W}, P = {spec.npanels}")
    W = width or 2
    n = 1 << (17 if W <= 2 else 15)
    seed = {2: 61, 24: 64, 128: 65}.get(W, 61)
    run_batch, *_, model = _octree_build(n, device="cuda", multi=True,
                                         nlambda=W, polychromatic=True)
    spec = cut(run_batch.spec)
    inp = table_event_inputs(model[1], n, spec.n_uniform, W, seed=seed,
                             npanels=spec.npanels, small_tau=0.02,
                             outside=0.02, device="cuda")
    oc = torch.as_tensor(spec.oc, device="cuda")
    return (m.table_poly_multi_event, m.table_poly_multi_event_plain,
            (spec, inp["u"], inp["rows"], oc, inp["L"], inp["L0"],
             table_poly_state(inp)),
            f"N = {n}, W = {W}, P = {spec.npanels}, H = {spec.H}")


def _same(got, want):
    return all(torch.equal(a, b) for a, b in
               zip(got["state"], want["state"])) and all(
        torch.equal(got[k], want[k]) for k in want if k != "state")


def _report(t, lines, per_block, source):
    """Each phase's mean and 90th percentile from the stamps t (rows of
    blocks or warps), and the life of a row; returns the summary words."""
    t = t[(t[:, 0] > 0)]
    # per block: the start, after each barrier, and the end
    nstamp = len(lines) + 2 if per_block else len(lines)
    first, last = 0, nstamp - 1
    unit = "block" if per_block else "warp"
    full = t[(t[:, first] > 0) & (t[:, last] > 0)]
    if len(full) == 0:
        return [f"no {unit} stamped (this instance passes no stamp)"]
    life = full[:, last] - full[:, first]
    span = full[:, last].max() - full[:, first].min()
    t0 = full[:, first].min()
    starts = np.percentile(full[:, first] - t0, (50, 90, 100))
    ends = np.percentile(full[:, last] - t0, (10, 50, 90, 100))
    out = [f"mean {unit} life {life.mean():.0f} ns, {unit}s resident "
           f"{life.sum() / span:.1f} ({len(full)} {unit}s); starts after "
           f"the first (p50, p90, max) {', '.join(f'{v:.0f}' for v in starts)}"
           f" ns, ends (p10, p50, p90, max) "
           f"{', '.join(f'{v:.0f}' for v in ends)} ns"]
    for a in range(nstamp - 1):
        ok = (t[:, a] > 0) & (t[:, a + 1] > 0)
        d = t[ok, a + 1] - t[ok, a]
        if per_block:
            where = (f"barrier at {source}:{lines[a]}" if a < len(lines)
                     else "kernel end")
        else:
            where = f"{source}:{lines[a + 1]}"
        out.append(f"  phase {a}-{a + 1} (to {where}): mean {d.mean():.0f} "
                   f"ns, p90 {np.percentile(d, 90):.0f} ns over "
                   f"{int(ok.sum())} {unit}s")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("kernel", choices=sorted(KERNELS))
    p.add_argument("--csrc", default=str(kernels.CSRC),
                   help="the csrc/ directory whose source is stamped")
    p.add_argument("--width", default="0",
                   help="wavelengths, a comma-separated list (0: default)")
    p.add_argument("--comp", type=int, default=1)
    p.add_argument("--threads", default="0",
                   help="k6, k7: threads a lane, a comma-separated list "
                        "(0: the kernel's own choice)")
    args = p.parse_args(argv)
    widths = [int(w) for w in args.width.split(",")]
    threads = [int(g) for g in args.threads.split(",")]
    if args.kernel not in DISPATCH and threads != [0]:
        p.error(f"--threads applies to {', '.join(DISPATCH)} only")
    require_cuda()
    source, struct, sig, entry = KERNELS[args.kernel]
    csrc = Path(args.csrc)
    plain_src = (csrc / source).read_text()
    common = (csrc / "common.cuh").read_text()
    src, lines, per_block = stamped_source(plain_src, args.kernel)
    if threads != [0]:
        src = force_threads(src, threads, args.kernel)
    work = Path(tempfile.mkdtemp(prefix="phases_"))
    so, _ = _build(work, source, src, common)

    base = getattr(kernels, struct)

    class Stamped(base):
        _fields_ = [("prof", ctypes.c_void_p)]

    lib = ctypes.CDLL(str(so))
    size = getattr(lib, entry.replace("_event", "_args_size"))
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(Stamped):
        raise SystemExit(f"{struct} differs between Python and {source}")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    prof = {}

    class Lib:
        """The package's library with the kernel's entry point swapped for
        the stamped one (the stamp buffer set on the way)."""

        def __getattr__(self, name):
            return getattr(kernels.library(), name)

    def stamped_entry(aref, *rest):
        aref._obj.prof = prof["buf"].data_ptr()
        return fn(aref, *rest)

    setattr(Lib, entry, staticmethod(stamped_entry))
    kernels.library()
    all_same = True
    for width in widths:
        wrapper, plain, call, shape = _inputs(args.kernel, width, args.comp)
        want = plain(*call)
        n = call[-1][0].shape[0]
        nrows = (n + 31) // 32 if not per_block else n  # bound on blocks
        prof["buf"] = torch.zeros(nrows * SLOTS, dtype=torch.int64,
                                  device="cuda")
        for g in threads:
            if threads != [0]:
                ctypes.c_int.in_dll(lib, "phases_threads").value = g
            label = f", {g} threads a lane" if g else ""
            saved = (base, kernels._lib)
            setattr(kernels, struct, Stamped)
            kernels._lib = Lib()
            try:
                got = wrapper(*call)
                torch.cuda.synchronize()
                same = _same(got, want)
                ms = cuda_ms(lambda: wrapper(*call))
                prof["buf"].zero_()
                wrapper(*call)
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"{args.kernel.upper()} stamped ({csrc / source}), "
                      f"{shape}{label}: refused ({e})")
                continue
            finally:
                setattr(kernels, struct, saved[0])
                kernels._lib = saved[1]
            all_same = all_same and same
            t = prof["buf"].view(nrows, SLOTS).cpu().numpy().astype(
                np.float64)
            rows = _report(t, lines, per_block, source)
            print(f"{args.kernel.upper()} stamped ({csrc / source}), "
                  f"{shape}{label}: bit-identical to plain {same}, "
                  f"{ms:.4f} ms, {rows[0]}")
            for row in rows[1:]:
                print(row)
    (work / "plain").mkdir()
    plain_so, log = _build(work / "plain", source, plain_src, common)
    for ln in log.splitlines():
        if sig.rstrip("(") in ln or "Used" in ln or "spill" in ln:
            print(f"  ptxas: {ln.strip()}")
    for row in sass_report(plain_so, sig):
        print(row)
    print(card_line())
    if not all_same:
        sys.exit("the stamped kernel disagrees with its plain version")

if __name__ == "__main__":
    main()
