"""GPU smoke test of skirt_tpu_torch: kernels, parity and the main paths.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

`python3 chip_smoke.py k2 bin_sum exact_peel peel_sed k1 k3 k4 k4d k5 k6
k6d k6p k7 chunked` runs phases 1-2 and then only the named kernel phases
(k1 phase 4, k2 phase 3, bin_sum phase 3b, exact_peel phase 3c, peel_sed
phase 3d,
k3 phase 5, k4 phase 6, k5 phase 7, k6 phase 8, k7 phase 9, k4d phase 10,
k6d phase 11, k6p phase 12, chunked phase 12b, each on the models main
builds for it, built once per run), and prints their
results and the card line but no "ok" line: the way to time two trees in
one call (this script copied into the other tree's checkout).

Phases (each prints one line first; any failure raises and the script
exits non-zero without printing a result):
  1. the card (nvidia-smi name and power limit) and torch / CUDA versions;
     no CUDA device is an error, never a CPU fallback
  2. build the CUDA kernels with nvcc (skirt_tpu_torch/_build/), one nvcc
     per source, all started together
  3. K2 binned_add kernel vs its plain version at the main paths' shapes,
     with the route each takes: the polychromatic frame (4,194,304
     updates into 32,768 bins, with dropped indices) and labs (32,768
     updates into 2,097,152 bins); the monochromatic frame (2,097,152
     updates into 1,024 bins) and labs (2,097,152 into 65,536); and one
     index_add_ over the same (kept) updates as the library yardstick;
     then the frame stream the S1 poly path really sends (the frame
     detects of event iterations 32-35 of one batch at the main path's
     shapes: w-banded bins w * 256 + pixel, ~17 hot pixels a
     wavelength row on the edge-on frame), timed per call the same way
  3b. the bin sum of the mono detects (ops.bin_sum_add, csrc/bin_sum.cu)
     vs float64 np.bincount and its plain version at 2^21 values: the
     mono path's 128 bins (lane % 128, the benchmark's layout, and
     uniform), the flagship's 4, one bin, the one-pass route's largest
     and the passes route (one more bin, and 5,000), each with its route,
     its largest relative bin error against the plain version's (at most
     twice), the bitwise repeat of two launches, and kernel / plain /
     torch.bincount / bound ms
  3c. the exact peel's kernel (ops.exact_peel.peel_columns,
     csrc/exact_peel.cu) vs its plain version on the card at the
     agn-torus cell's shapes (2^15 lanes drawn by density, its ten
     leaders, its 64^3 voxel view): the optical depths at H = 1, the
     integrals at H = 1 and 2, each with its largest relative error, the
     bitwise repeat of two launches, kernel / plain / bound ms (4 B a
     crossed voxel a component and 16 B a ray, from exact_peel_work) and
     the launches
  3d. the SED peel's kernel PS (ops.peel_sed.peel_sed_add,
     csrc/peel_sed.cu) vs its plain version on the card at torus-poly24's
     shapes (ten SKIRTOR leaders from the lanes' directions, W = 24, 2^15
     lanes) and disc-poly128's SED (one leader from (L, N) cosines,
     W = 128, 2^17 lanes), fresh and dead lanes: the largest relative
     tally error, the bitwise repeat of two launches, kernel / plain /
     bound ms (the reads over 3.35 TB/s, or an exp and an rsqrt a term on
     the MUFU lanes) and the launches; the main paths count PS's launches
     and fail where a poly path with an SED never launched it
  4. K1 poly_event kernel vs its plain version on identical inputs at the
     polychromatic path's shapes (N = 32,768 lanes, W = 128, 32/8 panels,
     2 leaders, refill K = 128 from the ExpDisk sampler), chained over six
     events from each of three skirt_tpu_torch.testing.event_case states:
     about 10% dead lanes (some with the launch budget used up),
     axis-parallel directions and a weight cut that fires
  5. K3 mono_event kernel vs its plain version, the same way, at the
     monochromatic path's shapes (N = 2,097,152 lanes, one of W = 4
     wavelengths per lane, 32/8 panels, 2 leaders, refill K = 128 from
     the ExpDisk sampler, labs on; three mono_event_case states, with
     min_scatt_events 1 and a weight cut that fires), then one two-
     component case and one 128-wavelength case (where the Pallas
     driver feeds per-lane tables, lam_inputs) at 262,144 lanes, each
     timed; then
     the host builds of the octrees and tessellations, and the 33,000-
     site tessellation's locate at the staged peel's 2^22 points for
     chunk budgets of 64 MB to 1 GB (the same cells from each)
  6. K4 table_event kernel vs its plain version at capability config 3's
     monochromatic shapes (the octree AGN torus of
     experiments/bench_octree.py traced through its 32^3 voxel view,
     N = 2^17 lanes, one of W = 2 wavelengths per lane, 16 panels, labs
     on): three skirt_tpu_torch.testing.table_event_inputs states (about
     10% dead lanes, lanes with optical depths below 1e-3, lanes past
     min_scatt_events 1 with a weight cut that fires, lanes whose deposit
     falls outside the grid), each chained over six events, the panels
     re-staged on the card between events as the lifecycle stages them
  7. K5 table_multi_event kernel vs its plain version the same way at the
     two-component model's monochromatic shapes (bench_torch._multi_model:
     the torus and a uniform sphere on a 16^3 voxel view, N = 2^17, 24
     panels, H = 2, both panel sums re-staged between events after a
     torch-side direction change)
  8. K6 table_poly_event kernel vs its plain version the same way at
     W = 2 (config 3's polychromatic lanes, N = 2^17, three states),
     W = 24 (the production-width row, N = 2^15) and W = 128 (the widest
     the kernel takes, N = 2^15)
  9. K7 table_poly_multi_event kernel vs its plain version the same way on
     the two-component model at W = 2 (N = 2^17, three states), W = 24
     and W = 128 (N = 2^15; the model's optics interpolated in log
     lambda), H = 2
  10. K4d, the direct-table variant of K4 (no in-kernel locate, the
     deposit distance out), vs its plain version the same way at
     capability config 4's shapes: experiments/bench_voronoi.py's model
     on the exact tessellation of 33,000 sites (bench_torch.
     _voronoi_model), N = 2^16 lanes, one of W = 8 wavelengths per lane,
     16 panels, labs on, three states, six events each, the panels
     re-staged on the card (the tessellation's locate) between events
  11. K6d, the direct-table variant of K6, the same way at W = 8 (N =
     2^16, three states) and W = 128 (N = 2^15)
  12. K6p, K6 and K6d with the polarized driver's column densities out
     (I_s, I_tot), the same way at W = 2 (N = 2^17), 24 and 128 (N =
     2^15), on config 3's voxel view and on the 33,000-site tessellation,
     one state each; every output bit-identical to the plain version
  12b. every event kernel's chunked route (the template instance its C
     entry point picks past 32 panels, 8 observer directions, K3's 2 and
     K7's 3 dust components, K3's 12,288 table floats) against its plain
     version, every output bit-identical, over three chained events from
     one state at the kernel's main-path lanes: K1, K3, K4, K4d, K5, K6,
     K6d, K6p and K7 at P = 33, 84 (the main 32x32x16 grid's max_steps)
     and 280 (the 33,000-site tessellation's); K1 and K3 at 12 leaders;
     K3 at H = 3 (2^18 lanes) and with 15,000 and 60,000 table floats
     (shared memory and, past the card's opt-in limit, device memory);
     K7 at H = 4 (P = 24); each timed against its bound with the shape's
     panel count
  13. K8 (binned_add_lm) at experiments/microbench_blocked_tally.py's
     flagship (2^17 lanes, 128 wavelength blocks, 16,384 cells), at
     nlambda = 20 (where skirt_tpu's tiles leave blocks 16-19 unwritten),
     where lanes are dense (nlambda 8, 1,000 cells, 16 lanes a bin) and
     where a slice passes the card's opt-in shared memory, each line with
     the route (sparse, dense with its split, global) ops.binned.k8_route
     gave it, with K2 on the same lanes as the script's yardsticks; the
     probes through their drivers (skirt_tpu_torch.experiments) at the JAX
     scripts' shapes, one call per distinct function (the Pallas variants
     that differ only in a TPU schedule are one call): PG through both
     routes on P1-P10, on the 32,768-entry table with uniform indices
     and on the 2^23 voxel ids config 3's mono table path stages for its
     panel rows (event iterations 32-35 of one batch), PO at every stage
     of P11-P14 (its SASS must hold HGMMA: wgmma), PM at every shape and
     type of P15 with mm.plan's tile (each timed over the Pallas grid's G
     repeats; its SASS must hold HGMMA and UTMALDG: wgmma and TMA).
     `python3 chip_smoke.py k8 pm po` runs these three alone (phases 1-2
     first, no "ok" line; SASS counts logged, not required)
  14. the main paths at full width, each with the launch counts of its
     kernels reset just before it and read just after, and its tallies
     checked: S1, polychromatic analytic, through make_lifecycle +
     make_multibatch (bench_torch._build defaults); the same model
     through OligoSimulation with quadrature_panels unset (P = 84 from
     the grid, K1's chunked route; one batch of 2^15 lanes, W = 128,
     K = 32); S2a, the mono
     flagship through OligoSimulation (bench.py BENCH_POLY=0
     BENCH_NLAMBDA=4 BENCH_LOG2_PACKETS=21, 2 batches instead of 8);
     config 3 monochromatic (K4, 2^17 lanes, K = 128) and polychromatic
     (K6, W = 2, 2^17 lanes, K = 256) through make_lifecycle +
     make_multibatch, 1 batch each (cut from 2 to keep the script's
     time); one
     OligoSimulation(voxelize="table") on the octree (one batch of 2^17
     polychromatic lanes, K = 256, labs folded back onto the leaves); the
     two-component model mono (K5) and poly (K7, W = 2) through
     make_lifecycle + make_multibatch, 2^17 lanes, K = 128, 1 batch
     each; and its OligoSimulation(voxelize="table") (one batch of 2^17
     polychromatic lanes, K = 128, K7); config 4's voronoi-direct-mono
     (K4d) and voronoi-direct-poly (K6d, W = 8) on the 33,000-site
     tessellation through make_lifecycle + make_multibatch, one batch of
     2^16 lanes each, 64 staged peel panels, refill depth cut to
     VORONOI_K = 8 (the cells' own K = 32 and 64 are bench_torch.py's);
     two OligoSimulation(voxelize="table") runs on 4,096 sites, W = 2,
     K = 8: the smooth sphere passes the field-error bound and runs the
     voxel view (K6, 2^17 lanes), the clumpy field (a random 3% of the
     cells at 1e3) does not and runs the direct table (K6d, 2^16 lanes),
     labs on the Voronoi cells either way; experiments/bench_polarized.py's
     three polarized chains (bench_torch._polarized_model: a polarized
     FullInstrument and an SED instrument, the Thomson Mueller tables,
     W = 2, 2^17 lanes, K = 64) through make_lifecycle + make_multibatch,
     one batch each: the mono analytic flagship (K3), the mono table on
     the config-3 torus (K4) and the poly table (K6p); and a polarized
     OligoSimulation(voxelize="table") on the torus filled with an
     ElectronDustMix (tau_x = 1, K = 16, K6p), which picks up the mix's
     Mueller tables and writes the Stokes frames; and the slice of the
     lambda-blocked tally and the probes: the four drivers of phase 13
     run once per distinct call (K8, PG, PO and PM counted)
  15. each path at a small size on the card against the same run on the
     CPU (the P = 84 OligoSimulation at tests/test_poly.py's tolerances;
     the direct table on tests/test_poly.py's 300-site model; the
     polarized poly table on tests/test_polarization.py's Thomson sphere)
  16. one JSON line of per-kernel results, the card line, and last
     {"ok": true, "device": {...}}

Times: CUDA events around back-to-back calls after warm-up calls, with a
sleep kernel queued first so that the host enqueues every call before
the device reaches them (the mean is then device time, not the wrappers'
host time); kernels mean of 10, plain versions mean of 5.  bound_ms is
the least time the H100 could take for the same work: the larger of the
bytes the call must move (each input read once, each output written
once; a table event reads its panels only for live lanes) over 3.35 TB/s
and its float operations over 67 TFLOP/s (the float32 rate outside the
tensor cores), operations counted per live lane from the kernel source
(each transcendental one operation; approximate; work a kernel repeats by
its own design counted once), from this run's inputs.  K1, K3, K5, K6
(K6d, K6p) and K7 also print an issue floor in their phase lines (not in
the kernels line, which carries measured times and bound_ms only), a
floor nearer what their build can reach:
they build with -fmad=false so as to round as their plain versions do,
so no multiply-add fuses, and an H100 SXM then issues at most 128 float32
operations per SM and clock, 33.5 T/s at 1,980 MHz (half the 67 TFLOP/s
that counts an FMA as two); their exp, log, sqrt, rsqrt, sin, cos and
the reciprocal of each division run on the SM's 16 MUFU lanes, 4.18 T/s.
The issue floor is the larger of the counted operations over the first
rate and those transcendentals, counted per live lane from the kernel
source as the operations are, over the second; it is a model, not a
measurement.  bound_ms stays as it was, so the rows compare with the
earlier runs'.  PM's bf16 products, and the 8-row products that PO's
"matmul" and "fixed_B" outputs keep, run on the tensor cores, so their
operations count at 989 TFLOP/s (dense bf16); the line beside it gives
the same operations at 67 TFLOP/s.  PO's bound is what its output needs
(a gather: indices, output and tables); onehot_floor_ms is the one-hot
formulation's own floor, every group's full (256, 128) @ (128, 1024)
products at 989 TFLOP/s.  The probes' library yardsticks:
index_add_ over the kept lanes (K8), tab[idx] (PG, PO's full gather),
torch.matmul (PM; bf16 out for bf16 in).

Tolerances: K2 and K8 per bin rtol 1e-4, atol 1e-6 (float32 sums of up
to a few thousand updates taken in another order by atomics; each order
is within n * 2^-24 of the exact sum).  PG and PO bit-identical; PM
within skirt_tpu_torch.experiments.mm.tolerance (two float32 sums of the
same K products in other orders, TF32 off).  K1, K3-K7, K4d and K6d by
skirt_tpu_torch.testing's criterion: the discrete outputs (deposit bin,
alive, nscatt, bcount, fresh, K5's interaction cell, whether K4d and K6d
deposit and K6d's deposit wavelength, and for K1, K6 and K7 the
wavelengths that survive the weight cut) agree on >= 99.9% of lanes
(the CPU tests' bound), and no
lane whose discrete outputs agree has a float output off by more than
rtol 1e-4 with atol 1e-6 x the array's largest magnitude.  On the card
the kernels and their plain versions round alike op for op (-fmad=false,
float32 reciprocals of the scale lengths, sums in one fixed order,
rsqrtf), so they agree to the bit in practice; the bounds leave room
only for a compiler that rounds one op differently.  K5, K6, K6d and K6p
are held to the bit on every output of every event (K6p's I_s and I_tot
included).  max_abs_err is
taken over the float outputs, each scaled by its array's largest
magnitude, on the lanes whose discrete outputs agree.  The small-size
cross-device checks hold the CUDA run to the CPU run at Monte Carlo
tolerances (the two devices draw different random streams): the
analytic polychromatic path at tests/test_poly.py's (per-wavelength SED
0.15, totals 0.05), the analytic monochromatic OligoSimulation at
tests/test_fused.py's (SED per wavelength and frame total 0.03, labs
0.05), the table paths at tests/test_fused_table.py's and
tests/test_poly.py's table tolerances (SED per wavelength 0.05 mono and
0.06 poly, labs total 0.05), the two-component paths at the refill
tolerance of tests/test_fused_table.py's multi-component test (SED per
wavelength and labs total 0.08), the direct table at tests/test_poly.py's
direct-table tolerances (SED per wavelength 0.08, labs total 0.06, labs
per wavelength 0.08), the polarized Thomson sphere at
tests/test_polarization.py's poly tolerances (Ftot per wavelength 0.04,
scattered 0.10; on the card the tangential ring, |q| > 0.15 with opposite
signs, and the integrated |P| below 0.06 of the scattered flux).
"""

import json
import sys
import time

import numpy as np

# bound() is the least-time model of bound_ms (module docstring) at the
# H100 SXM's published rates; card_line is also profile_torch.py's
from skirt_tpu_torch.experiments.common import (bound, card_line, cuda_ms,
                                                issue_floor, line, nbytes)


# the event kernels: events chained from each starting state
EVENTS = 6

# refill depth of the config-4 main paths here (the cells' own K, 32 to
# 256, are bench_torch.py's)
VORONOI_K = 8


def log(msg):
    print(msg, flush=True)


def sass_count(so, function, opcode):
    """Instructions of `opcode` in the SASS of the library's functions
    whose names hold `function` (cuobjdump -sass)."""
    import re
    import subprocess
    from pathlib import Path

    from skirt_tpu_torch import kernels

    cuobjdump = str(Path(kernels.nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return sum(len(re.findall(r"\b" + opcode + r"\b", body))
               for name, body in zip(parts[1::2], parts[2::2])
               if function in name)


def event_bound(reads, out, n, live, ops_per_live_lane):
    """bound of one event kernel call over n lanes: each (tensors, lanes)
    pair of `reads` holds per-lane inputs whose columns only `lanes` of
    the n lanes read (a dead lane skips most of them), each read once; the
    outputs written once; ops_per_live_lane operations on each live lane."""
    b = nbytes(out) + sum(nbytes(t) * lanes / n for t, lanes in reads)
    return bound(b, live * ops_per_live_lane)


# float operations per live lane, counted from the kernel sources
# (transcendentals one each; approximate): the slab-test span ~60, a
# closed-form density ~24 plus the panel midpoint 6, the deposit, bias,
# HG and frame arithmetic ~150 (~120 in the table kernels), a panel pick
# 2 per panel
def k1_ops(spec):
    P, W, pp, nl = spec.npanels, spec.W, spec.np_peel, len(spec.leaders)
    return (60 + 30 * P + 2 * (P - 1) + 150 + 70 * W
            + nl * (40 + 30 * pp + 6 * W))


def k3_ops(spec):
    P, pp, nl, H = spec.npanels, spec.np_peel, len(spec.leaders), spec.H
    return (60 + (6 + 24 * H) * P + 2 * (P - 1) + 150
            + nl * (40 + (6 + 24 * H) * pp))


# MUFU operations per live lane (exp, log, sqrt, rsqrt, sin, cos and one
# reciprocal per division), counted from the kernel sources as above: a
# closed-form density a root and an exp; the span 3 divisions; the
# deposit, bias, relaunch and HG scatter ~20 (K1 ~25)
def k1_trans(spec):
    P, W, pp, nl = spec.npanels, spec.W, spec.np_peel, len(spec.leaders)
    # per wavelength: ~2 exp, 5 divisions and an HG root; the peel weight
    # a division per leader
    return 3 + 2 * (P + nl * pp) + 25 + W * (8 + nl)


def k3_trans(spec):
    P, pp, nl, H = spec.npanels, spec.np_peel, len(spec.leaders), spec.H
    # with H > 1 each panel also an albedo division and an exp
    return (3 + 2 * H * (P + nl * pp) + (2 * P if H > 1 else 0) + 20
            + (nl * (2 * H + 1) if H > 1 else 0))


def k5_trans(P):
    # per panel an exp and the albedo division; the two samples' exp and
    # log, exp(-taupath), the bias weight's exp and three divisions, the
    # interaction fraction's division
    return 2 * P + 8


def k6_trans(W):
    # the interaction sample (exp, log, 1 / kappa_c), the HG cosine (2
    # divisions), the deposit sample (exp, log, 1 / kappa_w), the panel
    # fraction's division, the scatter (root, division, cos, sin, rsqrt);
    # per wavelength 2 exp, the F and Q divisions, the HG root and
    # division, the Lp and Ln divisions
    return 15 + 8 * W


def k7_trans(P, W, H):
    # the two samples (2 exp, 2 log), two inversion divisions, the HG
    # cosine (2 divisions) and scatter (~5); per wavelength 3 exp, 7
    # divisions and H HG evaluations (a root and a division each)
    return 13 + W * (10 + 2 * H)


def k4_ops(P):
    # the cumulative sums (2 per panel), two panel picks, the event
    return 2 * P + 4 * (P - 1) + 120


def k6_ops(P, W):
    # per wavelength: the deposit weight ~8, its Hillis-Steele prefix
    # log2 W adds and a compare, the Q / QH pass ~23, the weight pass ~27
    lg = max(1, (W - 1).bit_length())
    return 2 * P + 4 * (P - 1) + 120 + W * (59 + lg)


def k4d_ops(P):
    # K4 without the in-kernel deposit locate (~10 operations)
    return k4_ops(P) - 10


def k6d_ops(P, W):
    # K6 without the in-kernel deposit locate (~10 operations)
    return k6_ops(P, W) - 10


def k5_ops(P):
    # per panel: the cumulative sum, exp, the interacting energy, the albedo
    # division, the scattered and absorbed sums (~12); two panel picks; the
    # event
    return 12 * P + 4 * (P - 1) + 100


def k7_ops(P, W, H):
    # what the function needs (the first design walked the panels three
    # times per wavelength): pass A (4H + 2 per panel),
    # two inversions (8 per panel), the interaction and deposit weights of
    # a panel (6 per panel); per wavelength one walk over the panels (4H + 6
    # per panel), the blended HG once (15 per component), and ~36 + 2H for
    # the optical depth, the sums, weights and the deposit prefix
    lg = max(1, (W - 1).bit_length())
    return ((4 * H + 2) * P + 8 * P + 6 * P + 150
            + W * (P * (4 * H + 6) + 36 + 17 * H + lg))


def _poly_frame_stream(torch, first=32, iters=4):
    """The frame updates the S1 poly main path sends to K2 (bench_torch.
    _build defaults: W = 128, 2^15 lanes, K = 128, 32 / 8 panels): the
    (W, N) bins w * 256 + pixel and contributions of the frame
    instrument's scattering detects in event iterations first .. first +
    iters - 1 of one batch, flattened w-major as FrameInstrument.
    detect_poly passes them.  Returns [(idx, val)], one per iteration."""
    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.instruments import instruments

    run_batch, zero, ell, L0 = _build(
        nlambda=128, ncells=32, packets=1 << 15, refill_batches=128,
        quadrature_panels=32, peel_panels=8, device="cuda")
    calls = []
    add = instruments.binned_add

    def recording(tally, idx, values):
        if tally.numel() == 128 * 256:
            calls.append((idx.clone(), values.clone()))
            # call 0 is the emission peel, call i + 1 event iteration i
            if len(calls) == first + iters + 1:
                raise _Captured
        return add(tally, idx, values)

    instruments.binned_add = recording
    try:
        run_batch(rng.root_key(4357), ell, L0, zero())
    except _Captured:
        pass
    finally:
        instruments.binned_add = add
    if len(calls) < first + iters + 1:
        raise AssertionError(f"the poly path made {len(calls)} frame "
                             f"detects, fewer than {first + iters + 1}")
    return calls[first + 1:]


def _k2_check(torch, binned, nbins, pairs):
    """binned_add against drop_add on each (idx, val) from zero tallies:
    the largest absolute difference, after assert_close."""
    worst = 0.0
    for idx, val in pairs:
        got = binned.binned_add(torch.zeros(nbins, device="cuda"), idx, val)
        want = binned.drop_add(torch.zeros(nbins, device="cuda"), idx, val)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
        worst = max(worst, float((got - want).abs().max()))
    return worst


def phase_k2(torch, results):
    from skirt_tpu_torch.ops import binned

    rs = np.random.default_rng(12)
    worst = 0.0
    times = {}
    shapes = {"frame": (32768, 128 * 32768), "labs": (128 * 16384, 32768),
              "mono frame": (4 * 256, 1 << 21),
              "mono labs": (4 * 16384, 1 << 21)}
    streams = {}
    for name, (nbins, n) in shapes.items():
        idx = rs.integers(0, nbins, n)
        drop = rs.random(n)
        idx = np.where(drop < 0.05, -1, idx)              # escaped lanes
        idx = np.where(drop > 0.995, nbins + 7, idx)      # out of range
        idx = torch.from_numpy(idx.astype(np.int32)).cuda()
        val = torch.from_numpy(rs.random(n).astype(np.float32)).cuda()
        streams[name] = (nbins, [(idx, val)])
    # the poly frame as the main path sends it: w-banded, a few hot
    # pixels a wavelength row
    path = _poly_frame_stream(torch)
    streams["frame (path)"] = (32768, path)
    idx = torch.cat([i for i, _ in path])
    val = torch.cat([v for _, v in path])
    kept = (idx >= 0) & (idx < 32768)
    log(f"  K2 frame (path): event iterations 32-35 of one S1 batch, "
        f"{idx.numel() // len(path)} updates each, kept "
        f"{float(kept.float().mean()):.4f}, non-zero kept "
        f"{float((kept & (val != 0)).float().mean()):.4f}, distinct bins "
        f"{int(torch.unique(idx[kept]).numel())}")
    for name, (nbins, pairs) in streams.items():
        err = _k2_check(torch, binned, nbins, pairs)
        worst = max(worst, err)
        tally = torch.zeros(nbins, device="cuda")
        k = len(pairs)

        def kernel():
            for i, v in pairs:
                binned.binned_add(tally, i, v)

        def plain():
            for i, v in pairs:
                binned.drop_add(tally, i, v)

        # the library yardstick: one index_add_ over the kept updates
        kpairs = [(i[(i >= 0) & (i < nbins)].long(),
                   v[(i >= 0) & (i < nbins)]) for i, v in pairs]

        def library():
            for i, v in kpairs:
                tally.index_add_(0, i, v)

        ms = cuda_ms(kernel) / k
        plain_ms = cuda_ms(plain) / k
        lib_ms = cuda_ms(library) / k
        # each update read once (int32 + float32); the tally read and
        # written once, but no more of it than one 32-byte sector per kept
        # update; one add per kept update (the mean call's)
        n = sum(i.numel() for i, _ in pairs) // k
        kept = sum(i.numel() for i, _ in kpairs) // k
        bnd = bound(nbytes(pairs[0]) + 2 * min(nbytes(tally), 32 * kept),
                    kept)
        times[name] = (ms, plain_ms, lib_ms, bnd)
        route = "shared" if binned.kernels.library().skirt_binned_route(
            nbins) else "global"
        log(f"  K2 {name}: {n} updates -> {nbins} bins, route {route}, "
            f"max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
    results["K2"] = {"max_abs_err": worst, "ms": times["frame"][0],
                     "plain_ms": times["frame"][1],
                     "library_ms": times["frame"][2],
                     "bound_ms": times["frame"][3][0],
                     "bound_by": times["frame"][3][1], "times": times}


def phase_bin_sum(torch, results):
    """The per-wavelength bin sum of the mono detects (ops.bin_sum_add,
    csrc/bin_sum.cu) against float64 np.bincount and its plain version
    at the mono paths' shapes (2^21 values into 128 bins in the
    benchmark's lane % 128 layout and uniform; the flagship's 4 bins),
    one bin, the one-pass route's largest and the passes route: the
    route, the largest relative bin error of each, the bitwise repeat of
    two launches, kernel / plain / torch.bincount / bound ms."""
    from skirt_tpu_torch.ops import bin_sum, binned

    optin, sms = binned.device_limits("cuda")
    most = (optin - bin_sum.STATIC_SMEM) // (4 * bin_sum.THREADS)
    n = 1 << 21
    shapes = {"mono path": (128, "lane"), "mono uniform": (128, "uniform"),
              "flagship": (4, "lane"), "one bin": (1, "lane"),
              "one pass, largest": (most, "uniform"),
              "passes": (most + 1, "uniform"),
              "passes, 5000 bins": (5000, "uniform")}
    gen = torch.Generator(device="cuda").manual_seed(21)
    times, worst = {}, 0.0
    for name, (nl, layout) in shapes.items():
        val = torch.rand(n, generator=gen, device="cuda")
        val *= torch.rand(n, generator=gen, device="cuda") >= 0.25
        ell = (torch.arange(n, device="cuda") % nl if layout == "lane" else
               torch.randint(0, nl, (n,), generator=gen, device="cuda"))
        ell = ell.to(torch.int32)
        want = np.bincount(ell.cpu().numpy(), weights=val.double().cpu()
                           .numpy(), minlength=nl)

        def err(t):
            g = t.double().cpu().numpy()
            return float(np.max(np.abs(g - want)
                                / np.maximum(np.abs(want), 1e-300)))

        got = [bin_sum.bin_sum_add(torch.zeros(nl, device="cuda"), val, ell)
               for _ in range(2)]
        plain = bin_sum.bin_sum_plain(val, ell, nl)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(got[0], got[1]))
        k_err, p_err = err(got[0]), err(plain)
        if not repeat or k_err > 2 * p_err:
            raise AssertionError(f"bin_sum {name}: bitwise repeat {repeat}, "
                                 f"max_rel_err {k_err:.3e} against the "
                                 f"plain version's {p_err:.3e}")
        worst = max(worst, k_err)
        tally = torch.zeros(nl, device="cuda")
        ms = cuda_ms(lambda: bin_sum.bin_sum_add(tally, val, ell))
        plain_ms = cuda_ms(lambda: bin_sum.bin_sum_plain(val, ell, nl),
                           reps=5)
        lib_ms = cuda_ms(lambda: torch.bincount(ell, weights=val,
                                                minlength=nl))
        plan = bin_sum.bin_sum_plan(n, nl, optin, sms)
        # each value and index read once; the tally read and written and a
        # row of partials a block, each counted at 4 bytes a bin
        bnd = bound(8 * n + 4 * nl * (1 + plan.blocks), 0)
        times[name] = (ms, plain_ms, lib_ms, bnd)
        log(f"  bin_sum {name}: {n} values -> {nl} bins ({layout}), route "
            f"{plan.route} ({plan.bins} bins x {plan.ranges} ranges, "
            f"{plan.blocks} blocks a range), max_rel_err {k_err:.3e} (plain "
            f"{p_err:.3e}), bitwise repeat {repeat}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch.bincount {lib_ms:.4f} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    main = times["mono path"]
    results["BS"] = {"max_abs_err": worst, "ms": main[0],
                     "plain_ms": main[1], "library_ms": main[2],
                     "bound_ms": main[3][0], "bound_by": main[3][1],
                     "times": times}


def _torus_field():
    """The agn-torus cell's 64^3 voxel view (its grid and dust system)
    and its ten leaders, built by rtbench's torus_octree from its
    configuration."""
    import skirt_tpu_torch
    from rtbench.builders import torus_octree

    with open("rtbench/configs/agn-torus.json") as f:
        cfg = json.load(f)
    model, _ = torus_octree.build(cfg, skirt_tpu_torch, True, 1)
    ds, _ = model["dust_system"].voxelized()
    leaders = [tuple(float(v) for v in np.asarray(i.kobs, np.float64))
               for i in model["instruments"]]
    return ds.grid, ds, leaders


def phase_exact_peel(torch, results):
    """The exact peel's kernel (ops.exact_peel.peel_columns,
    csrc/exact_peel.cu) against its plain version on the card at the
    agn-torus cell's shapes: 2^15 lanes toward its ten leaders on its
    64^3 voxel view, the optical depths with H = 1 and the integrals with
    H = 1 and 2 (the field and its square), the lanes drawn in voxels by
    density: the largest relative error against the plain version (over
    values above 1e-6 of the largest), the bitwise repeat of two
    launches, kernel / plain / bound ms (4 B a crossed voxel a component
    and 16 B a ray, exact_peel_work's count, over 3.35 TB/s) and the
    launches."""
    from types import SimpleNamespace

    from skirt_tpu_torch.engine import fused_table
    from skirt_tpu_torch.ops import exact_peel

    grid, ds1, leaders = _torus_field()
    n = 1 << 15
    rho = torch.as_tensor(np.asarray(ds1.rho[0], np.float64))
    gen = torch.Generator().manual_seed(18)
    vox = torch.multinomial(rho / rho.sum(), n, replacement=True,
                            generator=gen)
    ijk = torch.stack([vox // (grid.ny * grid.nz),
                       vox // grid.nz % grid.ny, vox % grid.nz], 1)
    lo = torch.tensor(grid._lo, dtype=torch.float64)
    dx = torch.tensor(grid._dx, dtype=torch.float64)
    pos = (lo + (ijk + torch.rand(n, 3, generator=gen,
                                  dtype=torch.float64)) * dx)
    pos = pos.to(torch.float32).cuda()
    kdirs = torch.tensor(leaders, dtype=torch.float64).cuda()
    r1 = np.asarray(ds1.rho[0], np.float64)
    times, worst, launches = {}, 0.0, 0
    for H, what in ((1, "taus"), (1, "integrals"), (2, "integrals")):
        ds = ds1 if H == 1 else SimpleNamespace(
            ncomp=2, rho=[r1, r1 * r1 / r1.max()])
        peel = fused_table.make_exact_peel(grid, ds, leaders)
        ones = [torch.ones(n, device="cuda") for _ in range(H)]
        if what == "taus":
            def kernel():
                return torch.stack(peel(pos, ones))

            def plain():
                return torch.stack(peel.plain(pos, ones))
        else:
            def kernel():
                return torch.stack(peel.integrals(pos))

            def plain():
                return torch.stack(peel.plain_integrals(pos))
        before = exact_peel.peel_columns.launches
        got = [kernel() for _ in range(2)]
        launches += exact_peel.peel_columns.launches - before
        want = plain()
        torch.cuda.synchronize()
        repeat = bool(torch.equal(got[0], got[1]))
        w = want.double()
        big = w.abs() > 1e-6 * float(w.abs().max())
        err = float(((got[0].double() - w).abs() / w.abs())[big].max())
        if not repeat or err > 1e-5:
            raise AssertionError(f"exact peel {what}, H = {H}: bitwise "
                                 f"repeat {repeat}, max_rel_err {err:.3e}")
        worst = max(worst, err)
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, reps=3)
        rays, voxels = (int(v) for v in fused_table.exact_peel_work(
            grid, pos, None, kdirs, H))
        bnd = bound(4 * voxels + 16 * rays, 0)
        name = f"{what} H={H}"
        times[name] = (ms, plain_ms, bnd)
        log(f"  exact peel {name}: {n} lanes x {len(leaders)} leaders on "
            f"{grid.nx}x{grid.ny}x{grid.nz} voxels, {rays} rays, {voxels} "
            f"voxel reads ({voxels / max(rays, 1):.2f} a ray), "
            f"max_rel_err {err:.3e}, bitwise repeat {repeat}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}), {bnd[0] / ms:.1%} of it")
    main = times["taus H=1"]
    results["EP"] = {"max_abs_err": worst, "ms": main[0],
                     "plain_ms": main[1], "bound_ms": main[2][0],
                     "bound_by": main[2][1], "launches": launches,
                     "times": times}


def phase_peel_sed(torch, results):
    """The SED peel's kernel (ops.peel_sed.peel_sed_add,
    csrc/peel_sed.cu) against its plain version on the card at
    torus-poly24's shapes (ten SKIRTOR leaders from the lanes'
    directions, W = 24, 2^15 lanes) and disc-poly128's SED (one leader
    from (L, N) cosines, W = 128, 2^17 lanes), a fifth of the lanes dead
    and a fifth fresh: the largest relative tally error (within 1e-5:
    both sum in float32, in other orders), the bitwise repeat of two
    launches, kernel / plain / bound ms (Lp, Ln, I, the cosines or
    directions and the flags read once over 3.35 TB/s, or an exp and an
    rsqrt a (leader, wavelength, lane) term over the MUFU lanes' 4.18
    T/s) and the launches."""
    from skirt_tpu_torch.experiments.common import MUFU_OPS_PER_S
    from skirt_tpu_torch.ops import binned, peel_sed

    skirtor = [(np.sin(i), 0.0, np.cos(i))
               for i in np.deg2rad(np.arange(0, 91, 10))]
    shapes = {"torus-poly24": (10, 24, 1 << 15, "directions"),
              "disc-poly128 SED": (1, 128, 1 << 17, "rows")}
    gen = torch.Generator(device="cuda").manual_seed(20)
    times, worst, launches = {}, 0.0, 0

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    for name, (L, W, N, form) in shapes.items():
        d = torch.randn((N, 3), generator=gen, device="cuda")
        d /= d.norm(dim=1, keepdim=True)
        cos = peel_sed.LeaderCosines(d, skirtor[:L])
        if form == "rows":
            cos = torch.stack([cos(j) for j in range(L)])
        args = (list(range(L)), peel_sed.wavelengths(W, "cuda"),
                1e30 * rand(W, N), 1e30 * rand(W, N), rand(N) >= 0.2,
                rand(N) < 0.2, 1.3 * rand(W) - 0.4, -0.05 - 3.0 * rand(W),
                2.0 * rand(L, N), cos)

        def kernel(tal):
            return peel_sed.peel_sed_add(tal, *args)

        def plain(tal):
            return peel_sed.peel_sed_plain(tal, *args)

        def zeros():
            return [torch.zeros(W, device="cuda") for _ in range(L)]

        before = peel_sed.peel_sed_add.launches
        got = [kernel(zeros()) for _ in range(2)]
        launches += peel_sed.peel_sed_add.launches - before
        want = zeros()
        plain(want)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(*got))
        err = max(float(((a.double() - b.double()).abs()
                         / b.double().abs()).max())
                  for a, b in zip(got[0], want))
        if not repeat or err > 1e-5:
            raise AssertionError(f"peel_sed {name}: bitwise repeat "
                                 f"{repeat}, max_rel_err {err:.3e}")
        worst = max(worst, err)
        tal = zeros()
        ms = cuda_ms(lambda: kernel(tal))
        plain_ms = cuda_ms(lambda: plain(tal), reps=5)
        nbyte = (8 * W * N + 4 * L * N + 2 * N
                 + (12 * N if form == "directions" else 4 * L * N))
        bnd = bound(nbyte, 2 * L * W * N, MUFU_OPS_PER_S)
        times[name] = (ms, plain_ms, bnd)
        plan = peel_sed.peel_sed_plan(N, W, L,
                                      binned.device_limits("cuda")[1])
        log(f"  peel_sed {name}: {L} leaders ({form}) x W={W} x {N} lanes, "
            f"{plan}, max_rel_err {err:.3e}, bitwise repeat {repeat}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}: {nbyte / 1e6:.2f} MB, "
            f"{2 * L * W * N / 1e6:.2f}M MUFU operations), "
            f"{bnd[0] / ms:.1%} of it")
    main = times["torus-poly24"]
    results["PS"] = {"max_abs_err": worst, "ms": main[0],
                     "plain_ms": main[1], "bound_ms": main[2][0],
                     "bound_by": main[2][1], "launches": launches,
                     "times": times}


def phase_k1(torch, results):
    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_poly
    from skirt_tpu_torch.testing import event_agreement, event_case

    run_batch, _, _, L0 = _build(nlambda=128, ncells=32, packets=32768,
                                 refill_batches=128, quadrature_panels=32,
                                 peel_panels=8, device="cuda")
    n = L0.shape[0]
    worst = 0.0
    for seed in (5, 6, 7):
        spec, u, oc, L, l0, state = event_case(run_batch.spec, n, seed,
                                               "cuda")
        assert spec.W == 128 and spec.npanels == 32 and spec.np_peel == 8
        assert len(spec.leaders) == 2 and spec.refill and spec.nu_pos == 4
        dead = state[6] == 0
        log(f"  K1 inputs (seed {seed}): {n} lanes, {int(dead.sum())} dead, "
            f"{int((dead & (state[8] >= spec.K)).sum())} dead with the "
            f"launch budget used up, {int((state[3] == 0).sum())} with "
            f"dx == 0, min_scatt {spec.min_scatt}")
        for it in range(EVENTS):
            if it:
                u = rng.uniform_open(rng.event_key(seed, it),
                                     (spec.n_uniform, n), "cuda")
            got = fused_poly.poly_event(spec, u, oc, L, l0, state)
            want = fused_poly.poly_event_plain(spec, u, oc, L, l0, state)
            torch.cuda.synchronize()
            res = event_agreement(got, want)
            alive = got["state"][6] != 0
            cut = int(((got["Ln"] == 0) & alive[None]).sum())
            log(f"  K1 event {it}: discrete agree {res['discrete']:.6f}, "
                f"float-disagreeing lanes {res['float_bad']}, scaled max "
                f"err {res['scaled_err']:.3e}; alive "
                f"{float(alive.float().mean()):.3f}, fresh "
                f"{int(got['fresh'].sum())}, (lane, w) cut {cut}, deposits "
                f"{int((got['depi'] >= 0).sum())}")
            if res["discrete"] < 0.999 or res["float_bad"] > 0:
                raise AssertionError(f"K1 kernel disagrees with its plain "
                                     f"version at event {it}: {res}")
            worst = max(worst, res["scaled_err"])
            state = list(got["state"]) + [got["bc"]]
            L = got["Ln"]
    ms = cuda_ms(lambda: fused_poly.poly_event(spec, u, oc, L, l0, state))
    plain_ms = cuda_ms(lambda: fused_poly.poly_event_plain(
        spec, u, oc, L, l0, state), reps=5)
    alive = state[6] != 0
    live = int(alive.sum())
    refill = int((~alive & (state[8] < spec.K)).sum())
    cut = int((alive & (state[7] >= spec.min_scatt)).sum())
    # every lane reads its state; the uniforms only a live or relaunched
    # lane; the weights L only a live one, the launch weights L0 only a
    # relaunched one or a live one past min_scatt (its weight cut)
    bnd = event_bound([([oc, state], n), ([u], live + refill), ([L], live),
                       ([l0], refill + cut)],
                      fused_poly.poly_event(spec, u, oc, L, l0, state), n,
                      live, k1_ops(spec))
    floor = issue_floor(live * k1_ops(spec), live * k1_trans(spec))
    log(f"  K1 N={n} W=128: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}, {live} live lanes), issue floor "
        f"{floor:.4f} ms")
    results["K1"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1]}


def phase_k3(torch, results):
    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused
    from skirt_tpu_torch.testing import event_agreement, mono_event_case

    worst = 0.0
    by_case = {}
    cases = (("W=4", 4, 1, 1 << 21, (5, 6, 7)),
             ("W=4 H=2", 4, 2, 1 << 18, (8,)),
             ("W=128", 128, 1, 1 << 18, (9,)))
    for label, nlambda, ncomp, n, seeds in cases:
        run_batch, *_ = _build(nlambda=nlambda, ncells=32, packets=n,
                               refill_batches=128, quadrature_panels=32,
                               peel_panels=8, polychromatic=False,
                               ncomp=ncomp, device="cuda")
        for seed in seeds:
            spec, u, state = mono_event_case(run_batch.spec, n, seed, "cuda")
            assert spec.npanels == 32 and spec.np_peel == 8
            assert len(spec.leaders) == 2 and spec.refill and spec.nu_pos == 4
            assert spec.want_labs and spec.H == ncomp
            dead = state[7] == 0
            log(f"  K3 {label} inputs (seed {seed}): {n} lanes, "
                f"{int(dead.sum())} dead, "
                f"{int((dead & (state[11] >= spec.K)).sum())} dead with the "
                f"launch budget used up, {int((state[3] == 0).sum())} with "
                f"dx == 0, min_scatt {spec.min_scatt}")
            for it in range(EVENTS):
                if it:
                    u = rng.uniform_open(rng.event_key(seed, it),
                                         (spec.n_uniform, n), "cuda")
                got = fused.mono_event(spec, u, state)
                want = fused.mono_event_plain(spec, u, state)
                torch.cuda.synchronize()
                res = event_agreement(got, want)
                bits = _bits(got, want)
                alive_in = state[7] != 0
                alive = got["state"][7] != 0
                log(f"  K3 {label} event {it}: discrete agree "
                    f"{res['discrete']:.6f}, float-disagreeing lanes "
                    f"{res['float_bad']}, scaled max err "
                    f"{res['scaled_err']:.3e}, bit-identical {bits}; alive "
                    f"{float(alive.float().mean()):.3f}, fresh "
                    f"{int(got['fresh'].sum())}, killed "
                    f"{int((alive_in & ~alive).sum())}, deposits "
                    f"{int((got['depi'] >= 0).sum())}")
                if res["discrete"] < 0.999 or res["float_bad"] > 0:
                    raise AssertionError(f"K3 kernel disagrees with its "
                                         f"plain version ({label}) at event "
                                         f"{it}: {res}")
                worst = max(worst, res["scaled_err"])
                state = list(got["state"]) + state[9:11] + [got["bc"]]
        ms = cuda_ms(lambda: fused.mono_event(spec, u, state))
        plain_ms = cuda_ms(lambda: fused.mono_event_plain(spec, u, state),
                           reps=5)
        alive = state[7] != 0
        live = int(alive.sum())
        refill = int((~alive & (state[11] < spec.K)).sum())
        # every lane reads its state, the uniforms only a live or a
        # relaunched one
        bnd = event_bound([([state], n), ([u], live + refill)],
                          fused.mono_event(spec, u, state), n, live,
                          k3_ops(spec))
        floor = issue_floor(live * k3_ops(spec), live * k3_trans(spec))
        log(f"  K3 N={n} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {live} live lanes), "
            f"issue floor {floor:.4f} ms")
        by_case[label] = {"lanes": n, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bnd[0], "bound_by": bnd[1]}
    results["K3"] = dict(by_case["W=4"], max_abs_err=worst, by_case=by_case)


def phase_main_poly(torch, results):
    from bench_torch import _build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_poly
    from skirt_tpu_torch.engine.lifecycle import make_multibatch
    from skirt_tpu_torch.ops import binned, peel_sed

    W, packets, K, nbatches = 128, 1 << 15, 128, 2
    run_batch, zero_tallies, ell, L0 = _build(
        nlambda=W, ncells=32, packets=packets, refill_batches=K,
        quadrature_panels=32, peel_panels=8, device="cuda")
    run_many = make_multibatch(run_batch, nbatches)
    tallies = zero_tallies()
    torch.cuda.synchronize()
    binned.binned_add.launches = 0
    fused_poly.poly_event.launches = 0
    peel_sed.peel_sed_add.launches = 0
    t0 = time.perf_counter()
    out = run_many(rng.root_key(4357), ell, L0, tallies)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K1": fused_poly.poly_event.launches,
                "K2": binned.binned_add.launches,
                "PS": peel_sed.peel_sed_add.launches}
    results["launches_poly"] = launches
    pps = packets * K * nbatches * W / dt
    sed = out["instruments"][0]["Ftot"].double().cpu().numpy()
    labs = float(out["labs"].double().sum())
    launched = nbatches * W * 1e36
    log(f"  poly main path: {nbatches} batches x {packets} lanes x K={K} x "
        f"W={W} in {dt:.3f} s = {pps:.4e} packets/s; launches {launches}; "
        f"SED total {sed.sum():.4e} W, labs {labs:.4e} W of "
        f"{launched:.4e} W launched")
    for leaf in [v for d in out["instruments"] for v in d.values()] \
            + [out["labs"]]:
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("non-finite tally")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if not (sed.sum() > 0 and (sed > 0).all()):
        raise AssertionError("SED Ftot not positive")
    if not 0 < labs < launched:
        raise AssertionError(f"labs {labs} outside (0, {launched})")
    results["main_poly"] = {"seconds": dt, "packets_per_s": pps}


def phase_reference_poly(torch):
    """The polychromatic model family at a small size: CUDA kernels vs
    the plain path on the CPU, at Monte Carlo tolerance."""
    from bench_torch import _build
    from skirt_tpu_torch import rng

    outs = {}
    for dev in ("cuda", "cpu"):
        run, zero, ell, L0 = _build(nlambda=12, ncells=16, packets=4096,
                                    refill_batches=4, quadrature_panels=16,
                                    peel_panels=8, max_scatt=32,
                                    vary_lambda=True, device=dev)
        t = run(rng.root_key(99), ell, L0, zero())
        outs[dev] = {"sed": t["instruments"][0]["Ftot"].double().cpu().numpy(),
                     "frame": float(t["instruments"][1]["ftot"].double().sum()),
                     "labs": float(t["labs"].double().sum())}
    g, c = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(g["sed"], c["sed"], rtol=0.15)
    for k in ("frame", "labs"):
        if abs(g[k] / c[k] - 1) > 0.05:
            raise AssertionError(f"{k}: cuda {g[k]} vs cpu {c[k]}")
    if abs(g["sed"].sum() / c["sed"].sum() - 1) > 0.05:
        raise AssertionError("SED total differs between cuda and cpu")
    log(f"  small poly model cuda/cpu: SED {g['sed'].sum() / c['sed'].sum():.4f}, "
        f"frame {g['frame'] / c['frame']:.4f}, labs {g['labs'] / c['labs']:.4f}")


def _poly_simulation(device, nlambda, lanes, batches, **model_kw):
    """An OligoSimulation of the bench model with polychromatic lanes:
    `lanes` lanes per batch (each carrying all nlambda wavelengths),
    `batches` batches in one dispatch."""
    from bench_torch import _model
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog

    grid, ds, ss, ins, opts = _model(nlambda=nlambda, polychromatic=True,
                                     **model_kw)
    K = max(opts.refill_batches, 1)
    return OligoSimulation(stellar_system=ss, instruments=ins,
                           dust_system=ds, options=opts,
                           packets=lanes * K * batches,
                           batch_size=lanes * nlambda,
                           dispatch_batches=batches, log=SilentLog(),
                           device=device)


def phase_main_poly_default(torch, results):
    """The main-path analytic model through OligoSimulation with
    quadrature_panels unset: the panels follow the grid (max_steps 84 on
    its 32 x 32 x 16 cells), so K1 runs its chunked route.  W = 128, 2^15
    lanes, one batch at K = 32 (depth cut from S1's 2 x 128)."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_poly
    from skirt_tpu_torch.ops import binned

    W, lanes, K = 128, 1 << 15, 32
    sim = _poly_simulation("cuda", W, lanes, 1, ncells=32, refill_batches=K,
                           peel_panels=8)
    spec = sim._lifecycle.spec
    assert isinstance(spec, fused_poly.PolyEventSpec)
    assert sim.options.quadrature_panels is None and spec.npanels == 84
    assert fused_poly.cuda_route(spec)[0]
    torch.cuda.synchronize()
    binned.binned_add.launches = 0
    fused_poly.poly_event.launches = 0
    t0 = time.perf_counter()
    acc = sim._run_phase(rng.root_key(sim.seed), 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K1": fused_poly.poly_event.launches,
                "K2": binned.binned_add.launches}
    results["launches_poly_p84"] = launches
    pps = lanes * K * W / dt
    launched = float(sim.stellar_system.Lv.sum())
    sed, labs = _check_tallies(acc, launched, "poly P=84 main path")
    log(f"  poly main path, quadrature_panels unset (OligoSimulation, "
        f"P={spec.npanels}): 1 batch x {lanes} lanes x K={K} x W={W} in "
        f"{dt:.3f} s = {pps:.4e} packets/s; launches {launches}; SED total "
        f"{sed.sum():.4e} W, labs {labs:.4e} W of {launched:.4e} W launched")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    results["main_poly_p84"] = {"seconds": dt, "packets_per_s": pps}


def phase_reference_poly_default(torch):
    """The same OligoSimulation (quadrature_panels unset: P = 84, K1's
    chunked route) at a small size on the card against the CPU, at
    tests/test_poly.py's tolerances (SED per wavelength 0.15, totals
    0.05)."""
    from skirt_tpu_torch import rng

    outs = {}
    for dev in ("cuda", "cpu"):
        sim = _poly_simulation(dev, 12, 4096, 1, ncells=32, refill_batches=4,
                               peel_panels=8, max_scatt=32, vary_lambda=True)
        assert sim._lifecycle.spec.npanels == 84
        acc = sim._run_phase(rng.root_key(sim.seed), 0)
        sed, labs = _check_tallies(acc, float(sim.stellar_system.Lv.sum()),
                                   f"small poly P=84 run on {dev}")
        outs[dev] = {"sed": sed,
                     "frame": float(acc["instruments"][1]["ftot"].sum()),
                     "labs": labs}
    g, c = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(g["sed"], c["sed"], rtol=0.15)
    for k in ("frame", "labs"):
        if abs(g[k] / c[k] - 1) > 0.05:
            raise AssertionError(f"P=84 {k}: cuda {g[k]} vs cpu {c[k]}")
    if abs(g["sed"].sum() / c["sed"].sum() - 1) > 0.05:
        raise AssertionError("P=84 SED total differs between cuda and cpu")
    log(f"  small poly OligoSimulation (P=84) cuda/cpu: SED "
        f"{g['sed'].sum() / c['sed'].sum():.4f}, frame "
        f"{g['frame'] / c['frame']:.4f}, labs {g['labs'] / c['labs']:.4f}")


def _mono_simulation(device, nlambda, lanes, batches, **model_kw):
    """An OligoSimulation of the bench model with one wavelength per lane:
    `lanes` lanes per batch, `batches` batches in one dispatch."""
    from bench_torch import _model
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog

    grid, ds, ss, ins, opts = _model(nlambda=nlambda, polychromatic=False,
                                     **model_kw)
    K = max(opts.refill_batches, 1)
    return OligoSimulation(stellar_system=ss, instruments=ins,
                           dust_system=ds, options=opts,
                           packets=lanes // nlambda * K * batches,
                           batch_size=lanes, dispatch_batches=batches,
                           log=SilentLog(), device=device)


def _check_tallies(acc, launched, what):
    """Finite tallies, a positive SED, 0 < labs < launched (float64 host
    sums of an OligoSimulation phase)."""
    for d in acc["instruments"]:
        for v in d.values():
            if not np.isfinite(v).all():
                raise AssertionError(f"{what}: non-finite tally")
    sed = acc["instruments"][0]["Ftot"]
    if not (sed > 0).all():
        raise AssertionError(f"{what}: SED Ftot not positive")
    labs = float(acc["labs"].sum())
    if not 0 < labs < launched:
        raise AssertionError(f"{what}: labs {labs} outside (0, {launched})")
    return sed, labs


def phase_main_mono(torch, results):
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused
    from skirt_tpu_torch.ops import bin_sum, binned

    W, lanes, K, nbatches = 4, 1 << 21, 128, 2
    sim = _mono_simulation("cuda", W, lanes, nbatches, ncells=32,
                           refill_batches=K, quadrature_panels=32,
                           peel_panels=8)
    spec = sim._lifecycle.spec
    assert isinstance(spec, fused.MonoEventSpec)
    assert len(list(sim._batches())) == nbatches
    torch.cuda.synchronize()
    binned.binned_add.launches = 0
    fused.mono_event.launches = 0
    bs_before = sum(bin_sum.bin_sum_add.launches.values())
    t0 = time.perf_counter()
    acc = sim._run_phase(rng.root_key(sim.seed), 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K3": fused.mono_event.launches,
                "K2": binned.binned_add.launches,
                "BS": sum(bin_sum.bin_sum_add.launches.values()) - bs_before}
    results["launches_mono"] = launches
    pps = lanes * K * nbatches / dt
    launched = float(sim.stellar_system.Lv.sum())
    sed, labs = _check_tallies(acc, launched, "mono main path")
    log(f"  mono main path (OligoSimulation): {nbatches} batches x {lanes} "
        f"lanes x K={K}, W={W} one per lane, in {dt:.3f} s = {pps:.4e} "
        f"packets/s; launches {launches} ({launches['K3'] / nbatches:.0f} "
        f"event iterations per batch); SED total {sed.sum():.4e} W, labs "
        f"{labs:.4e} W of {launched:.4e} W launched")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    results["main_mono"] = {"seconds": dt, "packets_per_s": pps}


def phase_reference_mono(torch):
    """A small OligoSimulation(fused=True) on the card against the same
    on the CPU, at tests/test_fused.py's Monte Carlo tolerances."""
    from skirt_tpu_torch import rng

    outs = {}
    for dev in ("cuda", "cpu"):
        sim = _mono_simulation(dev, 2, 1 << 13, 2, ncells=16,
                               refill_batches=4, quadrature_panels=16,
                               peel_panels=8, max_scatt=32, vary_lambda=True)
        acc = sim._run_phase(rng.root_key(sim.seed), 0)
        sed, labs = _check_tallies(acc, float(sim.stellar_system.Lv.sum()),
                                   f"small mono run on {dev}")
        outs[dev] = {"sed": sed,
                     "frame": float(acc["instruments"][1]["ftot"].sum()),
                     "labs": labs}
    g, c = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(g["sed"], c["sed"], rtol=0.03)
    for k, tol in (("frame", 0.03), ("labs", 0.05)):
        if abs(g[k] / c[k] - 1) > tol:
            raise AssertionError(f"{k}: cuda {g[k]} vs cpu {c[k]}")
    log(f"  small mono OligoSimulation cuda/cpu: SED "
        f"{', '.join(f'{r:.4f}' for r in g['sed'] / c['sed'])}, frame "
        f"{g['frame'] / c['frame']:.4f}, labs {g['labs'] / c['labs']:.4f}")


def _bits(got, want):
    """Every output of two event results equal to the bit."""
    import torch
    return all(torch.equal(a, b) for a, b in zip(got["state"],
                                                   want["state"])) and all(
        torch.equal(got[k], want[k]) for k in want if k != "state")


def _chain_k4(torch, label, spec, grid, ds, n, seeds, events=EVENTS,
              exact=False):
    """K4 (or K4d, spec.arith_locate False) against its plain version on
    table_event_inputs states (about 10% dead lanes, lanes with optical
    depths below 1e-3, lanes past min_scatt_events 1 with a weight cut
    that fires, lanes whose deposit falls outside the grid), each chained
    over six events (or `events`), the panels re-staged on the card
    between events as the lifecycle stages them; exact=True also requires
    every output bit-identical.  Returns (worst scaled error, the timed
    inputs (u, kr, state) of the first state's first event)."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_table as tft
    from skirt_tpu_torch.testing import (event_agreement, table_event_inputs,
                                         table_restage, table_state)

    P = spec.npanels
    dep = "depi" if spec.arith_locate else "depd"
    worst = 0.0
    timed = None
    for seed in seeds:
        inp = table_event_inputs(ds, n, spec.n_uniform, spec.nlambda,
                                 seed=seed, npanels=P, small_tau=0.02,
                                 outside=0.02, device="cuda")
        kr, state = table_state(inp, ds)
        u = inp["u"]
        kext_pk = ds.packet_kappas(state[9])[1]
        alive_in = state[7] != 0
        log(f"  {label} inputs (seed {seed}): {n} lanes, "
            f"{int((~alive_in).sum())} dead, "
            f"{int((alive_in & inp['small_tau']).sum())} live with tau < "
            f"1e-3, {int((alive_in & (state[8] >= spec.min_scatt)).sum())} "
            f"live past min_scatt, {int((alive_in & inp['outside']).sum())} "
            f"live with the deposit point outside the grid")
        for it in range(events):
            if it:
                u = rng.uniform_open(rng.event_key(seed, it),
                                     (spec.n_uniform, n), "cuda")
            if timed is None:
                timed = (u, kr, state)
            got = tft.table_event(spec, u, kr, state)
            want = tft.table_event_plain(spec, u, kr, state)
            torch.cuda.synchronize()
            res = event_agreement(got, want)
            alive_in = state[7] != 0
            alive = got["state"][7] != 0
            log(f"  {label} event {it}: discrete agree {res['discrete']:.6f}"
                f", float-disagreeing lanes {res['float_bad']}, scaled max "
                f"err {res['scaled_err']:.3e}, bit-identical "
                f"{_bits(got, want)}; alive "
                f"{float(alive.float().mean()):.3f}, killed "
                f"{int((alive_in & ~alive).sum())}, deposits "
                f"{int((got[dep] >= 0).sum())}")
            if res["discrete"] < 0.999 or res["float_bad"] > 0 or (
                    exact and not _bits(got, want)):
                raise AssertionError(f"{label} kernel disagrees with its "
                                     f"plain version at event {it}: {res}")
            worst = max(worst, res["scaled_err"])
            st = got["state"]
            kr, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                       torch.stack(st[3:6], -1), P, kext_pk)
            state = list(st) + [state[9], state[10], t0, dt, state[13],
                                state[14]]
    return worst, timed


def _time_k4(torch, label, spec, timed, ops):
    """Kernel, plain and bound times of one K4 / K4d event on its timed
    inputs (a state's first event, ~90% live lanes; by the sixth event few
    are left)."""
    from skirt_tpu_torch.engine import fused_table as tft

    u, kr, state = timed
    n = state[0].shape[0]
    live = int((state[7] != 0).sum())
    ms = cuda_ms(lambda: tft.table_event(spec, u, kr, state))
    plain_ms = cuda_ms(lambda: tft.table_event_plain(spec, u, kr, state),
                       reps=5)
    # every lane reads position, direction, L, alive and nscatt; only a
    # live one its uniforms, panels, t0, dt, albedo and g, and with an
    # in-kernel locate its wavelength ell (K4d's caller bins the deposit);
    # only a live one past min_scatt the launch weight L0 (its weight cut)
    live_reads = [u, kr] + ([state[9]] if spec.arith_locate else []) \
        + state[11:]
    cut = int(((state[7] != 0) & (state[8] >= spec.min_scatt)).sum())
    bnd = event_bound([(state[:9], n), (live_reads, live), ([state[10]], cut)],
                      tft.table_event(spec, u, kr, state), n, live, ops)
    log(f"  {label} N={n} P={spec.npanels}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {live} live "
        f"lanes)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1]}


def _cut_spec(spec):
    """The spec with a weight cut that fires within the six events:
    min_weight_reduction 100 after one scattering."""
    import dataclasses
    return dataclasses.replace(spec, min_scatt=1,
                               inv_minred=float(np.float32(1 / 100)))


def phase_k4(torch, results, octree):
    from bench_torch import _octree_build

    n = 1 << 17
    run_batch, *_, model = _octree_build(n, device="cuda",
                                         polychromatic=False, grid=octree)
    grid, ds = model[0], model[1]
    spec = _cut_spec(run_batch.spec)
    assert spec.npanels == 16 and spec.nlambda == 2 and spec.want_labs
    assert spec.arith_locate and (grid.nx, grid.ny, grid.nz) == (32, 32, 32)
    worst, timed = _chain_k4(torch, "K4", spec, grid, ds, n, (21, 22, 23))
    results["K4"] = dict(_time_k4(torch, "K4", spec, timed,
                                  k4_ops(spec.npanels)), max_abs_err=worst)


def phase_k4d(torch, results, vgrid):
    """K4d at voronoi-direct-mono's shapes: the 33,000-site tessellation,
    N = 2^16 lanes, one of W = 8 wavelengths per lane, 16 panels, labs."""
    from bench_torch import _octree_build

    n = 1 << 16
    run_batch, *_, model = _octree_build(
        n, device="cuda", voronoi=True, grid=vgrid, direct=True,
        polychromatic=False, nlambda=8, peel_panels=64)
    grid, ds = model[0], model[1]
    spec = _cut_spec(run_batch.spec)
    assert grid is vgrid and not spec.arith_locate
    assert spec.npanels == 16 and spec.nlambda == 8 and spec.want_labs
    worst, timed = _chain_k4(torch, "K4d", spec, grid, ds, n, (71, 72, 73))
    results["K4d"] = dict(_time_k4(torch, "K4d", spec, timed,
                                   k4d_ops(spec.npanels)), max_abs_err=worst)


def _chain_k6(torch, label, spec, grid, ds, n, seeds, exact=False,
              events=EVENTS):
    """K6 (or K6d, K6p) against its plain version the way _chain_k4 holds
    K4, the lanes' luminosities carried from event to event; exact=True
    also requires every output bit-identical.  Returns (worst scaled
    error, the timed inputs (u, r, L, L0, state))."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_table_poly as tftp
    from skirt_tpu_torch.testing import (event_agreement, table_event_inputs,
                                         table_poly_state, table_restage)

    W, P = spec.W, spec.npanels
    oc = torch.as_tensor(spec.oc, device="cuda")
    ones = [torch.ones(n, device="cuda")]
    worst = 0.0
    timed = None
    for seed in seeds:
        inp = table_event_inputs(ds, n, spec.n_uniform, W, seed=seed,
                                 npanels=P, small_tau=0.02, outside=0.02,
                                 device="cuda")
        state = table_poly_state(inp)
        u, r, L, L0 = inp["u"], inp["rows"], inp["L"], inp["L0"]
        alive_in = state[6] != 0
        log(f"  {label} W={W} inputs (seed {seed}): {n} lanes, "
            f"{int((~alive_in).sum())} dead, "
            f"{int((alive_in & inp['small_tau']).sum())} live with "
            f"panel densities x 1e-6, "
            f"{int((alive_in & (state[7] >= spec.min_scatt)).sum())} "
            f"live past min_scatt, "
            f"{int((alive_in & inp['outside']).sum())} live with the "
            f"deposit point outside the grid")
        for it in range(events):
            if it:
                u = rng.uniform_open(rng.event_key(seed, it),
                                     (spec.n_uniform, n), "cuda")
            if timed is None:
                timed = (u, r, L, L0, state)
            got = tftp.table_poly_event(spec, u, r, oc, L, L0, state)
            want = tftp.table_poly_event_plain(spec, u, r, oc, L, L0, state)
            torch.cuda.synchronize()
            res = event_agreement(got, want)
            alive_in = state[6] != 0
            alive = got["state"][6] != 0
            cut = int(((got["Ln"] == 0) & alive[None]).sum())
            log(f"  {label} W={W} event {it}: discrete agree "
                f"{res['discrete']:.6f}, float-disagreeing lanes "
                f"{res['float_bad']}, scaled max err "
                f"{res['scaled_err']:.3e}, bit-identical "
                f"{_bits(got, want)}; alive "
                f"{float(alive.float().mean()):.3f}, killed "
                f"{int((alive_in & ~alive).sum())}, (lane, w) cut {cut}, "
                f"deposits {int((got['depi'] >= 0).sum())}")
            if res["discrete"] < 0.999 or res["float_bad"] > 0 or (
                    exact and not _bits(got, want)):
                raise AssertionError(f"{label} kernel disagrees with its "
                                     f"plain version (W={W}) at event "
                                     f"{it}: {res}")
            worst = max(worst, res["scaled_err"])
            st = got["state"]
            r, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                      torch.stack(st[3:6], -1), P, ones)
            state = list(st) + [t0, dt]
            L = got["Ln"]
    return worst, timed


def _time_k6(torch, label, spec, timed, ops):
    """Kernel, plain and bound times of one K6 / K6d / K6p event on its
    timed inputs, and the modelled issue floor in the log line."""
    from skirt_tpu_torch.engine import fused_table_poly as tftp

    u, r, L, L0, state = timed
    oc = torch.as_tensor(spec.oc, device="cuda")
    n = state[0].shape[0]
    live = int((state[6] != 0).sum())
    ms = cuda_ms(lambda: tftp.table_poly_event(spec, u, r, oc, L, L0, state))
    plain_ms = cuda_ms(lambda: tftp.table_poly_event_plain(
        spec, u, r, oc, L, L0, state), reps=5)
    # every lane reads position, direction, alive and nscatt; only a live
    # one its uniforms, panels, weights L, t0 and dt, and only a live one
    # past min_scatt the launch weights L0 (its weight cut)
    cut = int(((state[6] != 0) & (state[7] >= spec.min_scatt)).sum())
    bnd = event_bound([([oc] + state[:8], n), ([u, r, L, state[8:]], live),
                       ([L0], cut)],
                      tftp.table_poly_event(spec, u, r, oc, L, L0, state),
                      n, live, ops)
    floor = issue_floor(live * ops, live * k6_trans(spec.W))
    log(f"  {label} N={n} W={spec.W} P={spec.npanels}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {live} "
        f"live lanes), issue floor {floor:.4f} ms")
    return {"lanes": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1]}


def phase_k6(torch, results, octree):
    from bench_torch import _octree_build

    worst = 0.0
    by_w = {}
    for W, n, seeds in ((2, 1 << 17, (31, 32, 33)), (24, 1 << 15, (34,)),
                        (128, 1 << 15, (35,))):
        run_batch, *_, model = _octree_build(n, device="cuda", nlambda=W,
                                             polychromatic=True, grid=octree)
        grid, ds = model[0], model[1]
        spec = _cut_spec(run_batch.spec)
        assert spec.npanels == 16 and spec.W == W and spec.want_labs
        assert spec.arith_locate
        err, timed = _chain_k6(torch, "K6", spec, grid, ds, n, seeds,
                               exact=True)
        worst = max(worst, err)
        by_w[W] = _time_k6(torch, "K6", spec, timed,
                           k6_ops(spec.npanels, W))
    results["K6"] = dict(by_w[2], max_abs_err=worst, by_W=by_w)


def phase_k6d(torch, results, vgrid):
    """K6d at voronoi-direct-poly's shapes (the 33,000-site tessellation,
    N = 2^16, W = 8, 16 panels, labs) and at W = 128 (N = 2^15; the
    model's optics spread over 128 wavelengths)."""
    from bench_torch import _octree_build

    worst = 0.0
    by_w = {}
    for W, n, seeds in ((8, 1 << 16, (81, 82, 83)), (128, 1 << 15, (84,))):
        run_batch, *_, model = _octree_build(
            n, device="cuda", voronoi=True, grid=vgrid, direct=True,
            polychromatic=True, nlambda=W, peel_panels=64)
        grid, ds = model[0], model[1]
        spec = _cut_spec(run_batch.spec)
        assert grid is vgrid and not spec.arith_locate
        assert spec.npanels == 16 and spec.W == W and spec.want_labs
        err, timed = _chain_k6(torch, "K6d", spec, grid, ds, n, seeds,
                               exact=True)
        worst = max(worst, err)
        by_w[W] = _time_k6(torch, "K6d", spec, timed,
                           k6d_ops(spec.npanels, W))
    results["K6d"] = dict(by_w[8], max_abs_err=worst, by_W=by_w)


def phase_k6p(torch, results, octree, vgrid):
    """K6p, K6 and K6d with the column densities of the polarized driver
    (I_s, I_tot) out, bit-identical to its plain version: on config 3's
    voxel view (arithmetic locate) at W = 2 (N = 2^17, the polarized poly
    table cell's shapes), 24 and 128 (N = 2^15), and on the 33,000-site
    tessellation (the direct table) at the same W, one state each."""
    import dataclasses

    from bench_torch import _octree_build

    worst = 0.0
    by_w = {}
    for direct, grid0 in ((False, octree), (True, vgrid)):
        for W, n, seed in ((2, 1 << 17, 91), (24, 1 << 15, 92),
                           (128, 1 << 15, 93)):
            kw = (dict(voronoi=True, direct=True, peel_panels=64)
                  if direct else {})
            run_batch, *_, model = _octree_build(
                n, device="cuda", nlambda=W, polychromatic=True, grid=grid0,
                **kw)
            grid, ds = model[0], model[1]
            spec = dataclasses.replace(_cut_spec(run_batch.spec),
                                       want_pol=True)
            assert spec.arith_locate is not direct and spec.want_labs
            label = "K6p direct" if direct else "K6p"
            err, timed = _chain_k6(torch, label, spec, grid, ds, n,
                                   (seed + 10 * direct,), exact=True)
            worst = max(worst, err)
            ops = (k6d_ops if direct else k6_ops)(spec.npanels, W)
            by_w[f"{'direct ' if direct else ''}W={W}"] = _time_k6(
                torch, label, spec, timed, ops)
    results["K6p"] = dict(by_w["W=2"], max_abs_err=worst, by_W=by_w)


def _chain_k5(torch, label, spec, grid, ds, n, seeds, events=EVENTS):
    """K5 against its plain version the way _chain_k4 holds K4, every
    output to the bit, both panel sums re-staged between events after a
    torch-side direction change.  Returns (worst scaled error, the timed
    inputs (u, kr, ks, state) of the last state's first event)."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_table as tft
    from skirt_tpu_torch.testing import (event_agreement, table_event_inputs,
                                         table_multi_state, table_restage)

    P = spec.npanels
    worst = 0.0
    first = None
    for seed in seeds:
        inp = table_event_inputs(ds, n, spec.n_uniform, 2, seed=seed,
                                 npanels=P, small_tau=0.02, outside=0.02,
                                 device="cuda")
        kr, ks, state = table_multi_state(inp, ds)
        u = inp["u"]
        ksca_pk, kext_pk = ds.packet_kappas(state[9])
        alive_in = state[7] != 0
        log(f"  {label} inputs (seed {seed}): {n} lanes, H=2, "
            f"{int((~alive_in).sum())} dead, "
            f"{int((alive_in & inp['small_tau']).sum())} live with tau < "
            f"1e-3, {int((alive_in & (state[8] >= spec.min_scatt)).sum())} "
            f"live past min_scatt, {int((alive_in & inp['outside']).sum())} "
            f"live with the deposit point outside the grid")
        for it in range(events):
            if it:
                u = rng.uniform_open(rng.event_key(seed, it),
                                     (spec.n_uniform, n), "cuda")
            if it == 0:
                first = (u, kr, ks, state)      # the timed inputs
            got = tft.table_multi_event(spec, u, kr, ks, state)
            want = tft.table_multi_event_plain(spec, u, kr, ks, state)
            torch.cuda.synchronize()
            res = event_agreement(got, want)
            alive_in = state[7] != 0
            alive = got["state"][4] != 0
            log(f"  {label} event {it}: discrete agree {res['discrete']:.6f}, "
                f"float-disagreeing lanes {res['float_bad']}, scaled max "
                f"err {res['scaled_err']:.3e}, bit-identical "
                f"{_bits(got, want)}; alive "
                f"{float(alive.float().mean()):.3f}, killed "
                f"{int((alive_in & ~alive).sum())}, deposits "
                f"{int((got['depi'] >= 0).sum())}, interaction cells "
                f"{int((got['cell'] >= 0).sum())}")
            if res["discrete"] < 0.999 or res["float_bad"] > 0 or not \
                    _bits(got, want):
                raise AssertionError(f"{label} kernel disagrees with its "
                                     f"plain version at event {it}: {res}")
            worst = max(worst, res["scaled_err"])
            # the driver scatters torch-side; here a new isotropic direction
            # for the lanes that go on, then the panels re-staged
            st = got["state"]
            d = torch.where(alive[:, None], rng.isotropic_direction(
                rng.event_key(seed, it, 11), (n,), "cuda"),
                torch.stack(state[3:6], -1))
            kr, ks, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                           d, P, kext_pk, ksca_pk)
            state = list(st[:3]) + [d[:, i].contiguous() for i in range(3)] \
                + [st[3], st[4], state[8] + st[4]] + state[9:11] + [t0, dt]
    return worst, first


def _time_k5(torch, label, spec, timed):
    """Kernel, plain and bound times of one K5 event on its timed inputs,
    and the modelled issue floor in the log line."""
    from skirt_tpu_torch.engine import fused_table as tft

    u, kr, ks, state = timed
    n, P = state[0].shape[0], spec.npanels
    live = int((state[7] != 0).sum())
    ms = cuda_ms(lambda: tft.table_multi_event(spec, u, kr, ks, state))
    plain_ms = cuda_ms(lambda: tft.table_multi_event_plain(spec, u, kr, ks,
                                                           state), reps=5)
    # every lane reads position, L and alive; only a live one its
    # uniforms, both panel sums, direction, nscatt, ell, L0, t0 and dt
    bnd = event_bound([(state[:3] + state[6:8], n),
                       ([u, kr, ks, state[3:6], state[8:]], live)],
                      tft.table_multi_event(spec, u, kr, ks, state), n, live,
                      k5_ops(P))
    floor = issue_floor(live * k5_ops(P), live * k5_trans(P))
    log(f"  {label} N={n} P={P} H=2: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {live} live "
        f"lanes), issue floor {floor:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1]}


def phase_k5(torch, results, multi_tree):
    import dataclasses

    from bench_torch import _octree_build
    from skirt_tpu_torch.engine import fused_table as tft

    n = 1 << 17
    run_batch, *_, model = _octree_build(n, device="cuda", multi=True,
                                         polychromatic=False, grid=multi_tree)
    grid, ds = model[0], model[1]
    spec = dataclasses.replace(run_batch.spec, min_scatt=1,
                               inv_minred=float(np.float32(1 / 100)))
    assert isinstance(spec, tft.TableMultiEventSpec) and ds.ncomp == 2
    assert spec.npanels == 24 and spec.nlambda == 2 and spec.want_labs
    worst, first = _chain_k5(torch, "K5", spec, grid, ds, n, (51, 52, 53))
    results["K5"] = dict(_time_k5(torch, "K5", spec, first),
                         max_abs_err=worst)


def _k7_components(spec, H):
    """The K7 spec at H components from the two-component model's: the
    extra components copies of the first two (their panels at half the
    density, their opacities 1.3x), g as theirs."""
    import dataclasses

    oc = np.asarray(spec.oc, np.float64).reshape(3, 2, spec.W)
    extra = [oc[:, h % 2:h % 2 + 1] * np.array([1.3, 1.3, 1.0])[:, None, None]
             for h in range(2, H)]
    oc = np.concatenate([oc] + extra, 1)
    return dataclasses.replace(spec, H=H, oc=np.ascontiguousarray(
        oc.reshape(3 * H, spec.W), np.float32))


def _k7_rows(torch, r, P, H):
    """The (H P, N) panel rows of _k7_components from the model's two."""
    return torch.cat([r] + [0.5 * r[(h % 2) * P:(h % 2 + 1) * P]
                            for h in range(2, H)]) if H > 2 else r


def _chain_k7(torch, label, spec, grid, ds, n, seeds, events=EVENTS,
              exact=False):
    """K7 against its plain version the way _chain_k6 holds K6 (at
    spec.H components: _k7_components); exact=True also requires every
    output bit-identical.  Returns (worst scaled error, the timed inputs
    (u, r, L, L0, state) of the last state's first event)."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_table_poly as tftp
    from skirt_tpu_torch.testing import (event_agreement, table_event_inputs,
                                         table_poly_state, table_restage)

    W, P, H = spec.W, spec.npanels, spec.H
    oc = torch.as_tensor(spec.oc, device="cuda")
    worst = 0.0
    first = None
    for seed in seeds:
        inp = table_event_inputs(ds, n, spec.n_uniform, W, seed=seed,
                                 npanels=P, small_tau=0.02, outside=0.02,
                                 device="cuda")
        state = table_poly_state(inp)
        u, L, L0 = inp["u"], inp["L"], inp["L0"]
        r = _k7_rows(torch, inp["rows"], P, H)
        alive_in = state[6] != 0
        log(f"  {label} W={W} inputs (seed {seed}): {n} lanes, H={H}, "
            f"{int((~alive_in).sum())} dead, "
            f"{int((alive_in & inp['small_tau']).sum())} live with "
            f"panel densities x 1e-6, "
            f"{int((alive_in & (state[7] >= spec.min_scatt)).sum())} "
            f"live past min_scatt, "
            f"{int((alive_in & inp['outside']).sum())} live with the "
            f"deposit point outside the grid")
        for it in range(events):
            if it:
                u = rng.uniform_open(rng.event_key(seed, it),
                                     (spec.n_uniform, n), "cuda")
            if it == 0:
                first = (u, r, L, L0, state)    # the timed inputs
            got = tftp.table_poly_multi_event(spec, u, r, oc, L, L0, state)
            want = tftp.table_poly_multi_event_plain(spec, u, r, oc, L, L0,
                                                     state)
            torch.cuda.synchronize()
            res = event_agreement(got, want)
            alive_in = state[6] != 0
            alive = got["state"][6] != 0
            cut = int(((got["Ln"] == 0) & alive[None]).sum())
            log(f"  {label} W={W} event {it}: discrete agree "
                f"{res['discrete']:.6f}, float-disagreeing lanes "
                f"{res['float_bad']}, scaled max err "
                f"{res['scaled_err']:.3e}, bit-identical "
                f"{_bits(got, want)}; alive "
                f"{float(alive.float().mean()):.3f}, killed "
                f"{int((alive_in & ~alive).sum())}, (lane, w) cut {cut}, "
                f"deposits {int((got['depi'] >= 0).sum())}")
            if res["discrete"] < 0.999 or res["float_bad"] > 0 or (
                    exact and not _bits(got, want)):
                raise AssertionError(f"{label} kernel disagrees with its "
                                     f"plain version (W={W}) at event "
                                     f"{it}: {res}")
            worst = max(worst, res["scaled_err"])
            st = got["state"]
            r, t0, dt = table_restage(grid, ds, torch.stack(st[:3], -1),
                                      torch.stack(st[3:6], -1), P, None)
            r = _k7_rows(torch, r, P, H)
            state = list(st) + [t0, dt]
            L = got["Ln"]
    return worst, first


def _time_k7(torch, label, spec, timed):
    """Kernel, plain and bound times of one K7 event on its timed inputs,
    and the modelled issue floor in the log line."""
    from skirt_tpu_torch.engine import fused_table_poly as tftp

    u, r, L, L0, state = timed
    W, P, H = spec.W, spec.npanels, spec.H
    oc = torch.as_tensor(spec.oc, device="cuda")
    n = state[0].shape[0]
    live = int((state[6] != 0).sum())
    ms = cuda_ms(lambda: tftp.table_poly_multi_event(spec, u, r, oc, L, L0,
                                                     state))
    plain_ms = cuda_ms(lambda: tftp.table_poly_multi_event_plain(
        spec, u, r, oc, L, L0, state), reps=5)
    # every lane reads position, direction, alive and nscatt; only a
    # live one its uniforms, the H panel row sets, weights L, t0 and dt,
    # and only a live one past min_scatt the launch weights L0
    cut = int(((state[6] != 0) & (state[7] >= spec.min_scatt)).sum())
    bnd = event_bound([([oc] + state[:8], n),
                       ([u, r, L, state[8:]], live), ([L0], cut)],
                      tftp.table_poly_multi_event(spec, u, r, oc, L, L0,
                                                  state),
                      n, live, k7_ops(P, W, H))
    floor = issue_floor(live * k7_ops(P, W, H), live * k7_trans(P, W, H))
    log(f"  {label} N={n} W={W} P={P} H={H}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {live} "
        f"live lanes), issue floor {floor:.4f} ms")
    return {"lanes": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1]}


def phase_k7(torch, results, multi_tree):
    import dataclasses

    from bench_torch import _octree_build
    from skirt_tpu_torch.engine import fused_table_poly as tftp

    worst = 0.0
    by_w = {}
    for W, n, seeds in ((2, 1 << 17, (61, 62, 63)), (24, 1 << 15, (64,)),
                        (128, 1 << 15, (65,))):
        run_batch, *_, model = _octree_build(n, device="cuda", multi=True,
                                             nlambda=W, polychromatic=True,
                                             grid=multi_tree)
        grid, ds = model[0], model[1]
        spec = dataclasses.replace(run_batch.spec, min_scatt=1,
                                   inv_minred=float(np.float32(1 / 100)))
        assert isinstance(spec, tftp.TablePolyMultiEventSpec)
        assert spec.npanels == 24 and spec.H == 2 and spec.W == W
        assert spec.want_labs
        err, first = _chain_k7(torch, "K7", spec, grid, ds, n, seeds)
        worst = max(worst, err)
        by_w[W] = _time_k7(torch, "K7", spec, first)
    results["K7"] = dict(by_w[2], max_abs_err=worst, by_W=by_w)


# the chunked routes' shapes (phase 12b): panel counts past MAXP = 32 (84:
# the main 32x32x16 grid's max_steps; 280: the 33,000-site tessellation's)
CHUNK_P = (33, 84, 280)
CHUNK_EVENTS = 3


def _leaders(count):
    """`count` observer directions (unit vectors at spread inclinations
    and azimuths)."""
    out = []
    for j, inc in enumerate(np.linspace(0.15, 3.0, count)):
        out.append((float(np.sin(inc) * np.cos(0.7 * j)),
                    float(np.sin(inc) * np.sin(0.7 * j)), float(np.cos(inc))))
    return out


def _chain_analytic(torch, label, kernel, plain, spec, n, seed, events,
                    poly):
    """K1 (poly) or K3 against its plain version over `events` chained
    events from one testing.event_case / mono_event_case state, every
    output to the bit.  Returns (worst scaled error, the timed inputs)."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.testing import (event_agreement, event_case,
                                         mono_event_case)

    if poly:
        spec, u, oc, L, l0, state = event_case(spec, n, seed, "cuda")
    else:
        spec, u, state = mono_event_case(spec, n, seed, "cuda")
    worst, timed = 0.0, None
    for it in range(events):
        if it:
            u = rng.uniform_open(rng.event_key(seed, it),
                                 (spec.n_uniform, n), "cuda")
        args = (spec, u, oc, L, l0, state) if poly else (spec, u, state)
        if timed is None:
            timed = args
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        res = event_agreement(got, want)
        bits = _bits(got, want)
        log(f"  {label} event {it}: discrete agree {res['discrete']:.6f}, "
            f"float-disagreeing lanes {res['float_bad']}, bit-identical "
            f"{bits}")
        if not bits:
            raise AssertionError(f"{label} kernel disagrees with its plain "
                                 f"version at event {it}: {res}")
        worst = max(worst, res["scaled_err"])
        if poly:
            state = list(got["state"]) + [got["bc"]]
            L = got["Ln"]
        else:
            state = list(got["state"]) + state[9:11] + [got["bc"]]
    return worst, timed


def _time_analytic(torch, label, kernel, plain, args, poly):
    """Kernel, plain and bound times of one K1 or K3 event, as phases 4
    and 5 count them."""
    spec, u, state = args[0], args[1], args[-1]
    n = state[0].shape[0]
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args), reps=5)
    ia, ib = (6, 8) if poly else (7, 11)
    alive = state[ia] != 0
    live = int(alive.sum())
    refill = int((~alive & (state[ib] < spec.K)).sum())
    if poly:
        oc, L, l0 = args[2:5]
        cut = int((alive & (state[7] >= spec.min_scatt)).sum())
        reads = [([oc, state], n), ([u], live + refill), ([L], live),
                 ([l0], refill + cut)]
        ops, trans = k1_ops(spec), k1_trans(spec)
    else:
        reads = [([state], n), ([u], live + refill)]
        ops, trans = k3_ops(spec), k3_trans(spec)
    bnd = event_bound(reads, kernel(*args), n, live, ops)
    floor = issue_floor(live * ops, live * trans)
    log(f"  {label} N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}, {live} live lanes), issue floor "
        f"{floor:.4f} ms")
    return {"lanes": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1]}


def _k3_components(spec, H):
    """The K3 spec at H components from the two-component one: the extra
    components copies of the first two's densities, their opacities 1.3x,
    their g halved."""
    import dataclasses

    NL = spec.nlambda
    tab = np.asarray(spec.tab, np.float64).reshape(3, 2, NL)
    extra = [tab[:, h % 2:h % 2 + 1] * np.array([1.3, 1.3, 0.5])[:, None,
                                                                  None]
             for h in range(2, H)]
    tab = np.concatenate([tab] + extra, 1)
    geoms = [spec.density_geometries[h % 2] for h in range(H)]
    return dataclasses.replace(
        spec, H=H, tab=np.ascontiguousarray(tab.reshape(3 * H, NL),
                                            np.float32),
        density_geometries=geoms, _tab_dev={})


def _k3_wide_table(spec, NL):
    """The K3 spec with an NL-wavelength table (3 NL floats), the model's
    columns repeated."""
    import dataclasses

    tab = np.asarray(spec.tab)[:, np.arange(NL) % spec.nlambda]
    return dataclasses.replace(spec, nlambda=NL, tab=np.ascontiguousarray(
        tab, np.float32), _tab_dev={})


def phase_chunked(torch, results, octree, multi_tree, vgrid):
    """Every event kernel's chunked route (panel counts past MAXP = 32,
    more than 8 observers, more dust components, K3's wide tables)
    against its plain version, every output to the bit, over
    CHUNK_EVENTS chained events from one state, at the kernel's main-path
    lanes, each timed against its bound with the shape's panel count."""
    import dataclasses

    from bench_torch import _build, _octree_build
    from skirt_tpu_torch.engine import fused, fused_poly

    out = {}
    t0 = time.perf_counter()

    def took(what):
        log(f"  {what} in {time.perf_counter() - t0:.1f} s of the phase")

    def put(kname, shape, err, timing):
        out.setdefault(kname, {})[shape] = dict(timing, max_abs_err=err)

    def panels(spec, P):
        return dataclasses.replace(spec, npanels=P,
                                   inv_np=float(np.float32(1.0 / P)))

    # K1: the poly path's shapes (N = 2^15, W = 128, 8 peel panels, refill)
    run_batch, *_ = _build(nlambda=128, ncells=32, packets=32768,
                           refill_batches=128, quadrature_panels=32,
                           peel_panels=8, device="cuda")
    base = run_batch.spec
    k1 = (fused_poly.poly_event, fused_poly.poly_event_plain)
    cases = [(f"P={P}", panels(base, P)) for P in CHUNK_P]
    cases.append(("12 leaders", dataclasses.replace(base,
                                                    leaders=_leaders(12))))
    for shape, spec in cases:
        assert fused_poly.cuda_route(spec)[0]
        err, timed = _chain_analytic(torch, f"K1 {shape}", *k1, spec, 32768,
                                     101, CHUNK_EVENTS, True)
        put("K1", shape, err, _time_analytic(torch, f"K1 {shape}", *k1,
                                             timed, True))
    took("K1")
    # K3: the mono path's shapes (N = 2^21, W = 4), then H = 3 and the
    # wide tables at 2^18 lanes
    k3 = (fused.mono_event, fused.mono_event_plain)
    run_batch, *_ = _build(nlambda=4, ncells=32, packets=1 << 21,
                           refill_batches=128, quadrature_panels=32,
                           peel_panels=8, polychromatic=False, device="cuda")
    base = run_batch.spec
    cases = [(f"P={P}", panels(base, P), 1 << 21) for P in CHUNK_P]
    cases.append(("12 leaders", dataclasses.replace(base,
                                                    leaders=_leaders(12)),
                  1 << 21))
    cases += [(f"table {3 * NL} floats", _k3_wide_table(base, NL), 1 << 18)
              for NL in (5000, 20000)]
    run_batch, *_ = _build(nlambda=4, ncells=32, packets=1 << 18,
                           refill_batches=128, quadrature_panels=32,
                           peel_panels=8, polychromatic=False, ncomp=2,
                           device="cuda")
    cases.append(("H=3", _k3_components(run_batch.spec, 3), 1 << 18))
    for shape, spec, n in cases:
        assert fused.cuda_route(spec)[0]
        err, timed = _chain_analytic(torch, f"K3 {shape}", *k3, spec, n, 102,
                                     CHUNK_EVENTS, False)
        put("K3", shape, err, _time_analytic(torch, f"K3 {shape}", *k3,
                                             timed, False))
    took("K3")
    # K4 and K6 (and K6p) on config 3's voxel view, K4d and K6d on the
    # 33,000-site tessellation, K5 and K7 on the two-component model
    n17, n16 = 1 << 17, 1 << 16
    rb = _octree_build(n17, device="cuda", polychromatic=False,
                       grid=octree)
    k4 = (_cut_spec(rb[0].spec), rb[-1])
    rb = _octree_build(n16, device="cuda", voronoi=True, grid=vgrid,
                       direct=True, polychromatic=False, nlambda=8,
                       peel_panels=64)
    k4d = (_cut_spec(rb[0].spec), rb[-1])
    rb = _octree_build(n17, device="cuda", polychromatic=True, grid=octree)
    k6 = (_cut_spec(rb[0].spec), rb[-1])
    rb = _octree_build(n16, device="cuda", voronoi=True, grid=vgrid,
                       direct=True, polychromatic=True, nlambda=8,
                       peel_panels=64)
    k6d = (_cut_spec(rb[0].spec), rb[-1])
    rb = _octree_build(n17, device="cuda", multi=True, polychromatic=False,
                       grid=multi_tree)
    k5 = (_cut_spec(rb[0].spec), rb[-1])
    rb = _octree_build(n17, device="cuda", multi=True, polychromatic=True,
                       grid=multi_tree)
    k7 = (_cut_spec(rb[0].spec), rb[-1])
    took("the table models")
    for P in CHUNK_P:
        shape = f"P={P}"
        for kname, (spec0, model), n, ops in (
                ("K4", k4, n17, k4_ops(P)), ("K4d", k4d, n16, k4d_ops(P))):
            spec = dataclasses.replace(spec0, npanels=P)
            err, timed = _chain_k4(torch, f"{kname} {shape}", spec,
                                   model[0], model[1], n, (103,),
                                   events=CHUNK_EVENTS, exact=True)
            put(kname, shape, err, _time_k4(torch, f"{kname} {shape}", spec,
                                            timed, ops))
        for kname, (spec0, model), n, pol in (
                ("K6", k6, n17, False), ("K6p", k6, n17, True),
                ("K6d", k6d, n16, False)):
            spec = dataclasses.replace(spec0, npanels=P, want_pol=pol)
            err, timed = _chain_k6(torch, f"{kname} {shape}", spec,
                                   model[0], model[1], n, (104,), exact=True,
                                   events=CHUNK_EVENTS)
            ops = (k6d_ops if kname == "K6d" else k6_ops)(P, spec.W)
            put(kname, shape, err, _time_k6(torch, f"{kname} {shape}", spec,
                                            timed, ops))
        spec = dataclasses.replace(k5[0], npanels=P)
        err, timed = _chain_k5(torch, f"K5 {shape}", spec, k5[1][0],
                               k5[1][1], n17, (105,), events=CHUNK_EVENTS)
        put("K5", shape, err, _time_k5(torch, f"K5 {shape}", spec, timed))
        took(f"K4, K4d, K6, K6p, K6d, K5 at P = {P}")
    for shape, P, H in [(f"P={P}", P, 2) for P in CHUNK_P] + [("H=4", 24,
                                                               4)]:
        spec = _k7_components(dataclasses.replace(k7[0], npanels=P), H)
        err, timed = _chain_k7(torch, f"K7 {shape}", spec, k7[1][0],
                               k7[1][1], n17, (106,), events=CHUNK_EVENTS,
                               exact=True)
        put("K7", shape, err, _time_k7(torch, f"K7 {shape}", spec, timed))
    took("K7")
    results["chunked"] = out


# (spec type, event wrapper, kernel name) of the table engines by
# (multi-component, polychromatic)
def _table_engine(multi, poly):
    from skirt_tpu_torch.engine import fused_table as tft
    from skirt_tpu_torch.engine import fused_table_poly as tftp

    return {(False, False): (tft.TableEventSpec, tft.table_event, "K4"),
            (False, True): (tftp.TablePolyEventSpec, tftp.table_poly_event,
                            "K6"),
            (True, False): (tft.TableMultiEventSpec, tft.table_multi_event,
                            "K5"),
            (True, True): (tftp.TablePolyMultiEventSpec,
                           tftp.table_poly_multi_event, "K7")}[multi, poly]


def _run_table_path(torch, poly, lanes, batches, grid, device="cuda",
                    multi=False, voronoi=False, labs_by_wavelength=False,
                    **model_kw):
    """Config 3 (multi=False), the two-component model (multi=True) or
    config 4 (voronoi=True) through make_lifecycle + make_multibatch on
    `grid` (an octree or tessellation built earlier, or None): (seconds,
    packets, SED, labs
    total (per wavelength with labs_by_wavelength), launched W, launches
    of the path's kernels; on the direct table K4d or K6d; EP the exact
    peel's, 0 where the peel is staged or runs on the CPU; PS the SED
    peel's, 0 on the mono paths, the blend of several components and the
    CPU)."""
    import warnings

    from bench_torch import _octree_build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine.lifecycle import make_multibatch
    from skirt_tpu_torch.ops import binned, exact_peel, peel_sed

    with warnings.catch_warnings():
        # the direct table's staged-peel downgrade, expected here; any
        # other warning (the native builder's fallback) still shows
        warnings.filterwarnings("ignore",
                                message="table_peel='exact' needs")
        run_batch, zero, ell, L0, packets, model = _octree_build(
            lanes, device=device, multi=multi, voronoi=voronoi,
            polychromatic=poly, grid=grid, **model_kw)
    spec_type, event, kname = _table_engine(multi, poly)
    assert type(run_batch.spec) is spec_type
    direct = not getattr(run_batch.spec, "arith_locate", True)
    W = model[2].wavelength_grid.nlambda
    run_many = make_multibatch(run_batch, batches)
    tallies = zero()
    if device == "cuda":
        torch.cuda.synchronize()
    binned.binned_add.launches = 0
    exact_peel.peel_columns.launches = 0
    peel_sed.peel_sed_add.launches = 0
    event.launches = 0
    if direct:
        event.direct_launches = 0
    t0 = time.perf_counter()
    out = run_many(rng.root_key(4357), ell, L0, tallies)
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if direct:
        launches = {kname + "d": event.direct_launches,
                    "K2": binned.binned_add.launches}
        assert event.launches == event.direct_launches
    else:
        launches = {kname: event.launches, "K2": binned.binned_add.launches}
    launches["EP"] = exact_peel.peel_columns.launches
    launches["PS"] = peel_sed.peel_sed_add.launches
    for leaf in [v for d in out["instruments"] for v in d.values()] \
            + [out["labs"]]:
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("non-finite tally")
    sed = out["instruments"][0]["Ftot"].double().cpu().numpy()
    labs = out["labs"].double().reshape(-1, W).sum(0).cpu().numpy()
    if not labs_by_wavelength:
        labs = float(labs.sum())
    # per batch every wavelength launches 1e36 W (poly) or all
    # wavelengths together do (mono: ell = lane % W)
    launched = batches * 1e36 * (W if poly else 1)
    return dt, packets * batches, sed, labs, launched, launches


def phase_main_table(torch, results, octree):
    for poly in (False, True):
        name = "poly" if poly else "mono"
        lanes, batches = 1 << 17, 1
        K = 256 if poly else 128
        dt, packets, sed, labs, launched, launches = _run_table_path(
            torch, poly, lanes, batches, octree)
        pps = packets / dt
        kname = "K6" if poly else "K4"
        log(f"  config 3 {name}: {batches} batches x {lanes} lanes x K={K}"
            f"{' x W=2' if poly else ', W=2 one per lane'} in {dt:.3f} s = "
            f"{pps:.4e} packets/s; launches {launches} "
            f"({launches[kname] / batches:.0f} event iterations per batch); "
            f"SED {', '.join(f'{v:.4e}' for v in sed)} W, labs "
            f"{labs:.4e} W of {launched:.4e} W launched")
        if min(launches[kname], launches["K2"], launches["EP"],
               launches["PS"] if poly else 1) <= 0:
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        if not (sed > 0).all():
            raise AssertionError("SED Ftot not positive")
        if not 0 < labs < launched:
            raise AssertionError(f"labs {labs} outside (0, {launched})")
        results[f"launches_table_{name}"] = launches
        results[f"main_table_{name}"] = {"seconds": dt, "packets_per_s": pps}


def phase_simulation_table(torch, results, octree):
    """OligoSimulation(voxelize="table") on the octree (leaf-resolution
    gridded densities): it voxelizes, runs the K6 engine and folds the
    labs back onto the leaves."""
    from bench_torch import _octree_model
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_table_poly
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog
    from skirt_tpu_torch.ops import binned, exact_peel, peel_sed

    grid, ds, ss, ins, opts, _ = _octree_model(grid=octree, voxelize=False)
    W, lanes, K = 2, 1 << 17, opts.refill_batches
    sim = OligoSimulation(stellar_system=ss, instruments=ins, dust_system=ds,
                          options=opts, packets=lanes * K,
                          batch_size=lanes * W, dispatch_batches=1,
                          log=SilentLog(), device="cuda")
    assert sim._poly and sim.dust_system.table and sim._labs_fold
    assert isinstance(sim._lifecycle.spec, fused_table_poly.TablePolyEventSpec)
    assert len(list(sim._batches())) == 1
    torch.cuda.synchronize()
    binned.binned_add.launches = 0
    exact_peel.peel_columns.launches = 0
    peel_sed.peel_sed_add.launches = 0
    fused_table_poly.table_poly_event.launches = 0
    t0 = time.perf_counter()
    acc = sim._run_phase(rng.root_key(sim.seed), 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K6": fused_table_poly.table_poly_event.launches,
                "K2": binned.binned_add.launches,
                "EP": exact_peel.peel_columns.launches,
                "PS": peel_sed.peel_sed_add.launches}
    results["launches_table_sim"] = launches
    launched = float(ss.Lv.sum())
    sed, labs = _check_tallies(acc, launched, "table OligoSimulation")
    if acc["labs"].shape != (octree.ncells * W,):
        raise AssertionError(f"labs not folded onto the {octree.ncells} "
                             f"leaves: {acc['labs'].shape}")
    pps = lanes * K * W / dt
    log(f"  OligoSimulation(voxelize='table'): {octree.ncells} leaves -> "
        f"{sim.grid.nx}^3 voxels, 1 batch x {lanes} lanes x K={K} x W={W} in "
        f"{dt:.3f} s = {pps:.4e} packets/s; launches {launches}; SED "
        f"{', '.join(f'{v:.4e}' for v in sed)} W, labs {labs:.4e} W of "
        f"{launched:.4e} W launched, on {octree.ncells} leaves")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    results["main_table_sim"] = {"seconds": dt, "packets_per_s": pps}


def phase_reference_table(torch):
    """The table paths at a small size (max_level 4: 16^3 voxels) on the
    card against the same runs on the CPU, at the table tolerances."""
    for poly, lanes, sed_tol in ((False, 1 << 13, 0.05), (True, 1 << 12, 0.06)):
        outs = {}
        for dev in ("cuda", "cpu"):
            _, _, sed, labs, launched, _ = _run_table_path(
                torch, poly, lanes, 1, None, device=dev, max_level=4,
                refill_batches=4)
            if not (0 < labs < launched and (sed > 0).all()):
                raise AssertionError(f"small table run on {dev}: SED {sed}, "
                                     f"labs {labs}")
            outs[dev] = (sed, labs)
        (g, gl), (c, cl) = outs["cuda"], outs["cpu"]
        np.testing.assert_allclose(g, c, rtol=sed_tol)
        if abs(gl / cl - 1) > 0.05:
            raise AssertionError(f"labs: cuda {gl} vs cpu {cl}")
        log(f"  small table {'poly' if poly else 'mono'} cuda/cpu: SED "
            f"{', '.join(f'{r:.4f}' for r in g / c)}, labs {gl / cl:.4f}")


def phase_main_multi(torch, results, multi_tree):
    """The two-component model at full width through make_lifecycle +
    make_multibatch: mono (K5) and poly (K7, W = 2), 2^17 lanes, K = 128,
    1 batch each."""
    for poly in (False, True):
        name = "poly" if poly else "mono"
        kname = "K7" if poly else "K5"
        lanes, batches, K = 1 << 17, 1, 128
        dt, packets, sed, labs, launched, launches = _run_table_path(
            torch, poly, lanes, batches, multi_tree, multi=True,
            refill_batches=K)
        pps = packets / dt
        log(f"  multi {name}: {batches} batches x {lanes} lanes x K={K}"
            f"{' x W=2' if poly else ', W=2 one per lane'}, H=2 in {dt:.3f} "
            f"s = {pps:.4e} packets/s; launches {launches} "
            f"({launches[kname] / batches:.0f} event iterations per batch); "
            f"SED {', '.join(f'{v:.4e}' for v in sed)} W, labs "
            f"{labs:.4e} W of {launched:.4e} W launched")
        if min(launches[kname], launches["K2"], launches["EP"]) <= 0:
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        if not (sed > 0).all():
            raise AssertionError("SED Ftot not positive")
        if not 0 < labs < launched:
            raise AssertionError(f"labs {labs} outside (0, {launched})")
        results[f"launches_multi_{name}"] = launches
        results[f"main_multi_{name}"] = {"seconds": dt, "packets_per_s": pps}


def _multi_simulation(multi_tree, poly, lanes, K, device):
    """OligoSimulation(voxelize="table") on the two-component octree (the
    leaf-resolution gridded system): one batch of `lanes` lanes."""
    from bench_torch import _multi_model
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog

    grid, ds, ss, ins, opts, _ = _multi_model(
        grid=multi_tree, voxelize=False, polychromatic=poly, refill_batches=K)
    W = 2
    sim = OligoSimulation(stellar_system=ss, instruments=ins, dust_system=ds,
                          options=opts,
                          packets=lanes * K if poly else lanes // W * K,
                          batch_size=lanes * W if poly else lanes,
                          dispatch_batches=1, log=SilentLog(), device=device)
    assert sim._poly == poly and sim.dust_system.table and sim._labs_fold
    assert sim.dust_system.ncomp == 2
    assert type(sim._lifecycle.spec) is _table_engine(True, poly)[0]
    assert len(list(sim._batches())) == 1
    return sim


def phase_simulation_multi(torch, results, multi_tree):
    """OligoSimulation(voxelize="table") on the two-component octree: it
    voxelizes, runs the K7 engine and folds the labs onto the leaves."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_table_poly
    from skirt_tpu_torch.ops import binned, exact_peel

    lanes, K, W = 1 << 17, 128, 2
    sim = _multi_simulation(multi_tree, True, lanes, K, "cuda")
    torch.cuda.synchronize()
    binned.binned_add.launches = 0
    exact_peel.peel_columns.launches = 0
    fused_table_poly.table_poly_multi_event.launches = 0
    t0 = time.perf_counter()
    acc = sim._run_phase(rng.root_key(sim.seed), 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K7": fused_table_poly.table_poly_multi_event.launches,
                "K2": binned.binned_add.launches,
                "EP": exact_peel.peel_columns.launches}
    results["launches_multi_sim"] = launches
    launched = float(sim.stellar_system.Lv.sum())
    sed, labs = _check_tallies(acc, launched, "multi OligoSimulation")
    if acc["labs"].shape != (multi_tree.ncells * W,):
        raise AssertionError(f"labs not folded onto the {multi_tree.ncells} "
                             f"leaves: {acc['labs'].shape}")
    pps = lanes * K * W / dt
    log(f"  OligoSimulation(voxelize='table'), two components: "
        f"{multi_tree.ncells} leaves -> {sim.grid.nx}^3 voxels, 1 batch x "
        f"{lanes} lanes x K={K} x W={W} in {dt:.3f} s = {pps:.4e} "
        f"packets/s; launches {launches}; SED "
        f"{', '.join(f'{v:.4e}' for v in sed)} W, labs {labs:.4e} W of "
        f"{launched:.4e} W launched")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    results["main_multi_sim"] = {"seconds": dt, "packets_per_s": pps}


def phase_reference_multi(torch, multi_tree):
    """The two-component paths at a small size on the card against the
    same runs on the CPU (refill K = 4), at the tolerances of the CPU tests
    with refill (SED per wavelength and labs total 0.08): mono (K5) and
    poly (K7) through make_lifecycle, and the mono OligoSimulation with its
    labs folded onto the leaves."""
    from skirt_tpu_torch import rng

    for poly, lanes in ((False, 1 << 13), (True, 1 << 12)):
        outs = {}
        for dev in ("cuda", "cpu"):
            _, _, sed, labs, launched, _ = _run_table_path(
                torch, poly, lanes, 1, multi_tree, device=dev, multi=True,
                refill_batches=4)
            if not (0 < labs < launched and (sed > 0).all()):
                raise AssertionError(f"small multi run on {dev}: SED {sed}, "
                                     f"labs {labs}")
            outs[dev] = (sed, labs)
        (g, gl), (c, cl) = outs["cuda"], outs["cpu"]
        np.testing.assert_allclose(g, c, rtol=0.08)
        if abs(gl / cl - 1) > 0.08:
            raise AssertionError(f"labs: cuda {gl} vs cpu {cl}")
        log(f"  small multi {'poly' if poly else 'mono'} cuda/cpu: SED "
            f"{', '.join(f'{r:.4f}' for r in g / c)}, labs {gl / cl:.4f}")
    outs = {}
    for dev in ("cuda", "cpu"):
        sim = _multi_simulation(multi_tree, False, 1 << 13, 4, dev)
        acc = sim._run_phase(rng.root_key(sim.seed), 0)
        outs[dev] = _check_tallies(acc, float(sim.stellar_system.Lv.sum()),
                                   f"small multi OligoSimulation on {dev}")
    (g, gl), (c, cl) = outs["cuda"], outs["cpu"]
    np.testing.assert_allclose(g, c, rtol=0.08)
    if abs(gl / cl - 1) > 0.08:
        raise AssertionError(f"simulation labs: cuda {gl} vs cpu {cl}")
    log(f"  small multi OligoSimulation cuda/cpu: SED "
        f"{', '.join(f'{r:.4f}' for r in g / c)}, labs {gl / cl:.4f}")


def phase_main_voronoi(torch, results, vgrid):
    """voronoi-direct-mono (K4d: one of 8 wavelengths per lane) and
    voronoi-direct-poly (K6d: W = 8 per lane) on the 33,000-site
    tessellation through make_lifecycle + make_multibatch, 2^16 lanes, 64
    staged peel panels, one batch each at refill depth K = VORONOI_K
    (bench_torch.py measures the cells at their own K)."""
    for poly in (False, True):
        name = "poly" if poly else "mono"
        kname = "K6d" if poly else "K4d"
        lanes, K, W = 1 << 16, VORONOI_K, 8
        dt, packets, sed, labs, launched, launches = _run_table_path(
            torch, poly, lanes, 1, vgrid, voronoi=True, direct=True,
            nlambda=W, peel_panels=64, refill_batches=K)
        pps = packets / dt
        log(f"  voronoi-direct-{name}: {vgrid.ncells} cells, 1 batch x "
            f"{lanes} lanes x K={K}"
            f"{f' x W={W}' if poly else f', W={W} one per lane'} in "
            f"{dt:.3f} s = {pps:.4e} packets/s; launches {launches}; SED "
            f"{', '.join(f'{v:.4e}' for v in sed)} W, labs {labs:.4e} W of "
            f"{launched:.4e} W launched")
        if launches[kname] <= 0 or launches["K2"] <= 0:
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        if not (sed > 0).all():
            raise AssertionError("SED Ftot not positive")
        if not 0 < labs < launched:
            raise AssertionError(f"labs {labs} outside (0, {launched})")
        results[f"launches_voronoi_{name}"] = launches
        results[f"main_voronoi_{name}"] = {"seconds": dt,
                                           "packets_per_s": pps}


def time_locate_chunks(torch, vgrid):
    """The tessellation's locate at the staged peel's size (2^16 lanes x
    64 panels = 2^22 points, uniform in the domain) for chunk budgets of
    64 MB to 1 GB of gathered rows: device ms (cuda_ms) and wall ms (mean
    of 3 synchronized calls, launch gaps included); every budget must give
    the same cells."""
    from skirt_tpu_torch.grids import voronoi

    gen = torch.Generator(device="cuda").manual_seed(5)
    lo = torch.as_tensor(vgrid.extent[:3], dtype=torch.float32, device="cuda")
    hi = torch.as_tensor(vgrid.extent[3:], dtype=torch.float32, device="cuda")
    pts = lo + (hi - lo) * torch.rand((1 << 16, 64, 3), generator=gen,
                                      device="cuda")
    budgets = voronoi._LOCATE_CHUNK_FLOATS
    default = budgets["cuda"]
    ref = None
    try:
        for floats in (1 << 24, 1 << 26, 1 << 27, 1 << 28):
            budgets["cuda"] = floats
            torch.cuda.reset_peak_memory_stats()
            cells = vgrid.locate_batched(pts)
            if ref is None:
                ref = cells
            elif not torch.equal(cells, ref):
                raise AssertionError(f"locate chunk {floats} floats moves "
                                     "cells")
            dev_ms = cuda_ms(lambda: vgrid.locate_batched(pts), reps=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                vgrid.locate_batched(pts)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 3 * 1e3
            log(f"  locate chunk {floats * 4 >> 20} MB"
                f"{' (default)' if floats == default else ''}: 2^22 points "
                f"on {vgrid.ncells} sites, device {dev_ms:.3f} ms, wall "
                f"{wall_ms:.3f} ms, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    finally:
        budgets["cuda"] = default


def _voronoi_simulation(vgrid, clumpy, lanes, K, device):
    """OligoSimulation(voxelize="table") on a Voronoi model (the gridded
    system on the tessellation; polychromatic, W = 2): it measures the
    voxel view's field error and runs the voxel view (K6) within 10%, the
    direct table (K6d) above."""
    from bench_torch import _voronoi_model
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog

    grid, ds, ss, ins, opts, _ = _voronoi_model(
        grid=vgrid, voxelize=False, clumpy=clumpy, refill_batches=K)
    W = 2
    sim = OligoSimulation(stellar_system=ss, instruments=ins, dust_system=ds,
                          options=opts, packets=lanes * K,
                          batch_size=lanes * W, dispatch_batches=1,
                          log=SilentLog(), device=device)
    assert sim._poly and sim.dust_system.table
    assert len(list(sim._batches())) == 1
    assert sim._lifecycle.spec.arith_locate is (not clumpy)
    assert (sim._labs_fold is None) is clumpy
    return sim


def phase_simulation_voronoi(torch, results, vgrid4k):
    """OligoSimulation(voxelize="table") on the 4,096-site tessellation:
    the smooth sphere passes the field-error bound and runs the voxel view
    (K6, 2^17 lanes); the clumpy field does not and runs the direct table
    (K6d, 2^16 lanes); labs on the 4,096 Voronoi cells either way."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine import fused_table_poly
    from skirt_tpu_torch.ops import binned

    event = fused_table_poly.table_poly_event
    for clumpy, lanes in ((False, 1 << 17), (True, 1 << 16)):
        name = "direct" if clumpy else "voxel"
        kname = "K6d" if clumpy else "K6"
        K, W = VORONOI_K, 2
        t0 = time.perf_counter()
        sim = _voronoi_simulation(vgrid4k, clumpy, lanes, K, "cuda")
        setup = time.perf_counter() - t0
        err = getattr(sim.dust_system, "voxelization_error", None)
        torch.cuda.synchronize()
        binned.binned_add.launches = 0
        event.launches = event.direct_launches = 0
        t0 = time.perf_counter()
        acc = sim._run_phase(rng.root_key(sim.seed), 0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {kname: (event.direct_launches if clumpy
                            else event.launches),
                    "K2": binned.binned_add.launches}
        results[f"launches_voronoi_sim_{name}"] = launches
        launched = float(sim.stellar_system.Lv.sum())
        sed, labs = _check_tallies(acc, launched,
                                   f"Voronoi OligoSimulation ({name})")
        if acc["labs"].shape != (vgrid4k.ncells * W,):
            raise AssertionError(f"labs not on the {vgrid4k.ncells} cells: "
                                 f"{acc['labs'].shape}")
        view = (f"direct table on {vgrid4k.ncells} cells" if clumpy else
                f"{sim.grid.nx}^3 voxels, field error {err:.4f}")
        pps = lanes * K * W / dt
        field = "clumpy" if clumpy else "smooth"
        log(f"  OligoSimulation(voxelize='table'), {field}: {view} (set-up "
            f"{setup:.2f} s), 1 batch x {lanes} "
            f"lanes x K={K} x W={W} in {dt:.3f} s = {pps:.4e} packets/s; "
            f"launches {launches}; SED "
            f"{', '.join(f'{v:.4e}' for v in sed)} W, labs {labs:.4e} W of "
            f"{launched:.4e} W launched")
        if launches[kname] <= 0 or launches["K2"] <= 0:
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        if not clumpy and event.direct_launches:
            raise AssertionError("the voxel view launched K6d")
        results[f"main_voronoi_sim_{name}"] = {"seconds": dt,
                                               "packets_per_s": pps}


# the polarized chains of experiments/bench_polarized.py: (path, model
# keywords, kernel name)
POLARIZED = (("pol_mono", {}, "K3"),
             ("pol_table_mono", {"table": True}, "K4"),
             ("pol_table_poly", {"table": True, "poly": True}, "K6p"))


def _pol_launches(kname):
    """The launch count of a polarized chain's event kernel (K6p apart from
    K6 and K6d)."""
    from skirt_tpu_torch.engine import fused, fused_table, fused_table_poly

    if kname == "K3":
        return fused.mono_event.launches
    if kname == "K4":
        return fused_table.table_event.launches
    return fused_table_poly.table_poly_event.pol_launches


def _reset_launches():
    from skirt_tpu_torch.engine import fused, fused_table, fused_table_poly
    from skirt_tpu_torch.ops import binned

    binned.binned_add.launches = 0
    fused.mono_event.launches = 0
    fused_table.table_event.launches = 0
    ev = fused_table_poly.table_poly_event
    ev.launches = ev.direct_launches = ev.pol_launches = 0


def _check_polarized(torch, t, launched, what):
    """A polarized FullInstrument's tallies: finite, the total SED positive
    and below the launched power, the scattered part and the Stokes Q / U
    SEDs within it."""
    for v in t.values():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite tally")
    F = t["Ftot"].double().cpu().numpy()
    Fsc = t["Fscastel"].double().cpu().numpy()
    P = np.hypot(t["FQ"].double().cpu().numpy(),
                 t["FU"].double().cpu().numpy())
    if not ((F > 0).all() and F.sum() < launched and (Fsc > 0).all()
            and (Fsc <= F).all() and (P <= Fsc).all()):
        raise AssertionError(f"{what}: SED {F}, scattered {Fsc}, |P| {P}")
    return F, Fsc, P


def phase_main_polarized(torch, results, octree):
    """experiments/bench_polarized.py's three chains at full width through
    make_lifecycle + make_multibatch, 2^17 lanes, K = 64, W = 2, one
    batch each: the mono analytic flagship (K3), the mono table on the
    config-3 torus (K4) and the poly table (K6p).  A warm-up batch (the
    Mueller tables' first copies to the card, the allocator's growth) runs
    before the counts are set to 0 and the timed batch."""
    from bench_torch import _polarized_build
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine.lifecycle import make_multibatch
    from skirt_tpu_torch.ops import binned

    lanes = 1 << 17
    for name, kw, kname in POLARIZED:
        run_batch, zero, ell, L0, packets, model = _polarized_build(
            lanes, device="cuda", grid=octree if kw else None, **kw)
        assert run_batch.spec.want_pol if kname == "K6p" else True
        run_many = make_multibatch(run_batch, 1)
        run_many(rng.root_key(4357), ell, L0, zero())
        tallies = zero()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        out = run_many(rng.root_key(4357), ell, L0, tallies)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {kname: _pol_launches(kname),
                    "K2": binned.binned_add.launches}
        W = model[2].wavelength_grid.nlambda
        launched = 1e36 * (W if kw.get("poly") else 1)
        F, Fsc, P = _check_polarized(torch, out["instruments"][0], launched,
                                     name)
        pps = packets / dt
        log(f"  polarized {name}: 1 warm batch x {lanes} lanes x K="
            f"{model[4].refill_batches}{' x W=2' if kw.get('poly') else ''}"
            f" in {dt:.3f} s = {pps:.4e} packets/s; launches {launches}; "
            f"SED {', '.join(f'{v:.4e}' for v in F)} W, scattered "
            f"{', '.join(f'{v:.4e}' for v in Fsc)}, |P| "
            f"{', '.join(f'{v:.3e}' for v in P)}")
        if launches[kname] <= 0 or launches["K2"] <= 0:
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        results[f"launches_{name}"] = launches
        results[f"main_{name}"] = {"seconds": dt, "packets_per_s": pps}


def phase_simulation_polarized(torch, results, octree):
    """OligoSimulation(voxelize="table") on the config-3 torus filled with
    an ElectronDustMix (tau_x = 1, W = 2, one batch of 2^17 polarized
    lanes, K = 16): the simulation picks up the mix's Mueller tables, runs
    K6p, and writes the Stokes Q / U / V frames and SEDs."""
    import os
    import tempfile

    from bench_torch import _polarized_model
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine.simulation import OligoSimulation
    from skirt_tpu_torch.log import SilentLog
    from skirt_tpu_torch.ops import binned

    grid, ds, ss, ins, opts, _ = _polarized_model(
        table=True, poly=True, electron=True, grid=octree, voxelize=False,
        refill_batches=16)
    W, lanes, K = 2, 1 << 17, opts.refill_batches
    with tempfile.TemporaryDirectory() as out_dir:
        sim = OligoSimulation(stellar_system=ss, instruments=ins,
                              dust_system=ds, options=opts,
                              packets=lanes * K, batch_size=lanes * W,
                              dispatch_batches=1, log=SilentLog(),
                              out_dir=out_dir, prefix="pol", device="cuda")
        assert sim._poly and sim._mueller is ds.components[0].mix.mueller
        assert sim._lifecycle.spec.want_pol
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        acc = sim._run_phase(rng.root_key(sim.seed), 0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"K6p": _pol_launches("K6p"),
                    "K2": binned.binned_add.launches}
        sim.write(acc)
        files = sorted(os.listdir(out_dir))
    t = {k: torch.as_tensor(v) for k, v in acc["instruments"][0].items()}
    F, Fsc, P = _check_polarized(torch, t, float(ss.Lv.sum()),
                                 "polarized OligoSimulation")
    for name in ("stokesQ", "stokesU", "stokesV"):
        if f"pol_pol_{name}.fits" not in files:
            raise AssertionError(f"no {name} frame written: {files}")
    pps = lanes * K * W / dt
    log(f"  polarized OligoSimulation(voxelize='table', ElectronDustMix): "
        f"1 batch x {lanes} lanes x K={K} x W={W} in {dt:.3f} s = "
        f"{pps:.4e} packets/s; launches {launches}; SED "
        f"{', '.join(f'{v:.4e}' for v in F)} W, scattered "
        f"{', '.join(f'{v:.4e}' for v in Fsc)}, |P| "
        f"{', '.join(f'{v:.3e}' for v in P)}; wrote {len(files)} files")
    if launches["K6p"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    results["launches_pol_sim"] = launches
    results["main_pol_sim"] = {"seconds": dt, "packets_per_s": pps}


def _chromatic_mueller():
    """Mueller tables that differ by wavelength (as
    tests/test_torch_polarization.py's): wavelength 0 forward (HG g = 0.6 in
    S11) and polarized across the scattering plane, wavelength 1 backward
    (g = -0.5), polarized in it, with a retardance of 1 rad (S34 != 0).
    Each row is a pure Mueller matrix."""
    from skirt_tpu_torch.media.polarization import MuellerTables
    theta = np.linspace(0.0, np.pi, 181)
    c = np.cos(theta)
    rows = []
    for g, sign, delta in ((0.6, -1.0, 0.0), (-0.5, 1.0, 1.0)):
        S11 = (1 - g * g) / (1 + g * g - 2 * g * c) ** 1.5
        m = S11 * 2 * c / (1 + c * c)
        rows.append((S11, sign * S11 * (1 - c * c) / (1 + c * c),
                     m * np.cos(delta), m * np.sin(delta)))
    return MuellerTables(theta, *(np.stack(x) for x in zip(*rows)))


def _thomson_sphere(device, lanes, K, tau=0.2, chromatic=False, seed=5):
    """tests/test_polarization.py's Thomson sphere (an electron sphere of
    optical depth `tau` around a point source, seen edge-on by a polarized
    9x9 FullInstrument) on the polychromatic table engine (K6p), W = 2: the
    instrument's tallies after one batch of `lanes` lanes with K packets
    each, 1 W per wavelength in all.  `chromatic` swaps the Thomson tables
    for _chromatic_mueller's."""
    from skirt_tpu_torch import rng
    from skirt_tpu_torch.engine.lifecycle import (LifecycleOptions,
                                                  make_lifecycle)
    from skirt_tpu_torch.geometry import PointGeometry, UniformSphereGeometry
    from skirt_tpu_torch.grids import CartesianGrid
    from skirt_tpu_torch.instruments import FullInstrument
    from skirt_tpu_torch.media import (DustComponent, DustMassNormalization,
                                       DustSystem, ElectronDustMix)
    from skirt_tpu_torch.sources import (LuminosityStellarComponent,
                                         StellarSystem)
    from skirt_tpu_torch.wavelengths import OligoWavelengthGrid
    import torch

    wg = OligoWavelengthGrid([1e-6, 1.2e-6])
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1.0, 1.0])])
    b = np.linspace(-1, 1, 9)
    grid = CartesianGrid(b, b, b)
    mix = ElectronDustMix(wg)
    R = 0.9
    mass = tau / (float(mix.kappaext64[0]) * R) * (4 / 3 * np.pi * R ** 3)
    ds = DustSystem(grid, [DustComponent(UniformSphereGeometry(R), mix,
                                         DustMassNormalization(mass))],
                    samples_per_cell=4, density_mode="gridded").as_table()
    ins = FullInstrument("pol", 100.0, 2, 9, 9, fov_x=2.2, fov_y=2.2,
                         inclination=np.pi / 2, polarization=True)
    opts = LifecycleOptions(quadrature_panels=16, fused=True,
                            polychromatic=True, table_peel="exact",
                            refill_batches=K)
    mt = _chromatic_mueller() if chromatic else ds.mueller
    run = make_lifecycle(grid, ds, ss, [ins], opts, 2, mueller=mt)
    out = run(rng.root_key(seed), torch.zeros(lanes, dtype=torch.int32,
                                              device=device),
              torch.full((lanes, 2), 1.0 / (lanes * K), device=device),
              {"instruments": [ins.zero_tallies(device)]})
    return {k: v.double().cpu().numpy()
            for k, v in out["instruments"][0].items()}


def _ring_amplitudes(t, npix=9):
    """Per wavelength (sum fQ cos 2phi, sum fU sin 2phi, sum fQ sin 2phi,
    sum fU cos 2phi) / sum fscastel over the 9x9 scattered frames, phi the
    pixel's position angle: a tangential or radial ring loads the first
    two, and a flipped U (or a flipped rotation into the instrument frame)
    flips the second."""
    y, x = np.mgrid[:npix, :npix] - (npix - 1) / 2
    phi = np.arctan2(y, x).ravel()
    c2, s2 = np.cos(2 * phi), np.sin(2 * phi)
    fQ, fU = t["fQ"].reshape(2, -1), t["fU"].reshape(2, -1)
    fs = t["fscastel"].reshape(2, -1).sum(1)[:, None]
    return np.stack([fQ @ c2, fU @ s2, fQ @ s2, fU @ c2], axis=1) / fs


def _stokes_deviation(g, c):
    """The card's Stokes tallies against the CPU's, in the units that
    tests/test_torch_polarization.py holds the port to skirt_tpu in: the
    largest ring-amplitude difference (held at 0.03), the largest fQ / fU /
    fV pixel difference over the wavelength's peak scattered pixel (0.05),
    the largest fscastel pixel difference over it (0.10), and the largest
    FQ / FU / FV difference over Fscastel (0.03).  Between CPU runs of
    seeds 5 and 6-8 at the smoke's size (4,096 lanes, K = 4) these read at
    most 0.008, 0.024, 0.042 and 0.0093 on either sphere."""
    ring = float(np.abs(_ring_amplitudes(g) - _ring_amplitudes(c)).max())
    peak = np.maximum(g["fscastel"].reshape(2, -1).max(1),
                      c["fscastel"].reshape(2, -1).max(1))[:, None]

    def pix(k):
        return float((np.abs(g[k].reshape(2, -1) - c[k].reshape(2, -1))
                      / peak).max())

    tot = max(float(np.abs(g[k] / g["Fscastel"] - c[k] / c["Fscastel"]).max())
              for k in ("FQ", "FU", "FV"))
    dev = {"ring": ring, "stokes_pixel": max(pix(k) for k in ("fQ", "fU",
                                                              "fV")),
           "scattered_pixel": pix("fscastel"), "stokes_total": tot}
    lim = {"ring": 0.03, "stokes_pixel": 0.05, "scattered_pixel": 0.10,
           "stokes_total": 0.03}
    bad = {k: v for k, v in dev.items() if not v <= lim[k]}
    if bad:
        raise AssertionError(f"card vs cpu Stokes tallies: {bad} over {lim}")
    return dev


def phase_reference_polarized(torch):
    """The Thomson sphere on the poly table (K6p) on the card against the
    same run on the CPU at tests/test_polarization.py's tolerances (Ftot
    per wavelength 0.04, scattered 0.10), the card's tangential ring (|q| >
    0.15, opposite signs on the two image axes) and integrated |P| /
    scattered below 0.06; then, for it and for an optically thick sphere
    (tau 1) with Mueller tables that differ by wavelength, the card's
    Stokes frames and totals against the CPU's (_stokes_deviation).  The
    two devices draw from their own streams (Philox, mt19937), so the
    comparison is at Monte Carlo tolerance."""
    g = _thomson_sphere("cuda", 4096, 4)
    c = _thomson_sphere("cpu", 4096, 4)
    np.testing.assert_allclose(g["Ftot"], c["Ftot"], rtol=0.04)
    np.testing.assert_allclose(g["Fscastel"], c["Fscastel"], rtol=0.10)
    for w in range(2):
        fQ = g["fQ"].reshape(2, 9, 9)[w]
        fs = g["fscastel"].reshape(2, 9, 9)[w]
        qx, qy = fQ[4, 6] / fs[4, 6], fQ[6, 4] / fs[6, 4]
        if not (abs(qx) > 0.15 and abs(qy) > 0.15
                and np.sign(qx) == -np.sign(qy)):
            raise AssertionError(f"no tangential ring at w={w}: {qx}, {qy}")
    p = np.hypot(g["FQ"], g["FU"]) / g["Fscastel"]
    if p.max() >= 0.06:
        raise AssertionError(f"integrated polarization {p}")
    dev = _stokes_deviation(g, c)
    log(f"  small polarized poly table cuda/cpu: SED "
        f"{', '.join(f'{r:.4f}' for r in g['Ftot'] / c['Ftot'])}, scattered "
        f"{', '.join(f'{r:.4f}' for r in g['Fscastel'] / c['Fscastel'])}; "
        f"card |P| / scattered {', '.join(f'{v:.4f}' for v in p)}; Stokes "
        f"deviations {json.dumps(dev)}")
    g = _thomson_sphere("cuda", 4096, 4, tau=1.0, chromatic=True)
    c = _thomson_sphere("cpu", 4096, 4, tau=1.0, chromatic=True)
    np.testing.assert_allclose(g["Fscastel"], c["Fscastel"], rtol=0.10)
    rings = _ring_amplitudes(g)
    if not ((np.sign(rings[0, :2]) == -np.sign(rings[1, :2])).all()
            and (np.abs(rings[:, :2]) > 0.08).all()):
        raise AssertionError(f"chromatic rings on the card: {rings}")
    dev = _stokes_deviation(g, c)
    log(f"  chromatic Mueller tables, tau 1, cuda/cpu: scattered "
        f"{', '.join(f'{r:.4f}' for r in g['Fscastel'] / c['Fscastel'])}; "
        f"card rings {np.round(rings[:, :2], 4).tolist()}; Stokes "
        f"deviations {json.dumps(dev)}")


def phase_reference_voronoi(torch):
    """The direct table at a small size on the card against the same runs
    on the CPU: tests/test_poly.py's 300-site TestPolyDirect model, mono
    (K4d, 2^12 lanes) and poly (K6d, W = 2, 2^11 lanes), refill K = 4, at
    tests/test_poly.py's direct-table tolerances (SED per wavelength 0.08,
    labs total 0.06, labs per wavelength 0.08)."""
    for poly, lanes in ((False, 1 << 12), (True, 1 << 11)):
        outs = {}
        for dev in ("cuda", "cpu"):
            _, _, sed, labs, launched, _ = _run_table_path(
                torch, poly, lanes, 1, None, device=dev, voronoi=True,
                nsites=300, site_seed=11, volume_samples=16, azimuth=0.7,
                max_scatt=48, direct=True, table_peel="staged",
                refill_batches=4, labs_by_wavelength=True)
            if not (0 < labs.sum() < launched and (sed > 0).all()):
                raise AssertionError(f"small direct run on {dev}: SED {sed}, "
                                     f"labs {labs.sum()}")
            outs[dev] = (sed, labs)
        (g, gl), (c, cl) = outs["cuda"], outs["cpu"]
        np.testing.assert_allclose(g, c, rtol=0.08)
        np.testing.assert_allclose(gl, cl, rtol=0.08)
        if abs(gl.sum() / cl.sum() - 1) > 0.06:
            raise AssertionError(f"labs: cuda {gl} vs cpu {cl}")
        log(f"  small direct {'poly' if poly else 'mono'} cuda/cpu: SED "
            f"{', '.join(f'{r:.4f}' for r in g / c)}, labs per wavelength "
            f"{', '.join(f'{r:.4f}' for r in gl / cl)}")


def _probe_wrappers():
    """The slice's kernel wrappers, whose counts phase 14 reads."""
    from skirt_tpu_torch.experiments import gather, mm, onehot_gather
    from skirt_tpu_torch.ops import binned

    return {"K8": binned.binned_add_lm, "PG": gather.table_gather,
            "PO": onehot_gather.onehot_gather, "PM": mm.mm}


def _probe_sweeps(timed):
    """The four probe drivers' sweeps: {kernel: [records]}."""
    from skirt_tpu_torch.experiments import (microbench_blocked_tally,
                                             microbench_gather,
                                             microbench_mxu_gather,
                                             microbench_mxu_mm)

    tally = microbench_blocked_tally.sweep(timed=timed)
    po, pg_voxel = microbench_mxu_gather.sweep(timed=timed)
    return {"K8": [r for r in tally if r["name"].startswith("K8")],
            "K2": [r for r in tally if r["name"].startswith("K2")],
            "PG": microbench_gather.sweep(timed=timed) + pg_voxel,
            "PO": po, "PM": microbench_mxu_mm.sweep(timed=timed)}


class _Captured(Exception):
    pass


def _config3_panel_cells(torch, octree, lanes=1 << 17, first=32, iters=4,
                         device="cuda"):
    """The voxel ids that config 3's mono table path stages for its panel
    rows (the octree torus's 32^3 voxel view, 2^17 lanes, 16 panels) in
    event iterations first .. first + iters - 1 of one batch, when
    relaunched and scattered lanes are mixed: each iteration's (N, P)
    locate transposed to the (P, N) rows the event kernel reads, clipped
    to cell 0 outside the domain as the staging does, concatenated.
    Returns (the voxel view's float32 densities, the flat indices)."""
    from bench_torch import _octree_build
    from skirt_tpu_torch import rng

    run_batch, zero, ell, L0, _, model = _octree_build(
        lanes, device=device, polychromatic=False, grid=octree)
    tds = model[1]
    grid, npanels = tds.grid, model[4].quadrature_panels
    locate, seen = grid.locate_batched, []

    def recording(points):
        cells = locate(points)
        if tuple(points.shape[:-1]) == (lanes, npanels):
            seen.append(cells)
            if len(seen) == first + iters:
                raise _Captured
        return cells

    grid.locate_batched = recording
    try:
        run_batch(rng.root_key(4357), ell, L0, zero())
    except _Captured:
        pass
    finally:
        del grid.locate_batched
    if len(seen) < first + iters:
        raise AssertionError(f"config 3 staged {len(seen)} panel locates, "
                             f"fewer than {first + iters}")
    idx = torch.cat([c.T.clamp(min=0).reshape(-1)
                     for c in seen[first:]]).to(torch.int32)
    tab = torch.as_tensor(tds.rho[0], dtype=torch.float32, device=device)
    return tab, idx


def _panel_gathers(torch, octree):
    """PG through both routes on config 3's staged panel cells: the gather
    a K4-K7 fused with its panel densities would make."""
    from skirt_tpu_torch.experiments import microbench_gather
    from skirt_tpu_torch.experiments.gather import ROUTES

    tab, idx = _config3_panel_cells(torch, octree)
    distinct = int(torch.unique(idx).numel())
    log(f"  config 3 panel cells: {idx.numel()} indices into "
        f"{tab.numel()} voxels, {distinct} distinct")
    return [microbench_gather.run(
        "PG config-3 panel cells", "the panel rows K4-K7 read "
        "(skirt_tpu_torch/engine/fused_table.py staging)", tab, idx, route)
        for route in ROUTES]


# the row each probe kernel reports (its by_variant holds the rest)
_PROBE_HEAD = {"K8": "K8 binned_add_lm flagship",
               "PG": "PG T=32768 [l2]",
               "PO": "PO full split",
               "PM": "P15 (1024,1024)@(1024,1024) bf16 inner=1"}


def _probe_results(results, kname, recs):
    """results[kname] from a probe's timed records: the head row's times,
    the largest error, and every row by name (by_variant for the kernels
    line, by_case for ab_trees)."""
    for r in recs:
        log(f"  {kname} {line(r)}")
    r, = [r for r in recs if r["name"] == _PROBE_HEAD[kname]]
    keys = ("pallas", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_ms_fp32", "onehot_floor_ms", "max_abs_err", "route",
            "split", "tile")
    results[kname] = {
        "max_abs_err": max(x["max_abs_err"] for x in recs),
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "shape": r["shape"],
        "by_variant": {x["name"]: {k: x[k] for k in keys if k in x}
                       for x in recs},
        "by_case": {x["name"]: {k: x[k] for k in ("ms", "plain_ms",
                                                  "library_ms", "bound_ms")}
                    for x in recs}}


def _sass_check(kname, function, opcodes, strict):
    """Count each opcode in the SASS of the library's functions named
    `function`; strict: raise when one is missing."""
    from skirt_tpu_torch import kernels

    counts = {op: sass_count(kernels.build(), function, op) for op in opcodes}
    log(f"  {kname}'s SASS ({function}): "
        + ", ".join(f"{n} {op}" for op, n in counts.items()))
    missing = [op for op, n in counts.items() if not n]
    if strict and missing:
        raise AssertionError(f"{kname}'s kernel has no {missing} in its "
                             f"SASS")
    return counts


def phase_pm(torch, results, strict=False):
    """PM at every shape and type of P15, timed, with its SASS check
    (HGMMA: wgmma; UTMALDG: TMA loads)."""
    from skirt_tpu_torch.experiments import microbench_mxu_mm

    counts = _sass_check("PM", "mm_bf16", ("HGMMA", "UTMALDG"), strict)
    recs = microbench_mxu_mm.sweep(timed=True)
    _probe_results(results, "PM", recs)
    results["PM"]["max_err_over_tol"] = max(
        x["max_err_over_tol"] for x in recs)
    results["PM"]["sass"] = counts


def phase_k8(torch, results):
    """K8 at the flagship, on nlambda = 20, dense and past the card's
    opt-in shared memory, timed, each with its route (K2 on the flagship's
    lanes beside it)."""
    from skirt_tpu_torch.experiments import microbench_blocked_tally

    recs = microbench_blocked_tally.sweep(timed=True)
    for r in recs:
        if r["name"].startswith("K2"):
            log(f"  K2 {line(r)}")
    _probe_results(results, "K8",
                   [r for r in recs if r["name"].startswith("K8")])


def phase_po(torch, results, strict=False):
    """PO at every stage of P11-P14, timed, with its SASS check (HGMMA).
    Returns the driver's PG records on PO's 32,768-entry table."""
    from skirt_tpu_torch.experiments import microbench_mxu_gather

    counts = _sass_check("PO", "probe_onehot", ("HGMMA",), strict)
    po, pg_table = microbench_mxu_gather.sweep(timed=True)
    _probe_results(results, "PO", po)
    results["PO"]["sass"] = counts
    r, = [r for r in po if r["name"] == "PO full split"]
    results["PO"]["onehot_floor_ms"] = r["onehot_floor_ms"]
    return pg_table


def phase_probes(torch, results, octree):
    """K8 (at the flagship shape, on nlambda = 20, where skirt_tpu's tiles
    leave blocks unwritten, dense and past the opt-in limit) and the
    probes PG (both routes, P1-P10, the 32,768-entry table on uniform
    indices and on the panel cells that config 3 stages), PO (every stage,
    P11-P14) and PM (every shape and type of P15), each against its plain
    version at the JAX scripts' shapes, timed: kernel, plain, library and
    bound ms; PO's SASS must hold HGMMA, PM's HGMMA and UTMALDG."""
    from skirt_tpu_torch.experiments import microbench_gather

    t0 = time.perf_counter()
    phase_k8(torch, results)
    pg_table = phase_po(torch, results, strict=True)
    pg = (microbench_gather.sweep(timed=True) + pg_table
          + _panel_gathers(torch, octree))
    _probe_results(results, "PG", pg)
    phase_pm(torch, results, strict=True)
    by_name = {r["name"]: r for r in pg}
    results["PG"]["ms_smem"] = by_name["PG T=32768 [smem]"]["ms"]
    results["PG"]["panel_cells_ms"] = {
        route: by_name[f"PG config-3 panel cells [{route}]"]["ms"]
        for route in ("l2", "smem")}
    log(f"  probes timed in {time.perf_counter() - t0:.1f} s")


def phase_main_probes(torch, results):
    """The slice's own path: binned_add_lm and the probe drivers, run once
    per distinct call (each held to its plain version), with the four
    launch counts set to 0 just before and read just after."""
    wrappers = _probe_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    sweeps = _probe_sweeps(timed=False)
    dt = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"  probes: {sum(len(v) for v in sweeps.values())} calls in "
        f"{dt:.1f} s; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    results["launches_probes"] = launches


# the models of the table kernel phases, built once per run (as main
# builds them)
_MODELS = {}


def _model(name):
    if name not in _MODELS:
        from bench_torch import _multi_model, _octree_model, _voronoi_model
        build = {"octree": lambda: _octree_model(voxelize=False),
                 "multi": lambda: _multi_model(voxelize=False),
                 "vgrid": lambda: _voronoi_model(nsites=33000,
                                                 voxelize=False)}[name]
        _MODELS[name] = build()[0]
    return _MODELS[name]


# the kernel phases `python3 chip_smoke.py k2 k1 k3 k4 k4d k5 k6 k6d k6p k7
# chunked k8 pm po` runs alone, each on the models main builds for it (the
# probes' SASS counts logged, not required, so that a parent tree without
# TMA or wgmma still times)
SUBSET = {"k2": phase_k2, "bin_sum": phase_bin_sum,
          "exact_peel": phase_exact_peel, "peel_sed": phase_peel_sed,
          "k1": phase_k1,
          "k3": phase_k3,
          "k8": phase_k8,
          "pm": lambda torch, res: phase_pm(torch, res),
          "po": lambda torch, res: phase_po(torch, res),
          "k4": lambda torch, res: phase_k4(torch, res, _model("octree")),
          "k4d": lambda torch, res: phase_k4d(torch, res, _model("vgrid")),
          "k5": lambda torch, res: phase_k5(torch, res, _model("multi")),
          "k6": lambda torch, res: phase_k6(torch, res, _model("octree")),
          "k6d": lambda torch, res: phase_k6d(torch, res, _model("vgrid")),
          "k6p": lambda torch, res: phase_k6p(torch, res, _model("octree"),
                                              _model("vgrid")),
          "k7": lambda torch, res: phase_k7(torch, res, _model("multi")),
          "chunked": lambda torch, res: phase_chunked(
              torch, res, _model("octree"), _model("multi"),
              _model("vgrid"))}


def main():
    only = sys.argv[1:]
    unknown = [a for a in only if a not in SUBSET]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phase {unknown}; the "
                         f"phases run alone: {sorted(SUBSET)}")
    t_start = time.perf_counter()

    def stamp(msg):
        log(f"[{time.perf_counter() - t_start:.1f} s] {msg}")

    stamp("phase 1: device")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    stamp("phase 2: build kernels")
    from skirt_tpu_torch import kernels
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    log(f"  {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    results = {}
    if only:
        # a subset of the kernel phases (to time two trees in one call):
        # their results and the card line, no "ok" line
        for name in only:
            stamp(f"phase {name}")
            SUBSET[name](torch, results)
        print(json.dumps(results), flush=True)
        print(card, flush=True)
        return
    stamp("phase 3: K2 binned_add kernel vs plain")
    phase_k2(torch, results)
    stamp("phase 3b: the bin sum of the mono detects vs float64 and plain")
    phase_bin_sum(torch, results)
    stamp("phase 3c: the exact peel's kernel vs plain")
    phase_exact_peel(torch, results)
    stamp("phase 3d: the SED peel's kernel vs plain")
    phase_peel_sed(torch, results)
    stamp("phase 4: K1 poly_event kernel vs plain")
    phase_k1(torch, results)
    stamp("phase 5: K3 mono_event kernel vs plain")
    phase_k3(torch, results)
    from bench_torch import _multi_model, _octree_model, _voronoi_model
    t0 = time.perf_counter()
    octree = _octree_model(voxelize=False)[0]
    multi_tree = _multi_model(voxelize=False)[0]
    log(f"  config 3 octree: {octree.ncells} leaves; two-component octree: "
        f"{multi_tree.ncells} leaves; host builds "
        f"{time.perf_counter() - t0:.2f} s")
    vgrids = {}
    for nsites in (33000, 4096):
        vgrid, *_, host = _voronoi_model(nsites=nsites, voxelize=False)
        scheme, nbyte = host["locate"]
        log(f"  config 4 tessellation: {vgrid.ncells} sites, native "
            f"{vgrid.used_native}, built in {host['voronoi']:.2f} s; locate "
            f"{scheme}, table {nbyte / 2 ** 20:.1f} MB in "
            f"{host['locate_tables']:.2f} s")
        vgrids[nsites] = vgrid
    time_locate_chunks(torch, vgrids[33000])
    stamp("phase 6: K4 table_event kernel vs plain")
    phase_k4(torch, results, octree)
    stamp("phase 7: K5 table_multi_event kernel vs plain")
    phase_k5(torch, results, multi_tree)
    stamp("phase 8: K6 table_poly_event kernel vs plain")
    phase_k6(torch, results, octree)
    stamp("phase 9: K7 table_poly_multi_event kernel vs plain")
    phase_k7(torch, results, multi_tree)
    stamp("phase 10: K4d table_event (direct table) kernel vs plain")
    phase_k4d(torch, results, vgrids[33000])
    stamp("phase 11: K6d table_poly_event (direct table) kernel vs plain")
    phase_k6d(torch, results, vgrids[33000])
    stamp("phase 12: K6p table_poly_event (polarized) kernel vs plain")
    phase_k6p(torch, results, octree, vgrids[33000])
    stamp("phase 12b: the event kernels' chunked routes vs plain (P = 33, 84, "
        "280; 12 leaders; K3 at H = 3 and wide tables; K7 at H = 4)")
    phase_chunked(torch, results, octree, multi_tree, vgrids[33000])
    stamp("phase 13: K8 binned_add_lm and the probes PG, PO, PM vs plain")
    phase_probes(torch, results, octree)
    stamp("phase 14: main paths (S1 poly: make_lifecycle + make_multibatch, "
        "W=128; S2a mono: OligoSimulation, W=4; config 3 mono and poly: "
        "make_lifecycle + make_multibatch, W=2; config 3 "
        "OligoSimulation(voxelize='table'); the two-component model mono "
        "and poly: make_lifecycle + make_multibatch, W=2; its "
        "OligoSimulation(voxelize='table'); config 4 voronoi-direct-mono "
        "and -poly: make_lifecycle + make_multibatch, W=8; its "
        "OligoSimulation(voxelize='table') on the voxel view and on the "
        "direct table; the polarized chains mono analytic, mono table and "
        "poly table: make_lifecycle + make_multibatch, W=2; a polarized "
        "OligoSimulation(voxelize='table') on an ElectronDustMix; the "
        "lambda-blocked tally and the probe drivers)")
    stamp("  phase_main_poly")
    phase_main_poly(torch, results)
    stamp("  phase_main_poly_default")
    phase_main_poly_default(torch, results)
    stamp("  phase_main_mono")
    phase_main_mono(torch, results)
    stamp("  phase_main_table")
    phase_main_table(torch, results, octree)
    stamp("  phase_simulation_table")
    phase_simulation_table(torch, results, octree)
    stamp("  phase_main_multi")
    phase_main_multi(torch, results, multi_tree)
    stamp("  phase_simulation_multi")
    phase_simulation_multi(torch, results, multi_tree)
    stamp("  phase_main_voronoi")
    phase_main_voronoi(torch, results, vgrids[33000])
    stamp("  phase_simulation_voronoi")
    phase_simulation_voronoi(torch, results, vgrids[4096])
    stamp("  phase_main_polarized")
    phase_main_polarized(torch, results, octree)
    stamp("  phase_simulation_polarized")
    phase_simulation_polarized(torch, results, octree)
    stamp("  phase_main_probes")
    phase_main_probes(torch, results)
    stamp("phase 15: small runs on the card against the CPU")
    stamp("  phase_reference_poly")
    phase_reference_poly(torch)
    stamp("  phase_reference_poly_default")
    phase_reference_poly_default(torch)
    stamp("  phase_reference_mono")
    phase_reference_mono(torch)
    stamp("  phase_reference_table")
    phase_reference_table(torch)
    stamp("  phase_reference_multi")
    phase_reference_multi(torch, multi_tree)
    stamp("  phase_reference_voronoi")
    phase_reference_voronoi(torch)
    stamp("  phase_reference_polarized")
    phase_reference_polarized(torch)

    log(f"phase 16: results (phases 1-15 took "
        f"{time.perf_counter() - t_start:.1f} s)")
    paths = ("poly", "poly_p84", "mono", "table_mono", "table_poly", "table_sim",
             "multi_mono", "multi_poly", "multi_sim", "voronoi_mono",
             "voronoi_poly", "voronoi_sim_voxel", "voronoi_sim_direct",
             "pol_mono", "pol_table_mono", "pol_table_poly", "pol_sim")
    launches = {
        "K1": results["launches_poly"]["K1"]
        + results["launches_poly_p84"]["K1"],
        "K2": sum(results[f"launches_{p}"]["K2"] for p in paths),
        "K3": results["launches_mono"]["K3"]
        + results["launches_pol_mono"]["K3"],
        "K4": results["launches_table_mono"]["K4"]
        + results["launches_pol_table_mono"]["K4"],
        "K4d": results["launches_voronoi_mono"]["K4d"],
        "K5": results["launches_multi_mono"]["K5"],
        "K6": results["launches_table_poly"]["K6"]
        + results["launches_table_sim"]["K6"]
        + results["launches_voronoi_sim_voxel"]["K6"],
        "K6d": results["launches_voronoi_poly"]["K6d"]
        + results["launches_voronoi_sim_direct"]["K6d"],
        "K6p": results["launches_pol_table_poly"]["K6p"]
        + results["launches_pol_sim"]["K6p"],
        "K7": results["launches_multi_poly"]["K7"]
        + results["launches_multi_sim"]["K7"],
        "BS": results["launches_mono"]["BS"],
        "EP": sum(results[f"launches_{p}"]["EP"]
                  for p in ("table_mono", "table_poly", "table_sim",
                            "multi_mono", "multi_poly", "multi_sim")),
        "PS": sum(results[f"launches_{p}"]["PS"]
                  for p in ("poly", "table_poly", "table_sim")),
        **results["launches_probes"]}
    meta = {
        "K1": ("K1 poly_event", "skirt_tpu_torch/csrc/fused_poly.cu",
               "skirt_tpu/engine/fused_poly.py:85"),
        "K2": ("K2 binned_add", "skirt_tpu_torch/csrc/binned.cu",
               "skirt_tpu/ops/binned.py:37"),
        "BS": ("bin_sum", "skirt_tpu_torch/csrc/bin_sum.cu",
               "no Pallas kernel: skirt_tpu/instruments/instruments.py:98 "
               "_bin_sum, an XLA one-hot matvec"),
        "EP": ("exact peel", "skirt_tpu_torch/csrc/exact_peel.cu",
               "no Pallas kernel: skirt_tpu/engine/fused_table.py:395-540, "
               "the exact peel in XLA"),
        "PS": ("SED peel", "skirt_tpu_torch/csrc/peel_sed.cu",
               "no Pallas kernel: skirt_tpu/engine/fused_table_poly.py, "
               "fused_poly.py, the poly scattering peel in XLA"),
        "K3": ("K3 mono_event", "skirt_tpu_torch/csrc/fused_mono.cu",
               "skirt_tpu/engine/fused.py:199"),
        "K4": ("K4 table_event", "skirt_tpu_torch/csrc/fused_table.cu",
               "skirt_tpu/engine/fused_table.py:83"),
        "K5": ("K5 table_multi_event",
               "skirt_tpu_torch/csrc/fused_table_multi.cu",
               "skirt_tpu/engine/fused_table.py:248"),
        "K6": ("K6 table_poly_event",
               "skirt_tpu_torch/csrc/fused_table_poly.cu",
               "skirt_tpu/engine/fused_table_poly.py:107"),
        "K4d": ("K4d table_event (direct table)",
                "skirt_tpu_torch/csrc/fused_table.cu",
                "skirt_tpu/engine/fused_table.py:83 (arith_locate=False)"),
        "K6d": ("K6d table_poly_event (direct table)",
                "skirt_tpu_torch/csrc/fused_table_poly.cu",
                "skirt_tpu/engine/fused_table_poly.py:107 "
                "(arith_locate=False)"),
        "K6p": ("K6p table_poly_event (polarized)",
                "skirt_tpu_torch/csrc/fused_table_poly.cu",
                "skirt_tpu/engine/fused_table_poly.py:107 (want_pol=True, "
                ":175-179, :348-350)"),
        "K7": ("K7 table_poly_multi_event",
               "skirt_tpu_torch/csrc/fused_table_poly_multi.cu",
               "skirt_tpu/engine/fused_table_poly.py:355"),
        "K8": ("K8 binned_add_lm", "skirt_tpu_torch/csrc/binned_blocked.cu",
               "skirt_tpu/ops/binned.py:146"),
        "PG": ("PG table_gather", "skirt_tpu_torch/csrc/probe_gather.cu",
               "experiments/microbench_gather.py:101, :128; "
               "microbench_gather2.py:85; microbench_pallas_gather.py:65, "
               ":91, :117; microbench_pallas_gather2.py:60; "
               "microbench_pallas_gather3.py:42; "
               "microbench_pallas_gather4.py:45, :88 (P1-P10)"),
        "PO": ("PO onehot_gather",
               "skirt_tpu_torch/csrc/probe_onehot_gather.cu",
               "experiments/microbench_mxu_gather.py:62; "
               "microbench_mxu_gather2.py:48; microbench_mxu_gather3.py:55; "
               "microbench_mxu_gather4.py:91 (P11-P14)"),
        "PM": ("PM mm", "skirt_tpu_torch/csrc/probe_mm.cu",
               "experiments/microbench_mxu_mm.py:34 (P15)")}
    kern = {}
    for k, (name, source, replaces) in meta.items():
        r = results[k]
        kern[k] = {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "launches": launches[k],
                   "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                   "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"],
                   "library_ms": r.get("library_ms")}
    k2 = kern["K2"]
    k2["launches_by_path"] = {p: results[f"launches_{p}"]["K2"]
                              for p in paths}
    for i, key in enumerate(("ms", "plain_ms", "library_ms")):
        k2[f"{key}_by_shape"] = {n: v[i] for n, v
                                 in results["K2"]["times"].items()}
    k2["bound_ms_by_shape"] = {n: v[3][0] for n, v
                               in results["K2"]["times"].items()}
    for k in ("K6", "K7", "K6d", "K6p"):
        kern[k]["by_W"] = results[k]["by_W"]
    kern["K3"]["by_case"] = results["K3"]["by_case"]
    kern["BS"]["ms_by_shape"] = {n: v[0] for n, v
                                 in results["BS"]["times"].items()}
    for k in ("EP", "PS"):
        kern[k]["ms_by_shape"] = {n: v[0] for n, v
                                  in results[k]["times"].items()}
    for k, by_shape in results["chunked"].items():
        kern[k]["chunked"] = by_shape
    for k in ("K8", "PG", "PO", "PM"):
        kern[k]["shape"] = results[k]["shape"]
        kern[k]["by_variant"] = results[k]["by_variant"]
    kern["PG"]["ms_smem"] = results["PG"]["ms_smem"]
    kern["PG"]["panel_cells_ms"] = results["PG"]["panel_cells_ms"]
    kern["PO"]["onehot_floor_ms"] = results["PO"]["onehot_floor_ms"]
    kern["PO"]["hgmma_in_sass"] = results["PO"]["sass"]["HGMMA"]
    kern["PM"]["sass"] = results["PM"]["sass"]
    kern["PM"]["max_err_over_tol"] = results["PM"]["max_err_over_tol"]
    print(json.dumps({"kernels": list(kern.values()),
                      "main_path_packets_per_s": {
                          p: results[f"main_{p}"]["packets_per_s"]
                          for p in paths}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
