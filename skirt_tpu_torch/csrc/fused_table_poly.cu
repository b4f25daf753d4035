// K6: polychromatic table-mode scattering event, a group of threads per
// lane; K6d, its variant for direct-table grids (the exact Voronoi
// tessellation, an uneven Cartesian grid) that emits the deposit distance;
// and K6p, either of them with the two column densities the polarized
// driver needs.
//
// Replaces: skirt_tpu/engine/fused_table_poly.py:107 `_build_kernel` (the
// Pallas body at :160-350), called at :924: K6 with arith_locate, K6d with
// arith_locate=False (:228-239, :915-918), K6p with want_pol=True
// (:175-179, :348-350; built at :721-734).
// Same input/output contract: the staged (P, N) raw rho panels and the
// (7, N) uniforms come in as inputs and the kernel draws nothing itself, so
// the plain PyTorch version (engine/fused_table_poly.py::
// table_poly_event_plain) and this kernel see identical inputs.  The
// arithmetic follows the Pallas body operation for operation (built with
// -fmad=false; 1 - exp(-tau), never expm1; hg() as (1-g)(1+g)/sqrt(t t t)),
// and every ordered sum runs in the plain version's order, so the two
// agree to the bit.
//
// What bounds it on the H100: bytes.  Per live lane and event it reads P
// panel values, 2 x W luminosities and 17 words of state and uniforms, and
// writes 2 x W luminosities and 10 words; per wavelength it does ~60
// operations (two exp, five divisions and the HG root among them).  At
// W = 2, N = 2^17 that is ~25 MB (~7.5 us at 3.35 TB/s) against ~3 x 10^7
// operations; at W = 128, N = 2^15 ~65 MB against ~2.8 x 10^8 operations
// (~4 us at 67 TFLOP/s), bytes still (chip_smoke.py's k6_ops).  The first
// design (one thread per lane, its W absorbed powers in a local-memory
// array prefixed by one thread, three passes over w that recomputed the
// same exponentials, 1,024 blocks of 128 threads at N = 2^17 of which ~924
// fit at once) sat 2.5x off that bound at W = 2 and 17x at W = 128.  This
// one runs W = 2's 4,096 blocks in one wave: a block waits ~6.7 us for its
// rows, then computes ~7 us while 31 warps an SM issue at ~2/3 of the
// schedulers' rate, and the two halves do not overlap; a variant that
// walked two lane groups a block, the second's rows loading during the
// first's compute, was slower at every W (experiments/phases.py; PERF.md
// section 6).  At W = 24 and 128 the wavelength passes and the weight
// pass's stores hold it.
//
// Design: a block holds LANES = 32 consecutive lanes (threadIdx.x) and G
// threads per lane (threadIdx.y, the lane's roles; one warp a role): G = 1
// up to W = 4, 2 up to 8, 4 up to 32 and 16 above, each the fastest of
// G = 1, 2, 4, 8, 16 at W = 2, 8, 24, 128 (a thread owns at most wpt<G>
// wavelengths, w = r, r + G, ...).
// - Every input row of the lane is staged into shared memory ([row][lane])
//   by asynchronous copies, all in flight at once: its P panels (live
//   lanes; K6p every lane), its uniforms, position, direction, t0 and dt,
//   its W weights L and, past min_scatt, its W launch weights L0; with the
//   (3, W) optical constants.
// - Role 0 takes the lane's path column (the running sums I_k written over
//   its panels, for the two inversions), the driver wavelength c, the
//   interaction column I_s and the HG cosine; the other roles read them.
// - One pass per (lane, w): 1 - e^-tau, e^{-kappa I_s}, F, the HG weight
//   and Lab once; the terms of Qmix, QHmix and sum D go to shared memory
//   ([slot][w][lane]), Lab F and Lab F HG stay in the thread's registers.
// - The sums over w in BlockSum's order (XLA's CPU order, sum_block); with
//   several blocks each block's in-order partial on a role of its own (Q's
//   and QH's over the block's first term, D's beside the terms, which the
//   prefix still needs), then one role per sum adds the partials in order.
// - The deposit wavelength: the Hillis-Steele prefix of the D terms in
//   shared memory (common.cuh prefix_smem), and the count of prefix values
//   at or below the target, an integer sum over the roles.  The two
//   inversions (deposit and interaction panel) are binary searches over
//   the running sums I_k, which never decrease: rho >= 0 and dt >= 0.
// - The weight pass per thread; the lane's alive bit is the OR of its
//   threads' (a flag in shared memory); role 0 moves and scatters the lane.
// - Dead lanes copy their state through with zero weights (the Pallas body
//   computes them and masks them out).
// - A launch runs N / 32 blocks; with G = 1 at W = 2, N = 2^17 all 4,096
//   are resident at once (32 per SM at up to 64 registers a thread).
// - K6d (DIRECT): no locate here.  The deposit goes out as the sampled
//   wavelength wsel in odepi, the total Dsum in odepv and the distance
//   along the pre-event ray, mid_dep, in odepd (-1, 0 and -1 where nothing
//   is deposited); the lifecycle locates pos + mid_dep * dir on the grid and
//   forms the bin cell * W + wsel (engine/fused_table_poly.py).  One float
//   out more than K6.
// - K6p (POL): the raw column density at the sampled interaction point,
//   I_s = tau_smp / kappa_ext(c) at the driver wavelength c, in oIs, and
//   the whole path's, I_tot, in oIt, both before the position update.  The
//   driver rebuilds the per-wavelength mixture ratios from them and swaps
//   the HG weights for the Mueller ones.  The Pallas body writes both for
//   every lane, dead ones included, so a dead lane sums its panels and
//   draws I_s too (nothing else).
// - Past MAXP panels (CHUNKED, picked by the C entry point) the panels are
//   not staged: role 0 sums them from device memory in chunks of CH = 32,
//   keeping each chunk's last value in the scratch array cend ((nchunks,
//   N)), and each inversion walks again only the chunk its target falls in
//   (common.cuh chunk_invert).  Shared memory no longer grows with P, so a
//   block holds what it holds at P = 0.

#include "common.cuh"

namespace {

constexpr int MAX_W = 128;
constexpr int LANES = 32;
// the lane's scalar rows staged beside its panels: the 7 uniforms, then
// px, py, pz, dx, dy, dz, t0, dt
constexpr int NSC = 15;

// wavelengths a thread owns at most, and blocks per SM, by threads a lane
template <int G>
__host__ __device__ constexpr int wpt() {
  return G == 1 ? 4 : 8;
}
template <int G>
__host__ __device__ constexpr int blocks_per_sm() {
  return 1024 / (LANES * G);         // 64 registers a thread
}

}  // namespace

// Mirrored field for field by kernels.TablePolyArgs (ctypes).
struct TablePolyArgs {
  const float* u;
  const float* r;
  const float* oc;
  const float* L;
  const float* L0;
  const float* px;
  const float* py;
  const float* pz;
  const float* dx;
  const float* dy;
  const float* dz;
  const int* alive;
  const int* ns;
  const float* t0;
  const float* dt;
  float* opx;
  float* opy;
  float* opz;
  float* odx;
  float* ody;
  float* odz;
  int* oalive;
  int* ons;
  float* oLn;
  float* oLp;
  int* odepi;
  float* odepv;
  float* odepd;
  float* oIs;
  float* oIt;
  int N, W, npanels, min_scatt, sum_block, direct, pol;
  float xi, one_m_xi, inv_W, inv_minred;
  Geom geo;
  float* cend;
};

namespace {

// source of the lane's scalar row i (NSC of them)
__device__ __forceinline__ const float* scalar_row(const TablePolyArgs& a,
                                                   int i) {
  switch (i - 7) {
    case 0: return a.px;
    case 1: return a.py;
    case 2: return a.pz;
    case 3: return a.dx;
    case 4: return a.dy;
    case 5: return a.dz;
    case 6: return a.t0;
    case 7: return a.dt;
    default: return a.u + (long long)i * a.N;
  }
}

// the interaction column I_s at the driver wavelength c, drawn from the
// uniform-driver mixture: I_s = tau_smp / kappa_c; sc: the lane's scalar
// rows (uniform k at sc[k * LANES])
__device__ __forceinline__ float interaction_column(const TablePolyArgs& a,
                                                    const float* kext,
                                                    const float* sc, int c,
                                                    float I_tot) {
  const float tau_c = kext[c] * I_tot;
  const float kinv_cc = 1.f / kext[c];
  const float u1 = sc[0], u2 = sc[LANES];
  const float tau_exp = expon_cutoff(u2, tau_c);
  const float tau_smp =
      a.xi == 0.f ? tau_exp : (u1 < a.xi ? u2 * tau_c : tau_exp);
  return tau_smp * kinv_cc;
}

// what a lane's roles share beyond its rows and the terms
struct LaneShared {
  float I_tot[LANES], I_s[LANES], costheta[LANES];
  float Qmix[LANES], QHmix[LANES], Dsum[LANES];
  int wsel[LANES], any_ln[LANES];
};

template <bool LABS, bool DIRECT, bool POL, int G, bool CHUNKED>
__global__ void __launch_bounds__(LANES * G, blocks_per_sm<G>())
table_poly_event_kernel(const __grid_constant__ TablePolyArgs a) {
  constexpr int WPT = wpt<G>();
  extern __shared__ float dyn[];
  __shared__ LaneShared s;
  const int W = a.W, P = a.npanels, B = a.sum_block, nb = W / B;
  const int Ps = CHUNKED ? 0 : P;             // panel rows staged
  const int l = threadIdx.x, r = threadIdx.y;
  const int tid = r * LANES + l;
  const long long N = a.N;
  const int n = blockIdx.x * LANES + l;
  const bool valid = n < a.N;
  float* s_oc = dyn;                          // (3, W)
  float* sc = s_oc + 3 * W + l;               // [NSC][LANES]
  float* rho = sc + NSC * LANES;              // [Ps][LANES], then the I_k
  float* tL0 = rho + Ps * LANES;              // [W][LANES] each
  float* tQ = tL0 + W * LANES;                // L, then Q's terms
  float* tQH = tQ + W * LANES;
  float* tD = tQH + W * LANES;                // with labs
  float* tDp = tD + W * LANES;                // D's block partials [nb]
  const float* kext = s_oc;
  const float* alb = s_oc + W;
  const float* gw = s_oc + 2 * W;

  // -- every input row of the lane by asynchronous copies, all in flight
  //    at once; the constants ------------------------------------------------
  if (valid)
    for (int i = r; i < NSC; i += G)
      __pipeline_memcpy_async(sc + i * LANES, scalar_row(a, i) + n, 4);
  const bool live = valid && a.alive[n] != 0;
  const int nscatt = valid ? a.ns[n] : 0;
  const bool past_min = nscatt >= a.min_scatt;
  if (!CHUNKED && (POL ? valid : live))
    stage_rows<LANES>(rho, a.r, P, N, n, r, G);
  if (live) stage_rows<LANES>(tQ, a.L, W, N, n, r, G);
  if (live && past_min) stage_rows<LANES>(tL0, a.L0, W, N, n, r, G);
  __pipeline_commit();
  for (int i = tid; i < 3 * W; i += LANES * G) s_oc[i] = a.oc[i];
  if (r == 0) {
    s.any_ln[l] = 0;
    s.wsel[l] = 0;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // -- role 0: the path column I_tot (the running sums I_k over the
  //    panels, for the inversions), the driver wavelength c, the
  //    interaction column I_s and the HG cosine (driver g) ---------------
  if (r == 0 && (POL ? valid : live)) {
    const float delta = sc[14 * LANES];
    float cum = 0.f;
    if constexpr (CHUNKED) {
      const float* rg = a.r + n;
#pragma unroll 4
      for (int k = 0; k < P; ++k) {
        cum = cum + rg[k * N] * delta;
        if ((k & (CH - 1)) == CH - 1 || k == P - 1)
          a.cend[(k / CH) * N + n] = cum;
      }
    } else {
      for (int k = 0; k < P; ++k) {
        cum = cum + rho[k * LANES] * delta;
        rho[k * LANES] = cum;
      }
    }
    const int c = min((int)(sc[5 * LANES] * (float)W), W - 1);
    s.I_tot[l] = cum;
    s.I_s[l] = interaction_column(a, kext, sc, c, cum);
    if (live) s.costheta[l] = hg_costheta(gw[c], sc[3 * LANES]);
  }
  __syncthreads();

  // -- one pass per (lane, w): the terms of Qmix, QHmix and sum D; Lab F
  //    and Lab F HG stay in registers -------------------------------------
  float v_LF[WPT], v_LFH[WPT];
  if (live) {
    const float I_tot = s.I_tot[l], I_s = s.I_s[l];
    const float costheta = s.costheta[l];
    const float xi = a.xi;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        const float kx = kext[w];
        const float tau = kx * I_tot;
        const float ome = 1.f - expf(-tau);
        const float Lm = tQ[w * LANES];
        const float F = kx * expf(-kx * I_s) / fmaxf(ome, TINY);
        const float Q =
            xi == 0.f ? F : a.one_m_xi * F + xi * kx / fmaxf(tau, TINY);
        const float hgw = hg(gw[w], costheta);
        tQ[w * LANES] = Q;
        tQH[w * LANES] = Q * hgw;
        if (LABS) tD[w * LANES] = (1.f - alb[w]) * Lm * ome;
        const float LF = alb[w] * Lm * ome * F;
        v_LF[j] = LF;
        v_LFH[j] = LF * hgw;
      }
    }
  }
  __syncthreads();

  // -- the sums over w in BlockSum's order: with several blocks, each
  //    block's in-order partial on a role of its own (Q's and QH's over the
  //    block's first term, D's into tDp: the prefix needs D's terms), then
  //    one role per sum adds the partials in order ------------------------
  constexpr int NSUM = 2 + LABS;
  if (nb > 1) {
    if (live)
      for (int t = r; t < NSUM * nb; t += G) {
        const int q = t / nb, b = t - q * nb;
        const float* terms =
            (q == 0 ? tQ : (q == 1 ? tQH : tD)) + b * B * LANES;
        float* part = q == 2 ? tDp + b * LANES : (float*)terms;
        *part = block_part<LANES>(terms, B);
      }
    __syncthreads();
  }
  if (live)
    for (int q = r; q < NSUM; q += G) {
      const float* t = q == 0 ? tQ : (q == 1 ? tQH : tD);
      const float* parts = nb > 1 ? (q == 2 ? tDp : t) : nullptr;
      const float total =
          block_total<LANES>(t, parts, q == 2 ? LANES : B * LANES, nb, B);
      if (q == 0) s.Qmix[l] = fmaxf(total * a.inv_W, TINY);
      else if (q == 1) s.QHmix[l] = fmaxf(total * a.inv_W, TINY);
      else s.Dsum[l] = total;
    }
  __syncthreads();

  // -- the deposit wavelength: the D terms' Hillis-Steele prefix and the
  //    count of its values at or below u6 * Dsum -------------------------
  if (LABS) prefix_smem<LANES, WPT>(tD, W, r, G, live);
  if (LABS && live && W > 1) {
    const float target = sc[6 * LANES] * s.Dsum[l];
    const int cnt = count_le<LANES, WPT>(tD, W - 1, r, G, target);
    if (cnt) atomicAdd(&s.wsel[l], cnt);
  }

  // -- peel and onward weights, per-wavelength weight cut -----------------
  if (live) {
    const float Qmix = s.Qmix[l], QHmix = s.QHmix[l];
    bool any_ln = false;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        float Lp = v_LF[j] / Qmix;
        float Ln = v_LFH[j] / QHmix;
        if (past_min && Ln <= tL0[w * LANES] * a.inv_minred) {
          Lp = 0.f;
          Ln = 0.f;
        }
        any_ln = any_ln || (Ln > 0.f);
        a.oLn[w * N + n] = Ln;
        a.oLp[w * N + n] = Lp;
      }
    }
    if (any_ln) s.any_ln[l] = 1;
  }
  __syncthreads();

  // -- the lane's state: the deposit, the move to the interaction point,
  //    the HG scatter about the old direction; dead lanes' weights zero ---
  const bool alive = live && s.any_ln[l] != 0 && s.I_tot[l] > TINY;
  if (valid && !alive) {
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        a.oLn[w * N + n] = 0.f;
        a.oLp[w * N + n] = 0.f;
      }
    }
  }
  if (valid && r == 0) {
    float X = sc[7 * LANES], Y = sc[8 * LANES], Z = sc[9 * LANES];
    float DX = sc[10 * LANES], DY = sc[11 * LANES], DZ = sc[12 * LANES];
    const float t0 = sc[13 * LANES], delta = sc[14 * LANES];
    const float* cums = rho;                  // the running sums I_k
    // the chunked route's walk over the panels in device memory
    const float* rg = a.r + n;
    const float* ends = a.cend + n;
    float wc = 0.f;
    auto restart = [&](int c) {
      wc = c > 0 ? ends[(c - 1) * N] : 0.f;
      return wc;
    };
    auto next = [&](int k) {
      wc = wc + rg[k * N] * delta;
      return wc;
    };
    int ns_out = nscatt;
    if (LABS) {
      int depi = -1;
      float depv = 0.f, depd = -1.f;
      if (live) {
        const int wsel = s.wsel[l];
        const float Dsum = s.Dsum[l];
        const float tau_sel = kext[wsel] * s.I_tot[l];
        const float kinv_sel = 1.f / kext[wsel];
        const float I_dep = expon_cutoff(sc[2 * LANES], tau_sel) * kinv_sel;
        float at, before;
        const int i_dep =
            CHUNKED ? chunk_invert(ends, N, P - 1, I_dep, restart, next, at,
                                   before)
                    : count_below(cums, LANES, P - 1, I_dep);
        const float mid_dep = t0 + ((float)i_dep + 0.5f) * delta;
        if (DIRECT) {
          if (Dsum > 0.f) {
            depi = wsel;
            depv = Dsum;
            depd = mid_dep;
          }
        } else {
          const int cell = locate(a.geo, X + mid_dep * DX, Y + mid_dep * DY,
                                  Z + mid_dep * DZ);
          if (Dsum > 0.f && cell >= 0) {
            depi = cell * W + wsel;
            depv = Dsum;
          }
        }
      }
      a.odepi[n] = depi;
      a.odepv[n] = depv;
      if (DIRECT) a.odepd[n] = depd;
    }
    if (live) {
      const float I_s = s.I_s[l];
      int i_hit;
      float cum_h, cum_prev;
      if constexpr (CHUNKED) {
        i_hit = chunk_invert(ends, N, P - 1, I_s, restart, next, cum_h,
                             cum_prev);
      } else {
        i_hit = count_below(cums, LANES, P - 1, I_s);
        cum_h = cums[i_hit * LANES];
        cum_prev = i_hit > 0 ? cums[(i_hit - 1) * LANES] : 0.f;
      }
      const float dI_h = cum_h - cum_prev;
      const float fr =
          dI_h > 0.f ? (I_s - cum_prev) / fmaxf(dI_h, TINY) : 0.f;
      const float frac = fminf(fmaxf(fr, 0.f), 1.f);
      const float sp = t0 + ((float)i_hit + frac) * delta;
      X = X + sp * DX;
      Y = Y + sp * DY;
      Z = Z + sp * DZ;
    }
    if (alive) {
      scatter_direction(s.costheta[l], sc[4 * LANES], DX, DY, DZ);
      ns_out += 1;
    }
    a.opx[n] = X;
    a.opy[n] = Y;
    a.opz[n] = Z;
    a.odx[n] = DX;
    a.ody[n] = DY;
    a.odz[n] = DZ;
    a.oalive[n] = alive ? 1 : 0;
    a.ons[n] = ns_out;
    if (POL) {
      a.oIs[n] = s.I_s[l];
      a.oIt[n] = s.I_tot[l];
    }
  }
}

// dynamic shared memory of a launch: the constants, the scalar rows, the
// panels, L0 and the term slots (with labs D's, and its nb block partials
// where there are several)
__host__ __device__ constexpr size_t smem_floats(bool LABS, int W, int P,
                                                 int nb) {
  return (size_t)3 * W + (size_t)(NSC + P) * LANES +
         (size_t)(3 + LABS) * W * LANES +
         (LABS && nb > 1 ? (size_t)nb * LANES : 0);
}

template <bool LABS, bool DIRECT, bool POL, int G, bool CHUNKED>
int launch_g(const TablePolyArgs& a, cudaStream_t s) {
  const int blocks = (a.N + LANES - 1) / LANES;
  if (blocks <= 0) return (int)cudaGetLastError();
  static bool raised[64];
  const int e = raise_smem_limit(
      table_poly_event_kernel<LABS, DIRECT, POL, G, CHUNKED>,
      smem_floats(LABS, MAX_W, CHUNKED ? 0 : MAXP, MAX_W) * sizeof(float),
      raised);
  if (e) return e;
  const size_t smem = smem_floats(LABS, a.W, CHUNKED ? 0 : a.npanels,
                                  a.W / a.sum_block) *
                      sizeof(float);
  table_poly_event_kernel<LABS, DIRECT, POL, G, CHUNKED>
      <<<blocks, dim3(LANES, G), smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool LABS, bool DIRECT, bool POL, bool CHUNKED>
int launch(const TablePolyArgs& a, cudaStream_t s) {
  // the fastest width at W = 2, 8, 24 and 128 (experiments/phases.py
  // --threads; PERF.md section 6)
  if (a.W <= 4) return launch_g<LABS, DIRECT, POL, 1, CHUNKED>(a, s);
  if (a.W <= 8) return launch_g<LABS, DIRECT, POL, 2, CHUNKED>(a, s);
  if (a.W <= 32) return launch_g<LABS, DIRECT, POL, 4, CHUNKED>(a, s);
  return launch_g<LABS, DIRECT, POL, 16, CHUNKED>(a, s);
}

template <bool POL, bool CHUNKED>
int launch_pol(const TablePolyArgs& a, int labs, cudaStream_t s) {
  // without labs the direct and arithmetic-locate variants write the same
  // outputs
  if (!labs) return launch<false, false, POL, CHUNKED>(a, s);
  return a.direct ? launch<true, true, POL, CHUNKED>(a, s)
                  : launch<true, false, POL, CHUNKED>(a, s);
}

}  // namespace

extern "C" int skirt_table_poly_args_size() {
  return (int)sizeof(TablePolyArgs);
}

extern "C" int skirt_table_poly_event(const TablePolyArgs* a, int labs,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->W < 1 || a->W > MAX_W || a->npanels < 1 || a->sum_block < 1 ||
      a->W % a->sum_block != 0)
    return (int)cudaErrorInvalidValue;
  if (a->npanels <= MAXP)
    return a->pol ? launch_pol<true, false>(*a, labs, s)
                  : launch_pol<false, false>(*a, labs, s);
  if (!a->cend) return (int)cudaErrorInvalidValue;
  return a->pol ? launch_pol<true, true>(*a, labs, s)
                : launch_pol<false, true>(*a, labs, s);
}
