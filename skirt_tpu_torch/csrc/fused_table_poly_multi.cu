// K7: polychromatic multi-component table-mode event, a group of threads
// per lane.
//
// Replaces: skirt_tpu/engine/fused_table_poly.py:355 `_build_kernel_multi`
// (the Pallas body at :423-657), called at :924.  Same input/output
// contract: the staged (H * P, N) raw rho panels (h-major), the (3H, W)
// constants (kappa_ext rows, kappa_sca rows, g rows) and the (8, N) uniforms
// come in as inputs and the kernel draws nothing itself, so the plain
// PyTorch version (engine/fused_table_poly.py::table_poly_multi_event_plain)
// and this kernel see identical inputs.  The arithmetic follows the Pallas
// body operation for operation (built with -fmad=false; 1 - exp(-tau), never
// expm1; hg() as (1-g)(1+g)/sqrt(t t t), a division; rsqrtf only in the
// direction's normalisation), and every ordered sum runs in the plain
// version's order, so the two agree to the bit.
//
// Work per live lane and event: it reads H P panel values, 2 x W
// luminosities and ~16 words, writes 2 x W luminosities and 10 words, and
// walks the H P panels once per wavelength (~5 exp and H HG evaluations
// beside).  At W = 2, N = 2^17 the event moves ~40 MB, so the least time
// is set by bytes; at W = 24 and 128 (N = 2^15) by bytes and by the
// operations about equally (chip_smoke.py's k7_ops).  The first design
// (one thread per lane, the panels in 168-255 registers, three panel walks
// per wavelength, the deposit prefix in local memory) held 8-12 warps per
// SM and sat 10-35x off that bound, its time in the panel loads at W = 2
// and in the wavelength passes at W = 24 and 128 (experiments/phases.py).
// This one issues ~20% of the schedulers' rate at W = 128: each
// wavelength's panel walk is a chain of dependent adds, and the HG root and
// the divisions keep a thread's wavelengths from overlapping.  Replacing
// those operators by the per-call fallbacks of common.cuh (div_or,
// sqrt_or) or by the branch-free forms with the thread's pass redone
// (div_rn, hg_rn) made it slower at every width (experiments/phases.py);
// so did G = 8 or 16 at W = 2 (2.3x, 4.7x) and G = 16 at W = 24 (1.4x).
//
// Design: a block holds LANES = 32 consecutive lanes (threadIdx.x) and G
// threads per lane (threadIdx.y, the lane's roles; one warp a role): G = 2
// up to W = 4, 8 up to W = 32, 16 above, so that a thread owns at most 2,
// 4 or 8 wavelengths, w = r, r + G, ...
// - The lane's H x P panel rows are staged into shared memory by all of
//   its roles with asynchronous copies, all in flight at once ([row][lane],
//   coalesced reads of the (H P, N) rows; common.cuh stage_rows), with the
//   (3H, W) constants; the panels leave the registers.
// - Pass A, one role per ordered sum: the driver's cumulative optical
//   depth (into shared memory, for the two inversions) and each
//   component's integral I[h].  Then the two inversions on two roles
//   (binary searches over the non-decreasing driver sums, the count of
//   sums below the target that the Pallas body takes); the first also
//   draws the scattering component and the HG cosine.
// - One panel walk per (lane, w): a thread computes its wavelengths' six
//   point sums, 1 - e^-tau, the HG blend and the three terms of the sums
//   over w once, and keeps what the later passes need (k_sca and e^-tau at
//   the interaction point, the HG blend; with labs the deposit point's
//   absorption coefficient and e^-tau) in registers.
// - The sums over w in XLA's CPU order (BlockSum, sum_block) over the
//   terms in shared memory ([slot][w][lane]): Qmix, QHmix, the deposit
//   normaliser qd, then sum D.  With several blocks (W / sum_block > 1)
//   each block's in-order partial is taken on a role of its own, then one
//   role per sum adds the partials in order from 0, as BlockSum does
//   (common.cuh block_part, block_total; K6 shares them).
// - The deposit: each thread forms its wavelengths' absorbed powers D into
//   the slot qd's terms left; the Hillis-Steele prefix runs in shared
//   memory, each step's reads before its writes (the in-place descending
//   loop of the plain version reads only un-updated values, so it is the
//   same step; common.cuh prefix_smem), and the count of prefix values at
//   or below the target is an integer sum taken in parallel (count_le).
// - The weight pass per thread; the lane's alive bit is the OR of its
//   threads' (a flag in shared memory); one role moves and scatters.
// - Dead lanes copy their state through with zero weights; the deposit's
//   locate is the arithmetic one of common.cuh.
// - Past MAXP panels or MAX_H components the C entry point launches
//   table_poly_multi_event_chunked: H a run-time count, nothing staged
//   (each walk reads the panels from device memory), the driver's running
//   sums walked in chunks of CH = 32 with each chunk's last value in the
//   scratch array cend ((nchunks, N)) and the two inversions re-walking
//   only the crossing chunk (common.cuh chunk_invert), I[h] and rho_s[h]
//   in shared memory rows sized by H.  From the sums over w on it is the
//   one-pass kernel's code.

#include "common.cuh"

namespace {

constexpr int MAX_W = 128;
constexpr int MAX_H = 3;
constexpr int LANES = 32;

// wavelengths of a thread and blocks per SM by threads per lane
template <int G>
__host__ __device__ constexpr int wpt() {
  return G == 2 ? 2 : (G == 8 ? 4 : MAX_W / G);
}
template <int G>
__host__ __device__ constexpr int blocks_per_sm() {
  return 1024 / (LANES * G);         // 64 registers a thread
}

}  // namespace

// Mirrored field for field by kernels.TablePolyMultiArgs (ctypes).
struct TablePolyMultiArgs {
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
  int N, W, H, npanels, min_scatt, sum_block;
  float xi, one_m_xi, inv_W, inv_minred;
  Geom geo;
  float* cend;
};

namespace {

// the Pallas body's pass-B values of one wavelength w: the optical depth up
// to the interaction (s) and deposit (d) points, and the blended kappa_ext
// and kappa_sca of the panel each lies in; rho: the lane's column of the
// [H * P][LANES] panel rows
struct PointSums {
  float cum_s, cum_d, kmix_s, ksca_s, kmix_d, ksca_d;
};

template <int H>
__device__ __forceinline__ PointSums point_sums(
    const float* rho, const float* kext, const float* ksca, int W, int w,
    int P, int ks_i, float ks_f, int kd_i, float kd_f, float delta) {
  PointSums p = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ke[H], kc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    ke[h] = kext[h * W + w];
    kc[h] = ksca[h * W + w];
  }
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    if (k < P) {
      const float r0 = rho[k * LANES];
      float dtau = ke[0] * r0;
      float ks = kc[0] * r0;
#pragma unroll
      for (int h = 1; h < H; ++h) {
        const float rh = rho[(h * P + k) * LANES];
        dtau = dtau + ke[h] * rh;
        ks = ks + kc[h] * rh;
      }
      const float m_s = (ks_i > k ? 1.f : (ks_i == k ? ks_f : 0.f)) * delta;
      const float m_d = (kd_i > k ? 1.f : (kd_i == k ? kd_f : 0.f)) * delta;
      p.cum_s = p.cum_s + dtau * m_s;
      p.cum_d = p.cum_d + dtau * m_d;
      if (ks_i == k) {
        p.kmix_s = dtau;
        p.ksca_s = ks;
      }
      if (kd_i == k) {
        p.kmix_d = dtau;
        p.ksca_d = ks;
      }
    }
  }
  return p;
}

// panel of the driver's cumulative optical depths (cums[k * LANES], k < P,
// non-decreasing) where target lands and the fraction into it (the Pallas
// body's invert: the count of sums below target, found by binary search)
__device__ __forceinline__ void invert(const float* cums, int P, float target,
                                       int& i_hit, float& frac) {
  const int lo = count_below(cums, LANES, P - 1, target);
  i_hit = lo;
  const float cum_hi = cums[lo * LANES];
  const float cum_prev = lo > 0 ? cums[(lo - 1) * LANES] : 0.f;
  const float dtau = cum_hi - cum_prev;
  const float fr = dtau > 0.f ? (target - cum_prev) / fmaxf(dtau, TINY) : 0.f;
  frac = fminf(fmaxf(fr, 0.f), 1.f);
}

// what a lane's roles share beyond the panels and the terms
struct LaneShared {
  float I[MAX_H][LANES], rho_s[MAX_H][LANES];
  float tau_c[LANES], ks_f[LANES], kd_f[LANES], costheta[LANES];
  float Qmix[LANES], QHmix[LANES], qd[LANES], Dsum[LANES];
  int ks_i[LANES], kd_i[LANES], wsel[LANES], any_ln[LANES];
};

template <int H, bool LABS, int G>
__global__ void __launch_bounds__(LANES * G, blocks_per_sm<G>())
table_poly_multi_event_kernel(const __grid_constant__ TablePolyMultiArgs a) {
  constexpr int WPT = wpt<G>();
  extern __shared__ float dyn[];
  __shared__ LaneShared s;
  const int W = a.W, P = a.npanels;
  const int l = threadIdx.x, r = threadIdx.y;
  const int tid = r * LANES + l;
  const long long N = a.N;
  const int n = blockIdx.x * LANES + l;
  const bool valid = n < a.N;
  float* s_oc = dyn;                          // (3H, W)
  float* rho = s_oc + 3 * H * W + l;          // [H * P][LANES]
  float* cums = rho + H * P * LANES;          // [P][LANES]
  float* tQ = cums + P * LANES;               // [W][LANES] each
  float* tQH = tQ + W * LANES;
  float* tD = tQH + W * LANES;                // qd's terms, then D
  const float* kext = s_oc;                   // kext[h * W + w]
  const float* ksca = s_oc + H * W;
  const float* gg = s_oc + 2 * H * W;
  const float* u = a.u;

  // -- the live lanes' panel rows by asynchronous copies, all in flight at
  //    once; the constants ------------------------------------------------
  const bool live = valid && a.alive[n] != 0;
  if (live) stage_rows<LANES>(rho, a.r, H * P, N, n, r, G);
  __pipeline_commit();
  for (int i = tid; i < 3 * H * W; i += LANES * G) s_oc[i] = a.oc[i];
  if (r == 0) {
    s.any_ln[l] = 0;
    s.wsel[l] = 0;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // -- pass A, one role per ordered sum: the driver's cumulative optical
  //    depth, the per-component integrals --------------------------------
  if (live) {
    const float delta = a.dt[n];
    for (int q = r; q <= H; q += G) {
      if (q == 0) {
        const int c = min((int)(u[5 * N + n] * (float)W), W - 1);
        float cumc = 0.f;
        for (int k = 0; k < P; ++k) {
          float dk = 0.f;
#pragma unroll
          for (int h = 0; h < H; ++h)
            dk = dk + kext[h * W + c] * rho[(h * P + k) * LANES];
          cumc = cumc + dk * delta;
          cums[k * LANES] = cumc;
        }
        s.tau_c[l] = cumc;
      } else {
        const int h = q - 1;
        float I = 0.f;
        for (int k = 0; k < P; ++k)
          I = I + rho[(h * P + k) * LANES] * delta;
        s.I[h][l] = I;
      }
    }
  }
  __syncthreads();

  // -- interaction and deposit samples in driver-tau space; the scattering
  //    component drawn at the driver wavelength and its HG cosine ---------
  if (live && r < 2) {
    const float tau_c = s.tau_c[l];
    if (r == 0) {
      const float xi = a.xi;
      const float u1 = u[n], u2 = u[N + n];
      const float tau_exp = expon_cutoff(u2, tau_c);
      const float tau_smp =
          xi == 0.f ? tau_exp : (u1 < xi ? u2 * tau_c : tau_exp);
      int ks_i;
      float ks_f;
      invert(cums, P, tau_smp, ks_i, ks_f);
      s.ks_i[l] = ks_i;
      s.ks_f[l] = ks_f;
      const int c = min((int)(u[5 * N + n] * (float)W), W - 1);
      float rho_s[H], wv[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        rho_s[h] = rho[(h * P + ks_i) * LANES];
        s.rho_s[h][l] = rho_s[h];
        wv[h] = ksca[h * W + c] * rho_s[h];
      }
      float total_wv = wv[0];
#pragma unroll
      for (int h = 1; h < H; ++h) total_wv = total_wv + wv[h];
      const float u_comp = u[7 * N + n] * fmaxf(total_wv, TINY);
      float g_sel = gg[c];
      float acc = wv[0];
#pragma unroll
      for (int h = 1; h < H; ++h) {
        if (u_comp > acc) g_sel = gg[h * W + c];
        acc = acc + wv[h];
      }
      s.costheta[l] = hg_costheta(g_sel, u[3 * N + n]);
    } else {
      const float tau_dep = expon_cutoff(u[2 * N + n], tau_c);
      int kd_i;
      float kd_f;
      invert(cums, P, tau_dep, kd_i, kd_f);
      s.kd_i[l] = kd_i;
      s.kd_f[l] = kd_f;
    }
  }
  __syncthreads();

  // -- w pass 1, one panel walk per (lane, w): the terms of Qmix, QHmix
  //    and the deposit's qd; what the later passes need stays in
  //    registers ------------------------------------------------------------
  float v_ksca_s[WPT], v_e_s[WPT], v_num[WPT], v_kd[WPT], v_e_d[WPT];
  if (live) {
    const float delta = a.dt[n];
    const float xi = a.xi;
    const int ks_i = s.ks_i[l], kd_i = s.kd_i[l];
    const float ks_f = s.ks_f[l], kd_f = s.kd_f[l];
    const float costheta = s.costheta[l];
    float I[H], rho_s[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      I[h] = s.I[h][l];
      rho_s[h] = s.rho_s[h][l];
    }
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        const PointSums ps = point_sums<H>(rho, kext, ksca, W, w, P, ks_i,
                                           ks_f, kd_i, kd_f, delta);
        float tau = kext[w] * I[0];
#pragma unroll
        for (int h = 1; h < H; ++h) tau = tau + kext[h * W + w] * I[h];
        const float ome = 1.f - expf(-tau);
        if (LABS) {
          v_e_d[j] = expf(-ps.cum_d);
          v_kd[j] = ps.kmix_d - ps.ksca_d;
          tD[w * LANES] = ps.kmix_d * v_e_d[j] / fmaxf(ome, TINY);
        }
        v_e_s[j] = expf(-ps.cum_s);
        const float F = ps.kmix_s * v_e_s[j] / fmaxf(ome, TINY);
        const float Q = xi == 0.f
                            ? F
                            : a.one_m_xi * F + xi * ps.kmix_s / fmaxf(tau, TINY);
        tQ[w * LANES] = Q;
        float num = ksca[w] * rho_s[0] * hg(gg[w], costheta);
#pragma unroll
        for (int h = 1; h < H; ++h)
          num = num + ksca[h * W + w] * rho_s[h] * hg(gg[h * W + w], costheta);
        v_num[j] = num;
        v_ksca_s[j] = ps.ksca_s;
        tQH[w * LANES] = Q * (num / fmaxf(ps.ksca_s, TINY));
      }
    }
  }
  __syncthreads();

  // -- the sums over w in BlockSum's order: with several blocks, each
  //    block's in-order partial on a role of its own (written over the
  //    block's first term), then one role per sum adds the partials in
  //    order ---------------------------------------------------------------
  const int B = a.sum_block, nb = W / B;
  if (nb > 1) {
    if (live)
      for (int t = r; t < (2 + LABS) * nb; t += G) {
        const int q = t / nb, b = t - q * nb;
        float* terms = (q == 0 ? tQ : (q == 1 ? tQH : tD)) + b * B * LANES;
        terms[0] = block_part<LANES>(terms, B);
      }
    __syncthreads();
  }
  if (live) {
    for (int q = r; q < 2 + LABS; q += G) {
      const float* t = q == 0 ? tQ : (q == 1 ? tQH : tD);
      const float m = fmaxf(
          block_total<LANES>(t, nb > 1 ? t : nullptr, B * LANES, nb, B) *
              a.inv_W,
          TINY);
      if (q == 0) s.Qmix[l] = m;
      else if (q == 1) s.QHmix[l] = m;
      else s.qd[l] = m;
    }
  }
  __syncthreads();

  // -- the absorption deposit at s_dep, one wavelength drawn: the D terms,
  //    their sum, their Hillis-Steele prefix (each step's reads first) and
  //    the count of prefix values at or below the target ----------------
  if (LABS && live) {
    const float qd = s.qd[l];
    const bool dep_ok = s.tau_c[l] > TINY;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        const float D = a.L[w * N + n] * v_kd[j] * v_e_d[j] / qd;
        tD[w * LANES] = dep_ok ? D : 0.f;
      }
    }
  }
  __syncthreads();
  // sum D as above, the partials in the slots of Qmix's terms (tD keeps
  // the terms for the prefix); the prefix's first writes come after its
  // first barrier, so the total needs none of its own
  if (LABS && nb > 1) {
    if (live)
      for (int b = r; b < nb; b += G)
        tQ[b * B * LANES] = block_part<LANES>(tD + b * B * LANES, B);
    __syncthreads();
  }
  if (LABS && live && r == 0)
    s.Dsum[l] =
        block_total<LANES>(tD, nb > 1 ? tQ : nullptr, B * LANES, nb, B);
  if (LABS) prefix_smem<LANES, WPT>(tD, W, r, G, live);
  if (LABS && live && W > 1) {
    const float target = u[6 * N + n] * s.Dsum[l];
    const int cnt = count_le<LANES, WPT>(tD, W - 1, r, G, target);
    if (cnt) atomicAdd(&s.wsel[l], cnt);
  }

  // -- w pass 3: peel and onward weights, per-wavelength weight cut -------
  if (live) {
    const float Qmix = s.Qmix[l], QHmix = s.QHmix[l];
    const bool past_min = a.ns[n] >= a.min_scatt;
    bool any_ln = false;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        const float Lm = a.L[w * N + n];
        float Lp = Lm * v_ksca_s[j] * v_e_s[j] / Qmix;
        float Ln = Lm * v_num[j] * v_e_s[j] / QHmix;
        if (past_min && Ln <= a.L0[w * N + n] * a.inv_minred) {
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

  // -- the lane's state: move to the interaction point and HG scatter about
  //    the old direction; dead lanes' weights zero ------------------------
  const bool alive = live && s.any_ln[l] != 0 && s.tau_c[l] > TINY;
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
    float X = a.px[n], Y = a.py[n], Z = a.pz[n];
    float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
    int nscatt = a.ns[n];
    if (LABS) {
      int depi = -1;
      float depv = 0.f;
      if (live) {
        const float t0 = a.t0[n], delta = a.dt[n];
        const float s_dep = t0 + ((float)s.kd_i[l] + s.kd_f[l]) * delta;
        const float Dsum = s.Dsum[l];
        const int cell = locate(a.geo, X + s_dep * DX, Y + s_dep * DY,
                                Z + s_dep * DZ);
        if (Dsum > 0.f && cell >= 0) {
          depi = cell * W + s.wsel[l];
          depv = Dsum;
        }
      }
      a.odepi[n] = depi;
      a.odepv[n] = depv;
    }
    if (alive) {
      const float t0 = a.t0[n], delta = a.dt[n];
      const float sp = t0 + ((float)s.ks_i[l] + s.ks_f[l]) * delta;
      X = X + sp * DX;
      Y = Y + sp * DY;
      Z = Z + sp * DZ;
      scatter_direction(s.costheta[l], u[4 * N + n], DX, DY, DZ);
      nscatt += 1;
    }
    a.opx[n] = X;
    a.opy[n] = Y;
    a.opz[n] = Z;
    a.odx[n] = DX;
    a.ody[n] = DY;
    a.odz[n] = DZ;
    a.oalive[n] = alive ? 1 : 0;
    a.ons[n] = nscatt;
  }
}

// The chunked route (more than MAXP panels or MAX_H components): the
// panels stay in device memory (rho(h, k) at rg[(h P + k) N]), the driver's
// running sums are walked in chunks of CH = 32 with each chunk's last value
// in the scratch array cend ((nchunks, N)), and the per-component values
// (I[h], rho_s[h]) sit in shared memory rows [h][LANES] sized by H.
// point_sums of one wavelength, reading the panels from device memory
__device__ __forceinline__ PointSums point_sums_g(
    const float* rg, long long N, const float* kext, const float* ksca,
    int W, int w, int P, int H, int ks_i, float ks_f, int kd_i, float kd_f,
    float delta) {
  PointSums p = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float ke0 = kext[w], kc0 = ksca[w];
  for (int k = 0; k < P; ++k) {
    const float r0 = rg[k * N];
    float dtau = ke0 * r0;
    float ks = kc0 * r0;
    for (int h = 1; h < H; ++h) {
      const float rh = rg[((long long)h * P + k) * N];
      dtau = dtau + kext[h * W + w] * rh;
      ks = ks + ksca[h * W + w] * rh;
    }
    const float m_s = (ks_i > k ? 1.f : (ks_i == k ? ks_f : 0.f)) * delta;
    const float m_d = (kd_i > k ? 1.f : (kd_i == k ? kd_f : 0.f)) * delta;
    p.cum_s = p.cum_s + dtau * m_s;
    p.cum_d = p.cum_d + dtau * m_d;
    if (ks_i == k) {
      p.kmix_s = dtau;
      p.ksca_s = ks;
    }
    if (kd_i == k) {
      p.kmix_d = dtau;
      p.ksca_d = ks;
    }
  }
  return p;
}

// what a lane's roles share in the chunked route
struct LaneSharedC {
  float tau_c[LANES], ks_f[LANES], kd_f[LANES], costheta[LANES];
  float Qmix[LANES], QHmix[LANES], qd[LANES], Dsum[LANES];
  int ks_i[LANES], kd_i[LANES], wsel[LANES], any_ln[LANES];
};

template <bool LABS, int G>
__global__ void __launch_bounds__(LANES * G, blocks_per_sm<G>())
table_poly_multi_event_chunked(const __grid_constant__ TablePolyMultiArgs a) {
  constexpr int WPT = wpt<G>();
  extern __shared__ float dyn[];
  __shared__ LaneSharedC s;
  const int W = a.W, P = a.npanels, H = a.H;
  const int l = threadIdx.x, r = threadIdx.y;
  const int tid = r * LANES + l;
  const long long N = a.N;
  const int n = blockIdx.x * LANES + l;
  const bool valid = n < a.N;
  float* s_oc = dyn;                          // (3H, W)
  float* sI = s_oc + 3 * H * W + l;           // [H][LANES]: I[h]
  float* srho = sI + H * LANES;               // [H][LANES]: rho_s[h]
  float* tQ = srho + H * LANES;               // [W][LANES] each
  float* tQH = tQ + W * LANES;
  float* tD = tQH + W * LANES;                // qd's terms, then D
  const float* kext = s_oc;                   // kext[h * W + w]
  const float* ksca = s_oc + H * W;
  const float* gg = s_oc + 2 * H * W;
  const float* u = a.u;

  // -- the constants; the panels stay in device memory -------------------
  const bool live = valid && a.alive[n] != 0;
  const float* rg = a.r + n;                  // rho(h, k) at rg[(h P + k) N]
  for (int i = tid; i < 3 * H * W; i += LANES * G) s_oc[i] = a.oc[i];
  if (r == 0) {
    s.any_ln[l] = 0;
    s.wsel[l] = 0;
  }
  __syncthreads();
  // the driver's optical-depth step of panel k at wavelength c
  auto driver_dk = [&](int c, int k) {
    float dk = 0.f;
    for (int h = 0; h < H; ++h)
      dk = dk + kext[h * W + c] * rg[((long long)h * P + k) * N];
    return dk;
  };

  // -- pass A, one role per ordered sum: the driver's cumulative optical
  //    depth, the per-component integrals --------------------------------
  if (live) {
    const float delta = a.dt[n];
    for (int q = r; q <= H; q += G) {
      if (q == 0) {
        const int c = min((int)(u[5 * N + n] * (float)W), W - 1);
        float cumc = 0.f;
        for (int k = 0; k < P; ++k) {
          cumc = cumc + driver_dk(c, k) * delta;
          if ((k & (CH - 1)) == CH - 1 || k == P - 1)
            a.cend[(k / CH) * N + n] = cumc;
        }
        s.tau_c[l] = cumc;
      } else {
        const int h = q - 1;
        float I = 0.f;
        const float* rh = rg + (long long)h * P * N;
#pragma unroll 4
        for (int k = 0; k < P; ++k) I = I + rh[k * N] * delta;
        sI[h * LANES] = I;
      }
    }
  }
  __syncthreads();

  // -- interaction and deposit samples in driver-tau space; the scattering
  //    component drawn at the driver wavelength and its HG cosine ---------
  if (live && r < 2) {
    const float tau_c = s.tau_c[l];
    const float delta = a.dt[n];
    const int c = min((int)(u[5 * N + n] * (float)W), W - 1);
    const float* ends = a.cend + n;
    float wc = 0.f;
    auto restart = [&](int cc) {
      wc = cc > 0 ? ends[(cc - 1) * N] : 0.f;
      return wc;
    };
    auto next = [&](int k) {
      wc = wc + driver_dk(c, k) * delta;
      return wc;
    };
    // invert over the driver's running sums, walked in chunks
    auto invert_c = [&](float target, int& i_hit, float& frac) {
      float cum_hi, cum_prev;
      i_hit = chunk_invert(ends, N, P - 1, target, restart, next, cum_hi,
                           cum_prev);
      const float dtau = cum_hi - cum_prev;
      const float fr =
          dtau > 0.f ? (target - cum_prev) / fmaxf(dtau, TINY) : 0.f;
      frac = fminf(fmaxf(fr, 0.f), 1.f);
    };
    if (r == 0) {
      const float xi = a.xi;
      const float u1 = u[n], u2 = u[N + n];
      const float tau_exp = expon_cutoff(u2, tau_c);
      const float tau_smp =
          xi == 0.f ? tau_exp : (u1 < xi ? u2 * tau_c : tau_exp);
      int ks_i;
      float ks_f;
      invert_c(tau_smp, ks_i, ks_f);
      s.ks_i[l] = ks_i;
      s.ks_f[l] = ks_f;
      // the components' densities at the interaction panel, and the
      // scattering component drawn ~ ksca_h rho_h at the driver wavelength
      float total_wv = 0.f;
      for (int h = 0; h < H; ++h) {
        const float rs = rg[((long long)h * P + ks_i) * N];
        srho[h * LANES] = rs;
        const float wv = ksca[h * W + c] * rs;
        total_wv = h == 0 ? wv : total_wv + wv;
      }
      const float u_comp = u[7 * N + n] * fmaxf(total_wv, TINY);
      float g_sel = gg[c];
      float acc = ksca[c] * srho[0];
      for (int h = 1; h < H; ++h) {
        if (u_comp > acc) g_sel = gg[h * W + c];
        acc = acc + ksca[h * W + c] * srho[h * LANES];
      }
      s.costheta[l] = hg_costheta(g_sel, u[3 * N + n]);
    } else {
      const float tau_dep = expon_cutoff(u[2 * N + n], tau_c);
      int kd_i;
      float kd_f;
      invert_c(tau_dep, kd_i, kd_f);
      s.kd_i[l] = kd_i;
      s.kd_f[l] = kd_f;
    }
  }
  __syncthreads();

  // -- w pass 1, one panel walk per (lane, w): the terms of Qmix, QHmix
  //    and the deposit's qd; what the later passes need stays in
  //    registers ------------------------------------------------------------
  float v_ksca_s[WPT], v_e_s[WPT], v_num[WPT], v_kd[WPT], v_e_d[WPT];
  if (live) {
    const float delta = a.dt[n];
    const float xi = a.xi;
    const int ks_i = s.ks_i[l], kd_i = s.kd_i[l];
    const float ks_f = s.ks_f[l], kd_f = s.kd_f[l];
    const float costheta = s.costheta[l];
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        const PointSums ps = point_sums_g(rg, N, kext, ksca, W, w, P, H,
                                          ks_i, ks_f, kd_i, kd_f, delta);
        float tau = kext[w] * sI[0];
        for (int h = 1; h < H; ++h)
          tau = tau + kext[h * W + w] * sI[h * LANES];
        const float ome = 1.f - expf(-tau);
        if (LABS) {
          v_e_d[j] = expf(-ps.cum_d);
          v_kd[j] = ps.kmix_d - ps.ksca_d;
          tD[w * LANES] = ps.kmix_d * v_e_d[j] / fmaxf(ome, TINY);
        }
        v_e_s[j] = expf(-ps.cum_s);
        const float F = ps.kmix_s * v_e_s[j] / fmaxf(ome, TINY);
        const float Q = xi == 0.f
                            ? F
                            : a.one_m_xi * F + xi * ps.kmix_s / fmaxf(tau, TINY);
        tQ[w * LANES] = Q;
        float num = ksca[w] * srho[0] * hg(gg[w], costheta);
        for (int h = 1; h < H; ++h)
          num = num + ksca[h * W + w] * srho[h * LANES] *
                          hg(gg[h * W + w], costheta);
        v_num[j] = num;
        v_ksca_s[j] = ps.ksca_s;
        tQH[w * LANES] = Q * (num / fmaxf(ps.ksca_s, TINY));
      }
    }
  }
  __syncthreads();

  // -- the sums over w in BlockSum's order: with several blocks, each
  //    block's in-order partial on a role of its own (written over the
  //    block's first term), then one role per sum adds the partials in
  //    order ---------------------------------------------------------------
  const int B = a.sum_block, nb = W / B;
  if (nb > 1) {
    if (live)
      for (int t = r; t < (2 + LABS) * nb; t += G) {
        const int q = t / nb, b = t - q * nb;
        float* terms = (q == 0 ? tQ : (q == 1 ? tQH : tD)) + b * B * LANES;
        terms[0] = block_part<LANES>(terms, B);
      }
    __syncthreads();
  }
  if (live) {
    for (int q = r; q < 2 + LABS; q += G) {
      const float* t = q == 0 ? tQ : (q == 1 ? tQH : tD);
      const float m = fmaxf(
          block_total<LANES>(t, nb > 1 ? t : nullptr, B * LANES, nb, B) *
              a.inv_W,
          TINY);
      if (q == 0) s.Qmix[l] = m;
      else if (q == 1) s.QHmix[l] = m;
      else s.qd[l] = m;
    }
  }
  __syncthreads();

  // -- the absorption deposit at s_dep, one wavelength drawn: the D terms,
  //    their sum, their Hillis-Steele prefix (each step's reads first) and
  //    the count of prefix values at or below the target ----------------
  if (LABS && live) {
    const float qd = s.qd[l];
    const bool dep_ok = s.tau_c[l] > TINY;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        const float D = a.L[w * N + n] * v_kd[j] * v_e_d[j] / qd;
        tD[w * LANES] = dep_ok ? D : 0.f;
      }
    }
  }
  __syncthreads();
  // sum D as above, the partials in the slots of Qmix's terms (tD keeps
  // the terms for the prefix); the prefix's first writes come after its
  // first barrier, so the total needs none of its own
  if (LABS && nb > 1) {
    if (live)
      for (int b = r; b < nb; b += G)
        tQ[b * B * LANES] = block_part<LANES>(tD + b * B * LANES, B);
    __syncthreads();
  }
  if (LABS && live && r == 0)
    s.Dsum[l] =
        block_total<LANES>(tD, nb > 1 ? tQ : nullptr, B * LANES, nb, B);
  if (LABS) prefix_smem<LANES, WPT>(tD, W, r, G, live);
  if (LABS && live && W > 1) {
    const float target = u[6 * N + n] * s.Dsum[l];
    const int cnt = count_le<LANES, WPT>(tD, W - 1, r, G, target);
    if (cnt) atomicAdd(&s.wsel[l], cnt);
  }

  // -- w pass 3: peel and onward weights, per-wavelength weight cut -------
  if (live) {
    const float Qmix = s.Qmix[l], QHmix = s.QHmix[l];
    const bool past_min = a.ns[n] >= a.min_scatt;
    bool any_ln = false;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int w = r + G * j;
      if (w < W) {
        const float Lm = a.L[w * N + n];
        float Lp = Lm * v_ksca_s[j] * v_e_s[j] / Qmix;
        float Ln = Lm * v_num[j] * v_e_s[j] / QHmix;
        if (past_min && Ln <= a.L0[w * N + n] * a.inv_minred) {
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

  // -- the lane's state: move to the interaction point and HG scatter about
  //    the old direction; dead lanes' weights zero ------------------------
  const bool alive = live && s.any_ln[l] != 0 && s.tau_c[l] > TINY;
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
    float X = a.px[n], Y = a.py[n], Z = a.pz[n];
    float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
    int nscatt = a.ns[n];
    if (LABS) {
      int depi = -1;
      float depv = 0.f;
      if (live) {
        const float t0 = a.t0[n], delta = a.dt[n];
        const float s_dep = t0 + ((float)s.kd_i[l] + s.kd_f[l]) * delta;
        const float Dsum = s.Dsum[l];
        const int cell = locate(a.geo, X + s_dep * DX, Y + s_dep * DY,
                                Z + s_dep * DZ);
        if (Dsum > 0.f && cell >= 0) {
          depi = cell * W + s.wsel[l];
          depv = Dsum;
        }
      }
      a.odepi[n] = depi;
      a.odepv[n] = depv;
    }
    if (alive) {
      const float t0 = a.t0[n], delta = a.dt[n];
      const float sp = t0 + ((float)s.ks_i[l] + s.ks_f[l]) * delta;
      X = X + sp * DX;
      Y = Y + sp * DY;
      Z = Z + sp * DZ;
      scatter_direction(s.costheta[l], u[4 * N + n], DX, DY, DZ);
      nscatt += 1;
    }
    a.opx[n] = X;
    a.opy[n] = Y;
    a.opz[n] = Z;
    a.odx[n] = DX;
    a.ody[n] = DY;
    a.odz[n] = DZ;
    a.oalive[n] = alive ? 1 : 0;
    a.ons[n] = nscatt;
  }
}


// dynamic shared memory of a launch: the constants, the panel rows, the
// driver's cumulative sums and the term slots
__host__ __device__ constexpr size_t smem_floats(int H, bool LABS, int W,
                                                 int P) {
  return (size_t)3 * H * W + (size_t)(H + 1) * P * LANES +
         (size_t)(2 + LABS) * W * LANES;
}

template <int H, bool LABS, int G>
int launch_g(const TablePolyMultiArgs& a, cudaStream_t s) {
  const int blocks = (a.N + LANES - 1) / LANES;
  if (blocks <= 0) return (int)cudaGetLastError();
  static bool raised[64];
  const int e = raise_smem_limit(
      table_poly_multi_event_kernel<H, LABS, G>,
      smem_floats(H, LABS, MAX_W, MAXP) * sizeof(float), raised);
  if (e) return e;
  const size_t smem = smem_floats(H, LABS, a.W, a.npanels) * sizeof(float);
  table_poly_multi_event_kernel<H, LABS, G><<<blocks, dim3(LANES, G), smem,
                                              s>>>(a);
  return (int)cudaGetLastError();
}

template <int H, bool LABS>
int launch(const TablePolyMultiArgs& a, cudaStream_t s) {
  if (a.W <= 2 * wpt<2>()) return launch_g<H, LABS, 2>(a, s);
  if (a.W <= 8 * wpt<8>()) return launch_g<H, LABS, 8>(a, s);
  return launch_g<H, LABS, 16>(a, s);
}

// the chunked route's dynamic shared memory: the constants, I[h] and
// rho_s[h], the term slots
__host__ __device__ constexpr size_t smem_floats_c(int H, bool LABS, int W) {
  return (size_t)3 * H * W + (size_t)2 * H * LANES +
         (size_t)(2 + LABS) * W * LANES;
}

template <bool LABS, int G>
int launch_cg(const TablePolyMultiArgs& a, cudaStream_t s) {
  const int blocks = (a.N + LANES - 1) / LANES;
  if (blocks <= 0) return (int)cudaGetLastError();
  const size_t smem = smem_floats_c(a.H, LABS, a.W) * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        table_poly_multi_event_chunked<LABS, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  table_poly_multi_event_chunked<LABS, G>
      <<<blocks, dim3(LANES, G), smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool LABS>
int launch_c(const TablePolyMultiArgs& a, cudaStream_t s) {
  if (a.W <= 2 * wpt<2>()) return launch_cg<LABS, 2>(a, s);
  if (a.W <= 8 * wpt<8>()) return launch_cg<LABS, 8>(a, s);
  return launch_cg<LABS, 16>(a, s);
}

}  // namespace

extern "C" int skirt_table_poly_multi_args_size() {
  return (int)sizeof(TablePolyMultiArgs);
}

extern "C" int skirt_table_poly_multi_event(const TablePolyMultiArgs* a,
                                            int labs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->W < 1 || a->W > MAX_W || a->H < 2 || a->npanels < 1 ||
      a->sum_block < 1 || a->W % a->sum_block != 0)
    return (int)cudaErrorInvalidValue;
  if (a->npanels > MAXP || a->H > MAX_H) {
    if (!a->cend) return (int)cudaErrorInvalidValue;
    return labs ? launch_c<true>(*a, s) : launch_c<false>(*a, s);
  }
  if (a->H == 2) return labs ? launch<2, true>(*a, s) : launch<2, false>(*a, s);
  return labs ? launch<3, true>(*a, s) : launch<3, false>(*a, s);
}
