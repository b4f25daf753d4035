// K7: polychromatic multi-component table-mode event, one thread per lane.
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
// direction's normalisation).
//
// Work per live lane and event: it reads H P panel values, 2 x W
// luminosities and ~16 words, writes 2 x W luminosities and 10 words.  The
// function needs one walk over the H P panels per wavelength, ~5 exp and H
// HG evaluations; this kernel walks the panels three times per wavelength
// and evaluates the HG blend twice (below), ~2.6x the operations at W = 128,
// H = 2, P = 24.  At W = 2, N = 2^17 the event moves ~40 MB, so the least
// time is set by bytes; at W = 24 and 128 (N = 2^15) by bytes and by the
// function's operations about equally (chip_smoke.py's k7_ops).
//
// Design:
// - One thread per lane, the W axis a loop inside the thread (K1's and K6's
//   layout): L, L0, Ln, Lp are (W, N), coalesced at a fixed w.  The (3H, W)
//   constants sit in shared memory.
// - The lane's H x P raw panel densities are read once into registers
//   (H x MAXP floats, guarded and fully unrolled, so every index is
//   constant); H is a template parameter (2 or 3), MAXP = 32 panels.
// - Pass A over the panels: the driver wavelength's cumulative optical depth
//   (in registers, for the two inversions) and the per-component integrals.
//   The driver's kappa_ext, kappa_sca and g are direct reads of element c
//   (the Pallas body's one-hot sums over w add one element to zeros).
// - Pass B of the Pallas body keeps six W-long accumulators (the optical
//   depths up to the interaction and the deposit points, and the blended
//   kappa_ext and kappa_sca at both).  Here the order is w outer, panel
//   inner: for one w the six are scalars, summed over the panels in the
//   panel order of the Pallas body, so each is bit for bit its (w, lane)
//   element.  The sums over w (Qmix, QHmix, the deposit normaliser qd, sum
//   D) need all w before the weights can be formed, so the panel walk for a
//   w is repeated in each of the three w passes instead of storing 6 x W
//   floats per lane: registers hold the panels, and nothing spills to local
//   memory but the W absorbed-power values of the deposit prefix.
// - The sums over w take XLA's CPU order (BlockSum with sum_block, K6's), and
//   the deposit wavelength is chosen against the Hillis-Steele prefix of the
//   W absorbed powers in a per-thread array (local memory, W <= 128).
// - Dead lanes copy their state through with zero weights.

#include "common.cuh"

namespace {

constexpr int MAX_W = 128;
constexpr int MAX_H = 3;

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
};

namespace {

// the Pallas body's pass-B values of one wavelength w: the optical depth up
// to the interaction (s) and deposit (d) points, and the blended kappa_ext
// and kappa_sca of the panel each lies in
struct PointSums {
  float cum_s, cum_d, kmix_s, ksca_s, kmix_d, ksca_d;
};

template <int H>
__device__ __forceinline__ PointSums point_sums(
    const float (&rho)[H][MAXP], const float* kext, const float* ksca, int W,
    int w, int npanels, int ks_i, float ks_f, int kd_i, float kd_f,
    float delta) {
  PointSums p = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    if (k < npanels) {
      float dtau = kext[w] * rho[0][k];
      float ks = ksca[w] * rho[0][k];
#pragma unroll
      for (int h = 1; h < H; ++h) {
        dtau = dtau + kext[h * W + w] * rho[h][k];
        ks = ks + ksca[h * W + w] * rho[h][k];
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

// panel of the driver's cumulative optical depths where target lands and
// the fraction into it (the Pallas body's invert)
__device__ __forceinline__ void invert(const float (&cums)[MAXP],
                                       int npanels, float target, int& i_hit,
                                       float& frac) {
  i_hit = 0;
#pragma unroll
  for (int k = 0; k < MAXP - 1; ++k)
    if (k < npanels - 1) i_hit += (cums[k] < target) ? 1 : 0;
  float cum_hi = 0.f, cum_prev = 0.f;
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    if (k == i_hit) cum_hi = cums[k];
    if (k == i_hit - 1) cum_prev = cums[k];
  }
  const float dtau = cum_hi - cum_prev;
  const float fr = dtau > 0.f ? (target - cum_prev) / fmaxf(dtau, TINY) : 0.f;
  frac = fminf(fmaxf(fr, 0.f), 1.f);
}

template <int H, bool LABS>
__global__ void __launch_bounds__(128)
table_poly_multi_event_kernel(const __grid_constant__ TablePolyMultiArgs a) {
  __shared__ float s_oc[3 * MAX_H * MAX_W];
  const int W = a.W;
  for (int i = threadIdx.x; i < 3 * H * W; i += blockDim.x) s_oc[i] = a.oc[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const long long N = a.N;
  const int P = a.npanels;
  const float* kext = s_oc;               // kext[h * W + w]
  const float* ksca = s_oc + H * W;
  const float* gg = s_oc + 2 * H * W;
  const float* u = a.u;

  float X = a.px[n], Y = a.py[n], Z = a.pz[n];
  float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
  int nscatt = a.ns[n];
  bool alive = false;

  int depi = -1;
  float depv = 0.f;
  if (a.alive[n] != 0) {
    const float t0 = a.t0[n], delta = a.dt[n];
    const float xi = a.xi;

    // -- driver wavelength and its per-component kappas -------------------
    const int c = min((int)(u[5 * N + n] * (float)W), W - 1);

    // -- pass A: the lane's panels, the driver's cumulative optical depth,
    // the per-component integrals ------------------------------------------
    float rho[H][MAXP];
    float cums[MAXP];
    float cumc = 0.f;
    float I[H];
#pragma unroll
    for (int h = 0; h < H; ++h) I[h] = 0.f;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (k < P) {
        float dk = 0.f;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          rho[h][k] = a.r[(h * P + k) * N + n];
          dk = dk + kext[h * W + c] * rho[h][k];
          I[h] = I[h] + rho[h][k] * delta;
        }
        cumc = cumc + dk * delta;
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) rho[h][k] = 0.f;
      }
      cums[k] = cumc;
    }
    const float tau_c = cumc;

    // -- interaction and deposit samples in driver-tau space --------------
    const float u1 = u[n], u2 = u[N + n];
    const float tau_exp = expon_cutoff(u2, tau_c);
    const float tau_smp =
        xi == 0.f ? tau_exp : (u1 < xi ? u2 * tau_c : tau_exp);
    const float tau_dep = expon_cutoff(u[2 * N + n], tau_c);
    int ks_i, kd_i;
    float ks_f, kd_f;
    invert(cums, P, tau_smp, ks_i, ks_f);
    invert(cums, P, tau_dep, kd_i, kd_f);
    const float s = t0 + ((float)ks_i + ks_f) * delta;
    const float s_dep = t0 + ((float)kd_i + kd_f) * delta;
    float rho_s[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      rho_s[h] = 0.f;
#pragma unroll
      for (int k = 0; k < MAXP; ++k)
        if (k == ks_i) rho_s[h] = rho[h][k];
    }

    // -- scatter: the component drawn at the driver wavelength ------------
    float wv[H];
#pragma unroll
    for (int h = 0; h < H; ++h) wv[h] = ksca[h * W + c] * rho_s[h];
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
    const float costheta = hg_costheta(g_sel, u[3 * N + n]);

    // -- w pass 1: the mixture sums Qmix, QHmix and the deposit's qd ------
    BlockSum qsum, qhsum, qdsum;
    for (int w = 0; w < W; ++w) {
      const PointSums ps =
          point_sums<H>(rho, kext, ksca, W, w, P, ks_i, ks_f, kd_i, kd_f,
                        delta);
      float tau = kext[w] * I[0];
#pragma unroll
      for (int h = 1; h < H; ++h) tau = tau + kext[h * W + w] * I[h];
      const float ome = 1.f - expf(-tau);
      if (LABS)
        qdsum.add(ps.kmix_d * expf(-ps.cum_d) / fmaxf(ome, TINY), a.sum_block);
      const float F = ps.kmix_s * expf(-ps.cum_s) / fmaxf(ome, TINY);
      const float Q = xi == 0.f
                          ? F
                          : a.one_m_xi * F + xi * ps.kmix_s / fmaxf(tau, TINY);
      qsum.add(Q, a.sum_block);
      float num = ksca[w] * rho_s[0] * hg(gg[w], costheta);
#pragma unroll
      for (int h = 1; h < H; ++h)
        num = num + ksca[h * W + w] * rho_s[h] * hg(gg[h * W + w], costheta);
      qhsum.add(Q * (num / fmaxf(ps.ksca_s, TINY)), a.sum_block);
    }

    // -- w pass 2: the absorption deposit at s_dep, one wavelength drawn --
    if (LABS) {
      const float qd = fmaxf(qdsum.total * a.inv_W, TINY);
      const bool dep_ok = tau_c > TINY;
      float cD[MAX_W];
      BlockSum dsum;
      for (int w = 0; w < W; ++w) {
        const PointSums ps =
            point_sums<H>(rho, kext, ksca, W, w, P, ks_i, ks_f, kd_i, kd_f,
                          delta);
        const float D = a.L[w * N + n] * (ps.kmix_d - ps.ksca_d) *
                        expf(-ps.cum_d) / qd;
        cD[w] = dep_ok ? D : 0.f;
        dsum.add(cD[w], a.sum_block);
      }
      const float Dsum = dsum.total;
      int wsel = 0;
      if (W > 1) {
        for (int st = 1; st < W; st *= 2)
          for (int i = W - 1; i >= st; --i) cD[i] = cD[i] + cD[i - st];
        const float target = u[6 * N + n] * Dsum;
        for (int w = 0; w < W - 1; ++w) wsel += (cD[w] <= target) ? 1 : 0;
      }
      const int cell = locate(a.geo, X + s_dep * DX, Y + s_dep * DY,
                              Z + s_dep * DZ);
      if (Dsum > 0.f && cell >= 0) {
        depi = cell * W + wsel;
        depv = Dsum;
      }
    }

    // -- w pass 3: peel and onward weights, per-wavelength weight cut -----
    const float Qmix = fmaxf(qsum.total * a.inv_W, TINY);
    const float QHmix = fmaxf(qhsum.total * a.inv_W, TINY);
    const bool past_min = nscatt >= a.min_scatt;
    bool any_ln = false;
    for (int w = 0; w < W; ++w) {
      const PointSums ps =
          point_sums<H>(rho, kext, ksca, W, w, P, ks_i, ks_f, kd_i, kd_f,
                        delta);
      const float e_s = expf(-ps.cum_s);
      float num = ksca[w] * rho_s[0] * hg(gg[w], costheta);
#pragma unroll
      for (int h = 1; h < H; ++h)
        num = num + ksca[h * W + w] * rho_s[h] * hg(gg[h * W + w], costheta);
      const float Lm = a.L[w * N + n];
      float Lp = Lm * ps.ksca_s * e_s / Qmix;
      float Ln = Lm * num * e_s / QHmix;
      if (past_min && Ln <= a.L0[w * N + n] * a.inv_minred) {
        Lp = 0.f;
        Ln = 0.f;
      }
      any_ln = any_ln || (Ln > 0.f);
      a.oLn[w * N + n] = Ln;
      a.oLp[w * N + n] = Lp;
    }
    alive = any_ln && (tau_c > TINY);

    // -- move to the interaction point, HG scatter about the old direction
    if (alive) {
      X = X + s * DX;
      Y = Y + s * DY;
      Z = Z + s * DZ;
      scatter_direction(costheta, u[4 * N + n], DX, DY, DZ);
      nscatt += 1;
    }
  }
  if (!alive) {
    for (int w = 0; w < W; ++w) {
      a.oLn[w * N + n] = 0.f;
      a.oLp[w * N + n] = 0.f;
    }
  }
  if (LABS) {
    a.odepi[n] = depi;
    a.odepv[n] = depv;
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

template <int H, bool LABS>
int launch(const TablePolyMultiArgs& a, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (a.N + threads - 1) / threads;
  if (blocks > 0)
    table_poly_multi_event_kernel<H, LABS><<<blocks, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int skirt_table_poly_multi_args_size() {
  return (int)sizeof(TablePolyMultiArgs);
}

extern "C" int skirt_table_poly_multi_event(const TablePolyMultiArgs* a,
                                            int labs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->W < 1 || a->W > MAX_W || a->H < 2 || a->H > MAX_H ||
      a->npanels < 1 || a->npanels > MAXP || a->sum_block < 1 ||
      a->W % a->sum_block != 0)
    return (int)cudaErrorInvalidValue;
  if (a->H == 2) return labs ? launch<2, true>(*a, s) : launch<2, false>(*a, s);
  return labs ? launch<3, true>(*a, s) : launch<3, false>(*a, s);
}
