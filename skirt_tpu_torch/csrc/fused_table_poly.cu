// K6: polychromatic table-mode scattering event, one thread per lane; K6d,
// its variant for direct-table grids (the exact Voronoi tessellation, an
// uneven Cartesian grid) that emits the deposit distance; and K6p, either
// of them with the two column densities the polarized driver needs.
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
// -fmad=false; 1 - exp(-tau), never expm1; hg() as (1-g)(1+g)/sqrt(t t t)).
//
// What bounds it on the H100: arithmetic on the lane.  Per lane and event
// it reads P panel values, 2 x W luminosities and ~17 words, writes 2 x W
// luminosities and 10 words, and evaluates ~5 exp per wavelength (three
// passes over w recompute exp(-kappa_w I)).  At W = 24, N = 2^15 lanes
// that is ~15 MB and ~4 x 10^7 operations per event.  K6p writes 8 bytes
// per lane more.
//
// Design:
// - One thread per lane with a loop over W inside the thread (not the
//   TPU's (W, rows, 128) tile), as K1 does: L, L0, Ln, Lp are (W, N), so at
//   a fixed w neighbouring threads touch neighbouring addresses.  The
//   (3, W) optical constants sit in shared memory; the lane's P cumulative
//   column densities in registers (MAXP = 32).
// - The deposit wavelength is chosen against the Pallas body's cumsum_w, a
//   Hillis-Steele prefix sum (log2 W shifted adds), not a running sum: the
//   lane's W absorbed luminosities go to a per-thread array (local memory,
//   W <= 128) and are prefixed in place, high index first, so each step
//   adds the previous step's values as the shifted concatenation does.
// - Sum D, Qmix and QHmix are jnp.sum over w in the Pallas body; XLA's CPU
//   backend (the interpret-mode reference) sums blocks of B consecutive
//   wavelengths in order, B the largest divisor of W not above 32, and then
//   the block sums in order.  The kernel and its plain version take the
//   same order (sum_block = B, from the wrapper).
// - Dead lanes copy their state through with zero weights (the Pallas body
//   computes them and masks them out).
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

#include "common.cuh"

namespace {

constexpr int MAX_W = 128;

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
};

namespace {

// The whole path's column density: the panels' running sum I_k, kept in
// cums (the deposit and the interaction point invert it).
__device__ __forceinline__ float path_column(const TablePolyArgs& a, int n,
                                             float delta, float* cums) {
  const long long N = a.N;
  float cum = 0.f;
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    if (k < a.npanels) cum = cum + a.r[k * N + n] * delta;
    cums[k] = cum;
  }
  return cum;
}

// The driver wavelength c, uniform in [0, W) from the uniform row u[5].
__device__ __forceinline__ int driver_wavelength(const TablePolyArgs& a,
                                                 int n) {
  return min((int)(a.u[5LL * a.N + n] * (float)a.W), a.W - 1);
}

// The column density at the interaction point, drawn at the driver
// wavelength c from the uniform-driver mixture: I_s = tau_smp / kappa_c.
__device__ __forceinline__ float interaction_column(const TablePolyArgs& a,
                                                    const float* kext, int n,
                                                    int c, float I_tot) {
  const long long N = a.N;
  const float tau_c = kext[c] * I_tot;
  const float kinv_cc = 1.f / kext[c];
  const float u1 = a.u[n], u2 = a.u[N + n];
  const float tau_exp = expon_cutoff(u2, tau_c);
  const float tau_smp =
      a.xi == 0.f ? tau_exp : (u1 < a.xi ? u2 * tau_c : tau_exp);
  return tau_smp * kinv_cc;
}

template <bool LABS, bool DIRECT, bool POL>
__global__ void __launch_bounds__(128)
table_poly_event_kernel(const __grid_constant__ TablePolyArgs a) {
  __shared__ float s_oc[3 * MAX_W];
  const int W = a.W;
  for (int i = threadIdx.x; i < 3 * W; i += blockDim.x) s_oc[i] = a.oc[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const long long N = a.N;
  const float* kext = s_oc;
  const float* alb = s_oc + W;
  const float* gw = s_oc + 2 * W;
  const float* u = a.u;

  float X = a.px[n], Y = a.py[n], Z = a.pz[n];
  float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
  int nscatt = a.ns[n];
  bool alive = false;

  int depi = -1;
  float depv = 0.f, depd = -1.f;
  float I_s = 0.f, I_tot = 0.f;
  if (a.alive[n] != 0) {
    const float t0 = a.t0[n], delta = a.dt[n];

    // -- cumulative column density I_k (lambda-independent) -------------
    float cums[MAXP];
    I_tot = path_column(a, n, delta, cums);

    // -- absorption deposit: one sampled wavelength per event -----------
    if (LABS) {
      float cD[MAX_W];
      BlockSum dsum;
      for (int w = 0; w < W; ++w) {
        const float ome = 1.f - expf(-(kext[w] * I_tot));
        cD[w] = (1.f - alb[w]) * a.L[w * N + n] * ome;
        dsum.add(cD[w], a.sum_block);
      }
      const float Dsum = dsum.total;
      int wsel = 0;
      if (W > 1) {
        for (int s = 1; s < W; s *= 2)
          for (int i = W - 1; i >= s; --i) cD[i] = cD[i] + cD[i - s];
        const float target = u[6 * N + n] * Dsum;
        for (int w = 0; w < W - 1; ++w) wsel += (cD[w] <= target) ? 1 : 0;
      }
      const float tau_sel = kext[wsel] * I_tot;
      const float kinv_sel = 1.f / kext[wsel];
      const float I_dep = expon_cutoff(u[2 * N + n], tau_sel) * kinv_sel;
      int i_dep = 0;
#pragma unroll
      for (int k = 0; k < MAXP - 1; ++k)
        if (k < a.npanels - 1) i_dep += (cums[k] < I_dep) ? 1 : 0;
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

    // -- mixture-driver forced propagation -------------------------------
    const int c = driver_wavelength(a, n);
    I_s = interaction_column(a, kext, n, c, I_tot);
    int i_hit = 0;
#pragma unroll
    for (int k = 0; k < MAXP - 1; ++k)
      if (k < a.npanels - 1) i_hit += (cums[k] < I_s) ? 1 : 0;
    float cum_h = 0.f, cum_prev = 0.f;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (k == i_hit) cum_h = cums[k];
      if (k == i_hit - 1) cum_prev = cums[k];
    }
    const float dI_h = cum_h - cum_prev;
    const float fr = dI_h > 0.f ? (I_s - cum_prev) / fmaxf(dI_h, TINY) : 0.f;
    const float frac = fminf(fmaxf(fr, 0.f), 1.f);
    const float s = t0 + ((float)i_hit + frac) * delta;
    X = X + s * DX;
    Y = Y + s * DY;
    Z = Z + s * DZ;

    // -- per-wavelength mixture ratios: Qmix, QHmix ----------------------
    const float costheta = hg_costheta(gw[c], u[3 * N + n]);
    const float xi = a.xi;
    BlockSum qsum, qhsum;
    for (int w = 0; w < W; ++w) {
      const float kx = kext[w];
      const float tau = kx * I_tot;
      const float ome = 1.f - expf(-tau);
      const float F = kx * expf(-kx * I_s) / fmaxf(ome, TINY);
      const float Q =
          xi == 0.f ? F : a.one_m_xi * F + xi * kx / fmaxf(tau, TINY);
      qsum.add(Q, a.sum_block);
      qhsum.add(Q * hg(gw[w], costheta), a.sum_block);
    }
    const float Qmix = fmaxf(qsum.total * a.inv_W, TINY);
    const float QHmix = fmaxf(qhsum.total * a.inv_W, TINY);

    // -- peel and onward weights, per-wavelength weight cut --------------
    const bool past_min = nscatt >= a.min_scatt;
    bool any_ln = false;
    for (int w = 0; w < W; ++w) {
      const float kx = kext[w];
      const float tau = kx * I_tot;
      const float ome = 1.f - expf(-tau);
      const float F = kx * expf(-kx * I_s) / fmaxf(ome, TINY);
      const float Lab = alb[w] * a.L[w * N + n] * ome;
      float Lp = Lab * F / Qmix;
      float Ln = Lab * F * hg(gw[w], costheta) / QHmix;
      if (past_min && Ln <= a.L0[w * N + n] * a.inv_minred) {
        Lp = 0.f;
        Ln = 0.f;
      }
      any_ln = any_ln || (Ln > 0.f);
      a.oLn[w * N + n] = Ln;
      a.oLp[w * N + n] = Lp;
    }
    alive = any_ln && (I_tot > TINY);

    // -- HG scatter about the old direction (driver g) -------------------
    if (alive) {
      scatter_direction(costheta, u[4 * N + n], DX, DY, DZ);
      nscatt += 1;
    }
  } else if (POL) {
    float cums[MAXP];
    I_tot = path_column(a, n, a.dt[n], cums);
    I_s = interaction_column(a, kext, n, driver_wavelength(a, n), I_tot);
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
    if (DIRECT) a.odepd[n] = depd;
  }
  a.opx[n] = X;
  a.opy[n] = Y;
  a.opz[n] = Z;
  a.odx[n] = DX;
  a.ody[n] = DY;
  a.odz[n] = DZ;
  a.oalive[n] = alive ? 1 : 0;
  a.ons[n] = nscatt;
  if (POL) {
    a.oIs[n] = I_s;
    a.oIt[n] = I_tot;
  }
}

template <bool LABS, bool DIRECT, bool POL>
int launch(const TablePolyArgs& a, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (a.N + threads - 1) / threads;
  if (blocks > 0)
    table_poly_event_kernel<LABS, DIRECT, POL><<<blocks, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool POL>
int launch_pol(const TablePolyArgs& a, int labs, cudaStream_t s) {
  // without labs the direct and arithmetic-locate variants write the same
  // outputs
  if (!labs) return launch<false, false, POL>(a, s);
  return a.direct ? launch<true, true, POL>(a, s)
                  : launch<true, false, POL>(a, s);
}

}  // namespace

extern "C" int skirt_table_poly_args_size() {
  return (int)sizeof(TablePolyArgs);
}

extern "C" int skirt_table_poly_event(const TablePolyArgs* a, int labs,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->W < 1 || a->W > MAX_W || a->npanels < 1 || a->npanels > MAXP ||
      a->sum_block < 1 || a->W % a->sum_block != 0)
    return (int)cudaErrorInvalidValue;
  return a->pol ? launch_pol<true>(*a, labs, s)
                : launch_pol<false>(*a, labs, s);
}
