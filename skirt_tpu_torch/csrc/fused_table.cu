// K4: monochromatic table-mode scattering event, one thread per lane, and
// K4d, its variant for direct-table grids (the exact Voronoi tessellation,
// an uneven Cartesian grid) that emits the deposit distance.
//
// Replaces: skirt_tpu/engine/fused_table.py:83 `_build_kernel` (the Pallas
// body at :110-243), called at :672: K4 with arith_locate, K4d with
// arith_locate=False (:158-166, the float32 distance in the deposit slot,
// :665).  Same input/output
// contract: the staged (P, N) kappa_ext * rho panels and the (5, N)
// uniforms come in as inputs and the kernel draws nothing itself, so the
// plain PyTorch version (engine/fused_table.py::table_event_plain) and this
// kernel see identical inputs.  The arithmetic follows the Pallas body
// operation for operation (built with -fmad=false, so no contraction into
// FMAs; 1 - exp(-tau), never expm1; rsqrtf in the scattering frame).
//
// What bounds it on the H100: bytes.  Per lane and event it reads P panel
// values and 20 words of state and uniforms and writes 11 words, and does
// ~10 flops per panel plus a handful of transcendentals.  At N = 2^17
// lanes and P = 16 that is ~19 MB per event, ~6 us at 3.35 TB/s, against
// ~4 x 10^7 operations (~1 us at 67 TFLOP/s).
//
// Design:
// - One thread per lane; lanes are bounds-checked (the TPU driver pads to
//   whole tiles instead).  kr is panel-major, so at a fixed panel
//   neighbouring threads read neighbouring addresses.
// - Up to MAXP = 32 panels the lane's P cumulative optical depths live in
//   registers: guarded, fully unrolled loops keep every index constant.
// - Dead lanes copy their state through and deposit nothing (the Pallas
//   body computes them and masks every output back to its input).
// - K4: the deposit cell is the arithmetic locate floor((X - lo) * inv)
//   with float32 lo and inv (common.cuh locate, the Pallas body's form).
// - K4d (DIRECT): no locate here.  The deposit's distance along the
//   pre-event ray, mid_dep, goes to odepd (-1 where nothing is deposited)
//   in place of the bin, and the lifecycle locates pos + mid_dep * dir on
//   the grid (engine/fused_table.py).  One float out instead of one int:
//   the bound is K4's.
// - Labs on and off, and K4 / K4d, are template instantiations.
// - Past MAXP panels (CHUNKED, picked by the C entry point): the panels
//   are walked in chunks of CH = 32 (common.cuh chunk_invert): the first
//   pass sums them in order and keeps each chunk's last value in the
//   scratch array cend ((nchunks, N), allocated by the wrapper); each
//   inversion re-reads only the chunk its target falls in and walks it
//   again from the previous chunk's end.  The sums are the one-pass
//   route's to the bit; the panel bytes grow by at most two chunks a lane.

#include "common.cuh"

// Mirrored field for field by kernels.TableArgs (ctypes).
struct TableArgs {
  const float* u;
  const float* kr;
  const float* px;
  const float* py;
  const float* pz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* L;
  const int* alive;
  const int* ns;
  const int* ell;
  const float* L0;
  const float* t0;
  const float* dt;
  const float* alb;
  const float* g;
  float* opx;
  float* opy;
  float* opz;
  float* odx;
  float* ody;
  float* odz;
  float* oL;
  int* oalive;
  int* ons;
  int* odepi;
  float* odepv;
  float* odepd;
  int N, nlambda, npanels, min_scatt, direct;
  float xi, one_m_xi, inv_minred;
  Geom geo;
  float* cend;
};

namespace {

template <bool LABS, bool DIRECT, bool CHUNKED>
__global__ void __launch_bounds__(128)
table_event_kernel(const __grid_constant__ TableArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const long long N = a.N;
  const float* u = a.u;

  float X = a.px[n], Y = a.py[n], Z = a.pz[n];
  float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
  float L = a.L[n];
  bool alive = a.alive[n] != 0;
  int nscatt = a.ns[n];

  int depi = -1;
  float depv = 0.f, depd = -1.f;
  if (alive) {
    const float Lth = a.L0[n] * a.inv_minred;
    const float t0 = a.t0[n], delta = a.dt[n];
    const float albedo = a.alb[n], g = a.g[n];

    // -- cumulative optical depth from the staged panels ------------------
    constexpr int NC = CHUNKED ? 1 : MAXP;
    float cums[NC];
    float cum = 0.f;
    const float* kr = a.kr + n;
    float* ends = CHUNKED ? a.cend + n : nullptr;
    if constexpr (CHUNKED) {
#pragma unroll 4
      for (int k = 0; k < a.npanels; ++k) {
        cum = cum + kr[k * N] * delta;
        if ((k & (CH - 1)) == CH - 1 || k == a.npanels - 1)
          ends[(k / CH) * N] = cum;
      }
    } else {
#pragma unroll
      for (int k = 0; k < MAXP; ++k) {
        if (k < a.npanels) cum = cum + a.kr[k * N + n] * delta;
        cums[k] = cum;
      }
    }
    // the chunked route's walk: restart at chunk c, advance by panel k
    float wc = 0.f;
    auto restart = [&](int c) {
      wc = c > 0 ? ends[(c - 1) * N] : 0.f;
      return wc;
    };
    auto next = [&](int k) {
      wc = wc + kr[k * N] * delta;
      return wc;
    };
    const float taupath = cum;
    const float one_m_e = 1.f - expf(-taupath);
    const float Lm = L;

    // -- sampled absorption deposit ----------------------------------------
    if (LABS) {
      const float D = (1.f - albedo) * Lm * one_m_e;
      const float tau_dep = expon_cutoff(u[2 * N + n], taupath);
      int i_dep = 0;
      if constexpr (CHUNKED) {
        float at, before;
        i_dep = chunk_invert(ends, N, a.npanels - 1, tau_dep, restart, next,
                             at, before);
      } else {
#pragma unroll
        for (int k = 0; k < MAXP - 1; ++k)
          if (k < a.npanels - 1) i_dep += (cums[k] < tau_dep) ? 1 : 0;
      }
      const float mid_dep = t0 + ((float)i_dep + 0.5f) * delta;
      if (DIRECT) {
        if (D > 0.f) {
          depd = mid_dep;
          depv = D;
        }
      } else {
        const int cell = locate(a.geo, X + mid_dep * DX, Y + mid_dep * DY,
                                Z + mid_dep * DZ);
        if (D > 0.f && cell >= 0) {
          depi = cell * a.nlambda + a.ell[n];
          depv = D;
        }
      }
    }

    // -- scattered-luminosity update + termination (pre-bias L) -----------
    L = albedo * Lm * one_m_e;
    alive = (L > 0.f) && !((L <= Lth) && (nscatt >= a.min_scatt)) &&
            (taupath > 0.f);

    // -- forced propagation with the composite bias weight p/q -----------
    const float u1 = u[n], u2 = u[N + n];
    const float tau_exp = expon_cutoff(u2, taupath);
    float tau = tau_exp;
    if (a.xi != 0.f) {
      tau = u1 < a.xi ? u2 * taupath : tau_exp;
      const float p = expf(-tau) / fmaxf(one_m_e, TINY);
      const float qq = a.one_m_xi * p + a.xi / fmaxf(taupath, TINY);
      if (alive) L = L * (p / fmaxf(qq, 1e-37f));
    }
    int i_hit = 0;
    float cum_h = 0.f, cum_prev = 0.f;
    if constexpr (CHUNKED) {
      i_hit = chunk_invert(ends, N, a.npanels - 1, tau, restart, next, cum_h,
                           cum_prev);
    } else {
#pragma unroll
      for (int k = 0; k < MAXP - 1; ++k)
        if (k < a.npanels - 1) i_hit += (cums[k] < tau) ? 1 : 0;
#pragma unroll
      for (int k = 0; k < MAXP; ++k) {
        if (k == i_hit) cum_h = cums[k];
        if (k == i_hit - 1) cum_prev = cums[k];
      }
    }
    const float dtau_h = cum_h - cum_prev;
    const float fr = dtau_h > 0.f ? (tau - cum_prev) / fmaxf(dtau_h, TINY) : 0.f;
    const float frac = fminf(fmaxf(fr, 0.f), 1.f);
    const float s = t0 + ((float)i_hit + frac) * delta;
    if (alive) {
      X = X + s * DX;
      Y = Y + s * DY;
      Z = Z + s * DZ;
      // -- Henyey-Greenstein scatter ---------------------------------------
      scatter_direction(hg_costheta(g, u[3 * N + n]), u[4 * N + n], DX, DY,
                        DZ);
      nscatt += 1;
    }
  }
  if (LABS) {
    if (DIRECT)
      a.odepd[n] = depd;
    else
      a.odepi[n] = depi;
    a.odepv[n] = depv;
  }
  a.opx[n] = X;
  a.opy[n] = Y;
  a.opz[n] = Z;
  a.odx[n] = DX;
  a.ody[n] = DY;
  a.odz[n] = DZ;
  a.oL[n] = L;
  a.oalive[n] = alive ? 1 : 0;
  a.ons[n] = nscatt;
}

template <bool LABS, bool DIRECT, bool CHUNKED>
int launch(const TableArgs& a, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (a.N + threads - 1) / threads;
  if (blocks > 0)
    table_event_kernel<LABS, DIRECT, CHUNKED><<<blocks, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool CHUNKED>
int launch_c(const TableArgs& a, int labs, cudaStream_t s) {
  // without labs the two variants write the same outputs
  if (!labs) return launch<false, false, CHUNKED>(a, s);
  return a.direct ? launch<true, true, CHUNKED>(a, s)
                  : launch<true, false, CHUNKED>(a, s);
}

}  // namespace

extern "C" int skirt_table_args_size() { return (int)sizeof(TableArgs); }

extern "C" int skirt_table_event(const TableArgs* a, int labs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->npanels < 1 || a->nlambda < 1) return (int)cudaErrorInvalidValue;
  if (a->npanels <= MAXP) return launch_c<false>(*a, labs, s);
  if (!a->cend) return (int)cudaErrorInvalidValue;
  return launch_c<true>(*a, labs, s);
}
