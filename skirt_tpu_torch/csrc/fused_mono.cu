// K3: monochromatic analytic scattering event, one thread per lane.
//
// Replaces: skirt_tpu/engine/fused.py:199 `_build_kernel` (the Pallas body
// at :240-560).  Same input/output contract: the uniforms come in as a
// (n_uniform, N) array and the kernel draws nothing itself, so the plain
// PyTorch version (engine/fused.py::mono_event_plain) and this kernel see
// identical inputs.  The arithmetic follows the Pallas body operation for
// operation (built with -fmad=false, so no contraction into FMAs), and the
// ordered sums (the panel cumulative sum, the peel sums, w_tot) run in the
// plain version's order, so the two agree to the bit.
//
// What bounds it on the H100: the issue of its instructions.  Per live
// lane and event it evaluates the closed-form density (a root, an exp and
// ~25 other operations: ~48 SASS instructions with the panel midpoint and
// the sum) H x (npanels + nlead x np_peel) times (32 + 2 x 8 = 48 on the
// main path at H = 1) and moves ~25 words: 12 state words in, 15 out.  At
// 2^21 lanes that is ~210 MB per event, ~63 us at 3.35 TB/s, against
// ~3,700 instructions a lane (the densities ~2,300, the deposit,
// propagation, relaunch, peel set-up and scatter the rest): ~0.24 ms at
// one instruction per clock on each of the card's 528 schedulers, which
// this design issues at ~94% (experiments/phases.py counts them and
// times each phase).  The -fmad=false build that keeps it bit-identical
// to its plain version fuses no multiply-add.
//
// Design:
// - One thread per lane, 128-thread blocks; lanes are bounds-checked (the
//   TPU driver pads to whole tiles instead).
// - Divisions and roots without the operators' slow-path branches
//   (common.cuh div_rn, sqrt_rn): a lane's event runs once with them and,
//   if any operand it used left their safe range, once more with the
//   plain operators (a second, out-of-line copy of the same code).  The
//   branches kept each density in a basic block of its own; without them
//   the densities of a chunk of panels overlap.
// - The propagation and peel quadratures in chunks of 8 panels: a chunk's
//   densities first, then their contributions added in panel order; a
//   tail of single panels takes any npanels and np_peel.  The chunk and
//   leader loops stay loops: unrolled to MAXP and MAX_LEAD (with guards)
//   the two copies of the lane's code reach 18,000 instructions, and the
//   peel slows on instruction fetch.
// - The lane's cumulative optical depths (and with H > 1 its cumulative
//   absorbed fractions) in shared memory, [panel][thread], not in
//   registers: the deposit and interaction panels are found by a binary
//   search over the non-decreasing sums (the count of sums below the
//   target, which the Pallas body takes), and the sums at the hit panel
//   are two loads.  The cumulative absorbed fractions need not grow with
//   the panel (an albedo above 1 would shrink them), so they are counted.
// - The lane's uniforms by asynchronous copies (cp.async) into shared
//   memory at the start: they land behind the quadrature instead of
//   costing a DRAM round trip at each of the deposit, the propagation,
//   the relaunch and the scatter.
// - The per-wavelength tables, (kext*m/L^3, albedo, g) or
//   (kext_h*m_h/L^3, ksca_h*m_h/L^3, g_h) for h < H, are one (3H, nlambda)
//   array in dynamic shared memory, indexed by the lane's wavelength.  The
//   Pallas kernel's two table branches (compile-time select chains up to
//   16 wavelengths, per-lane input arrays above) carry the same bits, so
//   one kernel serves both.
// - Dead lanes skip the propagation quadrature (the Pallas body computes
//   it and masks it out); every lane computes the peel quadrature, whose
//   outputs the driver masks.
// - H is a template parameter (1 or 2), as are the density, the refill
//   sampler and the absorption tally.
// - Past MAXP panels, MAX_LEAD observers, MAX_COMP components or MAX_TABLE
//   table floats, the C entry point picks the chunked route
//   (mono_event_chunked, lane_event_c): the same arithmetic with the
//   division operator and sqrtf (no redo), H a run-time count (the
//   components' density constants in the device buffer dens_h, H x 8), the
//   observers from the device buffer lead, the uniforms read in place.
//   The panels are walked in chunks of CH = 32: the first pass keeps each
//   chunk's last optical depth in the scratch array cend, and the
//   interaction inversion evaluates again only the chunk its target falls
//   in (common.cuh chunk_invert); with H > 1 and labs the cumulative
//   absorbed fractions (which need not grow) go whole into cend, after the
//   chunk ends, and are counted there.  The tables sit in dynamic shared
//   memory up to the card's opt-in limit, and past it are read through L2
//   from device memory (TABG).

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int MAX_COMP = 2;
constexpr int MAX_TABLE = 12288;   // floats: 48 KB of shared memory
constexpr int THREADS = 128;
constexpr int CHUNK = 8;           // panels whose densities overlap

}  // namespace

// Mirrored field for field by kernels.MonoArgs (ctypes).
struct MonoArgs {
  const float* u;
  const float* tab;
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
  const int* bc;
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
  float* otau;
  float* ocos;
  float* oph;
  int* obc;
  int* ofresh;
  int N, nlambda, H, npanels, np_peel, nlead, min_scatt, K,
      scattering_peeloff, u_comp;
  float xi, one_m_xi, inv_np, inv_pp, inv_minred;
  float dens1[8];
  Geom geo;
  float* cend;
  const float* lead;
  const float* dens_h;
};

namespace {

// the uniforms a lane reads: 5, the sampler's and two direction uniforms
// with the relaunch, the component uniform with H > 1 (the wrapper's
// n_uniform rows)
template <int SAMP, int H>
__host__ __device__ constexpr int n_uniform() {
  return 5 + (SAMP != SAMP_NONE ? sampler_uniforms<SAMP>() + 2 : 0) +
         (H > 1 ? 1 : 0);
}

// One lane's event; writes every output.  Returns false, without EXACT, if
// an operand that mattered left the safe range of div_rn or sqrt_rn: the
// caller then runs the lane again with EXACT.  s_cum: the thread's column
// of the [2 * MAXP][THREADS] scratch (the cumulative optical depths, then
// with H > 1 the cumulative absorbed fractions); u: its column of the
// [n_uniform][THREADS] uniforms, copied in asynchronously (waited for
// before the first read).
template <int DENS, int SAMP, bool LABS, int H, bool EXACT>
__device__ __forceinline__ bool lane_event(const MonoArgs& a,
                                           const float* s_tab, float* s_cum,
                                           const float* u, int n) {
  const int NL = a.nlambda;
  const int P = a.npanels;
  const long long N = a.N;
  const Geom& g = a.geo;
  const float* dens[MAX_COMP] = {g.dens, a.dens1};
  float* s_cab = s_cum + MAXP * THREADS;
  // panels whose densities are computed together (one in the redo)
  constexpr int U = EXACT ? 1 : CHUNK;
  bool ok = true;

  // -- the lane's wavelength tables (an out-of-range index reads the first
  //    column, as the Pallas select chain does) ---------------------------
  const int ell = a.ell[n];
  const int li = (ell >= 0 && ell < NL) ? ell : 0;
  float kext[H], ksca[H], gh[H];
  float albedo = 0.f;
#pragma unroll
  for (int h = 0; h < H; ++h) kext[h] = s_tab[h * NL + li];
  if (H == 1) {
    albedo = s_tab[NL + li];
    gh[0] = s_tab[2 * NL + li];
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      ksca[h] = s_tab[(H + h) * NL + li];
      gh[h] = s_tab[(2 * H + h) * NL + li];
    }
  }

  float X = a.px[n], Y = a.py[n], Z = a.pz[n];
  float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
  float L = a.L[n];
  bool alive = a.alive[n] != 0;
  int nscatt = a.ns[n];
  const float L0 = a.L0[n];
  const float Lth = L0 * a.inv_minred;

  int depi = -1;
  float depv = 0.f;
  if (alive) {
    // -- traverse: equal-panel quadrature of the analytic density, a chunk
    //    of panel densities at a time ----------------------------------
    float t0, t1;
    span_rn<EXACT>(g, X, Y, Z, DX, DY, DZ, t0, t1, ok);
    const float delta = (t1 - t0) * a.inv_np;
    float cum = 0.f, Lsca_f = 0.f, cab = 0.f, e_prev = 1.f;
    // the densities at the midpoint of panel k, kf = k + 0.5 (exact in
    // float for any panel count)
    auto panel_rho = [&](float kf, float (&rk)[H]) {
      const float midk = t0 + kf * delta;
      const float mx = X + midk * DX, my = Y + midk * DY, mz = Z + midk * DZ;
#pragma unroll
      for (int h = 0; h < H; ++h)
        rk[h] = rho_s_rn<DENS, EXACT>(g, dens[h], mx, my, mz, ok);
    };
    // panel k's contribution to the cumulative sums, in panel order
    auto panel_add = [&](int k, const float (&rk)[H]) {
      if (H == 1) {
        cum = cum + kext[0] * rk[0] * delta;
      } else {
        float dke = 0.f, dks = 0.f;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          dke = dke + kext[h] * rk[h];
          dks = dks + ksca[h] * rk[h];
        }
        const float alb_q =
            div_rn_if<EXACT>(dks, fmaxf(dke, 1e-37f), dke > 0.f, ok);
        const float alb_k = dke > 0.f ? alb_q : 0.f;
        cum = cum + dke * delta;
        // per-panel absorbed/scattered split of the local albedo
        const float e_k = expf(-cum);
        const float seg = e_prev - e_k;
        Lsca_f = Lsca_f + alb_k * seg;
        cab = cab + (1.f - alb_k) * seg;
        s_cab[k * THREADS] = cab;
        e_prev = e_k;
      }
      s_cum[k * THREADS] = cum;
    };
    int k = 0;
#pragma unroll 1
    for (; k + U <= P; k += U) {
      const float kf = (float)k + 0.5f;
      float rk[U][H];
#pragma unroll
      for (int i = 0; i < U; ++i) panel_rho(kf + (float)i, rk[i]);
#pragma unroll
      for (int i = 0; i < U; ++i) panel_add(k + i, rk[i]);
    }
#pragma unroll 1
    for (; k < P; ++k) {
      float rk[H];
      panel_rho((float)k + 0.5f, rk);
      panel_add(k, rk);
    }
    __pipeline_wait_prior(0);
    const float taupath = cum;
    const float one_m_e = 1.f - expf(-taupath);
    const float Lm = L;

    // -- sampled absorption deposit ---------------------------------------
    if (LABS) {
      const float u_dep = u[2 * THREADS];
      float D;
      int i_dep = 0;
      if (H > 1) {
        // segment ~ its absorbed energy
        D = cab * Lm;
        const float target = u_dep * cab;
        for (int k = 0; k < P - 1; ++k)
          i_dep += (s_cab[k * THREADS] < target) ? 1 : 0;
      } else {
        D = (1.f - albedo) * Lm * one_m_e;
        const float tau_dep = expon_cutoff(u_dep, taupath);
        i_dep = count_below(s_cum, THREADS, P - 1, tau_dep);
      }
      const float mid_dep = t0 + ((float)i_dep + 0.5f) * delta;
      const int cell = locate(g, X + mid_dep * DX, Y + mid_dep * DY,
                              Z + mid_dep * DZ);
      if (cell >= 0 && D > 0.f) {
        depi = cell * NL + ell;
        depv = D;
      }
    }

    // -- scattered-luminosity update + termination (on the pre-bias L) ---
    L = H > 1 ? Lsca_f * Lm : albedo * Lm * one_m_e;
    alive = (L > 0.f) && !((L <= Lth) && (nscatt >= a.min_scatt)) &&
            (taupath > 0.f);

    // -- forced propagation with the composite bias weight p/q -----------
    const float u1 = u[0], u2 = u[THREADS];
    const float tau_exp = expon_cutoff(u2, taupath);
    float tau = tau_exp;
    if (a.xi != 0.f) {
      tau = u1 < a.xi ? u2 * taupath : tau_exp;
      const float p = div_rn_if<EXACT>(expf(-tau), fmaxf(one_m_e, 1e-30f),
                                       alive, ok);
      const float qq =
          a.one_m_xi * p +
          div_rn_if<EXACT>(a.xi, fmaxf(taupath, 1e-30f), alive, ok);
      const float w = div_rn_if<EXACT>(p, fmaxf(qq, 1e-37f), alive, ok);
      if (alive) L = L * w;
    }
    const int i_hit = count_below(s_cum, THREADS, P - 1, tau);
    const float cum_h = s_cum[i_hit * THREADS];
    const float cum_prev = i_hit > 0 ? s_cum[(i_hit - 1) * THREADS] : 0.f;
    const float dtau_h = cum_h - cum_prev;
    const float fr_q = div_rn_if<EXACT>(tau - cum_prev, fmaxf(dtau_h, 1e-30f),
                                        alive && dtau_h > 0.f, ok);
    const float fr = dtau_h > 0.f ? fr_q : 0.f;
    const float frac = fminf(fmaxf(fr, 0.f), 1.f);
    const float s = t0 + ((float)i_hit + frac) * delta;
    if (alive) {
      X = X + s * DX;
      Y = Y + s * DY;
      Z = Z + s * DZ;
    }
  }
  if (LABS) {
    a.odepi[n] = depi;
    a.odepv[n] = depv;
  }
  __pipeline_wait_prior(0);

  // -- persistent-lane relaunch (after the propagation, before the peel) --
  bool fresh = false;
  if (SAMP != SAMP_NONE) {
    int bcount = a.bc[n];
    if (!alive && bcount < a.K) {
      constexpr int nu = sampler_uniforms<SAMP>();
      sample_position<SAMP>(g, u, THREADS, 0, 5, X, Y, Z);
      const float ct = 2.f * u[(5 + nu) * THREADS] - 1.f;
      const float st = sqrt_rn<EXACT>(fmaxf(0.f, 1.f - ct * ct), ok);
      const float ph2 = TWO_PI * u[(6 + nu) * THREADS];
      DX = st * cosf(ph2);
      DY = st * sinf(ph2);
      DZ = ct;
      L = L0;
      nscatt = 0;
      bcount += 1;
      fresh = true;
      alive = true;
    }
    a.obc[n] = bcount;
    a.ofresh[n] = fresh ? 1 : 0;
  }

  // -- local mixture at the (post-refill) interaction point: component h
  //    with probability ~ ksca_h rho_h; the peel phase is the blend --------
  float g_sel = gh[0];
  float w_h[H];
  float w_tot = 0.f;
  if (H > 1) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      w_h[h] = ksca[h] * rho_s_rn<DENS, EXACT>(g, dens[h], X, Y, Z, ok);
    w_tot = w_h[0];
#pragma unroll
    for (int h = 1; h < H; ++h) w_tot = w_tot + w_h[h];
    const float u_c = u[a.u_comp * THREADS] * fmaxf(w_tot, 1e-37f);
    float w_acc = w_h[0];
#pragma unroll
    for (int h = 1; h < H; ++h) {
      if (u_c > w_acc) g_sel = gh[h];
      w_acc = w_acc + w_h[h];
    }
  }

  // -- peel-off optical depth and cosine toward each leader, a chunk of
  //    panel densities at a time ----------------------------------------
  const int PP = a.np_peel;
#pragma unroll 1
  for (int j = 0; j < a.nlead; ++j) {
    float cosj = 0.f, tau = 0.f, ph = 0.f;
    if (a.scattering_peeloff) {
      const float kx = g.lead_k[j][0], ky = g.lead_k[j][1],
                  kz = g.lead_k[j][2];
      cosj = DX * kx + DY * ky + DZ * kz;
      if (H > 1) {
        float phs = 0.f;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float gg = gh[h];
          const float t_ = 1.f + gg * gg - 2.f * gg * cosj;
          phs = phs + w_h[h] * ((1.f - gg) * (1.f + gg) * rsqrtf(t_ * t_ * t_));
        }
        const float ph_q = div_rn_if<EXACT>(phs, fmaxf(w_tot, 1e-30f),
                                            w_tot > 0.f, ok);
        ph = w_tot > 0.f ? ph_q : 0.f;
      }
      float pt0, pt1;
      span_const(g, j, X, Y, Z, pt0, pt1);
      const float pd = (pt1 - pt0) * a.inv_pp;
      // the densities at peel panel k's midpoint, then their sum in order
      auto peel_rho = [&](float kf, float (&rk)[H]) {
        const float mk = pt0 + kf * pd;
        const float mx = X + mk * kx, my = Y + mk * ky, mz = Z + mk * kz;
#pragma unroll
        for (int h = 0; h < H; ++h)
          rk[h] = rho_s_rn<DENS, EXACT>(g, dens[h], mx, my, mz, ok);
      };
      float rsum = 0.f;
      auto peel_add = [&](const float (&rk)[H]) {
        if (H > 1) {
#pragma unroll
          for (int h = 0; h < H; ++h) rsum = rsum + kext[h] * rk[h];
        } else {
          rsum = rsum + rk[0];
        }
      };
      int k = 0;
#pragma unroll 1
      for (; k + U <= PP; k += U) {
        const float kf = (float)k + 0.5f;
        float rk[U][H];
#pragma unroll
        for (int i = 0; i < U; ++i) peel_rho(kf + (float)i, rk[i]);
#pragma unroll
        for (int i = 0; i < U; ++i) peel_add(rk[i]);
      }
#pragma unroll 1
      for (; k < PP; ++k) {
        float rk[H];
        peel_rho((float)k + 0.5f, rk);
        peel_add(rk);
      }
      tau = (H > 1 ? rsum : kext[0] * rsum) * pd;
    }
    a.ocos[j * N + n] = cosj;
    a.otau[j * N + n] = tau;
    if (H > 1) a.oph[j * N + n] = ph;
  }

  // -- Henyey-Greenstein scatter; fresh lanes keep their launch direction -
  if (alive && !fresh) {
    const float costheta = hg_costheta_rn<EXACT>(g_sel, u[3 * THREADS], ok);
    scatter_direction_rn<EXACT>(costheta, u[4 * THREADS], DX, DY, DZ, ok);
    nscatt += 1;
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
  return EXACT || ok;
}

// the lane again with the plain operators, out of line (rarely called)
template <int DENS, int SAMP, bool LABS, int H>
__device__ __noinline__ void lane_event_exact(const MonoArgs& a,
                                              const float* s_tab,
                                              float* s_cum, const float* u,
                                              int n) {
  lane_event<DENS, SAMP, LABS, H, true>(a, s_tab, s_cum, u, n);
}

// floats of dynamic shared memory before the tables: the cumulative sums
// and the uniforms
template <int SAMP, int H>
__host__ __device__ constexpr int scratch_floats() {
  return ((H > 1 ? 2 : 1) * MAXP + n_uniform<SAMP, H>()) * THREADS;
}

template <int DENS, int SAMP, bool LABS, int H>
__global__ void __launch_bounds__(THREADS)
mono_event_kernel(const __grid_constant__ MonoArgs a) {
  constexpr int NU = n_uniform<SAMP, H>();
  extern __shared__ float dyn[];
  // [MAXP or 2 MAXP][THREADS] cumulative sums (the second half with H > 1),
  // [NU][THREADS] the lanes' uniforms, then the (3H, nlambda) wavelength
  // tables
  float* s_cum = dyn + threadIdx.x;
  float* s_u = dyn + (H > 1 ? 2 : 1) * MAXP * THREADS + threadIdx.x;
  float* s_tab = dyn + scratch_floats<SAMP, H>();
  const long long N = a.N;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  // the uniforms by asynchronous copies, which land behind the quadrature
  if (n < a.N)
    for (int k = 0; k < NU; ++k)
      __pipeline_memcpy_async(s_u + k * THREADS, a.u + k * N + n, 4);
  __pipeline_commit();
  const int NL = a.nlambda;
  for (int i = threadIdx.x; i < 3 * H * NL; i += blockDim.x)
    s_tab[i] = a.tab[i];
  __syncthreads();
  if (n >= a.N) return;
  if (!lane_event<DENS, SAMP, LABS, H, false>(a, s_tab, s_cum, s_u, n))
    lane_event_exact<DENS, SAMP, LABS, H>(a, s_tab, s_cum, s_u, n);
}

template <int DENS, int SAMP, bool LABS, int H>
int launch(const MonoArgs& a, cudaStream_t s) {
  const int blocks = (a.N + THREADS - 1) / THREADS;
  if (blocks <= 0) return (int)cudaGetLastError();
  constexpr size_t scratch = scratch_floats<SAMP, H>();
  static bool raised[64];
  const int e = raise_smem_limit(mono_event_kernel<DENS, SAMP, LABS, H>,
                                 (scratch + MAX_TABLE) * sizeof(float), raised);
  if (e) return e;
  const size_t smem = (scratch + (size_t)3 * H * a.nlambda) * sizeof(float);
  mono_event_kernel<DENS, SAMP, LABS, H><<<blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}


// One lane's event on the chunked route (see the header); writes every
// output.  tab: the (3H, nlambda) tables, in shared or device memory.
template <int DENS, int SAMP, bool LABS>
__device__ __forceinline__ void lane_event_c(const MonoArgs& a,
                                             const float* tab, int n) {
  const int NL = a.nlambda;
  const int P = a.npanels;
  const int H = a.H;
  const bool multi = H > 1;
  const long long N = a.N;
  const Geom& g = a.geo;
  const float* u = a.u + n;           // uniform k at u[k * N]
  bool ok = true;                     // the exact forms never clear it

  // -- the lane's wavelength tables --------------------------------------
  const int ell = a.ell[n];
  const int li = (ell >= 0 && ell < NL) ? ell : 0;
  auto kext = [&](int h) { return tab[h * NL + li]; };
  auto ksca = [&](int h) { return tab[(H + h) * NL + li]; };
  auto gh = [&](int h) { return tab[(2 * H + h) * NL + li]; };
  const float albedo = multi ? 0.f : tab[NL + li];
  // component h's density at a point
  auto rho = [&](int h, float mx, float my, float mz) {
    return rho_s_rn<DENS, true>(g, a.dens_h + 8 * h, mx, my, mz, ok);
  };

  float X = a.px[n], Y = a.py[n], Z = a.pz[n];
  float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
  float L = a.L[n];
  bool alive = a.alive[n] != 0;
  int nscatt = a.ns[n];
  const float L0 = a.L0[n];
  const float Lth = L0 * a.inv_minred;

  int depi = -1;
  float depv = 0.f;
  if (alive) {
    // -- traverse: the panels in order, each chunk's last optical depth
    //    into cend (with H > 1 and labs every cumulative absorbed fraction
    //    after them) ---------------------------------------------------------
    float t0, t1;
    span_rn<true>(g, X, Y, Z, DX, DY, DZ, t0, t1, ok);
    const float delta = (t1 - t0) * a.inv_np;
    const int nc = nchunks(P);
    float* ends = a.cend + n;
    float* cabs = ends + nc * N;
    // panel k's optical-depth step (H = 1: kext rho delta; else the blended
    // kext rho, whose albedo split goes to dks)
    auto panel_dke = [&](int k, float& dks) {
      const float midk = t0 + ((float)k + 0.5f) * delta;
      const float mx = X + midk * DX, my = Y + midk * DY, mz = Z + midk * DZ;
      float dke = 0.f;
      dks = 0.f;
      if (!multi) return kext(0) * rho(0, mx, my, mz);
      for (int h = 0; h < H; ++h) {
        const float rk = rho(h, mx, my, mz);
        dke = dke + kext(h) * rk;
        dks = dks + ksca(h) * rk;
      }
      return dke;
    };
    float cum = 0.f, Lsca_f = 0.f, cab = 0.f, e_prev = 1.f;
    for (int k = 0; k < P; ++k) {
      float dks;
      const float dke = panel_dke(k, dks);
      if (!multi) {
        cum = cum + dke * delta;
      } else {
        const float alb_k = dke > 0.f ? dks / fmaxf(dke, 1e-37f) : 0.f;
        cum = cum + dke * delta;
        const float e_k = expf(-cum);
        const float seg = e_prev - e_k;
        Lsca_f = Lsca_f + alb_k * seg;
        cab = cab + (1.f - alb_k) * seg;
        if (LABS) cabs[k * N] = cab;
        e_prev = e_k;
      }
      if ((k & (CH - 1)) == CH - 1 || k == P - 1) ends[(k / CH) * N] = cum;
    }
    // the optical depth's walk: restart at chunk c, advance by panel k
    float wc = 0.f;
    auto restart = [&](int c) {
      wc = c > 0 ? ends[(c - 1) * N] : 0.f;
      return wc;
    };
    auto next = [&](int k) {
      float dks;
      wc = wc + panel_dke(k, dks) * delta;
      return wc;
    };
    const float taupath = cum;
    const float one_m_e = 1.f - expf(-taupath);
    const float Lm = L;

    // -- sampled absorption deposit ---------------------------------------
    if (LABS) {
      const float u_dep = u[2 * N];
      float D;
      int i_dep = 0;
      if (multi) {
        D = cab * Lm;
        const float target = u_dep * cab;
        for (int k = 0; k < P - 1; ++k)
          i_dep += (cabs[k * N] < target) ? 1 : 0;
      } else {
        D = (1.f - albedo) * Lm * one_m_e;
        const float tau_dep = expon_cutoff(u_dep, taupath);
        float at, before;
        i_dep = chunk_invert(ends, N, P - 1, tau_dep, restart, next, at,
                             before);
      }
      const float mid_dep = t0 + ((float)i_dep + 0.5f) * delta;
      const int cell = locate(g, X + mid_dep * DX, Y + mid_dep * DY,
                              Z + mid_dep * DZ);
      if (cell >= 0 && D > 0.f) {
        depi = cell * NL + ell;
        depv = D;
      }
    }

    // -- scattered-luminosity update + termination (on the pre-bias L) ---
    L = multi ? Lsca_f * Lm : albedo * Lm * one_m_e;
    alive = (L > 0.f) && !((L <= Lth) && (nscatt >= a.min_scatt)) &&
            (taupath > 0.f);

    // -- forced propagation with the composite bias weight p/q -----------
    const float u1 = u[0], u2 = u[N];
    const float tau_exp = expon_cutoff(u2, taupath);
    float tau = tau_exp;
    if (a.xi != 0.f) {
      tau = u1 < a.xi ? u2 * taupath : tau_exp;
      const float p = expf(-tau) / fmaxf(one_m_e, 1e-30f);
      const float qq = a.one_m_xi * p + a.xi / fmaxf(taupath, 1e-30f);
      const float w = p / fmaxf(qq, 1e-37f);
      if (alive) L = L * w;
    }
    float cum_h, cum_prev;
    const int i_hit =
        chunk_invert(ends, N, P - 1, tau, restart, next, cum_h, cum_prev);
    const float dtau_h = cum_h - cum_prev;
    const float fr =
        dtau_h > 0.f ? (tau - cum_prev) / fmaxf(dtau_h, 1e-30f) : 0.f;
    const float frac = fminf(fmaxf(fr, 0.f), 1.f);
    const float s = t0 + ((float)i_hit + frac) * delta;
    if (alive) {
      X = X + s * DX;
      Y = Y + s * DY;
      Z = Z + s * DZ;
    }
  }
  if (LABS) {
    a.odepi[n] = depi;
    a.odepv[n] = depv;
  }

  // -- persistent-lane relaunch (after the propagation, before the peel) --
  bool fresh = false;
  if (SAMP != SAMP_NONE) {
    int bcount = a.bc[n];
    if (!alive && bcount < a.K) {
      constexpr int nu = sampler_uniforms<SAMP>();
      sample_position<SAMP>(g, a.u, N, n, 5, X, Y, Z);
      const float ct = 2.f * u[(5 + nu) * N] - 1.f;
      const float st = sqrtf(fmaxf(0.f, 1.f - ct * ct));
      const float ph2 = TWO_PI * u[(6 + nu) * N];
      DX = st * cosf(ph2);
      DY = st * sinf(ph2);
      DZ = ct;
      L = L0;
      nscatt = 0;
      bcount += 1;
      fresh = true;
      alive = true;
    }
    a.obc[n] = bcount;
    a.ofresh[n] = fresh ? 1 : 0;
  }

  // -- local mixture at the (post-refill) interaction point: component h
  //    with probability ~ ksca_h rho_h; the peel phase is the blend --------
  auto w_h = [&](int h) { return ksca(h) * rho(h, X, Y, Z); };
  float g_sel = gh(0);
  float w_tot = 0.f;
  if (multi) {
    w_tot = w_h(0);
    for (int h = 1; h < H; ++h) w_tot = w_tot + w_h(h);
    const float u_c = u[a.u_comp * N] * fmaxf(w_tot, 1e-37f);
    float w_acc = w_h(0);
    for (int h = 1; h < H; ++h) {
      if (u_c > w_acc) g_sel = gh(h);
      w_acc = w_acc + w_h(h);
    }
  }

  // -- peel-off optical depth and cosine toward each leader --------------
  const int PP = a.np_peel;
#pragma unroll 1
  for (int j = 0; j < a.nlead; ++j) {
    float cosj = 0.f, tau = 0.f, ph = 0.f;
    if (a.scattering_peeloff) {
      const float* ld = a.lead + j * LEAD_FLOATS;
      const float kx = ld[0], ky = ld[1], kz = ld[2];
      cosj = DX * kx + DY * ky + DZ * kz;
      if (multi) {
        float phs = 0.f;
        for (int h = 0; h < H; ++h) {
          const float gg = gh(h);
          const float t_ = 1.f + gg * gg - 2.f * gg * cosj;
          phs = phs + w_h(h) * ((1.f - gg) * (1.f + gg) * rsqrtf(t_ * t_ * t_));
        }
        ph = w_tot > 0.f ? phs / fmaxf(w_tot, 1e-30f) : 0.f;
      }
      float pt0, pt1;
      span_lead(g, ld, X, Y, Z, pt0, pt1);
      const float pd = (pt1 - pt0) * a.inv_pp;
      float rsum = 0.f;
#pragma unroll 1
      for (int k = 0; k < PP; ++k) {
        const float mk = pt0 + ((float)k + 0.5f) * pd;
        const float mx = X + mk * kx, my = Y + mk * ky, mz = Z + mk * kz;
        if (multi) {
          for (int h = 0; h < H; ++h)
            rsum = rsum + kext(h) * rho(h, mx, my, mz);
        } else {
          rsum = rsum + rho(0, mx, my, mz);
        }
      }
      tau = (multi ? rsum : kext(0) * rsum) * pd;
    }
    a.ocos[j * N + n] = cosj;
    a.otau[j * N + n] = tau;
    if (multi) a.oph[j * N + n] = ph;
  }

  // -- Henyey-Greenstein scatter; fresh lanes keep their launch direction -
  if (alive && !fresh) {
    const float costheta = hg_costheta_rn<true>(g_sel, u[3 * N], ok);
    scatter_direction_rn<true>(costheta, u[4 * N], DX, DY, DZ, ok);
    nscatt += 1;
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

// The chunked route: the tables in dynamic shared memory, or with TABG
// read in place through L2.
template <int DENS, int SAMP, bool LABS, bool TABG>
__global__ void __launch_bounds__(THREADS)
mono_event_chunked(const __grid_constant__ MonoArgs a) {
  extern __shared__ float dyn[];
  const float* tab = a.tab;
  if (!TABG) {
    for (int i = threadIdx.x; i < 3 * a.H * a.nlambda; i += blockDim.x)
      dyn[i] = a.tab[i];
    __syncthreads();
    tab = dyn;
  }
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  lane_event_c<DENS, SAMP, LABS>(a, tab, n);
}

template <int DENS, int SAMP, bool LABS, bool TABG>
int launch_c(const MonoArgs& a, size_t smem, cudaStream_t s) {
  const int blocks = (a.N + THREADS - 1) / THREADS;
  if (blocks <= 0) return (int)cudaGetLastError();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mono_event_chunked<DENS, SAMP, LABS, TABG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  mono_event_chunked<DENS, SAMP, LABS, TABG><<<blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// the chunked route: its tables in shared memory up to the card's opt-in
// limit, else in device memory
template <int DENS, int SAMP>
int launch_chunked(const MonoArgs& a, int labs, cudaStream_t s) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t smem = (size_t)3 * a.H * a.nlambda * sizeof(float);
  if (smem <= (size_t)optin)
    return labs ? launch_c<DENS, SAMP, true, false>(a, smem, s)
                : launch_c<DENS, SAMP, false, false>(a, smem, s);
  return labs ? launch_c<DENS, SAMP, true, true>(a, 0, s)
              : launch_c<DENS, SAMP, false, true>(a, 0, s);
}

template <int DENS, int SAMP, int H>
int launch_l(const MonoArgs& a, int labs, cudaStream_t s) {
  return labs ? launch<DENS, SAMP, true, H>(a, s)
              : launch<DENS, SAMP, false, H>(a, s);
}

template <int DENS, int SAMP>
int launch_h(const MonoArgs& a, int labs, cudaStream_t s) {
  if (a.H > MAX_COMP || 3 * a.H * a.nlambda > MAX_TABLE ||
      a.nlead > MAX_LEAD || a.npanels > MAXP)
    return launch_chunked<DENS, SAMP>(a, labs, s);
  return a.H == 1 ? launch_l<DENS, SAMP, 1>(a, labs, s)
                  : launch_l<DENS, SAMP, 2>(a, labs, s);
}

}  // namespace

extern "C" int skirt_mono_args_size() { return (int)sizeof(MonoArgs); }

extern "C" int skirt_mono_event(const MonoArgs* a, int dens, int samp,
                                int labs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->H < 1 || a->nlambda < 1 || a->npanels < 1 || dens != DENS_EXPDISK)
    return (int)cudaErrorInvalidValue;
  if ((a->H > MAX_COMP || 3 * a->H * a->nlambda > MAX_TABLE ||
       a->nlead > MAX_LEAD || a->npanels > MAXP) &&
      (!a->cend || !a->dens_h || (a->nlead > 0 && !a->lead)))
    return (int)cudaErrorInvalidValue;
  switch (samp) {
    case SAMP_NONE:
      return launch_h<DENS_EXPDISK, SAMP_NONE>(*a, labs, s);
    case SAMP_POINT:
      return launch_h<DENS_EXPDISK, SAMP_POINT>(*a, labs, s);
    case SAMP_EXPDISK:
      return launch_h<DENS_EXPDISK, SAMP_EXPDISK>(*a, labs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
