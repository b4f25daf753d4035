// K3: monochromatic analytic scattering event, one thread per lane.
//
// Replaces: skirt_tpu/engine/fused.py:199 `_build_kernel` (the Pallas body
// at :240-560).  Same input/output contract: the uniforms come in as a
// (n_uniform, N) array and the kernel draws nothing itself, so the plain
// PyTorch version (engine/fused.py::mono_event_plain) and this kernel see
// identical inputs.  The arithmetic follows the Pallas body operation for
// operation (built with -fmad=false, so no contraction into FMAs).
//
// What bounds it on the H100: arithmetic on the lane, not bytes.  Per
// lane and event it evaluates the closed-form density (a sqrt, an exp and
// a handful of multiplies) H x (npanels + nlead x np_peel) + H times
// (32 + 2 x 8 = 48 on the main path at H = 1) and moves ~25 words: 12
// state words in, 15 out.  At 2^21 lanes that is ~210 MB per event, ~63
// us at 3.35 TB/s, against ~3 x 10^9 transcendental-heavy operations.
//
// Design:
// - One thread per lane; lanes are bounds-checked (the TPU driver pads to
//   whole tiles instead).
// - The lane's npanels cumulative optical depths live in registers: a
//   compile-time maximum MAXP = 32 with guarded, fully unrolled loops
//   keeps every index constant.  The wrapper raises above it.  With H > 1
//   the cumulative absorbed fractions stay in registers beside them; the
//   per-panel albedo is folded into them in the same loop (the Pallas
//   body keeps it in a list for a second loop; each accumulator sees the
//   same operations in the same order either way).
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
//   sampler and the absorption tally; the C entry point raises on any
//   other choice.

#include "common.cuh"

namespace {

constexpr int MAX_COMP = 2;
constexpr int MAX_TABLE = 12288;   // floats: 48 KB of shared memory

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
};

namespace {

template <int DENS, int SAMP, bool LABS, int H>
__global__ void __launch_bounds__(128)
mono_event_kernel(const __grid_constant__ MonoArgs a) {
  extern __shared__ float s_tab[];
  const int NL = a.nlambda;
  for (int i = threadIdx.x; i < 3 * H * NL; i += blockDim.x)
    s_tab[i] = a.tab[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const long long N = a.N;
  const float* u = a.u;
  const Geom& g = a.geo;
  const float* dens[MAX_COMP] = {g.dens, a.dens1};

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
    // -- traverse: equal-panel quadrature of the analytic density --------
    float t0, t1;
    span(g, X, Y, Z, DX, DY, DZ, t0, t1);
    const float delta = (t1 - t0) * a.inv_np;
    float cums[MAXP];
    float cumabs[H > 1 ? MAXP : 1];
    float cum = 0.f, Lsca_f = 0.f, cab = 0.f, e_prev = 1.f;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (k < a.npanels) {
        const float midk = t0 + ((float)k + 0.5f) * delta;
        const float mx = X + midk * DX, my = Y + midk * DY,
                    mz = Z + midk * DZ;
        if (H == 1) {
          const float rho = rho_s<DENS>(g, dens[0], mx, my, mz);
          cum = cum + kext[0] * rho * delta;
        } else {
          float dke = 0.f, dks = 0.f;
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const float rho = rho_s<DENS>(g, dens[h], mx, my, mz);
            dke = dke + kext[h] * rho;
            dks = dks + ksca[h] * rho;
          }
          const float alb_k = dke > 0.f ? dks / fmaxf(dke, 1e-37f) : 0.f;
          cum = cum + dke * delta;
          // per-panel absorbed/scattered split of the local albedo
          const float e_k = expf(-cum);
          const float seg = e_prev - e_k;
          Lsca_f = Lsca_f + alb_k * seg;
          cab = cab + (1.f - alb_k) * seg;
          cumabs[k] = cab;
          e_prev = e_k;
        }
      }
      cums[k] = cum;
    }
    const float taupath = cum;
    const float one_m_e = 1.f - expf(-taupath);
    const float Lm = L;

    // -- sampled absorption deposit ---------------------------------------
    if (LABS) {
      const float u_dep = u[2 * N + n];
      float D;
      int i_dep = 0;
      if (H > 1) {
        // segment ~ its absorbed energy
        D = cab * Lm;
        const float target = u_dep * cab;
#pragma unroll
        for (int k = 0; k < MAXP - 1; ++k)
          if (k < a.npanels - 1) i_dep += (cumabs[k] < target) ? 1 : 0;
      } else {
        D = (1.f - albedo) * Lm * one_m_e;
        const float tau_dep = expon_cutoff(u_dep, taupath);
#pragma unroll
        for (int k = 0; k < MAXP - 1; ++k)
          if (k < a.npanels - 1) i_dep += (cums[k] < tau_dep) ? 1 : 0;
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
    const float u1 = u[n], u2 = u[N + n];
    const float tau_exp = expon_cutoff(u2, taupath);
    float tau = tau_exp;
    if (a.xi != 0.f) {
      tau = u1 < a.xi ? u2 * taupath : tau_exp;
      const float p = expf(-tau) / fmaxf(one_m_e, 1e-30f);
      const float qq = a.one_m_xi * p + a.xi / fmaxf(taupath, 1e-30f);
      if (alive) L = L * (p / fmaxf(qq, 1e-37f));
    }
    int i_hit = 0;
#pragma unroll
    for (int k = 0; k < MAXP - 1; ++k)
      if (k < a.npanels - 1) i_hit += (cums[k] < tau) ? 1 : 0;
    float cum_h = 0.f, cum_prev = 0.f;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (k == i_hit) cum_h = cums[k];
      if (k == i_hit - 1) cum_prev = cums[k];
    }
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
      sample_position<SAMP>(g, u, N, n, 5, X, Y, Z);
      const float ct = 2.f * u[(5 + nu) * N + n] - 1.f;
      const float st = sqrtf(fmaxf(0.f, 1.f - ct * ct));
      const float ph2 = TWO_PI * u[(6 + nu) * N + n];
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
    for (int h = 0; h < H; ++h) w_h[h] = ksca[h] * rho_s<DENS>(g, dens[h], X, Y, Z);
    w_tot = w_h[0];
#pragma unroll
    for (int h = 1; h < H; ++h) w_tot = w_tot + w_h[h];
    const float u_c = u[a.u_comp * N + n] * fmaxf(w_tot, 1e-37f);
    float w_acc = w_h[0];
#pragma unroll
    for (int h = 1; h < H; ++h) {
      if (u_c > w_acc) g_sel = gh[h];
      w_acc = w_acc + w_h[h];
    }
  }

  // -- peel-off optical depth and cosine toward each leader --------------
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
        ph = w_tot > 0.f ? phs / fmaxf(w_tot, 1e-30f) : 0.f;
      }
      float pt0, pt1;
      span_const(g, j, X, Y, Z, pt0, pt1);
      const float pd = (pt1 - pt0) * a.inv_pp;
      float rsum = 0.f;
      for (int k = 0; k < a.np_peel; ++k) {
        const float mk = pt0 + ((float)k + 0.5f) * pd;
        const float mx = X + mk * kx, my = Y + mk * ky, mz = Z + mk * kz;
        if (H > 1) {
#pragma unroll
          for (int h = 0; h < H; ++h)
            rsum = rsum + kext[h] * rho_s<DENS>(g, dens[h], mx, my, mz);
        } else {
          rsum = rsum + rho_s<DENS>(g, dens[0], mx, my, mz);
        }
      }
      tau = (H > 1 ? rsum : kext[0] * rsum) * pd;
    }
    a.ocos[j * N + n] = cosj;
    a.otau[j * N + n] = tau;
    if (H > 1) a.oph[j * N + n] = ph;
  }

  // -- Henyey-Greenstein scatter; fresh lanes keep their launch direction -
  if (alive && !fresh) {
    const float costheta = hg_costheta(g_sel, u[3 * N + n]);
    scatter_direction(costheta, u[4 * N + n], DX, DY, DZ);
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

template <int DENS, int SAMP, bool LABS, int H>
int launch(const MonoArgs& a, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (a.N + threads - 1) / threads;
  const size_t smem = (size_t)3 * H * a.nlambda * sizeof(float);
  if (blocks > 0)
    mono_event_kernel<DENS, SAMP, LABS, H><<<blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DENS, int SAMP, int H>
int launch_l(const MonoArgs& a, int labs, cudaStream_t s) {
  return labs ? launch<DENS, SAMP, true, H>(a, s)
              : launch<DENS, SAMP, false, H>(a, s);
}

template <int DENS, int SAMP>
int launch_h(const MonoArgs& a, int labs, cudaStream_t s) {
  return a.H == 1 ? launch_l<DENS, SAMP, 1>(a, labs, s)
                  : launch_l<DENS, SAMP, 2>(a, labs, s);
}

}  // namespace

extern "C" int skirt_mono_args_size() { return (int)sizeof(MonoArgs); }

extern "C" int skirt_mono_event(const MonoArgs* a, int dens, int samp,
                                int labs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->H < 1 || a->H > MAX_COMP || a->nlambda < 1 ||
      3 * a->H * a->nlambda > MAX_TABLE || a->nlead > MAX_LEAD ||
      a->npanels < 1 || a->npanels > MAXP || dens != DENS_EXPDISK)
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
