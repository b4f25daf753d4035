// K5: monochromatic multi-component table-mode event, one thread per lane.
//
// Replaces: skirt_tpu/engine/fused_table.py:248 `_build_kernel_multi` (the
// Pallas body at :280-390), called at :682.  Same input/output contract: the
// staged (P, N) kappa_ext * rho and kappa_sca * rho panel sums over the dust
// components and the (3, N) uniforms come in as inputs and the kernel draws
// nothing itself, so the plain PyTorch version
// (engine/fused_table.py::table_multi_event_plain) and this kernel see
// identical inputs.  The arithmetic follows the Pallas body operation for
// operation (built with -fmad=false; 1 - exp(-tau), never expm1; the albedo a
// true division ks / max(kr, 1e-30)).
//
// What bounds it on the H100: bytes.  Per live lane and event it reads 2 P
// panel values and 15 words of state and uniforms and writes 8 words, and
// does ~12 flops and one exp per panel.  At N = 2^17 lanes and P = 24 that
// is ~30 MB per event, ~9 us at 3.35 TB/s, against ~5 x 10^7 operations
// (~0.8 us at 67 TFLOP/s).
//
// Design:
// - One thread per lane, lanes bounds-checked.  kr and ks are panel-major,
//   so at a fixed panel neighbouring threads read neighbouring addresses.
// - Two running sums per panel stay in registers: the cumulative optical
//   depth (for the interaction panel) and the cumulative absorbed energy
//   (for the deposit panel), 2 x MAXP = 64 floats with guarded, fully
//   unrolled loops so every index is constant.  The C entry point refuses
//   more than MAXP panels.
// - The order of the Pallas body: the scattered luminosity (sum of the
//   per-panel albedo times the energy interacting there) replaces L before
//   the termination test, then the taupath > 0 gate, then the composite
//   bias weight p/q.
// - No direction leaves the kernel: the component selection at the
//   interaction cell and the HG scatter run torch-side.  The cell is located
//   at the hit panel's midpoint from the pre-event position.
// - Dead lanes copy their state through, deposit nothing and get cell -1.
// - Labs on and off are template instantiations.

#include "common.cuh"

// Mirrored field for field by kernels.TableMultiArgs (ctypes).
struct TableMultiArgs {
  const float* u;
  const float* kr;
  const float* ks;
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
  float* opx;
  float* opy;
  float* opz;
  float* oL;
  int* oalive;
  int* ocell;
  int* odepi;
  float* odepv;
  int N, nlambda, npanels, min_scatt;
  float xi, one_m_xi, inv_minred;
  Geom geo;
};

namespace {

template <bool LABS>
__global__ void __launch_bounds__(128)
table_multi_event_kernel(const __grid_constant__ TableMultiArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const long long N = a.N;
  const float* u = a.u;

  float X = a.px[n], Y = a.py[n], Z = a.pz[n];
  float L = a.L[n];
  bool alive = a.alive[n] != 0;

  int cell = -1;
  int depi = -1;
  float depv = 0.f;
  if (alive) {
    const float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
    const int nscatt = a.ns[n];
    const float Lth = a.L0[n] * a.inv_minred;
    const float t0 = a.t0[n], delta = a.dt[n];

    // -- cumulative optical depth and the per-panel absorbed energy -------
    float cums[MAXP], cws[MAXP];
    float cum = 0.f, e_prev = 1.f, Lsca = 0.f, cw = 0.f;
    const float Lm = L;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (k < a.npanels) {
        const float kr = a.kr[k * N + n];
        cum = cum + kr * delta;
        const float e_cur = expf(-cum);
        const float dE = Lm * (e_prev - e_cur);
        const float alb = a.ks[k * N + n] / fmaxf(kr, TINY);
        Lsca = Lsca + alb * dE;
        cw = cw + (1.f - alb) * dE;
        e_prev = e_cur;
      }
      cums[k] = cum;
      cws[k] = cw;
    }
    const float taupath = cum;

    // -- sampled absorption deposit: the panel drawn by absorbed energy ---
    if (LABS) {
      const float D = cw;
      const float target = u[2 * N + n] * D;
      int i_dep = 0;
#pragma unroll
      for (int k = 0; k < MAXP - 1; ++k)
        if (k < a.npanels - 1) i_dep += (cws[k] < target) ? 1 : 0;
      const float mid_dep = t0 + ((float)i_dep + 0.5f) * delta;
      const int c = locate(a.geo, X + mid_dep * DX, Y + mid_dep * DY,
                           Z + mid_dep * DZ);
      if (D > 0.f && c >= 0) {
        depi = c * a.nlambda + a.ell[n];
        depv = D;
      }
    }

    // -- scattered-luminosity update + termination (pre-bias L) -----------
    L = Lsca;
    alive = (L > 0.f) && !((L <= Lth) && (nscatt >= a.min_scatt)) &&
            (taupath > 0.f);

    // -- forced propagation with the composite bias weight p/q -----------
    const float one_m_e = 1.f - expf(-taupath);
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
    const float fr = dtau_h > 0.f ? (tau - cum_prev) / fmaxf(dtau_h, TINY) : 0.f;
    const float frac = fminf(fmaxf(fr, 0.f), 1.f);
    const float s = t0 + ((float)i_hit + frac) * delta;
    if (alive) {
      // the interaction cell: the hit panel's midpoint, pre-event position
      const float mid_h = t0 + ((float)i_hit + 0.5f) * delta;
      cell = locate(a.geo, X + mid_h * DX, Y + mid_h * DY, Z + mid_h * DZ);
      X = X + s * DX;
      Y = Y + s * DY;
      Z = Z + s * DZ;
    }
  }
  if (LABS) {
    a.odepi[n] = depi;
    a.odepv[n] = depv;
  }
  a.opx[n] = X;
  a.opy[n] = Y;
  a.opz[n] = Z;
  a.oL[n] = L;
  a.oalive[n] = alive ? 1 : 0;
  a.ocell[n] = cell;
}

template <bool LABS>
int launch(const TableMultiArgs& a, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (a.N + threads - 1) / threads;
  if (blocks > 0)
    table_multi_event_kernel<LABS><<<blocks, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int skirt_table_multi_args_size() {
  return (int)sizeof(TableMultiArgs);
}

extern "C" int skirt_table_multi_event(const TableMultiArgs* a, int labs,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->npanels < 1 || a->npanels > MAXP || a->nlambda < 1)
    return (int)cudaErrorInvalidValue;
  return labs ? launch<true>(*a, s) : launch<false>(*a, s);
}
