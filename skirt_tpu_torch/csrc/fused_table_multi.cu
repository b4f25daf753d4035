// K5: monochromatic multi-component table-mode event, one thread per lane.
//
// Replaces: skirt_tpu/engine/fused_table.py:248 `_build_kernel_multi` (the
// Pallas body at :280-390), called at :682.  Same input/output contract: the
// staged (P, N) kappa_ext * rho and kappa_sca * rho panel sums over the dust
// components and the (3, N) uniforms come in as inputs and the kernel draws
// nothing itself, so the plain PyTorch version
// (engine/fused_table.py::table_multi_event_plain) and this kernel see
// identical inputs.  The arithmetic follows the Pallas body operation for
// operation (built with -fmad=false; 1 - exp(-tau), never expm1; the albedo
// the correctly rounded quotient ks / max(kr, 1e-30)), so the two agree to
// the bit.
//
// What bounds it on the H100: bytes.  Per live lane and event it reads 2 P
// panel values and 15 words of state and uniforms and writes 8 words, and
// does ~14 operations and one exp per panel.  At N = 2^17 lanes and P = 24
// that is ~30 MB per event, ~9 us at 3.35 TB/s, against ~5 x 10^7
// operations (~0.8 us at 67 TFLOP/s).  The first design (the two running
// sums in 64 registers, 92 a thread, 5 blocks of 128 per SM: 1.55 waves at
// N = 2^17; each panel's albedo an IEEE division whose slow-path branch
// kept the panels' loads and exps from overlapping) sat 3.7x off it.
//
// Design:
// - A block holds LANES = 128 lanes.  A live lane's 2 P panel values are
//   staged into shared memory ([row][lane]) by asynchronous copies, all in
//   flight at once; its state and uniforms are plain loads issued beside
//   them.
// - The two running sums over the panels (the cumulative optical depth I_k
//   for the interaction, the cumulative absorbed energy for the deposit)
//   are written over the lane's own panel values, so registers hold no
//   array: at up to 64 registers a thread and 25 KB a block (P = 24) eight
//   blocks fit on an SM and N = 2^17 runs in one wave.
// - The albedo is div_rn<false> (common.cuh): branch-free and correctly
//   rounded while the operands lie well inside the normal range, a zero
//   numerator taken as the quotient itself (ks = 0 where kr = 0), operands
//   below 2^-64 both scaled by 2^64 first (exact).  Where an operand still
//   leaves that range, the lane's sums are redone out of line with the
//   division operator from the panels in device memory
//   (panel_sums_exact).
// - Both inversions are counts by binary search: the optical depths never
//   decrease (kr >= 0, dt >= 0); nor do the absorbed energies, since
//   fl(kappa_sca rho) <= fl(kappa_ext rho) for each component, so ks <= kr
//   and the albedo <= 1, while e^{-I_k} never grows.  The kernel checks the
//   second as it sums (a float exp need not be monotone) and counts
//   linearly where it fails.
// - The order of the Pallas body: the scattered luminosity (sum of the
//   per-panel albedo times the energy interacting there) replaces L before
//   the termination test, then the taupath > 0 gate, then the composite
//   bias weight p/q.
// - No direction leaves the kernel: the component selection at the
//   interaction cell and the HG scatter run torch-side.  The cell is located
//   at the hit panel's midpoint from the pre-event position.
// - Dead lanes copy their state through, deposit nothing and get cell -1.
// - A form with two threads a lane (one the optical-depth chain and its
//   exponentials, the other the albedo divisions, then one energy sum and
//   one inversion each; 4 P values a lane in shared memory, 64 lanes a
//   block) ran 1.15x slower at N = 2^17, P = 24 (PERF.md section 6).
// - Labs on and off are template instantiations.
// - Past MAXP panels (CHUNKED, picked by the C entry point) nothing is
//   staged: the lane walks its panels from device memory in chunks of
//   CH = 32, with the division operator, keeping each chunk's last optical
//   depth and absorbed energy in the scratch array cend ((2 nchunks, N));
//   each inversion walks again only the chunk its target falls in, from
//   the previous chunk's ends (common.cuh chunk_invert), or, where the
//   absorbed energies decrease somewhere, every chunk, counting.

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
  float* cend;
};

namespace {

constexpr int LANES = 128;            // lanes (threads) a block

// the count of s[k * LANES] < target over k < m: by binary search where
// the sums never decrease (mono), else one by one
__device__ __forceinline__ int count_sums_below(const float* s, int m,
                                                float target, bool mono) {
  if (mono) return count_below(s, LANES, m, target);
  int c = 0;
  for (int k = 0; k < m; ++k) c += (s[k * LANES] < target) ? 1 : 0;
  return c;
}

// The lane's panel sums: the cumulative optical depth (into cums[k *
// LANES]), the scattered luminosity Lsca and the cumulative absorbed energy
// (into cws[k * LANES]) from its panels kr[k * stride], ks[k * stride]
// (cums and cws may be the panels' own slots: each is read before it is
// written).  With EXACT the albedo is the division operator; without,
// div_rn, which clears the return value where an operand leaves its range.
// mono: the absorbed energies never decrease.
template <bool EXACT>
__device__ __forceinline__ bool panel_sums(const float* kr, const float* ks,
                                           long long stride, float* cums,
                                           float* cws, int P, float delta,
                                           float Lm, float& taupath,
                                           float& Lsca, float& D,
                                           bool& mono) {
  bool ok = true;
  float cum = 0.f, e_prev = 1.f, sca = 0.f, cw = 0.f;
  mono = true;
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    if (k < P) {
      const float krv = kr[k * stride], ksv = ks[k * stride];
      cum = cum + krv * delta;
      const float e_cur = expf(-cum);
      const float dE = Lm * (e_prev - e_cur);
      const float b = fmaxf(krv, TINY);
      // below 2^-64 both operands scaled by 2^64 (exact: the quotient and
      // its rounding are unchanged) to stay inside div_rn's range
      const float sc = b < 0x1p-64f ? 0x1p64f : 1.f;
      const float alb =
          EXACT ? ksv / b
                : (ksv == 0.f ? ksv : div_rn<false>(ksv * sc, b * sc, ok));
      sca = sca + alb * dE;
      const float cw_next = cw + (1.f - alb) * dE;
      mono = mono && cw_next >= cw;
      cw = cw_next;
      e_prev = e_cur;
      cums[k * LANES] = cum;
      cws[k * LANES] = cw;
    }
  }
  taupath = cum;
  Lsca = sca;
  D = cw;
  return ok;
}

// panel_sums with the division operator, from the panels in device memory,
// out of line: the rare lane with an operand out of div_rn's range
__device__ __noinline__ void panel_sums_exact(const TableMultiArgs& a, int n,
                                              float* cums, float* cws,
                                              float delta, float Lm,
                                              float& taupath, float& Lsca,
                                              float& D, bool& mono) {
  panel_sums<true>(a.kr + n, a.ks + n, a.N, cums, cws, a.npanels, delta, Lm,
                   taupath, Lsca, D, mono);
}

// The chunked route's walk over a lane's panels in device memory (kr[k *
// N], ks[k * N]): panel_sums' arithmetic with the division operator, from
// the start of any chunk.  ends: the lane's column of cend, the optical
// depths' chunk ends in rows [0, nc), the absorbed energies' in [nc, 2 nc).
struct ChunkWalk {
  const float* kr;
  const float* ks;
  const float* ends;
  long long N;
  int nc;
  float delta, Lm;
  float cum, e_prev, sca, cw;
  // the state at the start of chunk c
  __device__ __forceinline__ void restart(int c) {
    cum = c > 0 ? ends[(c - 1) * N] : 0.f;
    cw = c > 0 ? ends[(nc + c - 1) * N] : 0.f;
    e_prev = c > 0 ? expf(-cum) : 1.f;
    sca = 0.f;
  }
  // advance by panel k; false where the absorbed energy decreased
  __device__ __forceinline__ bool next(int k) {
    const float krv = kr[k * N], ksv = ks[k * N];
    cum = cum + krv * delta;
    const float e_cur = expf(-cum);
    const float dE = Lm * (e_prev - e_cur);
    const float alb = ksv / fmaxf(krv, TINY);
    sca = sca + alb * dE;
    const float cw_next = cw + (1.f - alb) * dE;
    const bool up = cw_next >= cw;
    cw = cw_next;
    e_prev = e_cur;
    return up;
  }
};

// The rest of a live lane's event from its sums: the deposit, the
// termination, the biased forced propagation and the interaction cell.
// cums / cws: the lane's running sums at stride LANES.
template <bool LABS, bool CHUNKED>
__device__ __forceinline__ void lane_finish(
    const TableMultiArgs& a, int n, const float* cums, const float* cws,
    ChunkWalk& cw_walk, bool mono, float taupath, float Lsca, float D,
    float u0, float u1,
    float u2, float X, float Y, float Z, float DX, float DY, float DZ,
    int nscatt, float Lth, float t0, float delta, int ell, float& oX,
    float& oY, float& oZ, float& oL, bool& alive, int& cell, int& depi,
    float& depv) {
  const int P = a.npanels;
  if (LABS) {
    const float target = u2 * D;
    int i_dep = 0;
    if constexpr (CHUNKED) {
      ChunkWalk& w = cw_walk;
      if (mono) {
        float at, before;
        i_dep = chunk_invert(
            w.ends + w.nc * w.N, w.N, P - 1, target,
            [&](int c) {
              w.restart(c);
              return w.cw;
            },
            [&](int k) {
              w.next(k);
              return w.cw;
            },
            at, before);
      } else {
        w.restart(0);
        for (int k = 0; k < P - 1; ++k) {
          w.next(k);
          i_dep += (w.cw < target) ? 1 : 0;
        }
      }
    } else {
      i_dep = count_sums_below(cws, P - 1, target, mono);
    }
    const float mid_dep = t0 + ((float)i_dep + 0.5f) * delta;
    const int c = locate(a.geo, X + mid_dep * DX, Y + mid_dep * DY,
                         Z + mid_dep * DZ);
    if (D > 0.f && c >= 0) {
      depi = c * a.nlambda + ell;
      depv = D;
    }
  }
  // -- scattered-luminosity update + termination (pre-bias L) -----------
  float L = Lsca;
  alive = (L > 0.f) && !((L <= Lth) && (nscatt >= a.min_scatt)) &&
          (taupath > 0.f);
  // -- forced propagation with the composite bias weight p/q -----------
  const float one_m_e = 1.f - expf(-taupath);
  const float tau_exp = expon_cutoff(u1, taupath);
  float tau = tau_exp;
  if (a.xi != 0.f) {
    tau = u0 < a.xi ? u1 * taupath : tau_exp;
    const float p = expf(-tau) / fmaxf(one_m_e, TINY);
    const float qq = a.one_m_xi * p + a.xi / fmaxf(taupath, TINY);
    if (alive) L = L * (p / fmaxf(qq, 1e-37f));
  }
  int i_hit;
  float cum_h, cum_prev;
  if constexpr (CHUNKED) {
    // the optical depth alone: each step adds kr * delta
    ChunkWalk& w = cw_walk;
    i_hit = chunk_invert(
        w.ends, w.N, P - 1, tau,
        [&](int c) {
          w.cum = c > 0 ? w.ends[(c - 1) * w.N] : 0.f;
          return w.cum;
        },
        [&](int k) {
          w.cum = w.cum + w.kr[k * w.N] * w.delta;
          return w.cum;
        },
        cum_h, cum_prev);
  } else {
    i_hit = count_below(cums, LANES, P - 1, tau);
    cum_h = cums[i_hit * LANES];
    cum_prev = i_hit > 0 ? cums[(i_hit - 1) * LANES] : 0.f;
  }
  const float dtau_h = cum_h - cum_prev;
  const float fr =
      dtau_h > 0.f ? (tau - cum_prev) / fmaxf(dtau_h, TINY) : 0.f;
  const float frac = fminf(fmaxf(fr, 0.f), 1.f);
  const float s = t0 + ((float)i_hit + frac) * delta;
  oL = L;
  oX = X;
  oY = Y;
  oZ = Z;
  if (alive) {
    // the interaction cell: the hit panel's midpoint, pre-event position
    const float mid_h = t0 + ((float)i_hit + 0.5f) * delta;
    cell = locate(a.geo, X + mid_h * DX, Y + mid_h * DY, Z + mid_h * DZ);
    oX = X + s * DX;
    oY = Y + s * DY;
    oZ = Z + s * DZ;
  }
}

template <bool LABS, bool CHUNKED>
__global__ void __launch_bounds__(128, 8)
table_multi_event_kernel(const __grid_constant__ TableMultiArgs a) {
  extern __shared__ float dyn[];
  const int l = threadIdx.x;
  const int n = blockIdx.x * LANES + l;
  const int P = a.npanels;
  float* sk = dyn + l;                // [P][LANES] kr, then the I_k
  float* ss = sk + P * LANES;         // [P][LANES] ks, then the absorbed sums
  if (n >= a.N) return;
  const long long N = a.N;

  // -- the live lane's 2 P panel values by asynchronous copies, all in
  //    flight at once; its state and uniforms beside them -----------------
  const bool live = a.alive[n] != 0;
  if (live && !CHUNKED) {
    stage_rows<LANES>(sk, a.kr, P, N, n, 0, 1);
    stage_rows<LANES>(ss, a.ks, P, N, n, 0, 1);
  }
  __pipeline_commit();
  const float X = a.px[n], Y = a.py[n], Z = a.pz[n];
  const float L = a.L[n];
  int cell = -1, depi = -1;
  float depv = 0.f;
  float oX = X, oY = Y, oZ = Z, oL = L;
  bool alive = live;
  if (live) {
    const float DX = a.dx[n], DY = a.dy[n], DZ = a.dz[n];
    const int nscatt = a.ns[n], ell = a.ell[n];
    const float Lth = a.L0[n] * a.inv_minred;
    const float t0 = a.t0[n], delta = a.dt[n];
    const float u0 = a.u[n], u1 = a.u[N + n], u2 = a.u[2 * N + n];
    __pipeline_wait_prior(0);

    // -- the running sums, written over the lane's panels; in chunks, the
    //    chunks' ends into cend ---------------------------------------------
    float taupath, Lsca, D;
    bool mono;
    ChunkWalk w;
    if constexpr (CHUNKED) {
      w.kr = a.kr + n;
      w.ks = a.ks + n;
      w.ends = a.cend + n;
      w.N = N;
      w.nc = nchunks(P);
      w.delta = delta;
      w.Lm = L;
      w.restart(0);
      mono = true;
      for (int k = 0; k < P; ++k) {
        mono = w.next(k) && mono;
        if ((k & (CH - 1)) == CH - 1 || k == P - 1) {
          a.cend[(k / CH) * N + n] = w.cum;
          a.cend[(w.nc + k / CH) * N + n] = w.cw;
        }
      }
      taupath = w.cum;
      Lsca = w.sca;
      D = w.cw;
    } else {
      if (!panel_sums<false>(sk, ss, LANES, sk, ss, P, delta, L, taupath,
                             Lsca, D, mono))
        panel_sums_exact(a, n, sk, ss, delta, L, taupath, Lsca, D, mono);
    }
    lane_finish<LABS, CHUNKED>(a, n, sk, ss, w, mono, taupath, Lsca, D, u0,
                               u1, u2, X, Y, Z, DX, DY, DZ, nscatt, Lth, t0,
                               delta, ell, oX, oY, oZ, oL, alive, cell, depi,
                               depv);
  }
  if (LABS) {
    a.odepi[n] = depi;
    a.odepv[n] = depv;
  }
  a.opx[n] = oX;
  a.opy[n] = oY;
  a.opz[n] = oZ;
  a.oL[n] = oL;
  a.oalive[n] = alive ? 1 : 0;
  a.ocell[n] = cell;
}

template <bool LABS, bool CHUNKED>
int launch(const TableMultiArgs& a, cudaStream_t s) {
  const int blocks = (a.N + LANES - 1) / LANES;
  if (blocks <= 0) return (int)cudaGetLastError();
  const size_t smem =
      CHUNKED ? 0 : (size_t)2 * a.npanels * LANES * sizeof(float);
  table_multi_event_kernel<LABS, CHUNKED><<<blocks, LANES, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int skirt_table_multi_args_size() {
  return (int)sizeof(TableMultiArgs);
}

extern "C" int skirt_table_multi_event(const TableMultiArgs* a, int labs,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->npanels < 1 || a->nlambda < 1) return (int)cudaErrorInvalidValue;
  if (a->npanels <= MAXP)
    return labs ? launch<true, false>(*a, s) : launch<false, false>(*a, s);
  if (!a->cend) return (int)cudaErrorInvalidValue;
  return labs ? launch<true, true>(*a, s) : launch<false, true>(*a, s);
}
