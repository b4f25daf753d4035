// The exact peel's column integrals: per lane and observer direction
// (leader) the integral of each dust component's density along the ray
// from the lane's point to where it leaves the grid, exact for the
// piecewise-constant voxel field, times 1 / |k_a|; or their sum weighted
// by the lanes' opacities (the peel's optical depths).
//
// Replaces no Pallas kernel: skirt_tpu computes the exact peel in XLA
// (skirt_tpu/engine/fused_table.py:395-540, a two-pointer merge of the
// lateral crossings and (lanes, Kp, n_a) overlap tensors).  The port's
// plain version is engine/fused_table.py::make_exact_peel's
// `leader_sums`, which sorts the crossings and clamps every column's
// a-interval against all n_a voxel edges: (lanes, Kp, n_a) tensors in
// ~180 launches a leader.  It stays the spec; CPU tensors run it.
//
// What bounds it on the H100: bytes, as rtbench/roofline.py counts them:
// 4 B for each voxel a ray crosses, per component, and 16 B a ray (its
// point and its result).  At the agn-torus cell's 2^15 lanes x 10 leaders
// on 64^3 voxels that is ~35 MB a pass, ~10 us at 3.35 TB/s.
//
// Design:
// - One thread per (lane, leader) ray, leaders along blockIdx.y: the 32
//   rays of a warp share one direction, so their walks run similar
//   lengths.  A leader's constants (its axes, the float32 components, the
//   crossing sequences' first-step coefficients, steps and nudges) come
//   from a row of `lead` that the wrapper builds once (ops/exact_peel.py
//   leader_row), the same values leader_sums computes.
// - The voxels are read straight from the (H, nx, ny, nz) float32
//   densities through the read-only path: 1 MB a component at 64^3,
//   which stays in the 50 MB L2 across the leaders, so a pass reads the
//   field from DRAM about once; no per-leader row-permuted copy exists.
// - The walk is leader_sums' own float32 arithmetic wherever it decides
//   a boundary (built with -fmad=false, one rounding an operation): the
//   grid box's exit (grid.ray_span), the two lateral axes' wall-crossing
//   sequences (cross_seq: the first crossing with its 1e-6 step nudge,
//   then first + m * step), merged by two pointers (the order torch.sort
//   gives; ties leave empty segments either way), at most Kp - 1 kept,
//   each segment's midpoint and the floors that give its column, and the
//   column's [a_near, a_far] clamped against the a-voxel edges lo + dx * v.
//   Only the a-voxels the interval can overlap are visited (its floors
//   widened by one each side, each overlap still clamped at zero), not
//   all n_a; so the result is exact for the voxel field as the plain one
//   is, and differs from it only in the order of the float32 sums.
// - The H component sums stay in registers (HG at a time: H = 1 and 2
//   in one walk, more in groups of 4, each group walking the ray again).
//   Integrals out: (L, H, N) I_h / |k_a|.  Optical depths out: (L, N)
//   sum_h kext[h] * I_h / |k_a|, h in order, as leader_tau adds them.
// - Components below 1e-12 in magnitude are zero, as in the plain version:
//   that axis has no crossings (the 0 and 90 deg SKIRTOR leaders).
// - No atomics, no shared memory, no allocation: every output is written
//   once by its thread, so two launches give the same bits, and the
//   launch can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
// floats of a leader's row in `lead` (ops/exact_peel.py ROW and
// leader_row give the layout)
constexpr int ROW = 32;
constexpr float BIG = 3.4e38f;

// one lateral axis of a leader: its wall crossings along the ray
struct Lateral {
  bool active, positive;
  float lo, inv, coef, step, thr;
};

__device__ __forceinline__ Lateral lateral(const float* r) {
  Lateral s;
  s.active = __ldg(r) != 0.f;
  s.positive = __ldg(r + 1) != 0.f;
  s.lo = __ldg(r + 2);
  s.inv = __ldg(r + 3);
  s.coef = __ldg(r + 4);
  s.step = __ldg(r + 5);
  s.thr = __ldg(r + 6);
  return s;
}

// cross_seq's first crossing: the distance to the next wall in voxel
// units times |dx / k|, a step further where it lies within 1e-6 steps
__device__ __forceinline__ float first_crossing(float p, const Lateral& s) {
  const float i0 = (p - s.lo) * s.inv;
  float first = s.positive ? (ceilf(i0) - i0) * s.coef
                           : (i0 - floorf(i0)) * s.coef;
  if (first <= s.thr) first = first + s.step;
  return first;
}

// crossing m of an active axis (first + m * step, two roundings), or INF
// at or past the exit
__device__ __forceinline__ float crossing(float first, int m,
                                          const Lateral& s, float t_exit) {
  const float t = first + (float)m * s.step;
  return t < t_exit ? t : CUDART_INF_F;
}

// grid.ray_span's stop: the slab test on the float32 box, 0 for a ray
// that misses it
__device__ __forceinline__ float ray_exit(const float p[3], const float k[3],
                                          const float lo[3],
                                          const float hi[3]) {
  float t_near = 0.f, t_far = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float near, far;
    if (fabsf(k[i]) > 1e-30f) {
      const float inv = 1.0f / k[i];
      const float t1 = (lo[i] - p[i]) * inv;
      const float t2 = (hi[i] - p[i]) * inv;
      near = fminf(t1, t2);
      far = fmaxf(t1, t2);
    } else {
      const bool in_slab = p[i] >= lo[i] && p[i] <= hi[i];
      near = in_slab ? -BIG : BIG;
      far = in_slab ? BIG : -BIG;
    }
    t_near = i ? fmaxf(t_near, near) : near;
    t_far = i ? fminf(t_far, far) : far;
  }
  const float t_start = fmaxf(t_near, 0.f);
  return (t_start <= t_far && t_far > 0.f) ? t_far : 0.f;
}

__device__ __forceinline__ float pick(const float v[3], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ int pick(const int v[3], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

struct Box {
  float lo[3], hi[3];
};

template <int HG>
__global__ void __launch_bounds__(THREADS)
exact_peel_kernel(const float* __restrict__ pos, const float* __restrict__ rho,
                  const float* __restrict__ lead,
                  const float* __restrict__ kext, float* __restrict__ out,
                  int N, int H, int nx, int ny, int nz, Box box) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int j = blockIdx.y;
  const float* r = lead + (size_t)j * ROW;
  const int a = (int)__ldg(r), b = (int)__ldg(r + 1), c = (int)__ldg(r + 2);
  const float ka = __ldg(r + 3), kb = __ldg(r + 4), kc = __ldg(r + 5);
  const float kdir[3] = {__ldg(r + 6), __ldg(r + 7), __ldg(r + 8)};
  const float inv_ka = __ldg(r + 9);
  const int kept = (int)__ldg(r + 10) - 1;      // crossings kept: Kp - 1
  const Lateral sb = lateral(r + 11), sc = lateral(r + 18);
  const float lo_a = __ldg(r + 25), dx_a = __ldg(r + 26);
  const float inv_a = __ldg(r + 27);

  const float p[3] = {__ldg(pos + 3 * (size_t)n), __ldg(pos + 3 * (size_t)n + 1),
                      __ldg(pos + 3 * (size_t)n + 2)};
  const float t_exit = ray_exit(p, kdir, box.lo, box.hi);
  const float pa = pick(p, a), pb = pick(p, b), pc = pick(p, c);
  const int nxyz[3] = {nx, ny, nz};
  const int strides[3] = {ny * nz, nz, 1};
  const int na = pick(nxyz, a), nb = pick(nxyz, b), nc = pick(nxyz, c);
  const int st_a = pick(strides, a), st_b = pick(strides, b),
            st_c = pick(strides, c);
  const float fb0 = sb.active ? first_crossing(pb, sb) : 0.f;
  const float fc0 = sc.active ? first_crossing(pc, sc) : 0.f;
  const size_t nvox = (size_t)nx * ny * nz;

  float tau = 0.f;
  for (int h0 = 0; h0 < H; h0 += HG) {
    float s[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) s[h] = 0.f;
    const float* rho_g = rho + (size_t)h0 * nvox;

    // the segment [t_in, t_out] of one column: its a-voxels' overlaps
    auto segment = [&](float t_in, float t_out) {
      if (!(t_out > t_in)) return;
      const float tmid = 0.5f * (t_in + t_out);
      const float fb = floorf(((pb + tmid * kb) - sb.lo) * sb.inv);
      const float fc = floorf(((pc + tmid * kc) - sc.lo) * sc.inv);
      if (!(fb >= 0.f && fb < (float)nb && fc >= 0.f && fc < (float)nc))
        return;
      const float a_in = pa + t_in * ka;
      const float a_out = pa + t_out * ka;
      const float a_near = fminf(a_in, a_out), a_far = fmaxf(a_in, a_out);
      const float v0 = fmaxf(floorf((a_near - lo_a) * inv_a) - 1.f, 0.f);
      const float v1 = fminf(floorf((a_far - lo_a) * inv_a) + 1.f,
                             (float)(na - 1));
      if (!(v0 <= v1)) return;
      const int col = (int)fb * st_b + (int)fc * st_c;
      for (int v = (int)v0; v <= (int)v1; ++v) {
        const float e0 = lo_a + dx_a * (float)v;
        const float e1 = lo_a + dx_a * (float)(v + 1);
        const float ov = fminf(a_far, e1) - fmaxf(a_near, e0);
        if (ov > 0.f) {
          const float* cell = rho_g + col + (size_t)v * st_a;
#pragma unroll
          for (int h = 0; h < HG; ++h)
            if (h0 + h < H) s[h] = s[h] + __ldg(cell + (size_t)h * nvox) * ov;
        }
      }
    };

    // the lateral crossings in order, two pointers over the two sequences
    int mb = 0, mc = 0;
    float tb = sb.active ? crossing(fb0, 0, sb, t_exit) : CUDART_INF_F;
    float tc = sc.active ? crossing(fc0, 0, sc, t_exit) : CUDART_INF_F;
    float t_in = 0.f;
    for (int q = 0; q < kept; ++q) {
      float t;
      if (tb <= tc) {
        t = tb;
        tb = crossing(fb0, ++mb, sb, t_exit);
      } else {
        t = tc;
        tc = crossing(fc0, ++mc, sc, t_exit);
      }
      if (!(t < CUDART_INF_F)) break;
      segment(t_in, t);
      t_in = t;
    }
    segment(t_in, t_exit);

#pragma unroll
    for (int h = 0; h < HG; ++h) {
      if (h0 + h >= H) continue;
      if (kext)
        tau = tau + __ldg(kext + (size_t)(h0 + h) * N + n) * s[h];
      else
        out[((size_t)j * H + h0 + h) * N + n] = s[h] * inv_ka;
    }
  }
  if (kext) out[(size_t)j * N + n] = tau * inv_ka;
}

template <int HG>
int launch(const float* pos, const float* rho, const float* lead,
           const float* kext, float* out, int N, int H, int L, int nx, int ny,
           int nz, const Box& box, cudaStream_t s) {
  const dim3 grid((N + THREADS - 1) / THREADS, L);
  exact_peel_kernel<HG><<<grid, THREADS, 0, s>>>(pos, rho, lead, kext, out, N,
                                                  H, nx, ny, nz, box);
  return (int)cudaGetLastError();
}

}  // namespace

// The exact peel of N lanes at pos ((N, 3) float32) toward L leaders
// (`lead`, (L, ROW) float32 rows) through H density fields (rho, (H, nx, ny,
// nz) float32) inside the float32 box lo, hi (3 each): with kext ((H, N)
// float32) out is (L, N) optical depths, without (null) the (L, H, N)
// integrals.  Refuses empty fields, more than 65,535 leaders and a
// crossing sequence one thread's index cannot hold.
extern "C" int skirt_exact_peel(const float* pos, const float* rho,
                                const float* lead, const float* kext,
                                float* out, int N, int H, int L, int nx,
                                int ny, int nz, const float* lo,
                                const float* hi, void* stream) {
  if (N <= 0 || L <= 0) return (int)cudaGetLastError();
  if (H < 1 || L > 65535 || nx < 1 || ny < 1 || nz < 1 ||
      (long long)nx * ny * nz > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  Box box;
  for (int i = 0; i < 3; ++i) {
    box.lo[i] = lo[i];
    box.hi[i] = hi[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (H == 1) return launch<1>(pos, rho, lead, kext, out, N, H, L, nx, ny, nz,
                               box, s);
  if (H == 2) return launch<2>(pos, rho, lead, kext, out, N, H, L, nx, ny, nz,
                               box, s);
  return launch<4>(pos, rho, lead, kext, out, N, H, L, nx, ny, nz, box, s);
}
