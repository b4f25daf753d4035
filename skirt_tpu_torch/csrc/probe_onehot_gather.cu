// PO: the one-hot gather probe on Hopper's tensor cores (mma.sync
// m16n8k16, bf16 in, float32 accumulate).
//
// Replaces the Pallas one-hot matrix-unit gathers of experiments/:
// microbench_mxu_gather.py:62 (the full gather, with and without the hi/lo
// split, group8 or not), microbench_mxu_gather2.py:48 (its stages),
// microbench_mxu_gather3.py:55 (stage variants and the fixed-B product) and
// microbench_mxu_gather4.py:91 kern_shape (fixed-B products, nmm per body).
//
// The table has T = 128 x 256 = 32,768 float32 entries, tab[hi * 256 + lo],
// held as tabT (256 lo rows, 128 hi columns) in bf16: th, and for the split
// also tl = bf16(tabT - th).  Indices come as (rows, 128) int32, rows a
// multiple of 8; a group is 8 rows (1,024 elements), and element (j, l) of
// group s is column c = 128 j + l of the group's one-hot B (128 x 1,024,
// B[h, c] = [hi_c == h]).  R = th @ B (256 x 1,024) holds th[r, hi_c] in
// column c.  What each stage writes (the Pallas variants' output formulas):
//   ONEHOT   out[8s + h, l] = sum_{j in J} [hi(8s + j, l) == h], h < 8
//            (mxu_gather2.py:63-66 with J = {0, 1}; mxu_gather3.py:67-86,
//            the oh_* variants, with J = 0..7); no product
//   MATMUL   out[8s + r, l] = sum_{j in J} R[r, 128 j + l], r < 8
//            (mxu_gather2.py:68-71, J = {0, 1, 2, 7})
//   FIXED_B  the same with R = sum_{m < nmm} th @ bfix (a fixed 128 x 1,024
//            bf16 matrix): mm_pure (mxu_gather3.py:61-66, J = {0, 1, 7},
//            nmm = 1) and kern_shape (mxu_gather4.py:95-106, J = {0, 7})
//   FULL     out[8s + j, l] = R[lo, 128 j + l] (+ the same with tl):
//            the gather th[lo, hi] (+ tl[lo, hi]) (mxu_gather.py:68-104,
//            mxu_gather2.py:72-80, mxu_gather3.py:87-100)
// Each non-zero output is a sum of a few bf16 values (every one-hot column
// has one 1), exact in float32 in any order, so the kernel is bit-identical
// to its plain version; the split adds th and tl once in float32 (two
// accumulators, one FADD, as the Pallas body adds its two products).
//
// What bounds it on the H100: the function is a gather (bytes: 8 per
// element); the one-hot formulation spends 2 x 256 x 128 products per
// element (twice with the split, nmm times for FIXED_B) on the tensor cores:
// 65,536 flop per element, 0.55 ms per 2^23 elements at 989 TFLOP/s.
//
// Design: 16 warps per block; warp w owns row tile w (rows 16w..16w+15) of
// every product and keeps its A fragments (th, and tl) for all 8 k-tiles in
// registers.  For each 8-element n-tile the one-hot B fragment is built in
// registers from hi (no memory), 8 mma.sync cover the depth of 128, and the
// thread whose C fragment holds row lo writes the element: each output is
// written by exactly one thread.  MATMUL and FIXED_B compute every row tile,
// as the Pallas products do, and keep rows 0..7 (warp 0).  The full product
// per element is what the probe measures; a gather that skips the zero
// k-tiles is later work.

#include <cuda_runtime.h>

namespace {

constexpr int STAGE_ONEHOT = 0;
constexpr int STAGE_MATMUL = 1;
constexpr int STAGE_FIXED_B = 2;
constexpr int STAGE_FULL = 3;
constexpr int WARPS = 16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 16 x 16 A fragment of rows r0..r0+15, depth k0..k0+15 of a (256, 128)
// bf16 table (m16n8k16 row-major A: lane g = lane / 4, q = lane % 4)
__device__ __forceinline__ void load_a(unsigned (&a)[4],
                                       const unsigned short* t, int r0,
                                       int k0, int g, int q) {
  const int k = k0 + 2 * q;
  a[0] = *reinterpret_cast<const unsigned*>(t + (r0 + g) * 128 + k);
  a[1] = *reinterpret_cast<const unsigned*>(t + (r0 + g + 8) * 128 + k);
  a[2] = *reinterpret_cast<const unsigned*>(t + (r0 + g) * 128 + k + 8);
  a[3] = *reinterpret_cast<const unsigned*>(t + (r0 + g + 8) * 128 + k + 8);
}

// one-hot B fragment for depth k0..k0+15 and the column whose hi is hv:
// B[k, n] = [hv == k] in bf16 (1.0 = 0x3F80), two values per register,
// the lower k in the low half
__device__ __forceinline__ unsigned onehot_pair(int hv, int k) {
  return (hv == k ? 0x3F80u : 0u) | (hv == k + 1 ? 0x3F800000u : 0u);
}

template <int STAGE, bool SPLIT>
__global__ void __launch_bounds__(WARPS * 32, 1)
probe_onehot(const unsigned short* __restrict__ th,
             const unsigned short* __restrict__ tl,
             const unsigned short* __restrict__ bfix,
             const int* __restrict__ idx, float* __restrict__ out,
             int ngroups, int jmask, int nmm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  unsigned ah[8][4], al[8][4];
  if (STAGE != STAGE_ONEHOT) {
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      load_a(ah[kt], th, 16 * warp, 16 * kt, g, q);
      if (SPLIT) load_a(al[kt], tl, 16 * warp, 16 * kt, g, q);
    }
  }
  for (int s = blockIdx.x; s < ngroups; s += gridDim.x) {
    const int* gidx = idx + (long long)s * 1024;
    float* gout = out + (long long)s * 1024;
    if (STAGE == STAGE_ONEHOT) {
      for (int o = threadIdx.x; o < 1024; o += blockDim.x) {
        const int h = o >> 7, l = o & 127;
        float acc = 0.f;
        for (int j = 0; j < 8; ++j)
          if ((jmask >> j) & 1)
            acc = acc + ((gidx[j * 128 + l] >> 8) == h ? 1.f : 0.f);
        gout[o] = acc;
      }
      continue;
    }
#pragma unroll 1
    for (int lt = 0; lt < 16; ++lt) {
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {
        const int e0 = j * 128 + lt * 8;  // first element of the n-tile
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        if (STAGE == STAGE_FIXED_B) {
          const unsigned short* bcol = bfix + e0 + g;
#pragma unroll 1
          for (int m = 0; m < nmm; ++m) {
            float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kt = 0; kt < 8; ++kt) {
              const int k = 16 * kt + 2 * q;
              const unsigned b0 = bcol[k * 1024] | (unsigned)bcol[(k + 1) * 1024]
                                                       << 16;
              const unsigned b1 = bcol[(k + 8) * 1024] |
                                  (unsigned)bcol[(k + 9) * 1024] << 16;
              mma_bf16(r, ah[kt], b0, b1);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) c[i] = m == 0 ? r[i] : c[i] + r[i];
          }
        } else {
          const int hv = gidx[e0 + g] >> 8;
          float cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < 8; ++kt) {
            const int k = 16 * kt + 2 * q;
            const unsigned b0 = onehot_pair(hv, k), b1 = onehot_pair(hv, k + 8);
            mma_bf16(c, ah[kt], b0, b1);
            if (SPLIT) mma_bf16(cl, al[kt], b0, b1);
          }
          if (SPLIT) {
#pragma unroll
            for (int i = 0; i < 4; ++i) c[i] = c[i] + cl[i];
          }
        }
        if (STAGE == STAGE_FULL) {
          const int2 lv = *reinterpret_cast<const int2*>(gidx + e0 + 2 * q);
          const int lo0 = lv.x & 255, lo1 = lv.y & 255;
          const int top = 16 * warp + g;
          float* o = gout + e0 + 2 * q;
          if (lo0 == top) o[0] = c[0];
          if (lo0 == top + 8) o[0] = c[2];
          if (lo1 == top) o[1] = c[1];
          if (lo1 == top + 8) o[1] = c[3];
        } else if (warp == 0 && ((jmask >> j) & 1)) {
          acc0 = acc0 + c[0];
          acc1 = acc1 + c[1];
        }
      }
      if (STAGE != STAGE_FULL && warp == 0)
        *reinterpret_cast<float2*>(gout + g * 128 + lt * 8 + 2 * q) =
            make_float2(acc0, acc1);
    }
  }
}

template <int STAGE, bool SPLIT>
int launch(const unsigned short* th, const unsigned short* tl,
           const unsigned short* bfix, const int* idx, float* out,
           int ngroups, int jmask, int nmm, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = ngroups < 2 * sms ? ngroups : 2 * sms;
  probe_onehot<STAGE, SPLIT><<<blocks, WARPS * 32, 0, s>>>(
      th, tl, bfix, idx, out, ngroups, jmask, nmm);
  return (int)cudaGetLastError();
}

}  // namespace

// stage: 0 onehot, 1 matmul, 2 fixed_B, 3 full; tl non-null splits the
// table (full only); rows = idx rows, a multiple of 8
extern "C" int skirt_probe_onehot_gather(const void* th, const void* tl,
                                         const void* bfix, const int* idx,
                                         float* out, int rows, int stage,
                                         int jmask, int nmm, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const auto* h = static_cast<const unsigned short*>(th);
  const auto* l = static_cast<const unsigned short*>(tl);
  const auto* b = static_cast<const unsigned short*>(bfix);
  const int ng = rows / 8;
  switch (stage) {
    case STAGE_ONEHOT:
      return launch<STAGE_ONEHOT, false>(h, l, b, idx, out, ng, jmask, nmm, s);
    case STAGE_MATMUL:
      return launch<STAGE_MATMUL, false>(h, l, b, idx, out, ng, jmask, nmm, s);
    case STAGE_FIXED_B:
      return launch<STAGE_FIXED_B, false>(h, l, b, idx, out, ng, jmask, nmm,
                                          s);
    case STAGE_FULL:
      return l ? launch<STAGE_FULL, true>(h, l, b, idx, out, ng, jmask, nmm, s)
               : launch<STAGE_FULL, false>(h, l, b, idx, out, ng, jmask, nmm,
                                           s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
