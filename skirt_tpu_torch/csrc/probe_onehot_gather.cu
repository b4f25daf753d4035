// PO: the one-hot gather probe on Hopper's tensor cores: wgmma with the
// one-hot as the register operand (bf16 in, float32 accumulate).
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
// to its plain version.  The split accumulates the th product and then the
// tl product into the same registers: every product term but one is an
// exact zero, and th + tl (8 significant bits each, tl at least 2^-8 of th
// apart) is exact in float32, so the sum is the plain version's one
// float32 add.
//
// What bounds it on the H100: the function is a gather (bytes: 8 per
// element); the one-hot formulation spends 2 x 256 x 128 products per
// element (twice with the split, nmm times for FIXED_B) on the tensor cores:
// 65,536 flop per element, 0.56 ms per 2^23 elements at 989 TFLOP/s (1.11
// ms with the split), which only wgmma reaches.  The first design
// (mma.sync m16n8k16, 16 warps a block each owning 16 of the 256 rows, a
// chain of 8 dependent mma.sync per 8 elements, every warp reloading the
// same indices and rebuilding the same one-hot) ran at ~10% of that rate.
//
// Design: the transposed product R^T = onehot(hi)^T th^T per 64 elements.
// - A warpgroup (4 warps) takes 64 elements (M = 64), the depth K = 128 hi
//   values as 8 k-steps of 16, and N = 256 lo rows: one wgmma m64n256k16
//   per k-step, its A the one-hot built in registers from the elements'
//   indices (the mma.sync A-fragment layout: each thread holds rows g and
//   g + 8 of its warp's 16, each index loaded once), its B th^T (and tl^T)
//   in shared memory, copied once per persistent block in the no-swizzle
//   K-major layout of 8 x 8 core matrices (LBO: the next 8 k, SBO: the next
//   8 rows).
// - The thread whose accumulator holds (element, lo) writes the element:
//   its value is picked from the 128 accumulators by a select tree on lo's
//   bits (a template recursion, so every register index is a constant).
//   Each element is written once.
// - MATMUL and FIXED_B run the full product of every j of a group, as the
//   Pallas products do, and keep columns 0..7 (r < 8) of the j in J, summed
//   in order in registers.  FIXED_B's A is bfix^T, read through L2 (every
//   block reads the same 256 KB); its nmm products accumulate in the
//   tensor core (exact: a few bf16 terms).
// - Two warpgroups a block, one block an SM (128 accumulators and 32 A
//   registers a thread): one warpgroup's selects and index loads overlap
//   the other's products.
// - ONEHOT has no product: one thread per output, as before.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int STAGE_ONEHOT = 0;
constexpr int STAGE_MATMUL = 1;
constexpr int STAGE_FIXED_B = 2;
constexpr int STAGE_FULL = 3;
constexpr int WG = 2;                     // warpgroups a block
constexpr int THREADS = 128 * WG;
constexpr int TAB = 256 * 128;            // bf16 values of th (and tl)

// th's (n, k) value in the no-swizzle K-major layout: core matrix (k / 8,
// n / 8) of 8 x 8 bf16 (128 bytes, row n % 8 at 16 bytes each), the k / 8
// columns 32 core matrices (4,096 bytes) apart
__device__ __forceinline__ int b_offset(int n, int k) {
  return ((k >> 3) * 32 + (n >> 3)) * 64 + (n & 7) * 8 + (k & 7);
}

// wgmma shared-memory descriptor of the 16 x 256 slice at k-step ks (the
// no-swizzle layout: LBO the next 8 k, SBO the next 8 rows)
__device__ __forceinline__ unsigned long long b_desc(const unsigned short* b,
                                                     int ks) {
  return smem_desc(smem_addr(b) + ks * 2 * 4096, 4096, 128, LAYOUT_NONE);
}

// one-hot pair for depth k, k + 1 and the element whose hi is hv: bf16 1.0
// (0x3F80) where hv matches, the lower k in the low half
__device__ __forceinline__ unsigned onehot_pair(int hv, int k) {
  return (hv == k ? 0x3F80u : 0u) | (hv == k + 1 ? 0x3F800000u : 0u);
}

// the one-hot A fragments of the 8 k-steps for rows with hi h0 (row g) and
// h1 (row g + 8)
__device__ __forceinline__ void onehot_a(unsigned (&a)[8][4], int h0, int h1,
                                         int q) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int k = 16 * ks + 2 * q;
    a[ks][0] = onehot_pair(h0, k);
    a[ks][1] = onehot_pair(h1, k);
    a[ks][2] = onehot_pair(h0, k + 8);
    a[ks][3] = onehot_pair(h1, k + 8);
  }
}

// the 8 k-steps' products into d, over one table; first: overwrite d
__device__ __forceinline__ void product(float (&d)[128],
                                        const unsigned (&a)[8][4],
                                        const unsigned short* b, bool first) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    wgmma_256(d, a[ks], b_desc(b, ks), (first && ks == 0) ? 0 : 1);
}

// d[4 * b + OFF + odd] for the block b = lo >> 3 of column lo, among the
// blocks [B0, B0 + NB) (NB a power of two, B0 a multiple of it): a tree of
// selects on b's bits, every register index a constant
template <int B0, int NB, int OFF>
__device__ __forceinline__ float pick_blocks(const float (&d)[128], int b,
                                             bool odd) {
  if constexpr (NB == 1) {
    return odd ? d[4 * B0 + OFF + 1] : d[4 * B0 + OFF];
  } else {
    constexpr int HALF = NB / 2;
    const float lo = pick_blocks<B0, HALF, OFF>(d, b, odd);
    const float hi = pick_blocks<B0 + HALF, HALF, OFF>(d, b, odd);
    return (b & HALF) ? hi : lo;
  }
}

// the accumulator of column lo in the row OFF / 2 (0: row g, 2: row g + 8)
template <int OFF>
__device__ __forceinline__ float pick(const float (&d)[128], int lo) {
  return pick_blocks<0, 32, OFF>(d, lo >> 3, lo & 1);
}

template <int STAGE, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
probe_onehot(const unsigned short* __restrict__ th,
             const unsigned short* __restrict__ tl,
             const unsigned short* __restrict__ bfix,
             const int* __restrict__ idx, float* __restrict__ out,
             int ngroups, int jmask, int nmm) {
  extern __shared__ __align__(128) unsigned short sb[];   // th^T, tl^T
  const int tid = threadIdx.x;
  // -- B once per block: th (and tl) into the core-matrix layout ----------
  for (int t = tid; t < TAB / 8; t += THREADS) {
    const int n = t >> 4, k = (t & 15) * 8;
    *reinterpret_cast<uint4*>(sb + b_offset(n, k)) =
        *reinterpret_cast<const uint4*>(th + n * 128 + k);
    if (SPLIT)
      *reinterpret_cast<uint4*>(sb + TAB + b_offset(n, k)) =
          *reinterpret_cast<const uint4*>(tl + n * 128 + k);
  }
  // the generic-proxy stores made visible to the tensor cores' reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7, lane = tid & 31, wib = (tid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  const int row = 16 * wib + g;          // this thread's rows: row, row + 8
  const int stride = gridDim.x * WG;
  float d[128];
  unsigned a[8][4];

  if (STAGE == STAGE_FULL) {
    // -- 64 elements a unit: the product, then each element's lo column --
    const long long units = (long long)ngroups * 16;
    for (long long t = (long long)blockIdx.x * WG + wg; t < units;
         t += stride) {
      const long long e0 = t * 64 + row;
      const int v0 = idx[e0], v1 = idx[e0 + 8];
      onehot_a(a, v0 >> 8, v1 >> 8, q);
      wgmma_fence();
      product(d, a, sb, true);
      if (SPLIT) product(d, a, sb + TAB, false);
      wgmma_commit_wait();
      fence_regs(d);
      const int lo0 = v0 & 255, lo1 = v1 & 255;
      const float r0 = pick<0>(d, lo0), r1 = pick<2>(d, lo1);
      if (((lo0 >> 1) & 3) == q) out[e0] = r0;
      if (((lo1 >> 1) & 3) == q) out[e0 + 8] = r1;
    }
    return;
  }

  // -- MATMUL, FIXED_B: a unit is half a group's columns l (64 of 128);
  //    the product of each j, its columns r < 8 summed over J in order ----
  const long long units = (long long)ngroups * 2;
  for (long long t = (long long)blockIdx.x * WG + wg; t < units;
       t += stride) {
    const long long s = t >> 1;
    const int l0 = (int)(t & 1) * 64 + row;  // this thread's l: l0, l0 + 8
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    bool any = false;
#pragma unroll 1
    for (int j = 0; j < 8; ++j) {
      const int c0 = j * 128 + l0;            // column of the group
      if (STAGE == STAGE_MATMUL) {
        const int* gidx = idx + s * 1024;
        onehot_a(a, gidx[c0] >> 8, gidx[c0 + 8] >> 8, q);
      } else {
        // A = bfix^T: rows c0 and c0 + 8, depth k (bfix[k * 1024 + c])
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int k = 16 * ks + 2 * q;
          const unsigned short* b0 = bfix + k * 1024 + c0;
          a[ks][0] = b0[0] | (unsigned)b0[1024] << 16;
          a[ks][1] = b0[8] | (unsigned)b0[1024 + 8] << 16;
          a[ks][2] = b0[8 * 1024] | (unsigned)b0[9 * 1024] << 16;
          a[ks][3] = b0[8 * 1024 + 8] | (unsigned)b0[9 * 1024 + 8] << 16;
        }
      }
      wgmma_fence();
      const int reps = STAGE == STAGE_FIXED_B ? nmm : 1;
#pragma unroll 1
      for (int m = 0; m < reps; ++m) product(d, a, sb, m == 0);
      wgmma_commit_wait();
      fence_regs(d);
      if ((jmask >> j) & 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = any ? acc[i] + d[i] : d[i];
        any = true;
      }
    }
    // d[0], d[1]: (l0, r = 2q, 2q + 1); d[2], d[3]: (l0 + 8, the same r)
    float* o = out + s * 1024;
    o[(2 * q) * 128 + l0] = acc[0];
    o[(2 * q + 1) * 128 + l0] = acc[1];
    o[(2 * q) * 128 + l0 + 8] = acc[2];
    o[(2 * q + 1) * 128 + l0 + 8] = acc[3];
  }
}

// ONEHOT: no product, one thread per output
__global__ void __launch_bounds__(512, 1)
probe_onehot_counts(const int* __restrict__ idx, float* __restrict__ out,
                    int ngroups, int jmask) {
  for (int s = blockIdx.x; s < ngroups; s += gridDim.x) {
    const int* gidx = idx + (long long)s * 1024;
    float* gout = out + (long long)s * 1024;
    for (int o = threadIdx.x; o < 1024; o += blockDim.x) {
      const int h = o >> 7, l = o & 127;
      float acc = 0.f;
      for (int j = 0; j < 8; ++j)
        if ((jmask >> j) & 1)
          acc = acc + ((gidx[j * 128 + l] >> 8) == h ? 1.f : 0.f);
      gout[o] = acc;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int STAGE, bool SPLIT>
int launch(const unsigned short* th, const unsigned short* tl,
           const unsigned short* bfix, const int* idx, float* out,
           int ngroups, int jmask, int nmm, cudaStream_t s) {
  const long long units = (long long)ngroups * (STAGE == STAGE_FULL ? 16 : 2);
  const long long want = (units + WG - 1) / WG;
  const int blocks = (int)(want < sm_count() ? want : sm_count());
  const size_t smem = (SPLIT ? 2 : 1) * TAB * sizeof(unsigned short);
  static bool raised[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_onehot<STAGE, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    if (dev < 64) raised[dev] = true;
  }
  probe_onehot<STAGE, SPLIT><<<blocks, THREADS, smem, s>>>(
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
    case STAGE_ONEHOT: {
      const int blocks = ng < 2 * sm_count() ? ng : 2 * sm_count();
      probe_onehot_counts<<<blocks, 512, 0, s>>>(idx, out, ng, jmask);
      return (int)cudaGetLastError();
    }
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
