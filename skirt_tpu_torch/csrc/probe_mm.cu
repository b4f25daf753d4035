// PM: the in-kernel matrix-product probe, C = sum_{i < inner} A @ B with
// float32 accumulation; A (M, K), B (K, N) both bf16 or both float32.
//
// Replaces: experiments/microbench_mxu_mm.py:34 (the body of the Pallas
// kernel its `run` builds, launched at :47).  That body perturbs A by
// acc[:, :K] * 1e-20 between its `inner` products, which is below one ulp
// of A at its inputs, so the chain is `inner` sums of the same product
// (tests/test_torch_probes.py asserts this on the seeded inputs): the
// kernel computes the product `inner` times and adds each to the sum in
// float32, in order.  The Pallas grid's G steps all write the same block;
// the drivers repeat the call G times instead.
//
// What bounds it on the H100: at 1024^3 bf16 the bytes (A, B read once,
// the float32 C written once: 8.4 MB, 2.5 us at 3.35 TB/s) just above the
// products (2 M K N flop, 2.2 us at 989 TFLOP/s dense bf16); float32
// products run outside the tensor cores (67 TFLOP/s).
//
// bf16 design (TMA + wgmma), a block per 64 x BN tile of C (the wrapper's
// plan, experiments/mm.py::plan, picks BN 64 or 128 so that the tiles fill
// the card):
// - one producer thread issues 2D TMA loads, 128 deep a stage, of A (two
//   64 x 64 boxes, K-major) and B (BN / 64 boxes of 128 x 64, N-major:
//   wgmma's transpose bit reads B as it lies, no transpose pass) with the
//   128-byte swizzle into a 192 KB ring of stages, each completing on its
//   `full` mbarrier;
// - one consumer warpgroup runs wgmma m64nBNk16 with both operands read
//   through shared-memory descriptors, 8 a stage;
//   a stage's products stay in flight while the next stage's are issued
//   (wait_group 1), and the warps release a stage on its `empty` mbarrier
//   once its products are done;
// - each of the `inner` products accumulates in its own registers and is
//   added to the float32 sum in order; the epilogue stores C in float2,
//   masked at the edges (TMA fills rows and columns past the matrix with
//   zeros, so tiles need not divide M, N or K).
// The tensor maps are encoded on the host per call (hopper.cuh, through
// the runtime's driver entry point) and passed as __grid_constant__.
// Measured on the H100 (PERF.md section 6): 128-deep stages beat 64-deep
// ones at 1024^3 (half the per-stage barrier and loop overhead); a deeper
// ring, two accumulator chains a warpgroup, two consumer warpgroups on
// 128-row tiles and TMA multicast over clusters of 2 or 4 blocks (B
// shared; the cross-block release coupling cost more than the L2 traffic
// it saved) did not help at P15's shapes and are not used.
//
// float32 design (SIMT, TF32 stays off): a block of 128 threads owns a
// 32 x 64 tile of C, 4 x 4 outputs a thread (small tiles, so that P15's
// shapes still give a block per SM); depth steps of 32 staged by
// cp.async into two buffers, the next step's copies in flight while the
// current one is multiplied; operands read from shared memory as float4.
// Each term is one __fmaf_rn (a single rounding; the library's
// -fmad=false does not touch the intrinsic), summed in order of k: each
// sum still lies within the K + inner roundings that `mm.tolerance`
// allows.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BOX_K = 64;        // bf16 depth of a TMA box: one 128-byte row
constexpr int BK = 128;          // bf16 depth a stage: 8 products
// the ring: as many stages as fit in RING_BYTES (3 to 6 by tile)
constexpr int RING_BYTES = 192 * 1024;
constexpr int KSF = 32;          // float32 depth step
constexpr int PADF = 4;          // float32 row padding of the A tile
constexpr int BMF = 32, BNF = 64;  // float32 tile

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2],
                                         unsigned long long da,
                                         unsigned long long db, int scale_d) {
  if constexpr (BN == 64)
    wgmma_ss_64(d, da, db, scale_d);
  else
    wgmma_ss_128(d, da, db, scale_d);
}

template <int BN>
struct Ring {
  static constexpr int A_BYTES = 64 * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;
  // the stages, 1,024-byte aligned (the swizzle's repeat), and the slack
  // to align the dynamic shared memory's base
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

template <int BN>
__global__ void __launch_bounds__(160, 1)
mm_bf16(const __grid_constant__ CUtensorMap ta,
        const __grid_constant__ CUtensorMap tb, float* __restrict__ C, int M,
        int K, int N, int inner) {
  using R = Ring<BN>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = R::STAGES;
  __shared__ unsigned long long full[STAGES], empty[STAGES];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int total = inner * ktiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // -- the producer: one thread keeps the ring filled -----------------------
    if (lane == 0) {
      tma_prefetch_map(&ta);
      tma_prefetch_map(&tb);
      for (int i = 0; i < total; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&full[s], R::STAGE_BYTES);
        unsigned char* st = ring + s * R::STAGE_BYTES;
        const int k0 = (i % ktiles) * BK;
#pragma unroll
        for (int h = 0; h < BK / BOX_K; ++h)
          tma_load_2d(st + h * 64 * 128, &ta, &full[s], k0 + h * BOX_K, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + R::A_BYTES + c * BK * 128, &tb, &full[s],
                      n0 + 64 * c, k0);
      }
    }
  } else {
    // -- the consumers: one warpgroup owns rows m0 .. m0 + 63 ---------------
    float acc[BN / 2], p[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = p[j] = 0.f;
    // the stage-0 descriptors; stage s and k-step ks add constant offsets
    // (16-byte units) to the start-address field
    const unsigned long long da0 =
        smem_desc(smem_addr(ring), 16, 1024, LAYOUT_SW128);
    const unsigned long long db0 = smem_desc(
        smem_addr(ring + R::A_BYTES), BK * 128, 1024, LAYOUT_SW128);
    int i = 0;
    for (int it = 0; it < inner; ++it) {
      for (int kt = 0; kt < ktiles; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        const unsigned long long da = da0 + s * (R::STAGE_BYTES >> 4);
        const unsigned long long db = db0 + s * (R::STAGE_BYTES >> 4);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_ss<BN>(p,
                       da + ((ks / 4 * 64 * 128 + ks % 4 * 32) >> 4),
                       db + (ks * 16 * 128 >> 4), (kt | ks) != 0);
        wgmma_commit();
        if (kt > 0) {
          // the previous stage's products are done: release it
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
      fence_regs(p);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j)
        acc[j] = it == 0 ? p[j] : acc[j] + p[j];
    }

    // -- epilogue: the wgmma accumulator layout (row g and g + 8 of each
    //    warp's 16, columns 8 j + 2 q, + 1) -----------------------------------
    const int g = lane >> 2, q = lane & 3;
    const int r0 = m0 + 16 * warp + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * q;
      if (c >= N) continue;
      if (r0 < M)
        *reinterpret_cast<float2*>(C + (long long)r0 * N + c) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r0 + 8 < M)
        *reinterpret_cast<float2*>(C + (long long)(r0 + 8) * N + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// float32: a BMF x KSF slice of A and a KSF x BNF slice of B by cp.async,
// 16 bytes a copy
constexpr int THREADS_F32 = BMF * 4;
__device__ __forceinline__ void stage_f32(float (*sA)[KSF + PADF],
                                          float (*sB)[BNF], const float* A,
                                          const float* B, int K, int N,
                                          int m0, int n0, int k0) {
  for (int v = threadIdx.x; v < BMF * KSF / 4; v += THREADS_F32) {
    const int r = v / (KSF / 4), c = 4 * (v % (KSF / 4));
    __pipeline_memcpy_async(&sA[r][c], A + (long long)(m0 + r) * K + k0 + c,
                            16);
  }
  for (int v = threadIdx.x; v < KSF * BNF / 4; v += THREADS_F32) {
    const int r = v / (BNF / 4), c = 4 * (v % (BNF / 4));
    __pipeline_memcpy_async(&sB[r][c], B + (long long)(k0 + r) * N + n0 + c,
                            16);
  }
  __pipeline_commit();
}

// 4 x 4 outputs a thread: rows 4 ty .., columns 4 tx ..
__global__ void __launch_bounds__(THREADS_F32)
mm_f32(const float* __restrict__ A, const float* __restrict__ B,
       float* __restrict__ C, int M, int K, int N, int inner) {
  constexpr int TM = 4;
  __shared__ __align__(16) float sA[2][BMF][KSF + PADF];
  __shared__ __align__(16) float sB[2][KSF][BNF];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * BMF, n0 = blockIdx.x * BNF;
  const int steps = K / KSF;
  float acc[TM][4];
  for (int it = 0; it < inner; ++it) {
    float p[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
    stage_f32(sA[0], sB[0], A, B, K, N, m0, n0, 0);
    for (int st = 0; st < steps; ++st) {
      const int cur = st & 1;
      if (st + 1 < steps) {
        stage_f32(sA[cur ^ 1], sB[cur ^ 1], A, B, K, N, m0, n0,
                  (st + 1) * KSF);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KSF; k += 4) {
        float4 a[TM], b[4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(&sA[cur][TM * ty + i][k]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          b[kk] = *reinterpret_cast<const float4*>(&sB[cur][k + kk][4 * tx]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                             : kk == 2 ? a[i].z : a[i].w;
            p[i][0] = __fmaf_rn(av, b[kk].x, p[i][0]);
            p[i][1] = __fmaf_rn(av, b[kk].y, p[i][1]);
            p[i][2] = __fmaf_rn(av, b[kk].z, p[i][2]);
            p[i][3] = __fmaf_rn(av, b[kk].w, p[i][3]);
          }
      }
      // the buffer just read is the next step's copy target
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = it == 0 ? p[i][j] : acc[i][j] + p[i][j];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
    *reinterpret_cast<float4*>(C + (long long)(m0 + TM * ty + i) * N + n0 +
                               4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

int set_smem_once(const void* fn, int bytes, bool (&raised)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && raised[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (dev < 64) raised[dev] = true;
  return 0;
}

template <int BN>
int launch_bf16(const void* A, const void* B, float* C, int M, int K, int N,
                int inner, cudaStream_t s) {
  static bool raised[64];
  using R = Ring<BN>;
  if (const int e = set_smem_once((const void*)mm_bf16<BN>, R::SMEM, raised))
    return e;
  CUtensorMap ta, tb;
  if (const int e = encode_bf16_2d(&ta, A, M, K, 64, BOX_K)) return e;
  if (const int e = encode_bf16_2d(&tb, B, K, N, BK, 64)) return e;
  const dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
  mm_bf16<BN><<<grid, 160, R::SMEM, s>>>(ta, tb, C, M, K, N, inner);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: A and B are bf16 (raw 16-bit), else float32.  bm x bn is the
// tile of C a block owns, from experiments/mm.py::plan: bf16 64 x 64 or
// 64 x 128; float32 32 x 64.  M and N multiples of 64, K of 32.
extern "C" int skirt_probe_mm(const void* A, const void* B, float* C, int M,
                              int K, int N, int bf16, int inner, int bm,
                              int bn, void* stream) {
  if (M % 64 || N % 64 || K % 32 || inner < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (bm == 64 && bn == 128)
      return launch_bf16<128>(A, B, C, M, K, N, inner, s);
    if (bm == 64 && bn == 64)
      return launch_bf16<64>(A, B, C, M, K, N, inner, s);
    return (int)cudaErrorInvalidValue;
  }
  if (bm != BMF || bn != BNF) return (int)cudaErrorInvalidValue;
  mm_f32<<<dim3(N / BNF, M / BMF), THREADS_F32, 0, s>>>(
      static_cast<const float*>(A), static_cast<const float*>(B), C, M, K, N,
      inner);
  return (int)cudaGetLastError();
}
