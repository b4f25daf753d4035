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
// What bounds it on the H100: operations.  2 M K N flop a product: bf16
// products on the tensor cores (989 TFLOP/s dense), float32 ones outside
// them (67 TFLOP/s); the bytes (A, B read once, C written once) are small.
//
// Design, a simple tile kernel (wgmma, TMA and a deeper pipeline are later
// work): bf16: a block of 4 warps owns a 64 x 64 tile of C; for each depth
// step of 32 it stages A (64 x 32) and B (transposed, 64 x 32) in shared
// memory and each warp runs 2 x 4 mma.sync m16n8k16 per 16 of depth on its
// 32 x 32 quarter.  float32: 16 x 16 threads own a 64 x 64 tile, 4 x 4
// outputs each (rows ty + 16 i, columns tx + 16 j), over depth steps of 16
// staged in shared memory; each product rounded, then added, in order of k
// (the library builds with -fmad=false).  Both load the next step's tiles
// into registers (16-byte loads) while they compute on the current one, so
// the loads' latency overlaps the products.  M and N must be multiples of
// 64, K of 32.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int KS = 32;      // bf16 depth step
constexpr int PAD = 8;      // bf16 row padding of the staged tiles
constexpr int KSF = 16;     // float32 depth step
constexpr int THREADS_BF16 = 128;
constexpr int THREADS_F32 = 256;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one depth step's tiles in registers: 8 bf16 of A and of B per uint4;
// A row w / 4, columns 8 (w % 4)..; B row w / 8, columns 8 (w % 8)..
constexpr int VEC_BF16 = TILE * KS / 8 / THREADS_BF16;  // uint4 of each a thread

__device__ __forceinline__ void load_bf16(uint4 (&ra)[VEC_BF16],
                                          uint4 (&rb)[VEC_BF16],
                                          const unsigned short* A,
                                          const unsigned short* B, int K,
                                          int N, int m0, int n0, int k0) {
#pragma unroll
  for (int v = 0; v < VEC_BF16; ++v) {
    const int w = threadIdx.x + v * THREADS_BF16;
    ra[v] = *reinterpret_cast<const uint4*>(
        A + (long long)(m0 + w / 4) * K + k0 + 8 * (w % 4));
    rb[v] = *reinterpret_cast<const uint4*>(
        B + (long long)(k0 + w / 8) * N + n0 + 8 * (w % 8));
  }
}

__global__ void __launch_bounds__(THREADS_BF16)
mm_bf16(const unsigned short* __restrict__ A,
        const unsigned short* __restrict__ B, float* __restrict__ C, int M,
        int K, int N, int inner) {
  __shared__ __align__(16) unsigned short sA[TILE][KS + PAD];
  __shared__ __align__(16) unsigned short sBt[TILE][KS + PAD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc[2][4][4];
  for (int it = 0; it < inner; ++it) {
    float p[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[mt][nt][i] = 0.f;
    uint4 ra[VEC_BF16], rb[VEC_BF16];
    load_bf16(ra, rb, A, B, K, N, m0, n0, 0);
    for (int k0 = 0; k0 < K; k0 += KS) {
#pragma unroll
      for (int v = 0; v < VEC_BF16; ++v) {
        const int w = threadIdx.x + v * THREADS_BF16;
        *reinterpret_cast<uint4*>(&sA[w / 4][8 * (w % 4)]) = ra[v];
        // B transposed: sBt[n][k] = B[k][n]
        const unsigned short* b =
            reinterpret_cast<const unsigned short*>(&rb[v]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sBt[8 * (w % 8) + i][w / 8] = b[i];
      }
      __syncthreads();
      if (k0 + KS < K) load_bf16(ra, rb, A, B, K, N, m0, n0, k0 + KS);
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        unsigned a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm + 16 * mt + g, c = kk + 2 * q;
          a[mt][0] = *reinterpret_cast<const unsigned*>(&sA[r][c]);
          a[mt][1] = *reinterpret_cast<const unsigned*>(&sA[r + 8][c]);
          a[mt][2] = *reinterpret_cast<const unsigned*>(&sA[r][c + 8]);
          a[mt][3] = *reinterpret_cast<const unsigned*>(&sA[r + 8][c + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = wn + 8 * nt + g, c = kk + 2 * q;
          b[nt][0] = *reinterpret_cast<const unsigned*>(&sBt[n][c]);
          b[nt][1] = *reinterpret_cast<const unsigned*>(&sBt[n][c + 8]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(p[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] = it == 0 ? p[mt][nt][i] : acc[mt][nt][i] + p[mt][nt][i];
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = m0 + wm + 16 * mt + g, c = n0 + wn + 8 * nt + 2 * q;
      *reinterpret_cast<float2*>(C + (long long)r * N + c) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(C + (long long)(r + 8) * N + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// float32: one float4 of A (row w / 4, columns 4 (w % 4)..) and of B (row
// w / 16, columns 4 (w % 16)..) a thread per depth step
__device__ __forceinline__ void load_f32(float4& ra, float4& rb,
                                         const float* A, const float* B,
                                         int K, int N, int m0, int n0,
                                         int k0) {
  const int w = threadIdx.x;
  ra = *reinterpret_cast<const float4*>(A + (long long)(m0 + w / 4) * K +
                                        k0 + 4 * (w % 4));
  rb = *reinterpret_cast<const float4*>(B + (long long)(k0 + w / 16) * N +
                                        n0 + 4 * (w % 16));
}

__global__ void __launch_bounds__(THREADS_F32)
mm_f32(const float* __restrict__ A, const float* __restrict__ B,
       float* __restrict__ C, int M, int K, int N, int inner) {
  __shared__ float sA[KSF][TILE];                 // sA[k][m]
  __shared__ __align__(16) float sB[KSF][TILE];   // sB[k][n]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int w = threadIdx.x;
  float acc[4][4];
  for (int it = 0; it < inner; ++it) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
    float4 ra, rb;
    load_f32(ra, rb, A, B, K, N, m0, n0, 0);
    for (int k0 = 0; k0 < K; k0 += KSF) {
      sA[4 * (w % 4) + 0][w / 4] = ra.x;
      sA[4 * (w % 4) + 1][w / 4] = ra.y;
      sA[4 * (w % 4) + 2][w / 4] = ra.z;
      sA[4 * (w % 4) + 3][w / 4] = ra.w;
      *reinterpret_cast<float4*>(&sB[w / 16][4 * (w % 16)]) = rb;
      __syncthreads();
      if (k0 + KSF < K) load_f32(ra, rb, A, B, K, N, m0, n0, k0 + KSF);
#pragma unroll
      for (int k = 0; k < KSF; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = p[i][j] + a[i] * b[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = it == 0 ? p[i][j] : acc[i][j] + p[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[(long long)(m0 + ty + 16 * i) * N + n0 + tx + 16 * j] = acc[i][j];
}

}  // namespace

// bf16 != 0: A and B are bf16 (raw 16-bit), else float32
extern "C" int skirt_probe_mm(const void* A, const void* B, float* C, int M,
                              int K, int N, int bf16, int inner,
                              void* stream) {
  if (M % TILE || N % TILE || K % KS || inner < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(N / TILE, M / TILE);
  if (bf16)
    mm_bf16<<<grid, THREADS_BF16, 0, s>>>(static_cast<const unsigned short*>(A),
                                 static_cast<const unsigned short*>(B), C, M,
                                 K, N, inner);
  else
    mm_f32<<<grid, THREADS_F32, 0, s>>>(static_cast<const float*>(A),
                                static_cast<const float*>(B), C, M, K, N,
                                inner);
  return (int)cudaGetLastError();
}
