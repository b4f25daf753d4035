// PG: the table-gather probe, out[e] = tab[idx[e]] (float32 table of T
// entries, int32 indices in [0, T)); with steps > 0 the chained form
// out[e] = sum_{i < steps} tab[(idx[e] + i) % T], added in order of i.
//
// Replaces the Pallas gathers of experiments/: microbench_gather.py:101 pk
// and :128 pk2 (the chained form, steps = 64), microbench_gather2.py:85,
// microbench_pallas_gather.py:65, :91, :117, microbench_pallas_gather2.py:60,
// microbench_pallas_gather3.py:42, microbench_pallas_gather4.py:45 raw_dg and
// :88 full_table.  Their (8, W), broadcast and 128-chunk layouts are TPU
// layouts of this one function: the drivers feed flat indices and reshape.
//
// What bounds it on the H100: bytes, 8 per element (the index read, the
// value written) when the table stays on chip; the table itself is at most
// 128 KB.  The question the probe answers is where the table should sit:
// ROUTE_L2 reads it through the read-only path (__ldg; it stays in L1 / L2),
// ROUTE_SMEM stages it into each block's shared memory first (one pass of T
// floats per block, opted in above 48 KB).

#include <cuda_runtime.h>

namespace {

constexpr int ROUTE_L2 = 0;
constexpr int ROUTE_SMEM = 1;

template <int ROUTE>
__global__ void probe_gather(const float* __restrict__ tab, int T,
                             const int* __restrict__ idx,
                             float* __restrict__ out, long long n,
                             int steps) {
  extern __shared__ float stab[];
  if (ROUTE == ROUTE_SMEM) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) stab[i] = tab[i];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int j = idx[e];
    if (steps == 0) {
      out[e] = ROUTE == ROUTE_SMEM ? stab[j] : __ldg(tab + j);
    } else {
      float acc = 0.f;
      for (int i = 0; i < steps; ++i) {
        const int k = (j + i) % T;
        acc = acc + (ROUTE == ROUTE_SMEM ? stab[k] : __ldg(tab + k));
      }
      out[e] = acc;
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

}  // namespace

extern "C" int skirt_probe_gather(const float* tab, int T, const int* idx,
                                  float* out, long long n, int steps,
                                  int route, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (route == ROUTE_SMEM) {
    const size_t smem = (size_t)T * sizeof(float);
    if ((long long)smem > device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
      return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(probe_gather<ROUTE_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    // as many resident blocks as the table lets share an SM (up to 2)
    const int per_sm = smem <= 100 * 1024 ? 2 : 1;
    const long long want = (n + 1023) / 1024;
    const long long cap = (long long)per_sm * sms;
    probe_gather<ROUTE_SMEM><<<(int)(want < cap ? want : cap), 1024, smem,
                               s>>>(tab, T, idx, out, n, steps);
  } else {
    const long long want = (n + 255) / 256;
    const long long cap = 16LL * sms;
    probe_gather<ROUTE_L2><<<(int)(want < cap ? want : cap), 256, 0, s>>>(
        tab, T, idx, out, n, steps);
  }
  return (int)cudaGetLastError();
}
