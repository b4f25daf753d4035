// K2: flat float32 scatter-add into `nbins` bins with drop semantics.
//
// Replaces: skirt_tpu/ops/binned.py:37 `_mxu_bincount` (a two-level
// one-hot contraction on the TPU's matrix unit).  Indices < 0 or >= nbins
// are dropped; nothing wraps.
//
// What bounds it on the H100: atomic throughput, not bytes.  The frame
// tally of the main path sends 128 x 32,768 = 4.19M updates into 32,768
// bins per detect (8 bytes read per update, ~34 MB); the labs tally sends
// 32,768 updates into 2,097,152 bins.  Global atomics on few hot bins
// serialise in L2.
//
// Design: when the bins fit in a block's dynamic shared memory (32,768
// bins = 128 KB of the 227 KB a block can opt into), each block keeps a
// private histogram: zero it, atomicAdd into shared memory (fast, on-SM),
// then flush every non-zero bin with one global atomicAdd.  The flush
// costs nblocks x nbins global atomics, so the grid is sized to keep
// updates per block well above nbins.  Otherwise (the 2M-bin labs tally)
// each update is one global atomicAdd straight into the tally.
//
// The sum order depends on scheduling: results are not bit-reproducible
// (float32 reassociation only, ~n_per_bin * 6e-8 relative).

#include <cuda_runtime.h>

namespace {

__global__ void binned_add_shared(float* __restrict__ tally,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ val,
                                  long long n, int nbins) {
  extern __shared__ float hist[];
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int b = idx[e];
    if (b >= 0 && b < nbins) atomicAdd(&hist[b], val[e]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const float v = hist[i];
    if (v != 0.f) atomicAdd(&tally[i], v);
  }
}

__global__ void binned_add_global(float* __restrict__ tally,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ val,
                                  long long n, int nbins) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int b = idx[e];
    if (b >= 0 && b < nbins) atomicAdd(&tally[b], val[e]);
  }
}

int smem_optin_bytes() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// 1 = shared-memory privatised histogram, 0 = global atomics.
extern "C" int skirt_binned_route(int nbins) {
  return (long long)nbins * 4 <= smem_optin_bytes() ? 1 : 0;
}

extern "C" int skirt_binned_add(float* tally, const int* idx,
                                const float* val, long long n, int nbins,
                                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 1024;
  const int sms = num_sms();
  if (skirt_binned_route(nbins)) {
    const size_t smem = (size_t)nbins * sizeof(float);
    cudaFuncSetAttribute(binned_add_shared,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    // keep >= 4 updates per bin per block so the flush stays a minor cost
    long long want = n / (4LL * nbins);
    int blocks = (int)(want < 1 ? 1 : (want > sms ? sms : want));
    binned_add_shared<<<blocks, threads, smem, s>>>(tally, idx, val, n, nbins);
  } else {
    long long want = (n + threads - 1) / threads;
    int blocks = (int)(want > 8LL * sms ? 8LL * sms : want);
    binned_add_global<<<blocks, threads, 0, s>>>(tally, idx, val, n, nbins);
  }
  return (int)cudaGetLastError();
}
