// K8: the lambda-blocked tally, a per-wavelength-block bincount over cells.
//
// Replaces: skirt_tpu/ops/binned.py:146 `_mxu_bincount_blocked` (a one-hot
// contraction on the TPU's matrix unit, one (Q, R) slice per wavelength
// block), reached through `binned_add_lm`.  Lanes come in `nlambda`
// contiguous equal blocks; lane e of block b = e / per adds val[e] to
// tally[b * QR + cell[e]], QR = Q * R the padded slice of one block.  Cells
// < 0 or >= ncells are dropped.  Every block is tallied: the Pallas kernel
// leaves the last nlambda % bpt blocks unwritten when its tile of bpt blocks
// does not divide nlambda (binned.py:174-176); this one has no tiles.
//
// What bounds it on the H100: bytes.  At the flagship shape (2^17 lanes,
// nlambda = 128, 16,384 cells, QR = 16,384) it reads 1 MiB of lanes and
// reads and writes the 8 MiB tally: ~5.3 us at 3.35 TB/s if the whole tally
// moves, about half that if only the touched 32-byte sectors must.  The
// adds (one per lane) are nothing beside that.
//
// Design: one block of threads per wavelength block owns that block's QR
// slice in dynamic shared memory (64 KiB at the flagship shape; up to
// 58,112 bins fit in the 227 KB a block can opt into).  It zeroes the slice,
// adds its lanes with shared-memory atomics, then writes tally + hist over
// the slice once with plain loads and stores: the slices are disjoint, so no
// global atomics are needed.  A slice above the opt-in limit takes the
// global route: one global atomicAdd per kept lane, as K2 does
// (csrc/binned.cu).  Shared-memory atomics add in scheduling order: the sums
// are not bit-reproducible (float32 reassociation only).

#include <cuda_runtime.h>

namespace {

__global__ void blocked_shared(float* __restrict__ tally,
                               const int* __restrict__ cell,
                               const float* __restrict__ val, int per,
                               int ncells, int qr) {
  extern __shared__ float hist[];
  for (int i = threadIdx.x; i < qr; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();
  const long long base = (long long)blockIdx.x * per;
  for (int e = threadIdx.x; e < per; e += blockDim.x) {
    const int c = cell[base + e];
    if (c >= 0 && c < ncells) atomicAdd(&hist[c], val[base + e]);
  }
  __syncthreads();
  float* out = tally + (long long)blockIdx.x * qr;
  for (int i = threadIdx.x; i < qr; i += blockDim.x) out[i] += hist[i];
}

__global__ void blocked_global(float* __restrict__ tally,
                               const int* __restrict__ cell,
                               const float* __restrict__ val, long long n,
                               int per, int ncells, int qr) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int c = cell[e];
    if (c >= 0 && c < ncells)
      atomicAdd(&tally[(e / per) * qr + c], val[e]);
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

// 1 = one block per wavelength block with its slice in shared memory,
// 0 = global atomics.
extern "C" int skirt_binned_blocked_route(int qr) {
  return (long long)qr * 4 <= smem_optin_bytes() ? 1 : 0;
}

extern "C" int skirt_binned_blocked_add(float* tally, const int* cell,
                                        const float* val, long long n,
                                        int nlambda, int ncells, int qr,
                                        void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int per = (int)(n / nlambda);
  if (skirt_binned_blocked_route(qr)) {
    const size_t smem = (size_t)qr * sizeof(float);
    cudaFuncSetAttribute(blocked_shared,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    blocked_shared<<<nlambda, 1024, smem, s>>>(tally, cell, val, per, ncells,
                                               qr);
  } else {
    const int threads = 1024;
    long long want = (n + threads - 1) / threads;
    const long long cap = 8LL * num_sms();
    blocked_global<<<(int)(want > cap ? cap : want), threads, 0, s>>>(
        tally, cell, val, n, per, ncells, qr);
  }
  return (int)cudaGetLastError();
}
