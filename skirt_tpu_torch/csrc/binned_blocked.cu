// K8: the lambda-blocked tally, a per-wavelength-block bincount over cells.
//
// Replaces: skirt_tpu/ops/binned.py:146 `_mxu_bincount_blocked` (a one-hot
// contraction on the TPU's matrix unit, one (Q, R) slice per wavelength
// block), reached through `binned_add_lm`.  Lanes come in `nlambda`
// contiguous equal blocks of `per` lanes; lane e of block b adds val[e] to
// tally[b * QR + cell[e]], QR = Q * R the padded slice of one block.
// Cells < 0 or >= ncells are dropped.  Every block is tallied: the Pallas
// kernel leaves the last nlambda % bpt blocks unwritten when its tile of
// bpt blocks does not divide nlambda (binned.py:174-176); this one has no
// tiles.
//
// What bounds it on the H100: bytes.  At the flagship shape (2^17 lanes,
// nlambda = 128, 16,384 cells, QR = 16,384) it reads 1 MiB of lanes; of the
// 8 MiB tally it must read and write only the 32-byte sectors its kept
// lanes touch (at most one each): 2.8 us at 3.35 TB/s.  The adds (one per
// lane) are nothing beside that.
//
// Design: three routes, chosen by lane density (ops/binned.py::k8_route
// picks one and the wrapper passes it in; this side checks that the layout
// can take it):
// - sparse, where a block's lanes are few against its slice (the
//   flagship: 1,024 lanes over 16,384 bins): every kept lane is one
//   red.global.add.f32 straight into the tally, so only the touched
//   sectors move.  A thread loads 4 lanes (16 bytes of cells, 16 of
//   values); the grid's y index is the wavelength block, so no lane needs
//   a division to find its block.
// - dense, where lanes per bin are many: a block holds the slice in
//   dynamic shared memory, zeroed in float4, and adds lanes with
//   shared-memory atomics.  Where nlambda gives a block to every SM, one
//   block a wavelength block owns its slice and adds it into the tally in
//   float4, skipping every 32-byte sector whose sums are all zero; where
//   it leaves SMs idle, the lanes of a wavelength block split over 2, 4 or
//   8 blocks, each adding its partial slice's non-zero bins by atomics (a
//   cluster that reduced the partial slices over distributed shared memory
//   hung on the card).
// - global, a slice past the card's opt-in shared memory: the sparse
//   route's kernel whatever the density.
// The card's opt-in limit and SM count are read once per device, and the
// dense kernel's shared-memory attribute set once per device.  Atomics add
// in scheduling order: the sums are not bit-reproducible (float32
// reassociation only).

#include <cuda_runtime.h>

namespace {

// the routes, as ops/binned.py numbers them
constexpr int ROUTE_GLOBAL = 0, ROUTE_DENSE = 1, ROUTE_SPARSE = 2;
constexpr int ATOMIC_THREADS = 256;
constexpr int DENSE_THREADS = 1024;

__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v)
               : "memory");
}

__device__ __forceinline__ void add_kept(float* out, int c, float v,
                                         int ncells) {
  if ((unsigned)c < (unsigned)ncells) red_add(out + c, v);
}

// sparse and global routes: per4 = per / 4 groups of 4 lanes a block
__global__ void __launch_bounds__(ATOMIC_THREADS)
blocked_atomic(float* __restrict__ tally, const int4* __restrict__ cell,
               const float4* __restrict__ val, int per4, int nlambda,
               int ncells, int qr) {
  for (int b = blockIdx.y; b < nlambda; b += gridDim.y) {
    const int4* cb = cell + (long long)b * per4;
    const float4* vb = val + (long long)b * per4;
    float* out = tally + (long long)b * qr;
    for (int e = blockIdx.x * ATOMIC_THREADS + threadIdx.x; e < per4;
         e += gridDim.x * ATOMIC_THREADS) {
      const int4 c = __ldg(cb + e);
      const float4 v = __ldg(vb + e);
      add_kept(out, c.x, v.x, ncells);
      add_kept(out, c.y, v.y, ncells);
      add_kept(out, c.z, v.z, ncells);
      add_kept(out, c.w, v.w, ncells);
    }
  }
}

__device__ __forceinline__ void shared_kept(float* hist, int c, float v,
                                            int ncells) {
  if ((unsigned)c < (unsigned)ncells) atomicAdd(hist + c, v);
}

__device__ __forceinline__ bool nonzero(float4 h) {
  return h.x != 0.f || h.y != 0.f || h.z != 0.f || h.w != 0.f;
}

// dense route: the S blocks (x) of wavelength block b (y) each hold the
// slice (qr a multiple of 1,024 floats) in shared memory and add per4 / S
// of its lane groups; alone (S = 1) a block owns the slice and adds it
// into the tally in float4, skipping every 32-byte sector whose sums are
// all zero; split, each block adds its non-zero bins by red.global.add.f32
template <int S>
__global__ void __launch_bounds__(DENSE_THREADS)
blocked_dense(float* __restrict__ tally, const int4* __restrict__ cell,
              const float4* __restrict__ val, int per4, int ncells, int qr) {
  extern __shared__ float4 hist4[];
  float* hist = reinterpret_cast<float*>(hist4);
  const int q4 = qr / 4;
  for (int i = threadIdx.x; i < q4; i += DENSE_THREADS)
    hist4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int share = per4 / S;
  const long long first = (long long)blockIdx.y * per4 + blockIdx.x * share;
  const int4* cb = cell + first;
  const float4* vb = val + first;
  for (int e = threadIdx.x; e < share; e += DENSE_THREADS) {
    const int4 c = __ldg(cb + e);
    const float4 v = __ldg(vb + e);
    shared_kept(hist, c.x, v.x, ncells);
    shared_kept(hist, c.y, v.y, ncells);
    shared_kept(hist, c.z, v.z, ncells);
    shared_kept(hist, c.w, v.w, ncells);
  }
  __syncthreads();
  float* slice = tally + (long long)blockIdx.y * qr;
  float4* out = reinterpret_cast<float4*>(slice);
  for (int i = threadIdx.x; i < q4; i += DENSE_THREADS) {
    const float4 h = hist4[i];
    if constexpr (S > 1) {
      if (h.x != 0.f) red_add(slice + 4 * i, h.x);
      if (h.y != 0.f) red_add(slice + 4 * i + 1, h.y);
      if (h.z != 0.f) red_add(slice + 4 * i + 2, h.z);
      if (h.w != 0.f) red_add(slice + 4 * i + 3, h.w);
    } else {
      // float4 i and i ^ 1 make a 32-byte sector; every lane shuffles (the
      // loop runs whole warps: q4 is a multiple of 256)
      const bool mine = nonzero(h);
      const int other = __shfl_xor_sync(0xffffffffu, (int)mine, 1);
      if (!(mine || other)) continue;
      float4 t = out[i];
      t.x += h.x;
      t.y += h.y;
      t.z += h.z;
      t.w += h.w;
      out[i] = t;
    }
  }
}

template <int S>
bool raise_dense(int bytes) {
  return cudaFuncSetAttribute(blocked_dense<S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes) != cudaSuccess;
}

template <int S>
void launch_dense(float* tally, const int4* cell, const float4* val,
                  int per4, int nlambda, int ncells, int qr, cudaStream_t s) {
  blocked_dense<S><<<dim3(S, nlambda), DENSE_THREADS, (size_t)qr * 4, s>>>(
      tally, cell, val, per4, ncells, qr);
}

struct DeviceInfo {
  int optin = 0, sms = 0;
  bool ready = false;
};

// the card's opt-in shared memory and SM count, read once per device, and
// the dense kernel's shared-memory limit raised to the opt-in once
DeviceInfo* device_info() {
  static DeviceInfo info[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return nullptr;
  DeviceInfo& d = info[dev];
  if (!d.ready) {
    if (cudaDeviceGetAttribute(&d.optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess ||
        raise_dense<1>(d.optin) || raise_dense<2>(d.optin) ||
        raise_dense<4>(d.optin) || raise_dense<8>(d.optin)) {
      cudaGetLastError();
      return nullptr;
    }
    d.ready = true;
  }
  return &d;
}

}  // namespace

// the card's opt-in shared memory per block (bytes) and SM count; 0 on
// success
extern "C" int skirt_binned_blocked_limits(int* optin, int* sms) {
  const DeviceInfo* d = device_info();
  if (!d) return (int)cudaErrorInvalidDevice;
  *optin = d->optin;
  *sms = d->sms;
  return 0;
}

// n lanes in nlambda blocks (n / nlambda a multiple of 1,024, cell and
// val on 16 bytes); route and split from ops/binned.py::k8_route (dense
// needs the slice within the opt-in limit and the tally on 16 bytes; split
// 1, 2, 4 or 8 blocks a wavelength block)
extern "C" int skirt_binned_blocked_add(float* tally, const int* cell,
                                        const float* val, long long n,
                                        int nlambda, int ncells, int qr,
                                        int route, int split, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const DeviceInfo* d = device_info();
  if (!d) return (int)cudaErrorInvalidDevice;
  const long long per = n / nlambda;
  if (per % 1024 || per * nlambda != n || qr % 1024 || per / 4 > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int per4 = (int)(per / 4);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* c4 = reinterpret_cast<const int4*>(cell);
  const auto* v4 = reinterpret_cast<const float4*>(val);
  if (route == ROUTE_DENSE) {
    if ((long long)qr * 4 > d->optin || nlambda > 65535 ||
        reinterpret_cast<unsigned long long>(tally) % 16)
      return (int)cudaErrorInvalidValue;
    switch (split) {
      case 1: launch_dense<1>(tally, c4, v4, per4, nlambda, ncells, qr, s);
        break;
      case 2: launch_dense<2>(tally, c4, v4, per4, nlambda, ncells, qr, s);
        break;
      case 4: launch_dense<4>(tally, c4, v4, per4, nlambda, ncells, qr, s);
        break;
      case 8: launch_dense<8>(tally, c4, v4, per4, nlambda, ncells, qr, s);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if ((route == ROUTE_SPARSE || route == ROUTE_GLOBAL) &&
             split == 1) {
    // a block a wavelength block and 1,024 lanes, at most 16 blocks an SM
    const int gy = nlambda < 65535 ? nlambda : 65535;
    const long long want = (per4 + ATOMIC_THREADS - 1) / ATOMIC_THREADS;
    long long cap = 16LL * d->sms / gy;
    if (cap < 1) cap = 1;
    const dim3 grid((unsigned)(want < cap ? want : cap), gy);
    blocked_atomic<<<grid, ATOMIC_THREADS, 0, s>>>(tally, c4, v4, per4,
                                                   nlambda, ncells, qr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
