// K2: flat float32 scatter-add into `nbins` bins with drop semantics.
//
// Replaces: skirt_tpu/ops/binned.py:37 `_mxu_bincount` (a two-level
// one-hot contraction on the TPU's matrix unit).  Indices < 0 or >= nbins
// are dropped; nothing wraps.
//
// What bounds it on the H100: the 8 bytes read per update, then the
// atomics.  The frame tally of the main path sends 128 x 32,768 = 4.19M
// updates into 32,768 bins per detect (~34 MB; 0.010 ms at 3.35 TB/s); the
// labs tally sends 32,768 updates into 2,097,152 bins.
//
// Shared route (the bins fit in a block's opt-in shared memory: up to
// 58,108 bins on the H100):
// - The grid fills the card: thread-block clusters of CLUSTER = 2 blocks
//   (clusters of 8 ran slower on every stream tried), as many clusters as
//   can be resident at once (one 128 KB block per SM for the frame).  Block k takes the k-th contiguous chunk of the update
//   stream, read with 16-byte loads when idx and val are 16-byte aligned
//   (a scalar loop takes the ragged tail).  On the path's w-major frame
//   stream (bins w * 256 + pixel, (W, N) rows) a chunk covers one or two
//   wavelength rows, a band of a few hundred bins.
// - Warp aggregation where the stream is hot: when two neighbouring lanes
//   of a warp hold the same bin (one shuffle and one vote tell), the warp
//   groups its updates by bin with __match_any_sync, sums each group in
//   registers (log2 of the group's size shuffle rounds) and its leader
//   alone adds the sum to the block's shared histogram: the disc's hot
//   pixels (~17 distinct ones per wavelength row on the path's edge-on
//   frame) cost one shared atomic per group, not one per lane.  Otherwise
//   (uniform indices: ~3% of warps at 1,024 bins) each lane adds its own
//   update: match_any costs more than the rare conflict.  Zero values are
//   skipped (adding 0 changes no bin).
// - A flush bounded by what was written: each block tracks the range of
//   bins it touched.  The cluster reduces its blocks' histograms over the
//   union of their ranges through distributed shared memory (block r sums
//   the r-th slice over the cluster's blocks) and sends each non-zero
//   4-bin group to the tally with one global atomic (a float4 atomic on
//   Hopper).  Uniform indices touch every bin in every block; the
//   cluster's reduction and the 4-bin atomics then cut the flush from
//   nblocks x nbins global atomics to nblocks x nbins / 8.
// Zeroing the whole histogram (at 128 KB, ~1,000 cycles of 16-byte
// stores) costs less than a first pass to find the range.
//
// Global route (more bins than fit: the 2.1M-bin poly labs, the
// 65,536-bin mono labs): one global atomicAdd per kept update.
//
// The sum order depends on scheduling: results are not bit-reproducible
// (float32 reassociation only, ~n_per_bin * 6e-8 relative).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int CLUSTER = 2;

// the sum of x over the lanes in `peers` (a __match_any_sync group), at the
// group's lowest lane; every lane of the warp calls it together
__device__ __forceinline__ float reduce_peers(unsigned peers, float x,
                                              int lane) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);
    const float t = __shfl_sync(0xffffffffu, x, (next - 1) & 31);
    if (next) x += t;
    // the lanes of odd rank are taken up by the lane below them
    above &= __ballot_sync(0xffffffffu, !(rank & 1));
    rank >>= 1;
  }
  return x;
}

// one update per lane, the warp's lanes together: aggregated by bin when
// two neighbouring lanes hold the same bin (a hot stream), one shared
// atomic per lane otherwise
__device__ __forceinline__ void add_update(float* hist, int b, float v,
                                           int nbins, int lane, int& lo,
                                           int& hi) {
  const bool ok = b >= 0 && b < nbins && v != 0.f;
  const int key = ok ? b : -1 - lane;
  const int below = __shfl_up_sync(0xffffffffu, key, 1);
  if (!__any_sync(0xffffffffu, lane > 0 && below == key)) {
    if (ok) {
      atomicAdd(hist + b, v);
      lo = min(lo, b);
      hi = max(hi, b);
    }
    return;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const float sum = reduce_peers(peers, ok ? v : 0.f, lane);
  if (ok && lane == __ffs(peers) - 1) {
    atomicAdd(hist + b, sum);
    lo = min(lo, b);
    hi = max(hi, b);
  }
}

__device__ __forceinline__ void flush_quad(float* tally, long long q,
                                           float4 v, int nbins, bool vec) {
  if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) return;
  const long long b = 4 * q;
#if CUDART_VERSION >= 12010
  if (vec && b + 3 < nbins) {
    atomicAdd(reinterpret_cast<float4*>(tally) + q, v);
    return;
  }
#endif
  if (v.x != 0.f) atomicAdd(tally + b, v.x);
  if (v.y != 0.f && b + 1 < nbins) atomicAdd(tally + b + 1, v.y);
  if (v.z != 0.f && b + 2 < nbins) atomicAdd(tally + b + 2, v.z);
  if (v.w != 0.f && b + 3 < nbins) atomicAdd(tally + b + 3, v.w);
}

__global__ void __launch_bounds__(THREADS)
binned_add_shared(float* __restrict__ tally, const int* __restrict__ idx,
                  const float* __restrict__ val, long long n, int nbins,
                  long long chunk) {
  extern __shared__ float4 hist4[];
  float* hist = reinterpret_cast<float*>(hist4);
  __shared__ int s_lo, s_hi;
  cg::cluster_group cluster = cg::this_cluster();
  const int nq = (nbins + 3) / 4;
  for (int i = threadIdx.x; i < nq; i += blockDim.x)
    hist4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x & ~31;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(n, start + chunk);
  int lo = INT_MAX, hi = -1;
  long long e0 = start;
  const bool vec_in =
      ((reinterpret_cast<unsigned long long>(idx) |
        reinterpret_cast<unsigned long long>(val)) & 15ull) == 0;
  if (vec_in && start < end) {
    // chunk is a multiple of 4, so every block's start is 16-byte aligned
    const long long nv = (end - start) / 4;
    const int4* iq = reinterpret_cast<const int4*>(idx + start);
    const float4* vq = reinterpret_cast<const float4*>(val + start);
    for (long long base = warp0; base < nv; base += blockDim.x) {
      const long long q = base + lane;
      int4 bi = make_int4(-1, -1, -1, -1);
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < nv) {
        bi = iq[q];
        vv = vq[q];
      }
      add_update(hist, bi.x, vv.x, nbins, lane, lo, hi);
      add_update(hist, bi.y, vv.y, nbins, lane, lo, hi);
      add_update(hist, bi.z, vv.z, nbins, lane, lo, hi);
      add_update(hist, bi.w, vv.w, nbins, lane, lo, hi);
    }
    e0 = start + 4 * nv;
  }
  for (long long base = e0 + warp0; base < end; base += blockDim.x) {
    const long long e = base + lane;
    int b = -1;
    float v = 0.f;
    if (e < end) {
      b = idx[e];
      v = val[e];
    }
    add_update(hist, b, v, nbins, lane, lo, hi);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0 && hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  cluster.sync();

  // the cluster's touched range, in 4-bin groups, cut into CLUSTER slices
  int clo = INT_MAX, chi = -1;
  for (int k = 0; k < CLUSTER; ++k) {
    clo = min(clo, *cluster.map_shared_rank(&s_lo, k));
    chi = max(chi, *cluster.map_shared_rank(&s_hi, k));
  }
  if (chi >= 0) {
    const int q0 = clo / 4, q1 = chi / 4 + 1;
    const int per = (q1 - q0 + CLUSTER - 1) / CLUSTER;
    const int rank = (int)cluster.block_rank();
    const int a = q0 + rank * per, b = min(q1, a + per);
    const bool vec_out =
        (reinterpret_cast<unsigned long long>(tally) & 15ull) == 0;
    for (int q = a + threadIdx.x; q < b; q += blockDim.x) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < CLUSTER; ++k) {
        const float4 h = cluster.map_shared_rank(hist4, k)[q];
        sum.x += h.x;
        sum.y += h.y;
        sum.z += h.z;
        sum.w += h.w;
      }
      flush_quad(tally, q, sum, nbins, vec_out);
    }
  }
  // no block leaves while another may still read its histogram
  cluster.sync();
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

// per device: the opt-in shared memory and the SM count (read once)
constexpr int MAX_DEVICES = 64;
int device_attr(cudaDeviceAttr attr, int* cache) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) {
    int v = 0;
    cudaDeviceGetAttribute(&v, attr, dev);
    return v;
  }
  if (cache[dev] == 0) cudaDeviceGetAttribute(&cache[dev], attr, dev);
  return cache[dev];
}

int smem_optin_bytes() {
  static int cache[MAX_DEVICES];
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, cache);
}

int num_sms() {
  static int cache[MAX_DEVICES];
  return device_attr(cudaDevAttrMultiProcessorCount, cache);
}

// the shared-route kernel's static shared memory (its two range words,
// padded), counted against the opt-in limit with the histogram
constexpr int STATIC_SMEM = 16;

long long shared_bytes(int nbins) {
  return (long long)((nbins + 3) / 4) * 16 + STATIC_SMEM;
}

// a launch refused before it ran leaves its error as the last error too:
// clear it, so the next call does not report it again
int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// clusters of the shared-route kernel resident at once for a histogram of
// `smem` bytes, asked of the runtime once per (device, bytes) (the query
// costs host time on every launch otherwise); the kernel's shared-memory
// limit raised to the most the route takes, so that no later, larger
// histogram finds it lower
cudaError_t resident_clusters(size_t smem, cudaLaunchConfig_t cfg,
                              int* clusters) {
  struct Entry {
    int dev;
    size_t smem;
    int clusters;
  };
  static std::mutex mu;
  static Entry cache[32];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].smem == smem) {
      *clusters = cache[i].clusters;
      return cudaSuccess;
    }
  cudaError_t e = cudaFuncSetAttribute(
      binned_add_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_optin_bytes() - STATIC_SMEM);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(CLUSTER * num_sms());
  e = cudaOccupancyMaxActiveClusters(clusters, binned_add_shared, &cfg);
  if (e != cudaSuccess) return e;
  if (used < 32) cache[used++] = {dev, smem, *clusters};
  return cudaSuccess;
}

// the shared route's launch: clusters of CLUSTER blocks, as many as fit on
// the card at once (fewer when n is small), each block a chunk of updates
int launch_shared(float* tally, const int* idx, const float* val,
                  long long n, int nbins, cudaStream_t s) {
  const size_t smem = (size_t)((nbins + 3) / 4) * sizeof(float4);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  cudaError_t e = resident_clusters(smem, cfg, &resident);
  if (e != cudaSuccess) return fail(e);
  if (resident < 1) return fail(cudaErrorInvalidConfiguration);
  // at least ~max(nbins / 2, 1,024) updates a block, so that zeroing and
  // reducing a histogram stays small beside the updates
  const long long per_block = nbins / 2 > 1024 ? nbins / 2 : 1024;
  long long want = (n + CLUSTER * per_block - 1) / (CLUSTER * per_block);
  const int clusters = (int)(want < 1 ? 1 : (want > resident ? resident
                                                             : want));
  const int blocks = clusters * CLUSTER;
  long long chunk = (n + blocks - 1) / blocks;
  chunk = (chunk + 3) / 4 * 4;
  cfg.gridDim = dim3(blocks);
  e = cudaLaunchKernelEx(&cfg, binned_add_shared, tally, idx, val, n, nbins,
                         chunk);
  if (e != cudaSuccess) return fail(e);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 = shared-memory histogram, 0 = global atomics.
extern "C" int skirt_binned_route(int nbins) {
  return shared_bytes(nbins) <= (long long)smem_optin_bytes() ? 1 : 0;
}

extern "C" int skirt_binned_add(float* tally, const int* idx,
                                const float* val, long long n, int nbins,
                                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (skirt_binned_route(nbins))
    return launch_shared(tally, idx, val, n, nbins, s);
  const int threads = 1024;
  const int sms = num_sms();
  long long want = (n + threads - 1) / threads;
  int blocks = (int)(want > 8LL * sms ? 8LL * sms : want);
  binned_add_global<<<blocks, threads, 0, s>>>(tally, idx, val, n, nbins);
  return (int)cudaGetLastError();
}
