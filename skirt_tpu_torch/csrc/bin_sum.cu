// The per-wavelength bin sum of the monochromatic detects (the SED
// tallies): tally[b] += the sum of values[e] over the e with ell[e] == b,
// added into the tally in place.
//
// Replaces no TPU kernel: skirt_tpu sums the same bins as an XLA one-hot
// matvec (skirt_tpu/instruments/instruments.py:98 `_bin_sum`), not a
// Pallas kernel.  The port's plain version (ops/bin_sum.py::
// bin_sum_plain) sums masked rows in chunks: at the mono path's 2^21
// values into 128 bins, 16 chunks of (8, 2^21) temporaries, ~2.1 ms a
// call on the H100.  Indices outside [0, nlambda) are dropped, as the
// plain version's comparisons drop them.
//
// What bounds it on the H100: the 8 bytes read per value (2^21 values:
// 16.8 MB, 5.0 us at 3.35 TB/s).
//
// Design (one algorithm; the wrapper's plan, ops/bin_sum.py::
// bin_sum_plan, sets its parameters from the shape):
// - Each thread owns a column of float32 partial sums, one per bin of the
//   pass, in shared memory, bin-major (bin r of thread t at r * THREADS +
//   t): the 32 lanes of a warp touch 32 banks whatever bins they hold, so
//   no lanes conflict, none are matched and no atomics are needed.  A
//   block holds bins x 1 KB: the "one pass" route takes up to 226 bins on
//   the H100; past that the bins split into `ranges` ranges of equal size,
//   one range per blockIdx.y, each block keeping the values of its range
//   from its chunk (the "passes" route).
// - A persistent grid along x (at most 2 blocks an SM; 1 at 128 bins,
//   128 KB), each block a contiguous chunk of the values read as int4 and
//   float4 by 256 threads: a thread's first UNROLL quads are in flight
//   while the block zeroes its columns, and each later batch while the
//   one before is added.
// - Each block adds its 256 columns per bin (a warp RB bins at a time:
//   each lane adds 8 columns by a pairwise float32 tree, then RB
//   interleaved fixed float64 shuffle trees) and writes its row of
//   partials, one float32 a bin.  Each lane's sum is 1/32 of a row and
//   each row 1/blocks of the total, so these roundings cost a small
//   fraction of one rounding of the total.
// - The last block of each range (an atomic ticket after a fence) adds the
//   blocks' rows in a fixed order, rounds once to float32, adds that into
//   the tally and resets its ticket for the next call.  It reads the rows
//   as float4 (4 bins), tq quads of bins at a time, each by THREADS / tq
//   groups of rows (FIN_LOADS rows in flight a thread) added in float64 in
//   order and then by a fixed pairwise tree in shared memory: with few
//   bins every thread still takes a share of the rows.  The tally's old
//   values are read before the rows, so their latency hides behind them.
// Every value's path to the tally is fixed by the shape and the card's SM
// count, so the result is bitwise repeatable run to run; the float64
// stages keep its error near one float32 rounding of the exact sum.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                       // quads a thread in flight
constexpr int RB = 8;                           // bins a warp reduces at once
constexpr int MAX_TQ = 32;                      // quads a finishing step
constexpr int FIN_LOADS = 8;                    // rows a finishing thread
                                                // has in flight
// the static shared memory the wrapper's plan reserves (the ticket flag)
constexpr int STATIC_SMEM = 16;

// the dynamic shared memory of a pass of `bins` bins: the columns, or the
// finish's 4 float64 sums a thread where they take more
size_t dynamic_bytes(int bins) {
  const size_t cols = (size_t)bins * THREADS * sizeof(float);
  const size_t fin = (size_t)THREADS * 4 * sizeof(double);
  return cols > fin ? cols : fin;
}

// floats a row of partials takes: the bins of a pass, padded to a quad
__device__ __forceinline__ int row_floats(int bins) {
  return (bins + 3) / 4 * 4;
}

// value v into the thread's column of bin b, kept when lo <= b < lo + cnt
__device__ __forceinline__ void add_value(float* col, int b, float v, int lo,
                                          int cnt) {
  const unsigned r = (unsigned)b - (unsigned)lo;
  if (r < (unsigned)cnt) col[r * THREADS] += v;
}

// quads q0, q0 + THREADS, ... (UNROLL of them) of the chunk, or empty
// ones (index -1, value 0) past its nq quads
__device__ __forceinline__ void load_quads(int4* e, float4* v,
                                           const int4* __restrict__ eq,
                                           const float4* __restrict__ vq,
                                           long long q0, long long nq) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long q = q0 + (long long)u * THREADS;
    e[u] = q < nq ? eq[q] : make_int4(-1, -1, -1, -1);
    v[u] = q < nq ? vq[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(THREADS)
bin_sum_kernel(float* __restrict__ tally, const float* __restrict__ val,
               const int* __restrict__ ell, long long n, int nlambda,
               int bins, long long chunk, float* __restrict__ part,
               unsigned* __restrict__ tickets) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned s_last;
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lo = blockIdx.y * bins;
  const int cnt = min(bins, nlambda - lo);

  // the block's chunk (a multiple of 4 values, so 16-byte aligned), its
  // first quads in flight while the columns are zeroed; then each batch
  // of quads is added while the next one is in flight
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = max(start, min(n, start + chunk));
  const long long nq = (end - start) / 4;
  const int4* eq = reinterpret_cast<const int4*>(ell + start);
  const float4* vq = reinterpret_cast<const float4*>(val + start);
  int4 e[UNROLL];
  float4 v[UNROLL];
  load_quads(e, v, eq, vq, tid, nq);
  for (int i = tid; i < cnt * (THREADS / 4); i += THREADS)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  float* col = smem + tid;
  for (long long q0 = tid; q0 < nq; q0 += (long long)THREADS * UNROLL) {
    int4 e2[UNROLL];
    float4 v2[UNROLL];
    load_quads(e2, v2, eq, vq, q0 + (long long)THREADS * UNROLL, nq);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      add_value(col, e[u].x, v[u].x, lo, cnt);
      add_value(col, e[u].y, v[u].y, lo, cnt);
      add_value(col, e[u].z, v[u].z, lo, cnt);
      add_value(col, e[u].w, v[u].w, lo, cnt);
      e[u] = e2[u];
      v[u] = v2[u];
    }
  }
  // the ragged tail: fewer than 4 values
  const long long tail = start + 4 * nq + tid;
  if (tail < end) add_value(col, ell[tail], val[tail], lo, cnt);
  __syncthreads();

  // the block's row: each bin's 256 columns, a warp RB bins at a time
  // (bins warp, warp + WARPS, ...); a lane's 8 columns (4l .. 4l + 3 and
  // 128 + 4l .. 128 + 4l + 3, each warp's loads conflict-free) by a
  // pairwise float32 tree, the lanes by RB interleaved float64 trees
  const int lane = tid & 31, warp = tid >> 5;
  const int rq = row_floats(bins) / 4;
  float* row =
      part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 4 * rq;
  for (int r0 = warp; r0 < cnt; r0 += WARPS * RB) {
    double s[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = min(r0 + k * WARPS, cnt - 1);
      const float4 a = smem4[r * (THREADS / 4) + lane];
      const float4 b = smem4[r * (THREADS / 4) + 32 + lane];
      s[k] = (double)(((a.x + a.y) + (a.z + a.w))
                      + ((b.x + b.y) + (b.z + b.w)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < RB; ++k)
        s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < RB; ++k)
        if (r0 + k * WARPS < cnt) row[r0 + k * WARPS] = (float)s[k];
    }
  }

  // the last block of this range to finish takes the ticket gridDim.x - 1
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(tickets + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the range's rows, tq quads of bins at a time: thread (g, q) adds rows
  // g, g + groups, ... of quad q in order, then the groups go by a fixed
  // pairwise tree; the sums, once rounded to float32, into the tally
  const int quads = (cnt + 3) / 4;
  int tq = 1;
  while (tq < quads && tq < MAX_TQ) tq <<= 1;
  const int groups = THREADS / tq;
  const int q = tid % tq, g = tid / tq;
  const float4* rows = reinterpret_cast<const float4*>(
      part + (long long)blockIdx.y * gridDim.x * 4 * rq);
  double* fin = reinterpret_cast<double*>(smem4) + 4 * tid;
  for (int q0 = 0; q0 < quads; q0 += tq) {
    const int qq = q0 + q;
    const int b = lo + 4 * qq;
    const int nb = g == 0 && qq < quads ? min(4, cnt - 4 * qq) : 0;
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = k < nb ? tally[b + k] : 0.f;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
    if (qq < quads) {
      // FIN_LOADS rows in flight at once, then added in order
      for (int x0 = g; x0 < (int)gridDim.x; x0 += FIN_LOADS * groups) {
        float4 w[FIN_LOADS];
#pragma unroll
        for (int j = 0; j < FIN_LOADS; ++j) {
          const int x = x0 + j * groups;
          w[j] = x < (int)gridDim.x ? __ldcg(rows + (long long)x * rq + qq)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < FIN_LOADS; ++j) {
          s0 += (double)w[j].x;
          s1 += (double)w[j].y;
          s2 += (double)w[j].z;
          s3 += (double)w[j].w;
        }
      }
    }
    __syncthreads();
    fin[0] = s0;
    fin[1] = s1;
    fin[2] = s2;
    fin[3] = s3;
    __syncthreads();
    for (int h = groups / 2; h > 0; h >>= 1) {
      if (g < h) {
        const double* o = fin + 4 * h * tq;
#pragma unroll
        for (int k = 0; k < 4; ++k) fin[k] += o[k];
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < nb) tally[b + k] = t[k] + (float)fin[k];
  }
  if (tid == 0) tickets[blockIdx.y] = 0u;
}

// a launch refused before it ran leaves its error as the last error too:
// clear it, so the next call does not report it again
int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// per device: the opt-in shared memory a block (read once), and the
// kernel's dynamic shared memory limit raised to it (once)
constexpr int MAX_DEVICES = 64;

cudaError_t prepare(int* optin) {
  static std::mutex mu;
  static int cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < MAX_DEVICES && cache[dev] > 0) {
    *optin = cache[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bin_sum_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *optin - STATIC_SMEM);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES) cache[dev] = *optin;
  return cudaSuccess;
}

}  // namespace

// tally[b] += the sum of val[e] over ell[e] == b for n values into nlambda
// bins, in `ranges` passes of `bins` bins (the last one shorter), on a
// grid of `blocks` x ranges blocks; part holds ranges x blocks rows of
// the pass's bins padded to a quad (floats), tickets `ranges` zeros (left
// zero).  val, ell and part on 16 bytes.  Refuses a plan whose ranges do
// not cover the bins exactly or whose columns do not fit in a block's
// shared memory.
extern "C" int skirt_bin_sum(float* tally, const float* val, const int* ell,
                             long long n, int nlambda, int bins, int ranges,
                             int blocks, float* part, unsigned* tickets,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (nlambda < 1 || bins < 1 || ranges < 1 || ranges > 65535 ||
      blocks < 1 || (long long)bins * ranges < nlambda ||
      (long long)bins * (ranges - 1) >= nlambda)
    return fail(cudaErrorInvalidValue);
  if (((reinterpret_cast<unsigned long long>(val) |
        reinterpret_cast<unsigned long long>(ell) |
        reinterpret_cast<unsigned long long>(part)) & 15ull) != 0)
    return fail(cudaErrorMisalignedAddress);
  int optin = 0;
  cudaError_t e = prepare(&optin);
  if (e != cudaSuccess) return fail(e);
  const size_t smem = dynamic_bytes(bins);
  if (smem + STATIC_SMEM > (size_t)optin) return fail(cudaErrorInvalidValue);
  long long chunk = (n + blocks - 1) / blocks;
  chunk = (chunk + 3) / 4 * 4;
  bin_sum_kernel<<<dim3(blocks, ranges), THREADS, smem,
                   (cudaStream_t)stream>>>(tally, val, ell, n, nlambda, bins,
                                           chunk, part, tickets);
  return (int)cudaGetLastError();
}
