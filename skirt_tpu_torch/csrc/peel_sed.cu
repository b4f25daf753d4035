// The polychromatic scattering peel into the SED instruments (kernel PS):
// for every SED instrument i of a poly driver at once, j(i) its leader,
//   Ftot_i[w] += sum_n a_n c_{w,n} exp(-kext_w I_{j(i),n}),
// with c = Ln on fresh (relaunched) lanes, else Lp HG(g_w, cos_{j,n}), and
// a the lanes' alive flag, added into the tallies in place.
//
// Replaces no Pallas kernel: skirt_tpu computes this peel in XLA
// (skirt_tpu/engine/fused_table_poly.py, fused_poly.py).  The port's plain
// version (ops/peel_sed.py::peel_sed_plain) is the per-instrument loop of
// engine/common.py::peel_poly with SEDInstrument._detect_poly: about 26
// plain-torch launches over (W, N) tensors an SED, 260 an iteration at the
// agn-torus cell's ten SEDs, each ~18-30 us of host, which set that cell's
// pace.  It stays the spec; CPU tensors run it.
//
// What bounds it on the H100, the reads (Lp, Ln, I, the directions or
// cosines, the flags) against one MUFU exp and one MUFU rsqrt a (leader,
// wavelength, lane) term:
// - agn-torus (L = 10 leaders, W = 24, N = 2^15): ~7.8 MB, 2.3 us at 3.35
//   TB/s; ~7.9M terms, 15.7M MUFU operations, 3.8 us at 4.18 T/s;
// - disc-galaxy's SED (L = 1, W = 128, N = 2^17): Lp and Ln 128 MB,
//   38 us at 3.35 TB/s.
//
// Design:
// - A thread walks lanes (grid-stride along x) and keeps ACC = 32 float32
//   sums in registers, one per (slot, wavelength) of its block: a block
//   takes one group of at most 8 slots (the distinct leaders, rounded up
//   to NS = 1, 2, 4 or 8: the kernel's instance) and a chunk of 32 / NS
//   wavelengths, both along blockIdx.y.  A lane's cosines (from K1's (L, N)
//   rows, or its pre-event direction dotted with the leaders' float32
//   unit vectors) and integrals sit in registers across the chunk; Lp and
//   Ln are read once a slot group, coalesced along the lanes.  A lane's
//   loads are all issued before its terms (none waits on another: Ln is
//   read whole and picked by the fresh flag), so their latencies overlap.
// - The per-wavelength constants 1 + g^2, 2 g, (1 - g)(1 + g) and -kext
//   sit in shared memory; HG is (1 - g^2) rsqrt(t^3) with t the plain
//   version's 1 + g^2 - 2 g cos (built with -fmad=false, one rounding an
//   operation, as the plain version computes it).
// - The block's sums go by shuffle trees and its warps in order into a row
//   of partials (the block's columns of slot x wavelength).  The last block
//   (an atomic ticket after a fence) adds the rows in float64, in a fixed
//   order (bin_sum.cu's finish: float4 quads of the row, groups of rows by
//   a pairwise tree), rounds each sum once to float32, adds it into the
//   tally of every instrument of that slot and resets the ticket.
// No atomics touch a tally and every sum's order is fixed by the shape and
// the card's SM count: two launches give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ACC = 32;           // a thread's sums: slots x wavelengths
constexpr int MAX_TQ = 64;        // quads of sums a finishing step
constexpr int FIN_LOADS = 8;      // rows a finishing thread has in flight

}  // namespace

constexpr int PS_MAX_SED = 32;    // instruments a launch
constexpr int PS_MAX_SLOT = 32;   // distinct leaders a launch

// one launch's arguments (kernels.PeelSedArgs mirrors it field for field):
// cos (L, N) or dir (N, 3) with kdir; fresh and Ln null without relaunch
struct PeelSedArgs {
  const float* Lp;
  const float* Ln;
  const unsigned char* alive;
  const unsigned char* fresh;
  const float* g;
  const float* mk;
  const float* I;
  const float* cos;
  const float* dir;
  float* part;
  unsigned* ticket;
  float* ftot[PS_MAX_SED];
  int slot_of[PS_MAX_SED];
  int row[PS_MAX_SLOT];
  float kdir[PS_MAX_SLOT][3];
  long long N;
  int W, nsed, nslot, group, wsplit, epad;
};

namespace {

template <int NS>
__global__ void __launch_bounds__(THREADS, 2)
peel_sed_kernel(const __grid_constant__ PeelSedArgs a) {
  constexpr int WC = ACC / NS;
  __shared__ float s_cw[4][WC];
  __shared__ float s_red[WARPS][ACC];
  __shared__ double s_fin[THREADS * 4];
  __shared__ unsigned s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.y / a.wsplit * a.group;
  const int ns = min(a.group, a.nslot - s0);
  const int w0 = blockIdx.y % a.wsplit * WC;
  const int nw = min(WC, a.W - w0);
  const long long N = a.N;

  if (tid < WC) {
    const float g = tid < nw ? a.g[w0 + tid] : 0.f;
    s_cw[0][tid] = 1.f + g * g;
    s_cw[1][tid] = 2.f * g;
    s_cw[2][tid] = (1.f - g) * (1.f + g);
    s_cw[3][tid] = tid < nw ? a.mk[w0 + tid] : 0.f;
  }
  __syncthreads();

  float acc[NS][WC];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int k = 0; k < WC; ++k) acc[s][k] = 0.f;

  for (long long n = (long long)blockIdx.x * THREADS + tid; n < N;
       n += (long long)gridDim.x * THREADS) {
    // every load of the lane first, none waiting on another (Ln read
    // whole and picked by the fresh flag), so that they are in flight
    // together
    const bool alive = a.alive[n] != 0;
    const bool fresh = a.fresh != nullptr && a.fresh[n] != 0;
    float dx = 0.f, dy = 0.f, dz = 0.f;
    if (a.cos == nullptr) {
      dx = a.dir[3 * n];
      dy = a.dir[3 * n + 1];
      dz = a.dir[3 * n + 2];
    }
    float c[NS], x[NS], lp[WC], ln[WC];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      c[s] = x[s] = 0.f;
      if (s < ns) {
        const long long o = (long long)a.row[s0 + s] * N + n;
        x[s] = a.I[o];
        if (a.cos != nullptr) c[s] = a.cos[o];
      }
    }
#pragma unroll
    for (int k = 0; k < WC; ++k) {
      const long long o = (long long)(w0 + k) * N + n;
      lp[k] = k < nw ? a.Lp[o] : 0.f;
      ln[k] = k < nw && a.fresh != nullptr ? a.Ln[o] : 0.f;
    }
    if (a.cos == nullptr) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int ss = s0 + min(s, ns - 1);
        c[s] = dx * a.kdir[ss][0] + dy * a.kdir[ss][1] + dz * a.kdir[ss][2];
      }
    }
#pragma unroll
    for (int k = 0; k < WC; ++k) {
      if (k < nw) {
        const float A = s_cw[0][k], B = s_cw[1][k], C = s_cw[2][k];
        const float M = s_cw[3][k];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          if (s < ns) {
            const float t = A - B * c[s];
            float v = fresh ? ln[k] : lp[k] * (C * rsqrtf(t * t * t));
            v = alive ? v : 0.f;
            acc[s][k] += v * expf(M * x[s]);
          }
        }
      }
    }
  }

  // the block's row of partials: each sum by a shuffle tree, the warps in
  // order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int k = 0; k < WC; ++k)
        acc[s][k] += __shfl_down_sync(0xffffffffu, acc[s][k], off);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int k = 0; k < WC; ++k) s_red[warp][s * WC + k] = acc[s][k];
  }
  __syncthreads();
  if (tid < ACC) {
    const int s = tid / WC, k = tid % WC;
    if (s < ns && k < nw) {
      float v = s_red[0][tid];
#pragma unroll
      for (int wp = 1; wp < WARPS; ++wp) v += s_red[wp][tid];
      a.part[(long long)blockIdx.x * a.epad + (s0 + s) * a.W + w0 + k] = v;
    }
  }

  // the last block to finish takes the ticket gridDim.x * gridDim.y - 1
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(a.ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the rows' sums, tq quads of (slot, wavelength) at a time: thread (g, q)
  // adds rows g, g + groups, ... of quad q in float64 in order, then the
  // groups go by a fixed pairwise tree; each sum, rounded once to float32,
  // into the tally of every instrument of its slot
  const int E = a.nslot * a.W;
  const int quads = a.epad / 4;
  int tq = 1;
  while (tq < quads && tq < MAX_TQ) tq <<= 1;
  const int groups = THREADS / tq;
  const int q = tid % tq, g = tid / tq;
  const int rows = gridDim.x;
  const float4* part = reinterpret_cast<const float4*>(a.part);
  double* fin = s_fin + 4 * tid;
  for (int q0 = 0; q0 < quads; q0 += tq) {
    const int qq = q0 + q;
    double t0 = 0.0, t1 = 0.0, t2 = 0.0, t3 = 0.0;
    if (qq < quads) {
      for (int x0 = g; x0 < rows; x0 += FIN_LOADS * groups) {
        float4 w[FIN_LOADS];
#pragma unroll
        for (int j = 0; j < FIN_LOADS; ++j) {
          const int xr = x0 + j * groups;
          w[j] = xr < rows ? __ldcg(part + (long long)xr * quads + qq)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < FIN_LOADS; ++j) {
          t0 += (double)w[j].x;
          t1 += (double)w[j].y;
          t2 += (double)w[j].z;
          t3 += (double)w[j].w;
        }
      }
    }
    __syncthreads();
    fin[0] = t0;
    fin[1] = t1;
    fin[2] = t2;
    fin[3] = t3;
    __syncthreads();
    for (int h = groups / 2; h > 0; h >>= 1) {
      if (g < h) {
        const double* o = fin + 4 * h * tq;
#pragma unroll
        for (int k = 0; k < 4; ++k) fin[k] += o[k];
      }
      __syncthreads();
    }
    if (g == 0 && qq < quads) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * qq + k;
        if (e < E) {
          const int s = e / a.W, w = e - s * a.W;
          const float v = (float)fin[k];
          for (int i = 0; i < a.nsed; ++i)
            if (a.slot_of[i] == s) a.ftot[i][w] += v;
        }
      }
    }
  }
  if (tid == 0) *a.ticket = 0u;
}

// a launch refused before it ran leaves its error as the last error too:
// clear it, so the next call does not report it again
int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

}  // namespace

// One launch over a->N lanes for a->nsed instruments of a->nslot slots: ns
// (1, 2, 4 or 8) the kernel's instance, at least a->group slots a block;
// `blocks` blocks along x, sgroups slot groups x a->wsplit wavelength
// chunks of 32 / ns along y.  part holds blocks rows of a->epad floats (a
// multiple of 4, at least nslot x W) on 16 bytes, ticket one zero (left
// zero).  Refuses a shape the grid does not cover exactly.
extern "C" int skirt_peel_sed(const PeelSedArgs* a, int ns, int blocks,
                              int sgroups, void* stream) {
  if (a->N <= 0) return (int)cudaGetLastError();
  const int wc = (ns == 1 || ns == 2 || ns == 4 || ns == 8) ? ACC / ns : 0;
  if (wc == 0 || a->W < 1 || a->nsed < 1 || a->nsed > PS_MAX_SED ||
      a->nslot < 1 || a->nslot > PS_MAX_SLOT || a->group < 1 ||
      a->group > ns || sgroups < 1 || (long long)sgroups * a->group <
      a->nslot || (long long)(sgroups - 1) * a->group >= a->nslot ||
      a->wsplit != (a->W + wc - 1) / wc || blocks < 1 ||
      (long long)sgroups * a->wsplit > 65535 || a->epad % 4 != 0 ||
      a->epad < a->nslot * a->W || a->Lp == nullptr ||
      a->alive == nullptr || a->g == nullptr || a->mk == nullptr ||
      a->I == nullptr || (a->cos == nullptr) == (a->dir == nullptr) ||
      (a->fresh != nullptr && a->Ln == nullptr) || a->ticket == nullptr)
    return fail(cudaErrorInvalidValue);
  for (int i = 0; i < a->nsed; ++i)
    if (a->ftot[i] == nullptr || a->slot_of[i] < 0 ||
        a->slot_of[i] >= a->nslot)
      return fail(cudaErrorInvalidValue);
  for (int s = 0; s < a->nslot; ++s)
    if (a->row[s] < 0) return fail(cudaErrorInvalidValue);
  if ((reinterpret_cast<unsigned long long>(a->part) & 15ull) != 0)
    return fail(cudaErrorMisalignedAddress);
  const dim3 grid(blocks, sgroups * a->wsplit);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (ns) {
    case 1: peel_sed_kernel<1><<<grid, THREADS, 0, st>>>(*a); break;
    case 2: peel_sed_kernel<2><<<grid, THREADS, 0, st>>>(*a); break;
    case 4: peel_sed_kernel<4><<<grid, THREADS, 0, st>>>(*a); break;
    default: peel_sed_kernel<8><<<grid, THREADS, 0, st>>>(*a); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int skirt_peel_sed_args_size() {
  return (int)sizeof(PeelSedArgs);
}
