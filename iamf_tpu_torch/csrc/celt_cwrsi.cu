// K11: CWRS index -> PVQ pulse vector, for a batch of CELT leaves.
//
// Replaces iamf_tpu/codecs/opus/device_cwrsi.py cwrsi_batch (jitted): a
// leaf (n, k, index) is the index-th of the V(n, k) vectors of n integers
// whose magnitudes sum to k; the walk takes one dimension d at a time
// from n down to 3 (the largest k' <= an upper bound whose count U(k', d)
// is at most the index left), then the closed forms of n = 2 and n = 1.
// It mirrors the native walk (native/src/opus/celt_pvq.cc cwrsi) exactly:
// u32 arithmetic with its wraps, and the int (k0 - k + s) ^ s sign trick.
//
// What bounds it: a leaf's walk is a chain of dependent steps (up to 94
// on the Opus sample), so the kernel's floor is the longest leaf's chain,
// not its bytes (an int triple in, n_max ints out: 3.1 MB for the
// sample's 7,751 leaves at n_max = 96, under 1 us at 3.35 TB/s). The
// design shortens the chains and keeps every warp busy:
//   - a warp a leaf: the state kk, i is the same in every lane and a step
//     is branch-free. Lane l holds entries j = l + 32 r (r < R) of the
//     row U(., d). The row is nondecreasing (saturated entries are
//     0xFFFFFFFF), so the j <= upper with row[j] <= i are a prefix [0, c):
//     c is the popcount of the lanes' ballots (the JAX package's
//     _search_le as a count), and row[c - 1] and the next row's [c - 1]
//     and [c] are three reads of one shared-memory word each;
//   - R = (k + 1) / 32 + 1 (k' never exceeds k, and the next row's entry
//     c <= k + 1 is read): a leaf of few pulses compares one entry a lane;
//   - a run of zero steps (kk < d, row[kk] <= i < row[kk + 1]: the
//     coefficient is 0 and kk stays) is taken 32 dimensions at a time:
//     lane l tests dimension d - l against i less a prefix sum of the
//     row[kk] before it, and a ballot finds where the run ends. Leaves of
//     few pulses in many dimensions (the sample's longest: n = 96, k <= 5)
//     walk in a few passes;
//   - a persistent grid of at most BLOCKS_SM blocks an SM, each taking
//     leaves blockIdx.x + gridDim.x m, THREADS at a time: it reads them,
//     counting-sorts them by n, longest first, and its warps take them by
//     a ticket in shared memory;
//   - each block holds the rows U(., d), d <= n_max ([n_max + 1, 132]
//     u32, 51.2 KB at n_max = 96) in shared memory, copied by one bulk
//     copy on an mbarrier that its first thread issues as it starts, so
//     the copy runs while the block reads and sorts its leaves;
//   - a warp writes its leaf's coefficients into its own row of shared
//     memory (one store a step, by lane 0; a run leaves its zeros) and
//     stores the row coalesced, in the aligned layout (coefficient j at
//     column j) or the walk order (coefficient j at n_max - n + j).
// On an H100 SXM (perf/k11.py stamps) the sample's longest leaf walks in
// ~6,200 cycles alone; what bounds the kernel now is a block's start
// (~5,100 cycles before its longest leaf walks: 1,024 threads launching,
// the leaves' reads and the rows' copy, both far slower when every SM
// starts at once than for one block alone, and the sort) and the steps'
// issue contention among a block's 32 warps.

#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int ROW_W = 132;     // U_MAX_K: k + 1 <= 129 fits
constexpr int N_MAX = 96;
constexpr int WARPS = 32;      // warps a block
constexpr int BLOCKS_SM = 1;   // blocks an SM in the grid
constexpr int THREADS = WARPS * 32;  // also the leaves a block sorts at once
constexpr int BINS = 128;            // sort keys: n clamped to [0, 127]
constexpr int COLS = N_MAX / 32;     // a lane's columns of a leaf's row
constexpr unsigned FULL = 0xFFFFFFFFu;

__host__ __device__ constexpr size_t smem_bytes(int n_max) {
  return (size_t)(n_max + 1) * ROW_W * 4          // the rows
         + (size_t)WARPS * N_MAX * 4              // a row of y a warp
         + (size_t)THREADS * 4 * 4;               // the sorted leaves
}

__device__ __forceinline__ int signed_diff(int k0, int k, int s) {
  return (int)(((unsigned)k0 - (unsigned)k + (unsigned)s) ^ (unsigned)s);
}

__device__ __forceinline__ unsigned look(const unsigned* row, int v) {
  return (v >= 0 && v < ROW_W) ? row[v] : 0u;
}

// A run of zero steps from dimension d (its step is one: kk < d and
// row[kk] <= i < row[kk + 1], so 0 <= kk <= 130), 32 dimensions at a
// time: lane l tests dimension d - l with the index less the row[kk]
// of the dimensions before it (a prefix sum over the lanes; no wrap
// before the first lane that fails, which ends the run). Returns the
// zero steps F taken (1 to 32) and leaves i, and p0 = row[kk], p1 =
// row[kk + 1] of dimension d - F where F < 32.
__device__ __forceinline__ int zero_run(const unsigned* rows, int d, int kk,
                                        unsigned& i, unsigned& p0,
                                        unsigned& p1, int lane) {
  const int dl = d - lane;
  const unsigned* rl = rows + (dl > 2 ? dl : 2) * ROW_W;
  const unsigned a = rl[kk], b = rl[kk + 1];
  unsigned incl = a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += up;
  }
  const unsigned il = i - (incl - a);  // the index at dimension dl
  const unsigned fail =
      __ballot_sync(FULL, !(dl > 2 && kk < dl && a <= il && il < b));
  const int F = fail ? __ffs(fail) - 1 : 32;
  const int src = F < 32 ? F : 31;
  i = __shfl_sync(FULL, F < 32 ? il : i - incl, src);
  p0 = __shfl_sync(FULL, a, src);
  p1 = __shfl_sync(FULL, b, src);
  return F;
}

// The walk of one leaf from dimension top > 2 down to 3, by one warp;
// lane 0 writes coefficient y of dimension d to ys[n_max - d] (ys is 0
// where a run of zero steps passes).
template <int R>
__device__ __forceinline__ void walk(const unsigned* rows, int top, int& kk,
                                     unsigned& i, int n_max, int* ys,
                                     int lane) {
  int d = top;
  const unsigned* row = rows + d * ROW_W;
  unsigned e[R], f[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    e[r] = lane + 32 * r < ROW_W ? row[lane + 32 * r] : 0u;
  unsigned p0 = look(row, kk), p1 = look(row, kk + 1), rd = row[d];
  while (d > 2) {
    if (kk < d && p0 <= i && i < p1) {
      const int F = zero_run(rows, d, kk, i, p0, p1, lane);
      d -= F;
      if (d <= 2) break;
      row = rows + d * ROW_W;
#pragma unroll
      for (int r = 0; r < R; ++r)
        e[r] = lane + 32 * r < ROW_W ? row[lane + 32 * r] : 0u;
      rd = row[d];
      if (F == 32) {
        p0 = row[kk];
        p1 = row[kk + 1];
      }
      continue;
    }
    const unsigned* next = row - ROW_W;
#pragma unroll
    for (int r = 0; r < R; ++r)
      f[r] = lane + 32 * r < ROW_W ? next[lane + 32 * r] : 0u;
    const unsigned rdn = next[d - 1];
    // lots of pulses (kk >= d): upper = row[d] > ix ? d - 1 : kk; lots of
    // dimensions: row[kk] <= i < row[kk + 1] leaves kk (upper = kk, all of
    // [0, kk] qualifies), else upper = kk - 1
    const bool s = i >= p1;
    const unsigned ix = s ? i - p1 : i;
    const bool ge = kk >= d;
    const bool zero = !ge && !s && p0 <= i;
    const int upper = ge ? (rd > ix ? d - 1 : kk) : (zero ? kk : kk - 1);
    // the search: the j <= upper with row[j] <= ix are a prefix [0, c)
    int c = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = lane + 32 * r;
      c += __popc(__ballot_sync(FULL, j < ROW_W && j <= upper && e[r] <= ix));
    }
    if (lane == 0) ys[n_max - d] = signed_diff(kk, c - 1, s ? -1 : 0);
    kk = c - 1;
    i = ix - (c > 0 ? row[c - 1] : 0u);
    p0 = c > 0 ? next[c - 1] : 0u;
    p1 = c < ROW_W ? next[c] : 0u;
    rd = rdn;
    row = next;
#pragma unroll
    for (int r = 0; r < R; ++r) e[r] = f[r];
    --d;
  }
}

// One leaf by one warp: the walk, the closed forms of n = 2 and n = 1,
// and the store of its row of n_max coefficients.
__device__ __forceinline__ void leaf(const unsigned* rows, int n0, int kk,
                                     unsigned i,
                                     int n_max, int align, int* ys, int* out,
                                     int lane) {
#pragma unroll
  for (int c = 0; c < COLS; ++c) ys[lane + 32 * c] = 0;
  __syncwarp();
  const int top = n0 < n_max ? n0 : n_max;
  if (top > 2) {  // R: k' <= k, and entry k + 1 is read
    const int hi = kk < 0 ? 0 : (kk > ROW_W - 2 ? ROW_W - 1 : kk + 1);
    switch (hi / 32 + 1) {
      case 1: walk<1>(rows, top, kk, i, n_max, ys, lane); break;
      case 2: walk<2>(rows, top, kk, i, n_max, ys, lane); break;
      case 3: walk<3>(rows, top, kk, i, n_max, ys, lane); break;
      case 4: walk<4>(rows, top, kk, i, n_max, ys, lane); break;
      default: walk<5>(rows, top, kk, i, n_max, ys, lane); break;
    }
  }
  if (lane == 0) {
    {  // n == 2
      const unsigned p = 2u * (unsigned)kk + 1u;
      const int s = i >= p ? -1 : 0;
      if (s) i -= p;
      const int k0 = kk;
      kk = (int)((i + 1u) >> 1);
      if (kk > 0) i -= 2u * (unsigned)kk - 1u;
      ys[n_max - 2] = signed_diff(k0, kk, s);
    }
    {  // n == 1 (C: s = -(int)i)
      const int s = (int)(0u - i);
      ys[n_max - 1] = (int)(((unsigned)kk + (unsigned)s) ^ (unsigned)s);
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = lane + 32 * c;
    if (j >= n_max) break;
    int v;
    if (!align) {
      v = ys[j];
    } else {  // walk column n_max - n + j, clamped; 0 past n
      const long long src = (long long)n_max - n0 + j;
      v = j < n0 ? ys[src < 0 ? 0 : (src > n_max - 1 ? n_max - 1 : src)] : 0;
    }
    out[j] = v;
  }
  __syncwarp();  // ys is read before the next leaf clears it
}

__global__ void __launch_bounds__(THREADS, BLOCKS_SM)
k11_cwrsi(const int* __restrict__ n, const int* __restrict__ k,
          const unsigned* __restrict__ idx, const unsigned* __restrict__ rows_g,
          int L, int n_max, int align, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ int bins[BINS];
  __shared__ int ticket;
  __shared__ __align__(8) uint64_t bar;
  const unsigned* rows = smem;                            // [n_max + 1][ROW_W]
  int* ys_all = (int*)(smem + (n_max + 1) * ROW_W);       // [WARPS][N_MAX]
  int* qn = ys_all + WARPS * N_MAX;                       // [THREADS] each
  int* qk = qn + THREADS;
  unsigned* qi = (unsigned*)(qk + THREADS);
  int* ql = (int*)(qi + THREADS);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* ys = ys_all + warp * N_MAX;
  const uint32_t rows_bar = smem_u32(&bar);
  if (t == 0) {  // the rows, waited for before the first walk
    const uint32_t bytes = (uint32_t)(n_max + 1) * ROW_W * 4;
    mbar_init(rows_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(rows_bar, bytes);
    bulk_load(smem_u32(smem), rows_g, bytes, rows_bar);
  }

  // this block's leaves: blockIdx.x + gridDim.x m, THREADS at a time
  const int G = gridDim.x, b = blockIdx.x;
  const int mine = (L - b + G - 1) / G;
  for (int base = 0; base < mine; base += THREADS) {
    const int cnt = mine - base < THREADS ? mine - base : THREADS;
    const bool have = t < cnt;
    int ln = 0, lk = 0, ll = 0;
    unsigned li = 0u;
    if (have) {
      ll = b + (base + t) * G;
      ln = n[ll];
      lk = k[ll];
      li = idx[ll];
    }
    for (int u = t; u < BINS; u += THREADS) bins[u] = 0;
    __syncthreads();
    int slot = t;
    {  // a counting sort by n, descending
      const int key =
          BINS - 1 - (ln < 0 ? 0 : (ln > BINS - 1 ? BINS - 1 : ln));
      if (have) atomicAdd(&bins[key], 1);
      __syncthreads();
      if (warp == 0) {  // exclusive scan of the bins, BINS / 32 a lane
        int v[BINS / 32], sum = 0;
#pragma unroll
        for (int u = 0; u < BINS / 32; ++u) {
          v[u] = bins[lane * (BINS / 32) + u];
          sum += v[u];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += up;
        }
        int run = incl - sum;
#pragma unroll
        for (int u = 0; u < BINS / 32; ++u) {
          bins[lane * (BINS / 32) + u] = run;
          run += v[u];
        }
      }
      __syncthreads();
      if (have) slot = atomicAdd(&bins[key], 1);
    }
    if (have) {
      qn[slot] = ln;
      qk[slot] = lk;
      qi[slot] = li;
      ql[slot] = ll;
    }
    if (t == 0) ticket = WARPS;
    __syncthreads();
    if (base == 0) mbar_wait(rows_bar, 0);

    for (int s = warp; s < cnt;) {
      leaf(rows, qn[s], qk[s], qi[s], n_max, align, ys,
           out + (size_t)ql[s] * n_max, lane);
      int nx = 0;
      if (lane == 0) nx = atomicAdd(&ticket, 1);
      s = __shfl_sync(FULL, nx, 0);
    }
    __syncthreads();  // the slots are read before the next round's writes
  }
}

}  // namespace

// n, k int32 [L]; idx u32 [L]; rows u32 [N_MAX + 1, 132] (device_cwrsi
// u_rows, 16-byte aligned); out int32 [L, n_max]
extern "C" int iamf_k11_cwrsi(const void* n, const void* k, const void* idx,
                              const void* rows, int L, int n_max, int align,
                              void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || n_max < 2 || n_max > N_MAX || (size_t)rows % 16)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      k11_cwrsi, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(N_MAX));
  if (attr != cudaSuccess) return (int)attr;
  static const int sms = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return v;
  }();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  // every block gets a leaf (so it waits for its rows' copy before it
  // ends); a block's warps each get one when L allows
  const long long by_warps = ((long long)L + WARPS - 1) / WARPS;
  const int grid = (int)(by_warps < (long long)sms * BLOCKS_SM
                             ? by_warps : (long long)sms * BLOCKS_SM);
  k11_cwrsi<<<grid, THREADS, smem_bytes(n_max), s>>>(
      (const int*)n, (const int*)k, (const unsigned*)idx,
      (const unsigned*)rows, L, n_max, align, (int*)out);
  return (int)cudaGetLastError();
}
