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
// What bounds it: the walk is a chain of dependent steps a leaf (up to 94
// searches, each a few dependent shared-memory reads), so a thread a leaf
// is latency-bound; the bytes are small (an int triple in, n_max ints
// out: 3.1 MB for the Opus sample's 7,751 leaves at n_max = 96). The
// design keeps each step short and the stores coalesced:
//   - a thread a leaf, THREADS leaves a block;
//   - the rows U(., d) for d <= n_max ([n_max + 1, 132] u32, 51.2 KB at
//     n_max = 96) sit in dynamic shared memory (over 48 KB: the opt-in);
//   - each search is a binary search over the row, which is
//     nondecreasing (saturated entries are 0xFFFFFFFF), instead of the
//     native descending scan or the JAX package's one-hot compares over
//     the whole row (an XLA:TPU workaround: it gathers slowly);
//   - a thread writes its walk into its row of a shared tile (stride
//     n_max + 1, so a warp's writes to one column hit distinct banks),
//     and the block stores the tile's rows to the output with consecutive
//     threads on consecutive addresses, in the aligned layout (coefficient
//     j at column j) or the walk order (coefficient j at n_max - n + j).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int ROW_W = 132;   // U_MAX_K: k + 1 <= 129 fits
constexpr int N_MAX = 96;
constexpr int THREADS = 128;
constexpr size_t SMEM_MAX =
    ((size_t)(N_MAX + 1) * ROW_W + (size_t)THREADS * (N_MAX + 1)) * 4;

__device__ __forceinline__ unsigned look(const unsigned* row, int v) {
  return (v >= 0 && v < ROW_W) ? row[v] : 0u;
}

// max{j <= upper : row[j] <= i}, or -1 when there is none (row is
// nondecreasing, so the j with row[j] <= i are a prefix)
__device__ __forceinline__ int search_le(const unsigned* row, int upper,
                                         unsigned i) {
  if (upper < 0 || row[0] > i) return -1;
  int lo = 0, hi = upper < ROW_W - 1 ? upper : ROW_W - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (row[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int signed_diff(int k0, int k, int s) {
  return (int)(((unsigned)k0 - (unsigned)k + (unsigned)s) ^ (unsigned)s);
}

__global__ void __launch_bounds__(THREADS)
k11_cwrsi(const int* __restrict__ n, const int* __restrict__ k,
          const unsigned* __restrict__ idx, const unsigned* __restrict__ rows_g,
          int L, int n_max, int align, int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  __shared__ int n_sh[THREADS];
  unsigned* rows = smem;                                   // [n_max + 1][ROW_W]
  int* tile = (int*)(smem + (n_max + 1) * ROW_W);          // [THREADS][n_max + 1]
  const int stride = n_max + 1;
  for (int t = threadIdx.x; t < (n_max + 1) * ROW_W; t += THREADS)
    rows[t] = rows_g[t];
  const int base = blockIdx.x * THREADS;
  const int l = base + threadIdx.x;
  int* my = tile + threadIdx.x * stride;
  __syncthreads();

  if (l < L) {
    const int n0 = n[l];
    int kk = k[l];
    unsigned i = idx[l];
    n_sh[threadIdx.x] = n0;
    const int top = n0 < n_max ? n0 : n_max;
    for (int d = n_max; d > 2 && d > top; --d) my[n_max - d] = 0;
    for (int d = top; d > 2; --d) {
      const unsigned* row = rows + d * ROW_W;
      int knew, y;
      unsigned inew;
      if (kk >= d) {  // lots of pulses
        const unsigned p = look(row, kk + 1);
        const int s = i >= p ? -1 : 0;
        const unsigned ia = s ? i - p : i;
        knew = search_le(row, row[d] > ia ? d - 1 : kk, ia);
        inew = ia - look(row, knew);
        y = signed_diff(kk, knew, s);
      } else {        // lots of dimensions
        const unsigned p0 = look(row, kk), p1 = look(row, kk + 1);
        if (p0 <= i && i < p1) {
          knew = kk;
          inew = i - p0;
          y = 0;
        } else {
          const int s = i >= p1 ? -1 : 0;
          const unsigned ib = s ? i - p1 : i;
          knew = search_le(row, kk - 1, ib);
          inew = ib - look(row, knew);
          y = signed_diff(kk, knew, s);
        }
      }
      kk = knew;
      i = inew;
      my[n_max - d] = y;
    }
    {  // n == 2
      const unsigned p = 2u * (unsigned)kk + 1u;
      const int s = i >= p ? -1 : 0;
      if (s) i -= p;
      const int k0 = kk;
      kk = (int)((i + 1u) >> 1);
      if (kk > 0) i -= 2u * (unsigned)kk - 1u;
      my[n_max - 2] = signed_diff(k0, kk, s);
    }
    {  // n == 1 (C: s = -(int)i)
      const int s = (int)(0u - i);
      my[n_max - 1] = (int)(((unsigned)kk + (unsigned)s) ^ (unsigned)s);
    }
  } else {
    n_sh[threadIdx.x] = 0;
  }
  __syncthreads();

  const int here = L - base < THREADS ? L - base : THREADS;
  for (int t = threadIdx.x; t < here * n_max; t += THREADS) {
    const int r = t / n_max, j = t - r * n_max;
    const int* w = tile + r * stride;
    int v;
    if (!align) {
      v = w[j];
    } else {
      const int n0 = n_sh[r];
      int src = n_max - n0 + j;
      src = src < 0 ? 0 : (src > n_max - 1 ? n_max - 1 : src);
      v = j < n0 ? w[src] : 0;
    }
    out[(size_t)(base + r) * n_max + j] = v;
  }
}

}  // namespace

// n, k int32 [L]; idx u32 [L]; rows u32 [N_MAX + 1, 132] (device_cwrsi
// u_rows); out int32 [L, n_max]
extern "C" int iamf_k11_cwrsi(const void* n, const void* k, const void* idx,
                              const void* rows, int L, int n_max, int align,
                              void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || n_max < 2 || n_max > N_MAX) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      k11_cwrsi, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem =
      ((size_t)(n_max + 1) * ROW_W + (size_t)THREADS * (n_max + 1)) * 4;
  k11_cwrsi<<<(L + THREADS - 1) / THREADS, THREADS, smem, s>>>(
      (const int*)n, (const int*)k, (const unsigned*)idx,
      (const unsigned*)rows, L, n_max, align, (int*)out);
  return (int)cudaGetLastError();
}
