// K1: CELT IMDCT + TDAC overlap as one split-TF32 tensor-core product per
// mode, plus a 120-sample overlap epilogue, for frames of N = 120, 240, 480
// or 960 samples (a template instantiated four times).
//
// Replaces the one Pallas kernel of the reference,
// iamf_tpu/codecs/opus/pallas_imdct.py fused_imdct_overlap / _kernel
// (constants from _fused_mats). Every output sample of a frame is linear in
// (spectrum, previous frame's raw 60-sample tail):
//     y     = freq . A_mode^T + tail_in . C^T     (mode = long | short)
//     tail' = freq . D_mode^T
// C is the same for both modes and has 120 nonzeros, all in output columns
// 0..119: y[j] += w[119-j] * tail_in[j < 60 ? j : 119-j].
//
// Design for Hopper:
// - One product per mode over K = N: W_mode = [A_mode | D_mode | 0]
//   (NOUT x KP, built on the host in codecs/opus/imdct.py: NOUT = N + 60
//   rounded up to the 64-column tile, KP = N rounded up to the 32-deep
//   k-step with zero columns, whose spectra the kernel loads as zeros), so
//   each row's N output samples and its 60-sample new tail come out of one
//   product. A transient frame's M = N/120 short blocks are folded into
//   W_short; at N = 120 both modes are the long one.
//   Once every tail exists, the C term is a separate elementwise epilogue
//   (k1_overlap); no frame chain remains and all B*L rows are independent.
// - Rows are split by mode into two index lists (atomic slots). A row's
//   result does not depend on its slot or on any other row, so the output
//   is deterministic. Each 64-row tile multiplies only its own mode's W.
// - Tensor cores in split TF32: W is stored as hi = tf32(W) and
//   lo = tf32(W - hi) (round to nearest, as cvt.rna.tf32.f32), and the
//   kernel splits the spectra the same way. Each 8-deep slice issues
//   a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (wgmma m64n64k8 .tf32). The dropped
//   a_lo.b_lo term and the residuals are below 2^-22 of each product: on the
//   host (numpy against float64, 1536 rows of randn*1000 spectra, peak
//   output 1.2e5) the split alone errs by 0.008, fp32 SGEMM by 0.063 and
//   plain TF32 by 29.0, against the 0.25 bound of tests/test_opus_pallas.py.
// - The tensor cores' fp32 accumulation truncates: accumulating all of K
//   there errs by 0.87 against the plain twin on the card. So each 32-deep
//   k-step starts a fresh partial (12 instructions), and the 30 partials
//   are summed on the CUDA cores with round-to-nearest (0.16).
// - W tiles arrive by TMA (128-byte swizzle, box 32 k x 64 n) into a ring
//   of STAGES buffers behind mbarriers, fed by one producer thread.
// - The spectra cannot take TMA or 16-byte cp.async: the packed rows are
//   N + 13 (hybrid 2N + 13) floats apart, not 16-byte aligned, and they
//   are gathered
//   through the mode lists. So each consumer warpgroup loads them with
//   coalesced 4-byte loads two k-steps ahead, stores them as fp32 into a
//   double-buffered tile, and reads back its own wgmma A fragments, which
//   it splits and keeps in registers (A from registers: the tensor cores
//   then read only W from shared memory). The contraction order within each
//   step is permuted (imdct.py k_order) so that a thread's fragment values
//   lie next to each other in the tile; W's columns are permuted to match.
//
// What bounds it: at B = 128, L = 12 the useful work is 1536 x 1020 x 960
// x 2 = 3.0 GFLOP; split TF32 makes it ~9 GFLOP of TF32 tensor work at
// N = 1024 (plus whole 64-row tiles), ~18 us at the card's 495 TFLOP/s.
// Bytes: each 128 x 64 block reads 64 x 960 x 8 B of W (from L2: the four
// W buffers are 15.7 MB) and 128 rows of spectra, ~200 MB of L2 traffic in
// all, and 6 MB of PCM out. Measured, the product takes ~65 us: each
// warpgroup's k-step (12 narrow m64n64k8 instructions, then a wait for them
// and the partial's promotion) runs at ~40 % of the tensor rate, with one
// block per SM (registers) and 1.6 waves of blocks. At B = 8 (96 rows) only
// 2 row tiles exist; the 64-wide N tile gives 32 blocks instead of 16 (a
// 128-wide tile was slower at B = 8; PERF.md has the variants). Shorter
// frames have fewer k-steps and column tiles (N = 480: 15 x 9, 240: 8 x 5,
// 120: 4 x 3) and proportionally more rows for the same samples.

#include <stddef.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int OVER = 60;         // raw tail length
constexpr int BM = 64;           // rows per consumer warpgroup (wgmma M)
constexpr int WGS = 2;           // consumer warpgroups per block
constexpr int BN = 64;           // product columns per block (wgmma N)
constexpr int BK = 32;           // k per step: one 128-byte swizzle row
constexpr int STAGES = 4;        // W ring depth

// the product's shape for frames of N samples
template <int N>
struct Dims {
  static constexpr int KSTEPS = (N + BK - 1) / BK;  // 30 at N = 960
  static constexpr int KP = KSTEPS * BK;             // W's columns
  static constexpr int NOUT = (N + OVER + BN - 1) / BN * BN;  // W's rows
};
constexpr int THREADS = WGS * 128 + 32;  // consumers + one producer warp
constexpr int ROWS = WGS * BM;           // rows per block

constexpr int A_LD = BK + 4;           // floats per staged spectrum row
constexpr int A_TILE = BM * A_LD * 4;  // 9 KB: 64 rows x 32 k, fp32
constexpr int B_TILE = BN * BK * 4;    // 8 KB: hi or lo of 64 cols x 32 k
// dynamic shared memory, from a 1024-byte aligned base (128-byte swizzle)
constexpr int OFF_B = 0;                            // [STAGES][hi, lo]
constexpr int OFF_A = OFF_B + STAGES * 2 * B_TILE;  // [WGS][2 buffers]
constexpr int OFF_BAR = OFF_A + WGS * 2 * A_TILE;   // full, empty
constexpr int OFF_ROWS = OFF_BAR + 2 * STAGES * 8;  // int[ROWS]

// Store 16 spectrum values per thread (rows 16w..16w+15 of the tile, lane
// = k) into an fp32 A tile and sync the warpgroup on barrier bar.
__device__ __forceinline__ void stage_a(const float (&v)[16], float* tile,
                                        int warp, int lane, int bar) {
#pragma unroll
  for (int j = 0; j < 16; ++j) tile[(warp * 16 + j) * A_LD + lane] = v[j];
  asm volatile("bar.sync %0, 128;" ::"r"(bar) : "memory");
}

__global__ void partition_rows(const uint8_t* __restrict__ trans, int R,
                               int* __restrict__ lists,
                               int* __restrict__ counts) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  int m = trans[r] != 0;
  int slot = atomicAdd(&counts[m], 1);
  lists[m * R + slot] = r;
}

// spectrum k of a row (offset roff), zero past the frame (W's pad columns)
template <int N>
__device__ __forceinline__ float spec(const float* src, int roff, int k) {
  if (N % BK == 0) return __ldg(src + roff + k);
  return k < N ? __ldg(src + roff + k) : 0.f;
}

// out[r, n] = sum_k freq[r, k] W_mode[n, k] for the block's 128 rows of one
// mode's list and 64 columns n; columns < N go to y, N..N+59 to tails.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
k1_product(const __grid_constant__ CUtensorMap w_long_hi,
           const __grid_constant__ CUtensorMap w_long_lo,
           const __grid_constant__ CUtensorMap w_short_hi,
           const __grid_constant__ CUtensorMap w_short_lo,
           const float* __restrict__ freq, int ld, int R,
           const int* __restrict__ lists, const int* __restrict__ counts,
           float* __restrict__ y, float* __restrict__ tails) {
  constexpr int KSTEPS = Dims<N>::KSTEPS;
  const int mode = blockIdx.z;
  const int cnt = counts[mode];
  const int m0 = blockIdx.x * ROWS;
  if (m0 >= cnt) return;
  const int n0 = blockIdx.y * BN;
  const int nwg = min(WGS, (cnt - m0 + BM - 1) / BM);  // warpgroups with rows

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sb = smem_u32(smem);
  const uint32_t full0 = sb + OFF_BAR, empty0 = full0 + STAGES * 8;
  int* rows = reinterpret_cast<int*>(smem + OFF_ROWS);

  const int tid = threadIdx.x;
  if (tid < ROWS)  // rows past the list repeat a real row; never stored
    rows[tid] = lists[mode * R + min(m0 + tid, cnt - 1)];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == WGS) {  // producer warp: one thread keeps the W ring full
    if (tid == WGS * 128) {
      const CUtensorMap* hi = mode ? &w_short_hi : &w_long_hi;
      const CUtensorMap* lo = mode ? &w_short_lo : &w_long_lo;
      for (int s = 0; s < KSTEPS; ++s) {
        const int st = s % STAGES;
        if (s >= STAGES) mbar_wait(empty0 + 8 * st, (s / STAGES - 1) & 1);
        const uint32_t dst = sb + OFF_B + st * 2 * B_TILE;
        mbar_expect_tx(full0 + 8 * st, 2 * B_TILE);
        tma_load(dst, hi, full0 + 8 * st, s * BK, n0);
        tma_load(dst + B_TILE, lo, full0 + 8 * st, s * BK, n0);
      }
    }
    return;
  }
  if (wg >= nwg) return;

  // consumer warpgroup: rows 64*wg .. 64*wg+63 of the block
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int* wrows = rows + wg * BM;
  float* atile = reinterpret_cast<float*>(smem + OFF_A + wg * 2 * A_TILE);

  // staging: warp w loads rows 16w..16w+15, lane = k within the step
  const float* src = freq;
  int roff[16];  // element offset of each row
#pragma unroll
  for (int j = 0; j < 16; ++j) roff[j] = wrows[warp * 16 + j] * ld;
  // pre holds the spectra of the step after the one being staged: loads are
  // issued a whole step before their values are stored
  float pre[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) pre[j] = spec<N>(src, roff[j], lane);
  stage_a(pre, atile, warp, lane, 1 + wg);
  if (KSTEPS > 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) pre[j] = spec<N>(src, roff[j], BK + lane);
  }

  // Each k-step's products go into a fresh partial, added to the fp32 sum
  // once the step is done: the tensor cores add only 12 products per
  // partial, and the long sum rounds to nearest here.
  static_assert(BN == 64, "the wgmma instruction is m64n64k8");
  float part[32], sum[32];
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = sum[i] = 0.f;
  for (int s = 0; s < KSTEPS; ++s) {
    const int st = s % STAGES;
    load_frags(atile + (s & 1) * (A_TILE / 4), A_LD, warp, lane, ahi, alo);
    mbar_wait(full0 + 8 * st, (s / STAGES) & 1);
    const uint32_t b_hi = sb + OFF_B + st * 2 * B_TILE;
    split_tf32_step(part, ahi, alo, b_hi, b_hi + B_TILE);
    // the other A buffer was last read before the previous step's barrier
    if (s + 1 < KSTEPS)
      stage_a(pre, atile + ((s + 1) & 1) * (A_TILE / 4), warp, lane, 1 + wg);
    if (s + 2 < KSTEPS) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        pre[j] = spec<N>(src, roff[j], (s + 2) * BK + lane);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    acc_fence(part);
    reg_fence(ahi);
    reg_fence(alo);
    if (t == 0) mbar_arrive(empty0 + 8 * st);  // W stage free
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] = __fadd_rn(sum[i], part[i]);
  }

  // sum[4c + e]: row 16 warp + lane/4 + 8 (e/2), column 8c + 2 (lane%4) + e%2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + lane / 4 + 8 * h;
    if (m0 + wg * BM + m >= cnt) continue;
    const int r = wrows[m];
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int n = n0 + 8 * c + 2 * (lane % 4);
      const float2 v =
          make_float2(sum[4 * c + 2 * h], sum[4 * c + 2 * h + 1]);
      if (n < N)
        *reinterpret_cast<float2*>(y + (size_t)r * N + n) = v;
      else if (n < N + OVER)
        *reinterpret_cast<float2*>(tails + (size_t)r * OVER + n - N) = v;
    }
  }
}

// the C term: y[r, j] += w[119-j] * tail_in[r][j < 60 ? j : 119-j], j < 120
// (the same 120 nonzeros at every N); tail_in is frame b-1's new tail (row
// r-L), or tail0[l] for frame 0
template <int N>
__global__ void k1_overlap(const float* __restrict__ window,
                           const float* __restrict__ tails,
                           const float* __restrict__ tail0, int L, int R,
                           float* __restrict__ y) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= R * 2 * OVER) return;
  const int r = e / (2 * OVER), j = e - r * (2 * OVER);
  const float* tin =
      r >= L ? tails + (size_t)(r - L) * OVER : tail0 + (size_t)r * OVER;
  float* out = y + (size_t)r * N + j;
  *out = __fadd_rn(*out, __fmul_rn(window[2 * OVER - 1 - j],
                                   tin[j < OVER ? j : 2 * OVER - 1 - j]));
}

// --- tensor maps of the W buffers ------------------------------------------

// A map depends only on the buffer's address and its frame size (which
// fixes its shape), so a small cache keyed on both is always right.
bool weight_map(const void* w, int n, int rows, int cols, CUtensorMap* out) {
  constexpr int SLOTS = 32;
  static std::mutex mu;
  static const void* keys[SLOTS] = {};
  static int key_n[SLOTS] = {};
  static CUtensorMap maps[SLOTS];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < SLOTS; ++i)
    if (keys[i] == w && key_n[i] == n) {
      *out = maps[i];
      return true;
    }
  CUtensorMap m;
  if (!tiled_map(w, rows, cols, BN, BK, &m)) return false;
  keys[next] = w;
  key_n[next] = n;
  maps[next] = m;
  next = (next + 1) % SLOTS;
  *out = m;
  return true;
}

template <int N>
int launch(const void* freq, int ld, const void* trans, const void* tail0,
           int B, int L, const void* const* ws, const void* window, void* y,
           void* tails, void* lists, void* counts, cudaStream_t s) {
  using D = Dims<N>;
  constexpr int SMEM_BYTES = OFF_ROWS + ROWS * 4 + 1024;
  const int R = B * L;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!weight_map(ws[i], N, D::NOUT, D::KP, &maps[i]))
      return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  partition_rows<<<(R + 255) / 256, 256, 0, s>>>(
      (const uint8_t*)trans, R, (int*)lists, (int*)counts);
  e = cudaFuncSetAttribute(k1_product<N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + ROWS - 1) / ROWS, D::NOUT / BN, 2);
  k1_product<N><<<grid, THREADS, SMEM_BYTES, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)freq, ld, R,
      (const int*)lists, (const int*)counts, (float*)y, (float*)tails);
  k1_overlap<N><<<(R * 2 * OVER + 255) / 256, 256, 0, s>>>(
      (const float*)window, (const float*)tails, (const float*)tail0, L, R,
      (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// freq: [B*L rows] of >= n floats, row stride ld (the packed spectra
// buffer is read in place); n: 120, 240, 480 or 960; trans: [B*L] uint8;
// tail0: [L, 60]; w_*: [NOUT, KP] split-TF32 product matrices of frames of
// n (16-byte aligned; imdct.product_mats); window: [120]; y: [B*L, n];
// tails: [B*L, 60] (row (B-1)*L+l is lane l's new tail); lists: int[2*B*L],
// counts: int[2] scratch.
extern "C" int iamf_k1_imdct(const void* freq, int ld, int n,
                             const void* trans, const void* tail0, int B,
                             int L, const void* w_long_hi,
                             const void* w_long_lo, const void* w_short_hi,
                             const void* w_short_lo, const void* window,
                             void* y, void* tails, void* lists, void* counts,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ws[4] = {w_long_hi, w_long_lo, w_short_hi, w_short_lo};
  switch (n) {
    case 120:
      return launch<120>(freq, ld, trans, tail0, B, L, ws, window, y, tails,
                         lists, counts, s);
    case 240:
      return launch<240>(freq, ld, trans, tail0, B, L, ws, window, y, tails,
                         lists, counts, s);
    case 480:
      return launch<480>(freq, ld, trans, tail0, B, L, ws, window, y, tails,
                         lists, counts, s);
    case 960:
      return launch<960>(freq, ld, trans, tail0, B, L, ws, window, y, tails,
                         lists, counts, s);
  }
  return (int)cudaErrorInvalidValue;
}
