// K7: the AAC-LC synthesis filterbank (ISO/IEC 14496-3 4.6.11) for one
// decode batch: IMDCT, windows, overlap-add across frames, s16 rounding.
//
// Replaces iamf_tpu/codecs/aac/tpu_synth.py synthesize_packed /
// _synthesize / _windowed_frames (a jitted program of two matmuls at
// HIGHEST precision). Per frame b and lane l (row r = b L + l):
//   long sequences (ONLY_LONG, LONG_START, LONG_STOP): t = the 2048-point
//     IMDCT of the 1024 spectral lines, frame = [t[:1024] * wl[seq, prev
//     shape], t[1024:] * wr[seq, shape]];
//   EIGHT_SHORT: eight 256-point IMDCTs of 128 lines each, windowed by the
//     short halves (window 0's left half by the previous shape) and
//     overlap-added inside the frame at 448 + 128 j;
//   out[b] = rint(clip(frame_b[:1024] + frame_{b-1}[1024:])) / 32768, with
//   the [L, 1024] carry as frame_{-1}'s second half; carry' = frame_{B-1}'s.
// The reference computes both paths for every row and selects; here a row
// takes only the path its sequence selects, which gives the same output.
//
// Design for Hopper, four launches:
// 1. k7_partition: the long rows into one index list (atomic slots; a row's
//    result does not depend on its slot).
// 2. k7_product: the long IMDCT as a split-TF32 tensor-core product over
//    K = 1024, K1's design (csrc/imdct.cu): W tiles by TMA into a ring
//    behind mbarriers, spectra staged by each consumer warpgroup and split
//    in registers, a fresh partial per 32-deep step summed round-to-nearest
//    on the CUDA cores. The IMDCT's output symmetry leaves 1024 distinct
//    columns of 2048 (t[1023 - n] = -t[n] for n < 512, t[3071 - n] = t[n]
//    for 1536 <= n < 2048): W holds columns 0..511 and 1024..1535 of the
//    reference's basis, so the product is half the reference's.
// 3. k7_window, a block a row: a long row unfolds its 1024 product columns
//    to 2048 samples and applies its two half windows; a short row computes
//    its eight short IMDCTs on the CUDA cores (1/8 of a long row's work; the
//    basis [128, 256] read through L1) and windows and overlap-adds them.
// 4. k7_overlap: the overlap across frames (row r - L's second half, or the
//    carry) and the s16 rounding, and the new carry.
//
// What bounds it: at B = 128, L = 12 (1536 rows) the spectra in and the PCM
// out are 12.6 MB (3.8 us at 3.35 TB/s); the long product is 1536 x 1024 x
// 1024 x 2 = 3.2 GFLOP of useful work, 9.7 G of split-TF32 tensor work
// (~20 us at 495 TFLOP/s): the product bounds this design, as K1's does.
// The two scratch passes (the product's columns and the windowed frames)
// add ~38 MB of traffic.

#include <stddef.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int K = 1024;          // spectral lines per frame
constexpr int NOUT = 1024;       // distinct IMDCT outputs (of 2048)
constexpr int EIGHT_SHORT = 2;
constexpr int BM = 64;           // rows per consumer warpgroup (wgmma M)
constexpr int WGS = 2;           // consumer warpgroups per block
constexpr int BN = 64;           // product columns per block (wgmma N)
constexpr int BK = 32;           // k per step: one 128-byte swizzle row
constexpr int KSTEPS = K / BK;   // 32
constexpr int STAGES = 4;        // W ring depth
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
constexpr int SMEM_BYTES = OFF_ROWS + ROWS * 4 + 1024;

constexpr int WIN_THREADS = 256;  // k7_window: one block a row

// Store 16 spectrum values per thread (rows 16w..16w+15 of the tile, lane
// = k) into an fp32 A tile and sync the warpgroup on barrier bar.
__device__ __forceinline__ void stage_a(const float (&v)[16], float* tile,
                                        int warp, int lane, int bar) {
#pragma unroll
  for (int j = 0; j < 16; ++j) tile[(warp * 16 + j) * A_LD + lane] = v[j];
  asm volatile("bar.sync %0, 128;" ::"r"(bar) : "memory");
}

__global__ void k7_partition(const int* __restrict__ meta, int R,
                             int* __restrict__ lists,
                             int* __restrict__ counts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R || meta[3 * r] == EIGHT_SHORT) return;
  lists[atomicAdd(counts, 1)] = r;
}

// z[r, n] = sum_k spec[r, k] W[n, k] for the block's 128 long rows and 64
// columns n of the 1024 distinct IMDCT outputs.
__global__ void __launch_bounds__(THREADS, 1)
k7_product(const __grid_constant__ CUtensorMap w_hi,
           const __grid_constant__ CUtensorMap w_lo,
           const float* __restrict__ spec, const int* __restrict__ lists,
           const int* __restrict__ counts, float* __restrict__ z) {
  const int cnt = counts[0];
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
    rows[tid] = lists[min(m0 + tid, cnt - 1)];
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
      for (int s = 0; s < KSTEPS; ++s) {
        const int st = s % STAGES;
        if (s >= STAGES) mbar_wait(empty0 + 8 * st, (s / STAGES - 1) & 1);
        const uint32_t dst = sb + OFF_B + st * 2 * B_TILE;
        mbar_expect_tx(full0 + 8 * st, 2 * B_TILE);
        tma_load(dst, &w_hi, full0 + 8 * st, s * BK, n0);
        tma_load(dst + B_TILE, &w_lo, full0 + 8 * st, s * BK, n0);
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
  const float* src = spec + lane;
  size_t roff[16];  // element offset of each row
#pragma unroll
  for (int j = 0; j < 16; ++j) roff[j] = (size_t)wrows[warp * 16 + j] * K;
  // pre holds the spectra of the step after the one being staged
  float pre[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) pre[j] = __ldg(src + roff[j]);
  stage_a(pre, atile, warp, lane, 1 + wg);
#pragma unroll
  for (int j = 0; j < 16; ++j) pre[j] = __ldg(src + roff[j] + BK);

  // a fresh partial per k-step (12 tensor-core instructions), summed
  // round-to-nearest here
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
      for (int j = 0; j < 16; ++j) pre[j] = __ldg(src + roff[j] + (s + 2) * BK);
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
    float* zr = z + (size_t)wrows[m] * NOUT;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int n = n0 + 8 * c + 2 * (lane % 4);
      *reinterpret_cast<float2*>(zr + n) =
          make_float2(sum[4 * c + 2 * h], sum[4 * c + 2 * h + 1]);
    }
  }
}

// frames[r] = the windowed 2048-sample frame of row r (see the note above):
// wl, wr [4 sequences][2 shapes][1024] half windows; sh [2 shapes][128]
// short half windows; bs [128 k][256 n] the short IMDCT basis.
__global__ void __launch_bounds__(WIN_THREADS)
k7_window(const float* __restrict__ spec, const int* __restrict__ meta,
          const float* __restrict__ z, const float* __restrict__ wl,
          const float* __restrict__ wr, const float* __restrict__ sh,
          const float* __restrict__ bs, float* __restrict__ frames) {
  const int r = blockIdx.x, tid = threadIdx.x;
  const int seq = meta[3 * r], shape = meta[3 * r + 1],
            prev = meta[3 * r + 2];
  float* f = frames + (size_t)r * 2 * K;
  if (seq != EIGHT_SHORT) {
    const float* zr = z + (size_t)r * NOUT;
    const float* wa = wl + (seq * 2 + prev) * K;
    const float* wb = wr + (seq * 2 + shape) * K;
    for (int n = tid; n < K; n += WIN_THREADS) {
      const float t0 = n < 512 ? zr[n] : -zr[1023 - n];
      const float t1 = n < 512 ? zr[512 + n] : zr[1535 - n];
      f[n] = __fmul_rn(t0, wa[n]);
      f[K + n] = __fmul_rn(t1, wb[n]);
    }
    return;
  }
  __shared__ float xs[K];        // the row's eight 128-line spectra
  __shared__ float ts[8 * 256];  // their IMDCTs
  for (int i = tid; i < K; i += WIN_THREADS) xs[i] = spec[(size_t)r * K + i];
  __syncthreads();
  {
    const int n = tid;  // output sample of each short IMDCT
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int k = 0; k < 128; ++k) {
      const float b = __ldg(bs + k * 256 + n);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(xs[j * 128 + k], b));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) ts[j * 256 + n] = acc[j];
  }
  __syncthreads();
  const float* sl = sh + shape * 128;
  const float* sl0 = sh + prev * 128;
  for (int p = tid; p < 2 * K; p += WIN_THREADS) {
    float v = 0.f;
    if (p >= 448 && p < 1600) {
      const int q = p - 448, j = q >> 7, o = q & 127;
      // window j's left half and window j-1's right half overlap here
      if (j == 0) {
        v = __fmul_rn(ts[o], sl0[o]);
      } else {
        const float right = __fmul_rn(ts[(j - 1) * 256 + 128 + o],
                                      sl[127 - o]);
        v = j < 8 ? __fadd_rn(right, __fmul_rn(ts[j * 256 + o], sl[o]))
                  : right;
      }
    }
    f[p] = v;
  }
}

// out[r] = rint(clip(first[r] + second[r - L] (or carry))) / 32768;
// carry' = the last frame's second halves
__global__ void k7_overlap(const float* __restrict__ frames,
                           const float* __restrict__ carry, int L, int R,
                           float* __restrict__ out,
                           float* __restrict__ carry_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * K) return;
  const int r = (int)(i / K), n = (int)(i % K);
  const float* fr = frames + (size_t)r * 2 * K;
  const float prev = r >= L ? frames[(size_t)(r - L) * 2 * K + K + n]
                            : carry[(size_t)r * K + n];
  const float v = __fadd_rn(fr[n], prev);
  out[i] = __fmul_rn(rintf(fminf(fmaxf(v, -32768.f), 32767.f)),
                     1.f / 32768.f);
  if (r >= R - L) carry_out[(size_t)(r - (R - L)) * K + n] = fr[K + n];
}

// A map depends only on the buffer's address (both have one shape), so a
// small cache keyed on the address is always right.
bool weight_map(const void* w, CUtensorMap* out) {
  static std::mutex mu;
  static const void* keys[4] = {};
  static CUtensorMap maps[4];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < 4; ++i)
    if (keys[i] == w) {
      *out = maps[i];
      return true;
    }
  CUtensorMap m;
  if (!tiled_map(w, NOUT, K, BN, BK, &m)) return false;
  keys[next] = w;
  maps[next] = m;
  next = (next + 1) % 4;
  *out = m;
  return true;
}

}  // namespace

// spec: [B*L, 1024] float32; meta: [B*L, 3] int32 (window_sequence,
// window_shape, previous shape); carry: [L, 1024]; w_hi, w_lo: [1024 n,
// 1024 k] split-TF32 product matrix (codecs/aac/synth.py product_mat);
// wl, wr: [4, 2, 1024]; sh: [2, 128]; bs: [128, 256]; out: [B*L, 1024];
// carry_out: [L, 1024]; scratch z: [B*L, 1024], frames: [B*L, 2048],
// lists: int[B*L], counts: int[1].
extern "C" int iamf_k7_aac_synth(const void* spec, const void* meta,
                                 const void* carry, int B, int L,
                                 const void* w_hi, const void* w_lo,
                                 const void* wl, const void* wr,
                                 const void* sh, const void* bs, void* out,
                                 void* carry_out, void* z, void* frames,
                                 void* lists, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * L;
  CUtensorMap maps[2];
  if (!weight_map(w_hi, &maps[0]) || !weight_map(w_lo, &maps[1]))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  k7_partition<<<(R + 255) / 256, 256, 0, s>>>((const int*)meta, R,
                                                (int*)lists, (int*)counts);
  e = cudaFuncSetAttribute(k7_product,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + ROWS - 1) / ROWS, NOUT / BN);
  k7_product<<<grid, THREADS, SMEM_BYTES, s>>>(
      maps[0], maps[1], (const float*)spec, (const int*)lists,
      (const int*)counts, (float*)z);
  k7_window<<<R, WIN_THREADS, 0, s>>>(
      (const float*)spec, (const int*)meta, (const float*)z,
      (const float*)wl, (const float*)wr, (const float*)sh,
      (const float*)bs, (float*)frames);
  k7_overlap<<<(unsigned)(((size_t)R * K + 255) / 256), 256, 0, s>>>(
      (const float*)frames, (const float*)carry, L, R, (float*)out,
      (float*)carry_out);
  return (int)cudaGetLastError();
}
