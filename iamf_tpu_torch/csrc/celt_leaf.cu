// K12: PVQ leaf normalization and spreading rotation, and the noise-fill
// LCG by jump-ahead.
//
// Replaces iamf_tpu/codecs/opus/device_leaf.py normalize_pulses,
// apply_rotations, lcg_noise_fill and lcg_leaf_entry_seeds (jitted).
//
// k12_normrot, a warp a leaf row of W <= 96 coefficients:
//   X = y * (gain / sqrt(sum y^2)), the sum of squares a warp reduction
//   (exact: the pulses are integers with sum |y| = k <= 128, so every
//   partial sum is an integer below 2^24), the division and square root
//   rounded to nearest as the reference's; then, for a leaf whose cfg is
//   >= 0, the matvec by its configuration's [96, 96] matrix (the
//   exp_rotation of device_leaf.rotation_matrix), a row at a time: the
//   lanes read the row coalesced, each multiplies its three coefficients
//   (j = lane, lane + 32, lane + 64, the x it already holds), and the
//   warp sums the parts by shuffles; every product and sum is rounded on
//   its own (the library builds with --fmad=false). A matvec has no
//   reuse, so the tensor cores would gain nothing, and TF32 would break
//   the reference's fp32. Leaves that do not rotate (90 % of real ones)
//   skip it. With y absent the input is X itself (apply_rotations). What
//   bounds it: the bytes, 96 ints in and 96 floats out a leaf, and a
//   36.9 KB matrix a rotating leaf.
//
// k12_lcg_fill: v[l, j] = A^(j+1) seed[l] + B_(j+1) mod 2^32 (celt_lcg_rand
//   seed' = 1664525 seed + 1013904223 after j + 1 steps), the jump tables'
//   first `width` entries staged in shared memory, an element a thread.
// k12_lcg_entry: leaf l's entry seed, the frame seed advanced by the
//   draws of the leaves before it: one block scans the draws (int32 with
//   its wraps, as the reference's cumsum), clips the exclusive prefix to
//   [0, 4096] and looks up (A^p, B_p) in shared memory.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int ROT_W = 96;
constexpr int WARPS = 4;          // leaves a normrot block
constexpr int LCG_MAX = 4096;
constexpr int FILL_THREADS = 256;
constexpr int ENTRY_THREADS = 1024;

__global__ void __launch_bounds__(WARPS * 32)
k12_normrot(const int* __restrict__ y, const float* __restrict__ xin,
            const float* __restrict__ gain, const int* __restrict__ cfg,
            const float* __restrict__ bank, int L, int W,
            float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = blockIdx.x * WARPS + warp;
  if (l >= L) return;  // a whole warp; the block has no barrier
  float x[3];
  if (y != nullptr) {
    float ryy = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int j = lane + 32 * c;
      x[c] = j < W ? (float)y[(size_t)l * W + j] : 0.f;
      ryy = __fadd_rn(ryy, __fmul_rn(x[c], x[c]));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      ryy = __fadd_rn(ryy, __shfl_xor_sync(0xffffffffu, ryy, o));
    const float g = __fdiv_rn(gain[l], __fsqrt_rn(ryy));
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = __fmul_rn(x[c], g);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int j = lane + 32 * c;
      x[c] = j < W ? xin[(size_t)l * W + j] : 0.f;
    }
  }
  const int c = cfg != nullptr ? cfg[l] : -1;
  if (c < 0) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int j = lane + 32 * r;
      if (j < W) out[(size_t)l * W + j] = x[r];
    }
    return;
  }
  const float* m = bank + (size_t)c * ROT_W * ROT_W;
  float* o = out + (size_t)l * ROT_W;
#pragma unroll 4
  for (int i = 0; i < ROT_W; ++i) {  // row i: the lanes' columns, summed
    const float* mi = m + (size_t)i * ROT_W + lane;
    float part = __fmul_rn(__ldg(mi), x[0]);
    part = __fadd_rn(part, __fmul_rn(__ldg(mi + 32), x[1]));
    part = __fadd_rn(part, __fmul_rn(__ldg(mi + 64), x[2]));
#pragma unroll
    for (int s = 16; s; s >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, s));
    if ((i & 31) == lane) o[i] = part;
  }
}

__global__ void __launch_bounds__(FILL_THREADS)
k12_lcg_fill(const unsigned* __restrict__ seed, int L, int width,
             const unsigned* __restrict__ tab, unsigned* __restrict__ out) {
  __shared__ unsigned a[LCG_MAX], b[LCG_MAX];
  for (int j = threadIdx.x; j < width; j += FILL_THREADS) {
    a[j] = tab[1 + j];
    b[j] = tab[LCG_MAX + 1 + 1 + j];
  }
  __syncthreads();
  const size_t total = (size_t)L * width;
  for (size_t e = (size_t)blockIdx.x * FILL_THREADS + threadIdx.x; e < total;
       e += (size_t)gridDim.x * FILL_THREADS) {
    const size_t l = e / width;
    const int j = (int)(e - l * width);
    out[e] = seed[l] * a[j] + b[j];
  }
}

__global__ void __launch_bounds__(ENTRY_THREADS)
k12_lcg_entry(unsigned frame_seed, const int* __restrict__ draws, int L,
              const unsigned* __restrict__ tab, unsigned* __restrict__ out) {
  __shared__ unsigned a[LCG_MAX + 1], b[LCG_MAX + 1];
  __shared__ unsigned wsum[ENTRY_THREADS / 32];
  __shared__ unsigned carry;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = t; j <= LCG_MAX; j += ENTRY_THREADS) {
    a[j] = tab[j];
    b[j] = tab[LCG_MAX + 1 + j];
  }
  if (t == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < L; base += ENTRY_THREADS) {
    const int l = base + t;
    const unsigned v = l < L ? (unsigned)draws[l] : 0u;
    unsigned x = v;  // inclusive scan in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += u;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      unsigned w = wsum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    const unsigned incl = carry + x + (warp ? wsum[warp - 1] : 0u);
    int p = (int)(incl - v);  // the exclusive prefix, int32
    p = p < 0 ? 0 : (p > LCG_MAX ? LCG_MAX : p);
    if (l < L) out[l] = frame_seed * a[p] + b[p];
    __syncthreads();
    if (t == ENTRY_THREADS - 1) carry = incl;
    __syncthreads();
  }
}

}  // namespace

// y int32 [L, W] (or null, then xin f32 [L, W]); gain f32 [L]; cfg int32
// [L] (null: no rotation; -1: this leaf does not rotate); bank f32
// [n_cfg, 96, 96]; out f32 [L, W]. A rotation needs W == 96.
extern "C" int iamf_k12_normrot(const void* y, const void* xin,
                                const void* gain, const void* cfg,
                                const void* bank, int L, int W, void* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || W < 1 || W > ROT_W || (y == nullptr) == (xin == nullptr) ||
      (y != nullptr && gain == nullptr) ||
      (cfg != nullptr && (bank == nullptr || W != ROT_W)))
    return (int)cudaErrorInvalidValue;
  k12_normrot<<<(L + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      (const int*)y, (const float*)xin, (const float*)gain, (const int*)cfg,
      (const float*)bank, L, W, (float*)out);
  return (int)cudaGetLastError();
}

// seed u32 [L]; tab u32 [2, 4097] (A^j, B_j); out u32 [L, width]
extern "C" int iamf_k12_lcg_fill(const void* seed, int L, int width,
                                 const void* tab, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || width < 1 || width > LCG_MAX) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)L * width;
  size_t blocks = (total + FILL_THREADS * 8 - 1) / (FILL_THREADS * 8);
  if (blocks > 1056) blocks = 1056;
  k12_lcg_fill<<<(unsigned)blocks, FILL_THREADS, 0, s>>>(
      (const unsigned*)seed, L, width, (const unsigned*)tab, (unsigned*)out);
  return (int)cudaGetLastError();
}

// draws int32 [L]; tab u32 [2, 4097]; out u32 [L]
extern "C" int iamf_k12_lcg_entry(unsigned frame_seed, const void* draws,
                                  int L, const void* tab, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1) return (int)cudaErrorInvalidValue;
  k12_lcg_entry<<<1, ENTRY_THREADS, 0, s>>>(
      frame_seed, (const int*)draws, L, (const unsigned*)tab, (unsigned*)out);
  return (int)cudaGetLastError();
}
