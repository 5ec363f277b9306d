// K12: PVQ leaf normalization and spreading rotation, and the noise-fill
// LCG by jump-ahead.
//
// Replaces iamf_tpu/codecs/opus/device_leaf.py normalize_pulses,
// apply_rotations, lcg_noise_fill and lcg_leaf_entry_seeds (jitted).
//
// k12_normrot: X = y * (gain / sqrt(sum y^2)) over leaf rows of W <= 96
//   coefficients, then, for a leaf whose cfg is >= 0, the matvec by its
//   configuration's [96, 96] matrix (the exp_rotation of
//   device_leaf.rotation_matrix); with y absent the input is X itself
//   (apply_rotations). The normalization is a warp a leaf: the sum of
//   squares a warp reduction (exact: the pulses are integers with
//   sum |y| = k <= 128, so every partial sum is an integer below 2^24),
//   the division and square root rounded to nearest as the reference's.
//   What bounds it: the bytes, 96 ints in and 96 floats out a leaf, and
//   each used configuration's 36.9 KB matrix once. The grid:
//   - one block a configuration first (the longest work starts first):
//     it stages its matrix in shared memory (16-byte loads, rows padded
//     to 100 floats so that a thread a row reads without bank
//     conflicts), gathers the indices of its leaves from cfg in leaf
//     order (8 a thread, counted with popc, a block scan of the counts),
//     normalizes them a warp each and multiplies them by the matrix with
//     a thread an output row, 4 leaves at a time, 48 leaves a pass;
//   - then blocks of 12 warps for the other leaves, two leaves a warp.
//   A call with no configuration (normalize_pulses) launches k12_norm
//   instead: a warp a leaf, four warps a block, few registers.
//   A row's product keeps the order of the warp-a-leaf design before it
//   (lane l's partial m[l] x[l] + m[l + 32] x[l + 32] + m[l + 64]
//   x[l + 64], the 32 partials summed as its xor butterfly did, pairs 16
//   apart first), every product and sum rounded on its own (the library
//   builds with --fmad=false): the outputs are that design's bit for bit. A matvec has little reuse, so
//   the tensor cores would gain nothing, and TF32 would break the
//   reference's fp32. Leaves that do not rotate (90 % of real ones) skip
//   it.
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
constexpr int NR_WARPS = 12;                 // a k12_normrot block's warps
constexpr int NR_THREADS = NR_WARPS * 32;
constexpr int NORM_LEAVES = 2;               // leaves a warp, normalize blocks
constexpr int MIN_BLOCKS = 1;                // k12_normrot blocks an SM
constexpr int NORM_WARPS = 4;                // leaves a k12_norm block
constexpr int PER = 8;                       // cfg entries a thread scans
constexpr int CHUNK = NR_THREADS * PER;      // a scan pass, the list's room
constexpr int XCAP = 48;                     // leaves a product pass
constexpr int GROUPS = NR_THREADS / ROT_W;   // leaves multiplied together
constexpr int MSTRIDE = 100;                 // a staged matrix row's floats
constexpr int LCG_MAX = 4096;
constexpr int FILL_THREADS = 256;
constexpr int ENTRY_THREADS = 1024;
static_assert(NR_THREADS % ROT_W == 0 && XCAP % NR_WARPS == 0, "tiling");

// a configuration block's shared memory
struct RotSmem {
  alignas(16) float m[ROT_W * MSTRIDE];  // the matrix, rows padded
  alignas(16) float x[XCAP][ROT_W];      // a pass's normalized leaves
  int list[CHUNK];                       // the configuration's leaves
  int wsum[NR_WARPS];
};

// leaf row l's coefficients lane + 32 c (0 past W), from y or xin
__device__ __forceinline__ void load_row(const int* __restrict__ y,
                                         const float* __restrict__ xin,
                                         int l, int W, int lane,
                                         float (&x)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int j = lane + 32 * c;
    x[c] = j >= W ? 0.f
                  : (y != nullptr ? (float)y[(size_t)l * W + j]
                                  : xin[(size_t)l * W + j]);
  }
}

// x * (gain / sqrt(sum x^2)), the sum a warp's
__device__ __forceinline__ void normalize(float (&x)[3], float gain) {
  float ryy = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) ryy = __fadd_rn(ryy, __fmul_rn(x[c], x[c]));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    ryy = __fadd_rn(ryy, __shfl_xor_sync(0xffffffffu, ryy, o));
  const float g = __fdiv_rn(gain, __fsqrt_rn(ryy));
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = __fmul_rn(x[c], g);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// the partials p[l] + p[l + 16] for l = 4c .. 4c + 3, where p[l] = (m[l]
// x[l] + m[l+32] x[l+32]) + m[l+64] x[l+64] (m a padded row, x a leaf, in
// shared memory)
__device__ __forceinline__ float4 pair_sums(const float* m, const float* x,
                                            int c) {
  float4 p[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = 4 * c + 16 * h;
    const float4 a0 = *reinterpret_cast<const float4*>(m + l);
    const float4 a1 = *reinterpret_cast<const float4*>(m + l + 32);
    const float4 a2 = *reinterpret_cast<const float4*>(m + l + 64);
    const float4 x0 = *reinterpret_cast<const float4*>(x + l);
    const float4 x1 = *reinterpret_cast<const float4*>(x + l + 32);
    const float4 x2 = *reinterpret_cast<const float4*>(x + l + 64);
    p[h] = make_float4(
        __fadd_rn(__fadd_rn(__fmul_rn(a0.x, x0.x), __fmul_rn(a1.x, x1.x)),
                  __fmul_rn(a2.x, x2.x)),
        __fadd_rn(__fadd_rn(__fmul_rn(a0.y, x0.y), __fmul_rn(a1.y, x1.y)),
                  __fmul_rn(a2.y, x2.y)),
        __fadd_rn(__fadd_rn(__fmul_rn(a0.z, x0.z), __fmul_rn(a1.z, x1.z)),
                  __fmul_rn(a2.z, x2.z)),
        __fadd_rn(__fadd_rn(__fmul_rn(a0.w, x0.w), __fmul_rn(a1.w, x1.w)),
                  __fmul_rn(a2.w, x2.w)));
  }
  return add4(p[0], p[1]);
}

// sum_j m[j] x[j] in the xor butterfly's order: the 32 partials p[l] summed
// pairwise 16 apart (pair_sums), then 8, 4, 2 and 1 apart; a chunk of
// four at a time, so that few values are live
__device__ __forceinline__ float row_product(const float* m, const float* x) {
  const float4 lo = add4(pair_sums(m, x, 0), pair_sums(m, x, 2));  // 8 apart
  const float4 hi = add4(pair_sums(m, x, 1), pair_sums(m, x, 3));
  const float4 s = add4(lo, hi);                                   // 4 apart
  return __fadd_rn(__fadd_rn(s.x, s.z), __fadd_rn(s.y, s.w));      // 2, 1
}

// The leaves of list[0, count) (configuration block, matrix staged): 48 a
// pass, a warp normalizing rows w, w + 12, ...; then the products, group
// g of 96 threads taking the pass's rows g, g + 4, ..., thread i row i.
__device__ void rotate_leaves(RotSmem& S, int count,
                              const int* __restrict__ y,
                              const float* __restrict__ xin,
                              const float* __restrict__ gain,
                              float* __restrict__ out) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = t / ROT_W, i = t % ROT_W;
  constexpr int RPW = XCAP / NR_WARPS;  // rows a warp a pass
  for (int k0 = 0; k0 < count; k0 += XCAP) {
    const int n = count - k0 < XCAP ? count - k0 : XCAP;
    float x[RPW][3], gv[RPW];
#pragma unroll
    for (int k = 0; k < RPW; ++k) {  // every row's loads in flight together
      const int r = warp + NR_WARPS * k;
      if (r < n) {
        const int l = S.list[k0 + r];
        load_row(y, xin, l, ROT_W, lane, x[k]);
        gv[k] = y != nullptr ? gain[l] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int r = warp + NR_WARPS * k;
      if (r < n) {
        if (y != nullptr) normalize(x[k], gv[k]);
#pragma unroll
        for (int c = 0; c < 3; ++c) S.x[r][lane + 32 * c] = x[k][c];
      }
    }
    __syncthreads();
    for (int r = g; r < n; r += GROUPS)
      out[(size_t)S.list[k0 + r] * ROT_W + i] =
          row_product(S.m + i * MSTRIDE, S.x[r]);
    __syncthreads();
  }
}

// normalize only (no configuration, or none that rotates): a warp a leaf,
// few registers, so that many warps' loads are in flight
__global__ void __launch_bounds__(NORM_WARPS * 32)
k12_norm(const int* __restrict__ y, const float* __restrict__ xin,
         const float* __restrict__ gain, int L, int W,
         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * NORM_WARPS + (threadIdx.x >> 5);
  if (l >= L) return;  // a whole warp
  float x[3];
  load_row(y, xin, l, W, lane, x);
  if (y != nullptr) normalize(x, gain[l]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int j = lane + 32 * c;
    if (j < W) out[(size_t)l * W + j] = x[c];
  }
}

__global__ void __launch_bounds__(NR_THREADS, MIN_BLOCKS)
k12_normrot(const int* __restrict__ y, const float* __restrict__ xin,
            const float* __restrict__ gain, const int* __restrict__ cfg,
            const float* __restrict__ bank, int L, int W, int n_cfg,
            float* __restrict__ out) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if ((int)blockIdx.x >= n_cfg) {  // a normalize block: two leaves a warp
    const int l0 = ((int)blockIdx.x - n_cfg) * NR_WARPS * NORM_LEAVES + warp;
    float x[NORM_LEAVES][3], gv[NORM_LEAVES];
    bool mine[NORM_LEAVES];
#pragma unroll
    for (int k = 0; k < NORM_LEAVES; ++k) {
      const int l = l0 + NR_WARPS * k;
      const int c = l < L && cfg != nullptr ? cfg[l] : -1;
      mine[k] = l < L && (c < 0 || c >= n_cfg);  // else its block rotates it
      if (mine[k]) {
        load_row(y, xin, l, W, lane, x[k]);
        gv[k] = y != nullptr ? gain[l] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < NORM_LEAVES; ++k) {
      if (!mine[k]) continue;  // a whole warp
      const int l = l0 + NR_WARPS * k;
      if (y != nullptr) normalize(x[k], gv[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int j = lane + 32 * c;
        if (j < W) out[(size_t)l * W + j] = x[k][c];
      }
    }
    return;
  }
  // configuration block c: its matrix (the first barrier of the scan
  // below orders these stores before the products), then its leaves
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RotSmem& S = *reinterpret_cast<RotSmem*>(smem_raw);
  const int c = blockIdx.x;
  const float4* mc = reinterpret_cast<const float4*>(
      bank + (size_t)c * ROT_W * ROT_W);
  for (int e = t; e < ROT_W * ROT_W / 4; e += NR_THREADS) {
    const int row = e / (ROT_W / 4), q = e % (ROT_W / 4);
    *reinterpret_cast<float4*>(S.m + row * MSTRIDE + 4 * q) = __ldg(mc + e);
  }
  int count = 0;  // the list's leaves (the same in every thread)
  for (int base = 0; base < L; base += CHUNK) {
    const int l0 = base + t * PER;
    unsigned mask = 0u;
    if (l0 + PER <= L) {
      const int4 u0 = *reinterpret_cast<const int4*>(cfg + l0);
      const int4 u1 = *reinterpret_cast<const int4*>(cfg + l0 + 4);
      mask = (u0.x == c) | (u0.y == c) << 1 | (u0.z == c) << 2 |
             (u0.w == c) << 3 | (u1.x == c) << 4 | (u1.y == c) << 5 |
             (u1.z == c) << 6 | (u1.w == c) << 7;
    } else {
      for (int e = 0; e < PER && l0 + e < L; ++e)
        mask |= (unsigned)(cfg[l0 + e] == c) << e;
    }
    const int cnt = __popc(mask);
    int incl = cnt;  // the counts' inclusive scan in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) S.wsum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NR_WARPS; ++w) {
      const int s = S.wsum[w];
      before += w < warp ? s : 0;
      total += s;
    }
    if (count + total > CHUNK) {  // the list is full: its leaves first
      rotate_leaves(S, count, y, xin, gain, out);
      count = 0;
    }
    for (int pos = count + before + incl - cnt; mask; mask &= mask - 1u)
      S.list[pos++] = l0 + __ffs((int)mask) - 1;
    count += total;
    __syncthreads();
  }
  rotate_leaves(S, count, y, xin, gain, out);
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
// [L] (null: no rotation; a leaf rotates when 0 <= cfg < n_cfg); bank f32
// [n_cfg, 96, 96]; out f32 [L, W]. A rotation needs W == 96; cfg and bank
// are read as 16-byte vectors: 16-byte aligned.
extern "C" int iamf_k12_normrot(const void* y, const void* xin,
                                const void* gain, const void* cfg,
                                const void* bank, int L, int W, int n_cfg,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || W < 1 || W > ROT_W || n_cfg < 0 ||
      (y == nullptr) == (xin == nullptr) ||
      (y != nullptr && gain == nullptr) || (cfg != nullptr && W != ROT_W) ||
      (n_cfg > 0 && (cfg == nullptr || bank == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((size_t)cfg % 16 || (size_t)bank % 16)
    return (int)cudaErrorMisalignedAddress;
  if (n_cfg == 0) {
    k12_norm<<<(L + NORM_WARPS - 1) / NORM_WARPS, NORM_WARPS * 32, 0, s>>>(
        (const int*)y, (const float*)xin, (const float*)gain, L, W,
        (float*)out);
    return (int)cudaGetLastError();
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      k12_normrot, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(RotSmem));
  if (attr != cudaSuccess) return (int)attr;
  const int leaves = NR_WARPS * NORM_LEAVES;
  k12_normrot<<<n_cfg + (L + leaves - 1) / leaves, NR_THREADS,
                sizeof(RotSmem), s>>>(
      (const int*)y, (const float*)xin, (const float*)gain, (const int*)cfg,
      (const float*)bank, L, W, n_cfg, (float*)out);
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
