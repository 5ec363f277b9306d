// K13: the packed mono band walk of CELT frames (LM = 3, C = 1), a block
// a frame.
//
// Replaces iamf_tpu/codecs/opus/device_bands.py run_frame (jitted): a
// 21-band loop over band_pack's flattened tables that threads the
// collapse masks [21], the LCG seed and the norm buffer [800] from band
// to band. In band i of N bins at offset a:
//   - the entry fill: the OR of the collapse masks of bands [fs, fe)
//     (with a lowband), else (1 << B_in) - 1;
//   - the fold source: the window of the norm buffer at eff (its start
//     clamped into the buffer padded by W zeros, as dynamic_slice does)
//     through the band's lowband pre-transform, an [N, N] matrix of the
//     configuration bank;
//   - 16 leaf slots, in order: a slot's fill is its 16-column OR-map of
//     the entry fill; a PVQ slot (k > 0) places its leaf vector, a q0
//     slot noise (LCG draws by jump-ahead from the band's prefix of
//     draws, (int)v >> 20) or the fold source shifted by off (window
//     start clamped likewise) plus or minus 1/256 (bit 15 of the draw),
//     renormalized to its gain; bin j of a slot lands at (j + off) mod N
//     (jnp.roll); its collapse bits are the blocks (j b_leaf / n) that
//     hold energy, or its fill, shifted by cm_shift;
//   - the seed advances by the band's draws; the upward transform is the
//     band's post matrix; the collapse mask is the band's cm OR-map of
//     the slots' bits masked to its blocks; sqrt(N) X goes to the norm
//     buffer unless the band is the last.
//
// What bounds it: the walk is sequential in the bands and the placement in
// the slots (a slot adds into bins that the next may touch), so one frame
// is a chain of 21 bands of two [N, N] matvecs and up to 16 placements,
// each step a block barrier or a dependent sum: latency, not bytes (a
// frame reads its packed tables, 0.2 MB, and its configuration's
// matrices, at most 2 x 124 KB a band, and writes 3.3 KB). The design
// spends the parallelism a frame has inside the block and runs the frames
// side by side:
//   - a block a frame (the frames of a batch are independent given their
//     tables and entry seeds), THREADS >= W threads: thread t owns bin t
//     of the band for the window, the draws and the placement;
//   - warp 0 computes the band's fills, draws and their prefix (a lane a
//     slot, a warp scan) and stages the slots' fields in shared memory;
//   - every slot's values are computed together (a thread holds its bin
//     of each in registers), with each q0 slot's energy summed in a fixed
//     order (the warps by shuffles, then the warps' sums in order) behind
//     one barrier for all of them; then the placements run in slot order;
//   - the matvecs take a thread a row with four partial sums in flight,
//     each product and sum rounded on its own; the banks store each
//     matrix transposed, so that a warp's loads are coalesced;
//   - the norm buffer, the fold window, the band's X and the LCG jump
//     tables (2 x 4097 u32) sit in shared memory, the matrices in the
//     device banks.
// The reference's sums (its matvecs, a q0 slot's energy) run in XLA's
// order and the plain twin's in PyTorch's: results agree within rel 2e-5
// of the spectrum's peak; seeds and collapse masks are exact.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NBANDS = 21, SLOTS = 16, W = 176, NBINS = 800, NCFG = 14;
constexpr int LCG_MAX = 4096;
constexpr int THREADS = 192;        // >= W, whole warps
constexpr int NWARPS = THREADS / 32;
static_assert(THREADS >= W && THREADS % 32 == 0, "a thread a bin");

// band_replay.EBANDS; a band's bins at LM = 3 are 8 x its width (a CPU
// test holds this table to EBANDS)
__constant__ int EBANDS[NBANDS + 1] = {0,  1,  2,  3,  4,  5,  6,  7,
                                       8,  10, 12, 14, 16, 20, 24, 28,
                                       34, 40, 48, 60, 78, 100};

// the packed tables' integer fields, each its own tensor (so that the
// wrapper launches nothing but K13): bt fields [F, 21], lt fields
// [F, 21, 16]
enum { PRESENT, HAS_LB, EFF, FS, FE, LAST, B_IN, CFG_ID, NBT };
enum { LN, LK, LOFF, LBL, LCMS, NLT };
struct Fields {
  const int* bt[NBT];
  const int* lt[NLT];
};

// u32 x << s as XLA's shift_left: 0 for a shift outside [0, 32)
__device__ __forceinline__ unsigned shl32(unsigned x, int s) {
  return (s >= 0 && s < 32) ? x << s : 0u;
}

// the OR of cols[i] over the bits i set in v (cols: 16 u32, 64-byte
// aligned, read with four unconditional vector loads so that they are in
// flight together)
__device__ __forceinline__ unsigned apply_cols16(const unsigned* cols,
                                                 unsigned v) {
  unsigned c[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(cols) + q);
    c[4 * q] = u.x;
    c[4 * q + 1] = u.y;
    c[4 * q + 2] = u.z;
    c[4 * q + 3] = u.w;
  }
  unsigned out = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if ((v >> i) & 1u) out |= c[i];
  return out;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// y[t] = sum_j m[t][j] x[j] for t < N (mT = m stored transposed, x in
// shared memory): a thread a row, so that a warp reads a column of the
// store together (coalesced); four partial sums over j = 4u + r keep
// four adds in flight; each product and sum rounded on its own
__device__ __forceinline__ void matvec(const float* __restrict__ mT,
                                       const float* x, float* y, int N) {
  const int t = threadIdx.x;
  if (t >= N) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int j = 0; j < N; j += 4) {  // N is a multiple of 8
#pragma unroll
    for (int r = 0; r < 4; ++r)
      acc[r] = __fadd_rn(acc[r],
                         __fmul_rn(__ldg(mT + (size_t)(j + r) * N + t),
                                   x[j + r]));
  }
  y[t] = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
}

__global__ void __launch_bounds__(THREADS)
k13_bands(const Fields p, const float* __restrict__ gain,
          const unsigned* __restrict__ fill,
          const float* __restrict__ vec, const unsigned* __restrict__ seed0,
          const float* __restrict__ post, const float* __restrict__ pre,
          const unsigned* __restrict__ cmb, const unsigned* __restrict__ bmb,
          const float* __restrict__ sq, const unsigned* __restrict__ lcg,
          float* __restrict__ spec_out, unsigned* __restrict__ seed_out,
          unsigned* __restrict__ coll_out) {
  __shared__ unsigned ja[LCG_MAX + 1], jb[LCG_MAX + 1];
  __shared__ float norm[NBINS];
  __shared__ float lbraw[W];
  __shared__ float lbcat[2 * W];   // the transformed window, then W zeros
  __shared__ float X[W];
  __shared__ float Xp[W];          // X through the band's post matrix
  __shared__ float red[SLOTS][NWARPS];
  __shared__ unsigned collapse[NBANDS];
  __shared__ unsigned f2_s[SLOTS], cmask_s[SLOTS], cm_pvq[SLOTS];
  __shared__ int prefix_s[SLOTS], draws_s[SLOTS];
  __shared__ int n_s[SLOTS], k_s[SLOTS], off_s[SLOTS], bl_s[SLOTS];
  __shared__ int cms_s[SLOTS];
  __shared__ float gain_s[SLOTS];
  __shared__ unsigned seed_s;

  const int f = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int j = t; j <= LCG_MAX; j += THREADS) {
    ja[j] = lcg[j];
    jb[j] = lcg[LCG_MAX + 1 + j];
  }
  for (int j = t; j < NBINS; j += THREADS) norm[j] = 0.f;
  if (t < NBANDS) collapse[t] = 0u;
  if (t == 0) seed_s = seed0[f];
  float* spec = spec_out + (size_t)f * NBINS;
  __syncthreads();

  size_t boff = 0;  // band i's [NCFG, N, N] block in post / pre
  for (int i = 0; i < NBANDS; ++i) {
    const int N = 8 * (EBANDS[i + 1] - EBANDS[i]), a = 8 * EBANDS[i];
    const size_t band = (size_t)f * NBANDS + i, slot0 = band * SLOTS;
    const bool present = p.bt[PRESENT][band] > 0;
    const bool has_lb = p.bt[HAS_LB][band] > 0;
    const int cfg = p.bt[CFG_ID][band];

    if (warp == 0) {  // the band's fills, draws and their prefix
      const int fs = p.bt[FS][band], fe = p.bt[FE][band];
      unsigned cm = (lane < NBANDS && lane >= fs && lane < fe)
                        ? collapse[lane] : 0u;
      cm = __reduce_or_sync(0xffffffffu, cm);
      const unsigned entry =
          has_lb ? cm : shl32(1u, p.bt[B_IN][band]) - 1u;
      unsigned draws = 0, f2 = 0, cmask = 0;
      if (lane < SLOTS) {  // the slots' fields, staged for the band
        const int n = p.lt[LN][slot0 + lane];
        const int k = p.lt[LK][slot0 + lane];
        const int bl = p.lt[LBL][slot0 + lane];
        n_s[lane] = n;
        k_s[lane] = k;
        bl_s[lane] = bl;
        off_s[lane] = p.lt[LOFF][slot0 + lane];
        cms_s[lane] = p.lt[LCMS][slot0 + lane];
        gain_s[lane] = gain[slot0 + lane];
        cmask = shl32(1u, bl) - 1u;
        f2 = apply_cols16(fill + (slot0 + lane) * 16, entry) & cmask;
        draws = (k == 0 && f2 != 0u) ? (unsigned)n : 0u;
      }
      unsigned incl = draws;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (lane < SLOTS) {
        f2_s[lane] = f2;
        cmask_s[lane] = cmask;
        prefix_s[lane] = (int)(incl - draws);
        draws_s[lane] = (int)draws;
        cm_pvq[lane] = 0u;
      }
    }
    if (t < N) {  // the fold window of pad(norm, W)
      const int q = clampi(p.bt[EFF][band], 0, NBINS) + t;
      lbraw[t] = q < NBINS ? norm[q] : 0.f;
    }
    __syncthreads();
    // through the lowband pre-transform
    matvec(pre + boff + (size_t)cfg * N * N, lbraw, lbcat, N);
    if (t < N) X[t] = 0.f;
    for (int u = N + t; u < 2 * W; u += THREADS) lbcat[u] = 0.f;
    __syncthreads();

    // every slot's values: a PVQ slot's leaf vector (and its collapse
    // bits), a q0 slot's noise or fold before its gain, with the warps'
    // parts of its energy
    const unsigned seed = seed_s;
    float v[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)  // all 16 loads in flight together
      v[s] = t < W ? __ldg(vec + (slot0 + s) * W + t) : 0.f;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int k = k_s[s];
      const int n = n_s[s];
      const bool mask = t < W && t < n;
      if (k <= 0 || !mask) v[s] = 0.f;
      if (k <= -2) continue;  // an empty slot adds nothing (uniform)
      if (k > 0) {
        unsigned bit = 0u;
        if (mask && v[s] != 0.f) {  // block (t b_leaf) // n (mask: t < n)
          const int num = t * bl_s[s];
          int blk = num / n;
          if (num % n != 0 && num < 0) --blk;
          if (blk >= 0 && blk < 8) bit = 1u << blk;
        }
        bit = __reduce_or_sync(0xffffffffu, bit);
        if (lane == 0 && bit) atomicOr(&cm_pvq[s], bit);
      } else {
        if (mask && f2_s[s] != 0u) {
          const int step = clampi(prefix_s[s] + t + 1, 0, LCG_MAX);
          const unsigned r = seed * ja[step] + jb[step];
          if (has_lb) {
            const float src = lbcat[clampi(off_s[s], 0, W) + t];
            v[s] = __fadd_rn(src, (r & 0x8000u) ? 1.f / 256 : -1.f / 256);
          } else {
            v[s] = (float)((int)r >> 20);
          }
        }
        float e = __fmul_rn(v[s], v[s]);
#pragma unroll
        for (int o = 16; o; o >>= 1)
          e = __fadd_rn(e, __shfl_xor_sync(0xffffffffu, e, o));
        if (lane == 0) red[s][warp] = e;
      }
    }
    __syncthreads();
    // each q0 slot's energy (the warps' parts in order) and gain; then the
    // placement in slot order: bin t to (t + off) mod N
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int k = k_s[s];
      if (k <= -2) continue;
      if (k <= 0) {
        float e = red[s][0];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) e = __fadd_rn(e, red[s][w]);
        e = __fadd_rn(1e-15f, e);
        const float g = __fdiv_rn(gain_s[s], __fsqrt_rn(e));
        v[s] = t < W && t < n_s[s] ? __fmul_rn(v[s], g) : 0.f;
      }
      if (t < N) {
        int tg = (t + off_s[s]) % N;
        if (tg < 0) tg += N;
        X[tg] = __fadd_rn(X[tg], v[s]);
      }
      __syncthreads();
    }

    if (t == 0) {  // the seed, the slots' collapse bits, the band's mask
      unsigned acc = 0u;
      for (int s = 0; s < SLOTS; ++s) {
        const int k = k_s[s];
        if (k <= -2) continue;
        const unsigned f2 = f2_s[s];
        const unsigned cm = k > 0 ? (bl_s[s] > 1 ? cm_pvq[s] : 1u)
                                  : (f2 == 0u ? 0u : (has_lb ? f2 : cmask_s[s]));
        acc |= shl32(cm, cms_s[s]);
      }
      const int tot = clampi(prefix_s[SLOTS - 1] + draws_s[SLOTS - 1], 0,
                             LCG_MAX);
      seed_s = seed * ja[tot] + jb[tot];
      const size_t c = (size_t)i * NCFG + cfg;
      if (present) collapse[i] = apply_cols16(cmb + c * 16, acc) & bmb[c];
    }
    // the upward transform, then the spectrum and the norm buffer
    matvec(post + boff + (size_t)cfg * N * N, X, Xp, N);
    __syncthreads();
    if (t < N) {
      const float acc = Xp[t];
      spec[a + t] = present ? acc : 0.f;
      if (present && p.bt[LAST][band] == 0)
        norm[a + t] = __fmul_rn(sq[i], acc);
    }
    __syncthreads();
    boff += (size_t)NCFG * N * N;
  }
  if (t < NBANDS) coll_out[(size_t)f * NBANDS + t] = collapse[t];
  if (t == 0) seed_out[f] = seed_s;
}

}  // namespace

// fields: a host array of 13 device pointers, the int32 bt fields [F, 21]
// (present, has_lb, eff, fs, fe, last, B_in, cfg_id) then the int32 lt
// fields [F, 21, 16] (n, k, off, b_leaf, cm_shift); gain f32 [F, 21, 16];
// fill u32 [F, 21, 16, 16]; vec f32 [F, 21, 16, 176]; seed0 u32 [F]; post, pre f32 (the 21 bands' [14, N, N]
// banks in order); cm u32 [21, 14, 16]; bm u32 [21, 14]; sq f32 [21]; lcg
// u32 [2, 4097]; out: spec f32 [F, 800], seed u32 [F], collapse u32 [F, 21]
extern "C" int iamf_k13_bands(const void* const* fields,
                              const void* gain, const void* fill,
                              const void* vec, const void* seed0,
                              const void* post, const void* pre,
                              const void* cm, const void* bm, const void* sq,
                              const void* lcg, int F, void* spec,
                              void* seed_out, void* coll, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || fields == nullptr) return (int)cudaErrorInvalidValue;
  Fields p;
  for (int j = 0; j < NBT; ++j) p.bt[j] = (const int*)fields[j];
  for (int j = 0; j < NLT; ++j) p.lt[j] = (const int*)fields[NBT + j];
  k13_bands<<<F, THREADS, 0, s>>>(
      p, (const float*)gain,
      (const unsigned*)fill, (const float*)vec, (const unsigned*)seed0,
      (const float*)post, (const float*)pre, (const unsigned*)cm,
      (const unsigned*)bm, (const float*)sq, (const unsigned*)lcg,
      (float*)spec, (unsigned*)seed_out, (unsigned*)coll);
  return (int)cudaGetLastError();
}
