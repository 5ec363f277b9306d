// K2: CELT comb post-filter + de-emphasis (+ a hybrid frame's SILK pcm) +
// s16 rounding, in two launches, for frames of n = 120, 240, 480 or 960.
//
// Replaces the jitted XLA stages of iamf_tpu/codecs/opus/tpu_synth.py:
// _comb_filter (a fori_loop over 13-sample chunks) with _comb_coeffs,
// _deemphasis (a blocked lower-triangular matmul) and the clip/rint of
// _synthesize. Reference behaviour: celt/celt.c comb_filter and
// celt_decoder.c deemphasis, as described in tpu_synth.py.
//
// What bounds it: the comb reads its own output at lag >= 15 (MINPERIOD),
// a recurrence along each lane's whole signal, so phase A is a chain of
// dependent steps per lane (12 lanes: 12 blocks), latency-bound: a step's
// outputs go to shared memory and the next step loads them, a round trip
// of ~180 cycles on an H100 even for a bare step (PERF.md; warp shuffles
// are no faster). The de-emphasis m = 0.85 * (z + 1e-30 + m) looks like a
// chain too, but 0.85^960 underflows float32 to 0: a 960-sample block of a
// lane's timeline depends on the blocks before it only through its entry
// memory, which is the zero-entry memory at the end of the block before
// (tpu_synth.py:284-287). So phase B is parallel over (960-sample block,
// lane) and bandwidth-bound (z in, PCM out: ~6 MB each for 122,880
// samples of 12 lanes). The blocks are those of the reference
// (tpu_synth._deemphasis): 960 samples of each lane's flattened timeline of
// the call, whatever the frame size (a frame of 480 cannot stand alone:
// 0.85^480 is 1.3e-34 in float32, not 0), the last block partial when the
// call is not a multiple of 960 samples.
//
// Phase A (comb_kernel): one block of NT threads per lane, frame by frame.
// The lane's comb output lives in a 2048-float shared-memory ring (>= HIST
// 1032 + a frame + look-back). A frame of n is three segments with one lag
// set each: [0,120) reads t_old and t_cur (t_cur alone when the old and
// current sets are equal), [120,m) t_cur and t_new (t_new alone), [m,n)
// t_new, with m = min(240, n): at n = 120 only the first segment runs, as
// the reference's first comb pass alone. A segment's chunk is the smallest lag it reads with a nonzero gain
// triple, less 2: the samples of a chunk read only finished outputs (a
// zero coefficient may read an unfinished slot, whose product is 0), so a
// chunk is one step. A segment whose gains are all zero is one step. A
// chunk <= 32 runs one sample a lane of warp 0, a chunk <= 32 G G
// consecutive samples a lane, both under __syncwarp() (a quarter of real
// content has lags under 100); a larger chunk runs G consecutive samples
// a thread of the block, a __syncthreads() a step (NT = 512 and G = 2 beat
// 256 and 3, 128 and 6 on the H100, PERF.md). The segments of
// TF frames (lags, gains, chunk, steps) are set up together, one a thread,
// from the packed parameters; the per-sample crossfade coefficients are
// derived in the step, as _comb_coeffs does. Warps 1.. copy frame f - 1's
// outputs from the ring to z and stage frame f + 1's n inputs with
// cp.async while warp 0 starts frame f. Writes z to the scratch, hist' and
// the lane's step count.
//
// Phase B (deemph_kernel): one warp per (block, lane), a block being 960
// samples of the lane's timeline (the last one cnt <= 960). Lane k runs
// samples [30k, 30k+30) serially from a zero memory; a Kogge-Stone shuffle
// scan over the 32 lanes combines the carries (multiplier 0.85^(30·2^s) at
// step s), and each sample's memory is fixed up with 0.85^t times its
// lane's entry memory. The block's entry memory is demem for block 0, else
// the zero-entry memory at the end of block i-1, which the same warp
// computes from block i-1's z (its own scan from 0): no warp waits on
// another. Samples past cnt are zeros and are not stored; demem' is the
// memory after the true last sample. z arrives through a padded shared
// tile; the sums leave through it, and the coalesced store adds a hybrid
// frame's SILK pcm (read from the packed rows) before the clip and the
// rounding, as the reference adds it after the de-emphasis.
//
// Rounding: every product and sum is written with __fmul_rn/__fadd_rn,
// the comb's in the reference's term order (tpu_synth.py:231-237), and the
// library is built with --fmad=false. The comb is bit-exact with the plain
// twin; the de-emphasis differs from the twin's blocked matmul by at most 1
// s16 LSB. tests/k2_model.py models both phases in numpy in this order.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int FRAME = 960;  // the largest frame, and phase B's block
constexpr int HIST = 1032;
constexpr int RING = 2048;
constexpr int NQ = 13;    // packed parameters a frame
constexpr int NT = 512;   // phase A: threads a block (one block a lane)
constexpr int G = 2;      // phase A: consecutive samples a thread takes
constexpr int TF = 64;    // phase A: frames whose segments are set up together
constexpr int SEG = 30;   // phase B: samples a lane of the warp walks
constexpr int DW = 4;     // phase B: warps a block
constexpr int NONE = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
// packed per-frame parameter columns (tpu_synth.py PK_*)
constexpr int PK_T_OLD = 1, PK_G_OLD = 4, PK_G_CUR = 7, PK_G_NEW = 10;
static_assert(SEG * 32 == FRAME, "a warp's lanes cover a frame");
static_assert(NT * G >= FRAME - 240, "a step of the block covers a segment");

// fl(0.85^t), t < 30, and fl(0.85^(30·2^s)), s < 5, rounded from float64
__constant__ float PW[SEG] = {
    0x1p+0f,         0x1.b33334p-1f,  0x1.71eb86p-1f,  0x1.3a6e98p-1f,
    0x1.0b4468p-1f,  0x1.c65ab0p-2f,  0x1.82337cp-2f,  0x1.48455cp-2f,
    0x1.1707c2p-2f,  0x1.da59fcp-3f,  0x1.9332e4p-3f,  0x1.56b80ep-3f,
    0x1.234fa6p-3f,  0x1.ef3a9ap-4f,  0x1.a4f1d0p-4f,  0x1.65cd8ap-4f,
    0x1.3021e8p-4f,  0x1.028338p-4f,  0x1.b778acp-5f,  0x1.758cfap-5f,
    0x1.3d84a0p-5f,  0x1.0de3f0p-5f,  0x1.cad04ap-6f,  0x1.85fdd8p-6f,
    0x1.4b7e2ap-6f,  0x1.19c4d8p-6f,  0x1.df01d6p-7f,  0x1.9727f6p-7f,
    0x1.5a152ap-7f,  0x1.262b96p-7f};
__constant__ float PS[5] = {0x1.f416e6p-8f, 0x1.e874bcp-15f, 0x1.d1fea2p-29f,
                            0x1.a81f82p-57f, 0x1.5f5430p-113f};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// frame `row`'s n inputs into shared memory in 16-byte pieces,
// asynchronously, by the threads from t0 on; one commit group per thread
__device__ __forceinline__ void stage_frame(float* yb, const float* y,
                                            size_t row, int n, int t,
                                            int t0) {
  for (int i = t - t0; i >= 0 && i < n / 4; i += NT - t0)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(yb + 4 * i)),
                 "l"(y + row * n + 4 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One segment of a frame: its span, lags, gain triples and chunk, the steps
// it takes and the warps a step needs (G samples a lane). Outside a
// crossfade lag2 = lag1 and g2 = 0.
struct Seg {
  int s0, s1, lag1, lag2, chunk, steps, warps, cross;
  float g1[3], g2[3];
};

__device__ __forceinline__ bool nonzero(const float* g) {
  return g[0] != 0.f || g[1] != 0.f || g[2] != 0.f;
}

__device__ __forceinline__ bool same(int ta, const float* ga, int tb,
                                     const float* gb) {
  return ta == tb && ga[0] == gb[0] && ga[1] == gb[1] && ga[2] == gb[2];
}

// segment k (0: [0,120), 1: [120,m), 2: [m,n), m = min(240, n)) of the
// frame of n whose 13 packed parameters are q (codecs/opus/synth.comb_chunks
// is the same schedule); an empty segment takes no step
__device__ Seg segment(const float* __restrict__ q, int k, int n) {
  float p[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) p[i] = __ldg(q + i);
  const int to = (int)p[PK_T_OLD], tc = (int)p[PK_T_OLD + 1],
            tn = (int)p[PK_T_OLD + 2];
  const float *go = p + PK_G_OLD, *gc = p + PK_G_CUR, *gn = p + PK_G_NEW;
  Seg s;
  const int m = min(240, n);
  s.s0 = k == 0 ? 0 : k == 1 ? 120 : m;
  s.s1 = k == 0 ? 120 : k == 1 ? m : n;
  const float *g1, *g2 = gn;
  if (k == 0 && !same(to, go, tc, gc)) {
    s.cross = 1, s.lag1 = to, s.lag2 = tc, g1 = go, g2 = gc;
  } else if (k == 1 && !same(tc, gc, tn, gn)) {
    s.cross = 1, s.lag1 = tc, s.lag2 = tn, g1 = gc;
  } else {
    s.cross = 0, s.lag1 = s.lag2 = k == 0 ? tc : tn, g1 = k == 0 ? gc : gn;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    s.g1[d] = g1[d];
    s.g2[d] = s.cross ? g2[d] : 0.f;
  }
  int least = nonzero(g1) ? s.lag1 : NONE;
  if (s.cross && nonzero(g2)) least = min(least, s.lag2);
  const int len = s.s1 - s.s0;
  s.chunk = least == NONE ? max(len, 1) : max(least - 2, 1);
  s.steps = (len + s.chunk - 1) / s.chunk;
  s.warps = (min(s.chunk, len) + 32 * G - 1) / (32 * G);
  return s;
}

// Sample j (>= -HIST) lives at ring[(j + HIST) & (RING - 1)]; the first
// MIRROR slots are repeated after the last, so the G + 4 taps a thread
// reads around a lag are one base address and immediate offsets.
constexpr int MIRROR = G + 3;

__device__ __forceinline__ void put(float* ring, int j, float v) {
  const int s = (j + HIST) & (RING - 1);
  ring[s] = v;
  if (s < MIRROR) ring[RING + s] = v;
}

// One step of a segment of the frame starting at sample jf of the lane's
// timeline: the samples [p0, p0 + n), each reading
// only finished outputs, GS consecutive ones a thread. A thread loads the
// GS + 4 taps its samples share around each lag and computes its samples,
// then stores them, so their loads go out together (a thread past the
// step's end computes its last sample again and stores nothing). Outside a
// crossfade c2 = 0 and lag2 = lag1: its three terms (each +-0) multiply the
// lag-1 taps, as the reference's do.
template <bool CROSS, int GS>
__device__ __forceinline__ void comb_step(float* ring, const float* fw,
                                          const Seg& s, const float* yf,
                                          int jf, int p0, int n, int t) {
  const int i0 = GS * t;
  if (i0 >= n) return;
  const int p = p0 + i0, j = jf + p;
  float a[GS + 4], b[GS + 4];
  const float* r1 = ring + ((j + HIST - s.lag1 - 2) & (RING - 1));
#pragma unroll
  for (int k = 0; k < GS + 4; ++k) a[k] = r1[k];
  if (CROSS) {
    const float* r2 = ring + ((j + HIST - s.lag2 - 2) & (RING - 1));
#pragma unroll
    for (int k = 0; k < GS + 4; ++k) b[k] = r2[k];
  } else {
#pragma unroll
    for (int k = 0; k < GS + 4; ++k) b[k] = a[k];
  }
  float out[GS];
#pragma unroll
  for (int g = 0; g < GS; ++g) {
    const int pg = min(p + g, s.s1 - 1);
    float c1[3], c2[3];
    if (CROSS) {
      const float fa = fw[pg - s.s0];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        c1[d] = __fmul_rn(__fsub_rn(1.f, fa), s.g1[d]);
        c2[d] = __fmul_rn(fa, s.g2[d]);
      }
    } else {
#pragma unroll
      for (int d = 0; d < 3; ++d) c1[d] = s.g1[d], c2[d] = 0.f;
    }
    const float* u = a + g;
    const float* v = b + g;
    float o = __fadd_rn(yf[pg], __fmul_rn(c1[0], u[2]));
    o = __fadd_rn(o, __fmul_rn(c1[1], __fadd_rn(u[3], u[1])));
    o = __fadd_rn(o, __fmul_rn(c1[2], __fadd_rn(u[4], u[0])));
    o = __fadd_rn(o, __fmul_rn(c2[0], v[2]));
    o = __fadd_rn(o, __fmul_rn(c2[1], __fadd_rn(v[3], v[1])));
    o = __fadd_rn(o, __fmul_rn(c2[2], __fadd_rn(v[4], v[0])));
    out[g] = o;
  }
#pragma unroll
  for (int g = 0; g < GS; ++g)
    if (i0 + g < n) put(ring, j + g, out[g]);
}

// One segment of the frame starting at jf, a step a chunk. A chunk <= 32 is one sample a
// lane of warp 0, a chunk <= 32 G is G samples a lane of warp 0, both
// under __syncwarp(), then one barrier of the block; a larger chunk is G
// samples a thread of the block, a barrier a step. The steps store only
// to shared memory (z is copied out a frame later).
template <bool CROSS>
__device__ __forceinline__ void comb_segment(float* ring, const float* fw,
                                             const Seg& s, const float* yf,
                                             int jf, int t) {
  if (s.warps == 1) {
    if (t < 32) {
      if (s.chunk <= 32) {
        for (int p0 = s.s0; p0 < s.s1; p0 += s.chunk) {
          comb_step<CROSS, 1>(ring, fw, s, yf, jf, p0, min(s.chunk, s.s1 - p0), t);
          __syncwarp();
        }
      } else {
        for (int p0 = s.s0; p0 < s.s1; p0 += s.chunk) {
          comb_step<CROSS, G>(ring, fw, s, yf, jf, p0, min(s.chunk, s.s1 - p0), t);
          __syncwarp();
        }
      }
    }
    __syncthreads();
    return;
  }
  for (int p0 = s.s0; p0 < s.s1; p0 += s.chunk) {
    comb_step<CROSS, G>(ring, fw, s, yf, jf, p0, min(s.chunk, s.s1 - p0), t);
    __syncthreads();
  }
}

// the comb outputs of the frame of n starting at jf from the ring to z by
// the threads from t0 on (its slots stay untouched while the next frame is
// combed: a frame plus the look-back fits the ring)
__device__ __forceinline__ void copy_out(const float* ring, float* zl, int jf,
                                         int n, int t, int t0) {
  constexpr int NC = (FRAME + NT - 33) / (NT - 32);
  float v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int p = t - t0 + c * (NT - t0);
    if (t >= t0 && p < n) v[c] = ring[(jf + p + HIST) & (RING - 1)];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int p = t - t0 + c * (NT - t0);
    if (t >= t0 && p < n) zl[jf + p] = v[c];
  }
}

__global__ void __launch_bounds__(NT)
comb_kernel(const float* __restrict__ y, const float* __restrict__ pk,
            int ld_pk, const float* __restrict__ hist,
            const float* __restrict__ window, int B, int L, int n,
            float* __restrict__ z, float* __restrict__ hist_out,
            int* __restrict__ steps_out) {
  const int l = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ float ring[RING + MIRROR];
  __shared__ float fw[120];
  __shared__ __align__(16) float yb[2][FRAME];  // frame f, frame f + 1
  __shared__ Seg sd[TF][3];  // the segments of TF frames
  for (int i = t; i < RING + MIRROR; i += NT) {
    const int s = i & (RING - 1);
    ring[i] = s < HIST ? hist[(size_t)l * HIST + s] : 0.f;
  }
  for (int i = t; i < 120; i += NT) fw[i] = __fmul_rn(window[i], window[i]);
  stage_frame(yb[0], y, l, n, t, 0);
  stage_wait();

  // Warps 1.. copy frame f - 1's z out and stage frame f + 1's inputs while
  // warp 0 starts frame f (alone where its first segment runs in one warp);
  // frame f + 1's inputs are waited for before the frame's last segment,
  // whose closing barrier publishes them.
  float* zl = z + (size_t)l * B * n;
  int steps = 0;
  for (int f = 0; f < B; ++f) {
    const int cur = f & 1;
    if (f % TF == 0) {  // the next TF frames' segments, one a thread
      for (int i = t; i < 3 * min(TF, B - f); i += NT)
        sd[i / 3][i % 3] = segment(
            pk + ((size_t)(f + i / 3) * L + l) * ld_pk, i % 3, n);
      __syncthreads();
    }
    if (f + 1 < B)
      stage_frame(yb[cur ^ 1], y, (size_t)(f + 1) * L + l, n, t, 32);
    if (f > 0) copy_out(ring, zl, (f - 1) * n, n, t, 32);
    for (int k = 0; k < 3; ++k) {
      const Seg s = sd[f % TF][k];
      steps += s.steps;
      if (k == 2) stage_wait();
      if (s.cross)
        comb_segment<true>(ring, fw, s, yb[cur], f * n, t);
      else
        comb_segment<false>(ring, fw, s, yb[cur], f * n, t);
    }
  }
  copy_out(ring, zl, (B - 1) * n, n, t, 0);
  // hist' = the last HIST comb outputs, oldest first
  const int total = B * n;
  for (int i = t; i < HIST; i += NT)
    hist_out[(size_t)l * HIST + i] = ring[(total + i) & (RING - 1)];
  if (t == 0) steps_out[l] = steps;
}

// the warp's padded tile: sample i of the frame at slot i + i / SEG, so lane
// k's 30 samples start at 31 k (no bank conflict when the lanes walk them)
__device__ __forceinline__ int slot(int i) { return i + i / SEG; }

// one block of z (cnt samples, zeros after) into the warp's tile, then
// lane's 30 samples + 1e-30
__device__ __forceinline__ void load_lane(float* s, const float* src,
                                          int cnt, int lane, float* zb) {
  __syncwarp();
#pragma unroll
  for (int i = lane; i < FRAME; i += 32) s[slot(i)] = i < cnt ? src[i] : 0.f;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < SEG; ++t) zb[t] = __fadd_rn(s[lane * (SEG + 1) + t], 1e-30f);
}

// memory after each lane, from the lanes' zero-entry carries c and the
// frame's entry memory e (inclusive Kogge-Stone scan of x -> A x + c)
__device__ __forceinline__ float scan(float c, float e, int lane) {
  float x = lane == 0 ? __fadd_rn(__fmul_rn(PS[0], e), c) : c;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const float v = __shfl_up_sync(FULL, x, 1 << s);
    if (lane >= (1 << s)) x = __fadd_rn(__fmul_rn(PS[s], v), x);
  }
  return x;
}

__global__ void __launch_bounds__(DW * 32)
deemph_kernel(const float* __restrict__ z, const float* __restrict__ demem,
              const float* __restrict__ pk, int ld_pk, int B, int L, int n,
              int hybrid, float* __restrict__ pcm,
              float* __restrict__ demem_out) {
  __shared__ float tile[DW][32 * (SEG + 1)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int total = B * n;  // samples of a lane's timeline
  const int nblk = (total + FRAME - 1) / FRAME;
  const int w = blockIdx.x * DW + warp;  // block i of lane l: i * L + l
  if (w >= nblk * L) return;
  const int i = w / L, l = w - i * L;
  const int g0 = i * FRAME, cnt = min(FRAME, total - g0);
  float* s = tile[warp];
  const float* zl = z + (size_t)l * total;
  float zb[SEG], mloc[SEG];

  float e = demem[l];
  if (i > 0) {  // zero-entry memory at the end of block i - 1 (a full one)
    load_lane(s, zl + g0 - FRAME, FRAME, lane, zb);
    float m = 0.f;
#pragma unroll
    for (int t = 0; t < SEG; ++t) m = __fmul_rn(0.85f, __fadd_rn(zb[t], m));
    e = __shfl_sync(FULL, scan(m, 0.f, lane), 31);
  }
  load_lane(s, zl + g0, cnt, lane, zb);
  float m = 0.f;
#pragma unroll
  for (int t = 0; t < SEG; ++t) {
    m = __fmul_rn(0.85f, __fadd_rn(zb[t], m));
    mloc[t] = m;
  }
  const float X = scan(m, e, lane);
  float E = __shfl_up_sync(FULL, X, 1);  // this lane's entry memory
  if (lane == 0) E = e;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < SEG; ++t) {
    const float mp = __fadd_rn(t ? mloc[t - 1] : 0.f, __fmul_rn(PW[t], E));
    s[lane * (SEG + 1) + t] = __fadd_rn(zb[t], mp);
  }
  if (i == nblk - 1 && lane == (cnt - 1) / SEG) {
    // the memory after the true last sample
    const int t0 = (cnt - 1) % SEG;
    float last = X;
#pragma unroll
    for (int t = 0; t < SEG - 1; ++t)
      if (t == t0) last = __fadd_rn(mloc[t], __fmul_rn(PW[t + 1], E));
    demem_out[l] = last;
  }
  __syncwarp();
  for (int k = lane; k < cnt; k += 32) {
    const int g = g0 + k, f = g / n, p = g - f * n;
    const size_t row = (size_t)f * L + l;
    float o = s[slot(k)];
    // hybrid: opus_decoder.c "pcm[i] += pcm_silk[i]", at s16 value scale
    if (hybrid) o = __fadd_rn(o, pk[row * ld_pk + NQ + p]);
    pcm[row * n + p] =
        __fmul_rn(rintf(fminf(fmaxf(o, -32768.f), 32767.f)), 1.f / 32768.f);
  }
}

}  // namespace

// y: [B, L, n] IMDCT output (16-byte aligned), n in {120, 240, 480, 960};
// pk: per-(frame, lane) packed parameters (row stride ld_pk; column 0 of
// the 13 = transient; a hybrid row's n SILK samples follow at column 13);
// hist: [L, 1032]; demem: [L]; window: [120] CELT window; hybrid: add the
// SILK pcm; scratch: float [L·B·n + L], 16-byte aligned: z [L, B·n], then
// phase A's steps per lane (int32); pcm: [B, L, n] (s16 / 32768); hist_out:
// [L, 1032]; demem_out: [L].
extern "C" int iamf_k2_comb_deemph(const void* y, const void* pk, int ld_pk,
                                   const void* hist, const void* demem,
                                   const void* window, int B, int L, int n,
                                   int hybrid, void* scratch, void* pcm,
                                   void* hist_out, void* demem_out,
                                   void* stream) {
  if (n != 120 && n != 240 && n != 480 && n != 960)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* z = static_cast<float*>(scratch);
  int* steps = reinterpret_cast<int*>(z + (size_t)L * B * n);
  comb_kernel<<<L, NT, 0, s>>>((const float*)y, (const float*)pk, ld_pk,
                               (const float*)hist, (const float*)window, B, L,
                               n, z, (float*)hist_out, steps);
  const int nblk = (B * n + FRAME - 1) / FRAME;
  deemph_kernel<<<(nblk * L + DW - 1) / DW, DW * 32, 0, s>>>(
      z, (const float*)demem, (const float*)pk, ld_pk, B, L, n, hybrid,
      (float*)pcm, (float*)demem_out);
  return (int)cudaGetLastError();
}
