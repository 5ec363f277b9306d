// K2: CELT comb post-filter + de-emphasis + s16 rounding, one lane per block.
//
// Replaces the jitted XLA stages of iamf_tpu/codecs/opus/tpu_synth.py:
// _comb_filter (a fori_loop over 13-sample chunks) with _comb_coeffs,
// _deemphasis (a blocked lower-triangular matmul, chosen for XLA compile
// time) and the clip/rint of _synthesize. Reference behaviour: celt/celt.c
// comb_filter and celt_decoder.c deemphasis, as described in tpu_synth.py.
//
// What bounds it: both filters are recurrences along time. The comb reads
// its own output at lag >= 15 (MINPERIOD), the de-emphasis
// m = 0.85 * (z + 1e-30 + m) is a one-sample dependency chain, so the
// kernel is latency-bound, not bandwidth-bound (12 lanes x 122,880 samples
// per 128-frame batch is 5.9 MB in, 5.9 MB out).
//
// Design: one block of two warps per lane. The lane's comb history lives
// in a 2048-float shared-memory ring (>= HIST 1032 + lag look-back, and
// more than two frames, so the two warps never touch the same slots). Warp
// 0 stages a frame's 960 inputs and 13 packed parameters in shared memory
// with coalesced loads and runs its comb: every lag of a frame is >= its
// smallest period (>= 15), so chunks of (smallest period - 2) samples, up
// to 32, depend only on finished outputs and are computed by one lane
// each. Meanwhile lane 0 of warp 1 runs the sequential de-emphasis over
// the previous frame and writes its s16 PCM; one block barrier per frame
// hands frames from one warp to the other. The per-sample comb
// coefficients (old -> current -> new crossfade over [0,120) and
// [120,240)) are derived in-kernel from the packed per-frame parameters,
// as _comb_coeffs does, instead of shipping per-sample tensors.
//
// Rounding: every product and sum is written with __fmul_rn/__fadd_rn in
// the reference's term order (tpu_synth.py:231-237), and the library is
// built with --fmad=false, so no a*b+c is contracted into an FMA. The comb
// is then bit-exact with the plain twin; the sequential de-emphasis differs
// from the reference's blocked matmul by at most 1 s16 LSB.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int FRAME = 960;
constexpr int HIST = 1032;
constexpr int RING = 2048;
// packed per-frame parameter columns (tpu_synth.py PK_*)
constexpr int PK_T_OLD = 1, PK_T_CUR = 2, PK_T_NEW = 3;
constexpr int PK_G_OLD = 4, PK_G_CUR = 7, PK_G_NEW = 10;

__device__ __forceinline__ float tap(const float* ring, int j, int lag, int d) {
  return ring[(j + HIST - lag + d) & (RING - 1)];
}

__global__ void __launch_bounds__(64)
comb_deemph_kernel(const float* __restrict__ y, const float* __restrict__ pk,
                   int ld_pk, const float* __restrict__ hist,
                   const float* __restrict__ demem,
                   const float* __restrict__ window, int B, int L,
                   float* __restrict__ pcm, float* __restrict__ hist_out,
                   float* __restrict__ demem_out) {
  const int l = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  __shared__ float ring[RING];
  __shared__ float fw[120];
  __shared__ float yf[FRAME];   // the comb warp's current frame of input
  __shared__ float q[16];       // ... and its 13 packed parameters
  // sample j (j >= -HIST) lives at ring[(j + HIST) & (RING - 1)]
  for (int i = t; i < RING; i += blockDim.x)
    ring[i] = i < HIST ? hist[(size_t)l * HIST + i] : 0.f;
  for (int i = t; i < 120; i += blockDim.x) fw[i] = __fmul_rn(window[i], window[i]);
  __syncthreads();

  float m = demem[l];
  // warp 0 runs the comb over frame f while warp 1 de-emphasizes frame f-1
  // (frame f's ring writes land on samples >= 2048 back, frame f-2 or older)
  for (int f = 0; f <= B; ++f) {
    if (warp == 0 && f < B) {
      const size_t row = (size_t)f * L + l;
      for (int i = lane; i < FRAME; i += 32) yf[i] = y[row * FRAME + i];
      if (lane < 13) q[lane] = pk[row * ld_pk + lane];
      __syncwarp();
      const int to = (int)q[PK_T_OLD], tc = (int)q[PK_T_CUR], tn = (int)q[PK_T_NEW];
      float go[3], gc[3], gn[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        go[d] = q[PK_G_OLD + d];
        gc[d] = q[PK_G_CUR + d];
        gn[d] = q[PK_G_NEW + d];
      }
      const bool eq_oc = to == tc && go[0] == gc[0] && go[1] == gc[1] && go[2] == gc[2];
      const bool eq_cn = tc == tn && gc[0] == gn[0] && gc[1] == gn[1] && gc[2] == gn[2];
      // every lag of this frame is one of to/tc/tn (>= 15): the outputs of
      // (smallest lag - 2) consecutive samples read only finished outputs
      const int chunk = max(1, min(32, min(to, min(tc, tn)) - 2));
      for (int p0 = 0; p0 < FRAME; p0 += chunk) {
        const int p = p0 + lane;
        if (lane < chunk && p < FRAME) {
          const int j = f * FRAME + p;
          const bool in_a = p < 120;
          const bool in_tr = p >= 120 && p < 240;
          const bool cross_a = in_a && !eq_oc;
          const bool cross_b = in_tr && !eq_cn;
          const float fa = in_a ? fw[p] : 0.f;
          const float fb = in_tr ? fw[p - 120] : 0.f;
          float c1[3], c2[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            c1[d] = in_a ? (cross_a ? __fmul_rn(__fsub_rn(1.f, fa), go[d]) : gc[d])
                         : (cross_b ? __fmul_rn(__fsub_rn(1.f, fb), gc[d]) : gn[d]);
            c2[d] = cross_a ? __fmul_rn(fa, gc[d])
                            : (cross_b ? __fmul_rn(fb, gn[d]) : 0.f);
          }
          const int lag1 = in_a ? (cross_a ? to : tc) : (cross_b ? tc : tn);
          const int lag2 = cross_a ? tc : (cross_b ? tn : lag1);
          float out = __fadd_rn(yf[p], __fmul_rn(c1[0], tap(ring, j, lag1, 0)));
          out = __fadd_rn(out, __fmul_rn(c1[1], __fadd_rn(tap(ring, j, lag1, 1), tap(ring, j, lag1, -1))));
          out = __fadd_rn(out, __fmul_rn(c1[2], __fadd_rn(tap(ring, j, lag1, 2), tap(ring, j, lag1, -2))));
          out = __fadd_rn(out, __fmul_rn(c2[0], tap(ring, j, lag2, 0)));
          out = __fadd_rn(out, __fmul_rn(c2[1], __fadd_rn(tap(ring, j, lag2, 1), tap(ring, j, lag2, -1))));
          out = __fadd_rn(out, __fmul_rn(c2[2], __fadd_rn(tap(ring, j, lag2, 2), tap(ring, j, lag2, -2))));
          ring[(j + HIST) & (RING - 1)] = out;
        }
        __syncwarp();
      }
    } else if (warp == 1 && lane == 0 && f > 0) {
      const int fp = f - 1;
      float* dst = pcm + ((size_t)fp * L + l) * FRAME;
      const int j0 = fp * FRAME + HIST;
#pragma unroll 8
      for (int i = 0; i < FRAME; ++i) {
        const float z = ring[(j0 + i) & (RING - 1)];
        const float o = __fadd_rn(__fadd_rn(z, 1e-30f), m);
        m = __fmul_rn(0.85f, o);
        dst[i] = __fmul_rn(rintf(fminf(fmaxf(o, -32768.f), 32767.f)), 1.f / 32768.f);
      }
    }
    __syncthreads();
  }
  // hist' = the last HIST comb outputs (pre-de-emphasis), oldest first
  const int total = B * FRAME;
  for (int i = t; i < HIST; i += blockDim.x)
    hist_out[(size_t)l * HIST + i] = ring[(total + i) & (RING - 1)];
  if (t == 32) demem_out[l] = m;
}

}  // namespace

// y: [B, L, 960] IMDCT output; pk: per-(frame, lane) packed parameters
// (row stride ld_pk; column 0 of the 13 = transient); hist: [L, 1032];
// demem: [L]; window: [120] CELT window; pcm: [B, L, 960] (s16 / 32768);
// hist_out: [L, 1032]; demem_out: [L].
extern "C" int iamf_k2_comb_deemph(const void* y, const void* pk, int ld_pk,
                                   const void* hist, const void* demem,
                                   const void* window, int B, int L,
                                   void* pcm, void* hist_out,
                                   void* demem_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  comb_deemph_kernel<<<L, 64, 0, s>>>(
      (const float*)y, (const float*)pk, ld_pk, (const float*)hist,
      (const float*)demem, (const float*)window, B, L, (float*)pcm,
      (float*)hist_out, (float*)demem_out);
  return (int)cudaGetLastError();
}
