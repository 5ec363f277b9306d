// K3: look-ahead peak limiter + quantize/interleave for one decode batch.
//
// Replaces the limiter block of iamf_tpu/core/pipeline.py decode_frames
// (with _limiter_block, dsp/limiter.py _gain_step and fast_pass) and
// dsp/quantize.py quantize_interleave. Reference behaviour:
// audio_effect_peak_limiter.c process_block / compute_target_gain, as in
// dsp/limiter.py.
//
// The peak the gain step reads does not depend on the gain: at step k the
// ring holds S[k:k+D], with S = ring (oldest first, from entry_index) ++
// the batch's channel-max magnitudes. So the work splits in three phases:
//   1. parallel: S, then the sliding-window max W[k] = max S[k:k+D]
//      (shared-memory tiles; never a 240-wide max inside the serial loop);
//   2. one warp: the scalar attack/release recurrence of _gain_step, in
//      its exact float32 order (IEEE division, no FMA contraction) over the
//      batch's N samples; 32-sample blocks with a settled envelope and no
//      peak over the threshold are skipped by one warp vote;
//   3. parallel: y = delayed * gain, scale by 2^(bits-1), clip, rint
//      (half to even), interleave to [N, C] int; new delay line, peak ring
//      and entry index.
// No fast path is needed: with an idle envelope the recurrence gives a gain
// of exactly 1.0, so the output is bit-identical to the reference's fast
// branch.
//
// What bounds it: phase 2 is a serial dependency chain of N = B*T steps
// (122,880 at B = 128), a few float ops each and two divisions while
// attacking/releasing: latency-bound on one warp wherever the envelope is
// live. Phases 1 and 3 move ~12 MB per batch (a few microseconds of HBM
// time).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WT = 256;  // window-max outputs per block

// S[i] = peak_data[(idx + i) % D] for i < D, else max_c |x[c, i - D]|
__global__ void seq_peaks(const float* __restrict__ x, int C, int N,
                          const float* __restrict__ peak, const int* __restrict__ eidx,
                          int D, float* __restrict__ S) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D + N) return;
  if (i < D) {
    S[i] = peak[(*eidx + i) % D];
    return;
  }
  int n = i - D;
  float mx = 0.f;
  for (int c = 0; c < C; ++c) mx = fmaxf(mx, fabsf(x[(size_t)c * N + n]));
  S[i] = mx;
}

__global__ void window_max(const float* __restrict__ S, int N, int D,
                           float* __restrict__ W) {
  extern __shared__ float s[];  // WT + D
  const int k0 = blockIdx.x * WT;
  for (int i = threadIdx.x; i < WT + D; i += blockDim.x) {
    int g = k0 + i;
    s[i] = g < N + D ? S[g] : 0.f;
  }
  __syncthreads();
  const int k = k0 + threadIdx.x;
  if (k >= N) return;
  float mx = s[threadIdx.x];
  for (int d = 1; d < D; ++d) mx = fmaxf(mx, s[threadIdx.x + d]);
  W[k] = mx;
}

__device__ __forceinline__ float curve_accel(float v) {
  if (v > 1.f) return 1.f;
  if (v < 0.f) return 0.f;
  float d = __fsub_rn(v, 1.f);
  return __fsub_rn(1.f, __fmul_rn(d, d));
}

// state: [current_gain, target_start_gain, target_end_gain, current_tc]
// One warp walks the recurrence: every lane runs the same scalar steps
// (the state is warp-uniform). The window maxima arrive in tiles of
// 32 x TILE_R samples, lane i holding every 32nd one, so each tile costs one
// round of coalesced loads and the steps read their peak with a shuffle.
// While the envelope is settled (never triggered, tc == -1, or past its
// release, tc >= release + attack) a sample whose peak does not exceed the
// threshold leaves the state as it is with a gain of exactly 1, so a
// 32-sample block of such peaks is skipped by one warp vote (the
// reference's fast path, which takes only the tc == -1 case).
constexpr int TILE_R = 16;

__global__ void gain_walk(const float* __restrict__ W, int N,
                          const float* __restrict__ st_in, float atk,
                          float rel, float inc, float thr,
                          float* __restrict__ gain, float* __restrict__ st_out) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  float g = st_in[0], tsg = st_in[1], teg = st_in[2], tc = st_in[3];
  const float relatk = __fadd_rn(rel, atk);
  for (int t0 = 0; t0 < N; t0 += 32 * TILE_R) {
    float w[TILE_R];
#pragma unroll
    for (int r = 0; r < TILE_R; ++r) {
      const int k = t0 + r * 32 + lane;
      w[r] = k < N ? W[k] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < TILE_R; ++r) {
      const int k0 = t0 + r * 32;
      if (k0 >= N) break;
      const int n = min(32, N - k0);
      const bool quiet = __all_sync(FULL, lane >= n || w[r] <= thr);
      const bool settled = tc == -1.f || !(tc < relatk);
      float mine = 1.f;
      if (!(settled && quiet)) {
        for (int i = 0; i < n; ++i) {
          const float peak = __shfl_sync(FULL, w[r], i);
          const bool active = tc != -1.f;
          const bool in_attack = active && tc < atk;
          const bool in_release = active && tc < relatk;
          const float tcn = (in_attack || in_release) ? __fadd_rn(tc, inc) : tc;
          if (in_attack)
            g = __fsub_rn(tsg, __fmul_rn(curve_accel(__fdiv_rn(tcn, atk)),
                                         __fsub_rn(tsg, teg)));
          else if (in_release)
            g = __fadd_rn(teg, __fmul_rn(curve_accel(__fdiv_rn(__fsub_rn(tcn, atk), rel)),
                                         __fsub_rn(1.f, teg)));
          else
            g = 1.f;
          if (__fmul_rn(peak, g) > thr) {
            tsg = g;
            teg = __fdiv_rn(thr, peak);
            tc = 0.f;
          } else {
            tc = tcn;
          }
          if (lane == i) mine = g;
        }
      } else {
        g = 1.f;
      }
      if (lane < n) gain[k0 + lane] = mine;
    }
  }
  if (lane == 0) {
    st_out[0] = g;
    st_out[1] = tsg;
    st_out[2] = teg;
    st_out[3] = tc;
  }
}

// delayed sequence: ring (oldest first from idx) ++ x
__device__ __forceinline__ float delayed(const float* x, const float* delay,
                                         int idx, int D, int N, int c, int n) {
  return n < D ? delay[(size_t)c * D + (idx + n) % D] : x[(size_t)c * N + n - D];
}

__global__ void apply_quantize(const float* __restrict__ x, int C, int N,
                               const float* __restrict__ delay,
                               const int* __restrict__ eidx, int D,
                               const float* __restrict__ gain,
                               const float* __restrict__ S, float scale,
                               float lo, float hi, int bits, void* __restrict__ out,
                               float* __restrict__ delay_out,
                               float* __restrict__ peak_out,
                               int* __restrict__ eidx_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int idx = *eidx;
  const int new_idx = (idx + N) % D;
  if (i < N * C) {
    const int n = i / C, c = i - n * C;
    float v = __fmul_rn(__fmul_rn(delayed(x, delay, idx, D, N, c, n), gain[n]), scale);
    v = rintf(fminf(fmaxf(v, lo), hi));
    if (bits == 16)
      static_cast<int16_t*>(out)[i] = (int16_t)v;
    else
      static_cast<int32_t*>(out)[i] = (int32_t)v;
  }
  if (i < C * D) {
    // ring slot r holds tail element (r - new_idx) mod D, oldest at new_idx
    const int c = i / D, r = i - c * D;
    delay_out[i] = delayed(x, delay, idx, D, N, c, N + (r - new_idx + D) % D);
  }
  if (i < D) peak_out[i] = S[N + (i - new_idx + D) % D];
  if (i == 0) *eidx_out = new_idx;
}

}  // namespace

// x: [C, N] planar mix; delay: [C, D]; peak: [D]; eidx: int[1];
// st_in/st_out: float[4] envelope state; scratch: float[(D + N) + 2 N];
// out: [N, C] int16 (bits 16) or int32; delay_out [C, D]; peak_out [D];
// eidx_out int[1].
extern "C" int iamf_k3_limiter(const void* x, int C, int N, const void* delay,
                               const void* peak, const void* eidx, int D,
                               const void* st_in, float atk, float rel,
                               float inc, float thr, int bits, void* scratch,
                               void* out, void* delay_out, void* peak_out,
                               void* eidx_out, void* st_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* S = static_cast<float*>(scratch);
  float* W = S + (D + N);
  float* gain = W + N;
  const float scale = (float)(1ll << (bits - 1));
  const float lo = -scale;
  const float hi = (float)((1ll << (bits - 1)) - 1);
  seq_peaks<<<(D + N + 255) / 256, 256, 0, s>>>(
      (const float*)x, C, N, (const float*)peak, (const int*)eidx, D, S);
  window_max<<<(N + WT - 1) / WT, WT, (WT + D) * sizeof(float), s>>>(S, N, D, W);
  gain_walk<<<1, 32, 0, s>>>(W, N, (const float*)st_in, atk, rel, inc, thr,
                            gain, (float*)st_out);
  const int work = N * C > C * D ? N * C : C * D;
  apply_quantize<<<(work + 255) / 256, 256, 0, s>>>(
      (const float*)x, C, N, (const float*)delay, (const int*)eidx, D, gain,
      S, scale, lo, hi, bits, out, (float*)delay_out, (float*)peak_out,
      (int*)eidx_out);
  return (int)cudaGetLastError();
}
