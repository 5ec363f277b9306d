// K9: the limiter's true-peak meter for one decode batch of S streams.
//
// Replaces the true-peak branch of iamf_tpu/dsp/limiter.py input_peaks
// (jitted inside the limiter block of core/pipeline.py decode_frames): a
// 4x-oversampling polyphase interpolator, 4 phases x 12 taps (the repo's
// own 48-tap Hann-windowed sinc, dsp/limiter.truepeak_filters), over each
// channel with an 11-sample history carried across batches:
//   peaks[t] = max over c, p of |sum_i h[p][i] x[c, t - i]|,
// x[c, t - i] reaching into hist (oldest first) for t < i; hist' = the last
// 11 samples of hist ++ x. The peaks replace K3's sample peaks max_c |x|
// (csrc/limiter.cu seq_peaks takes them as a pointer). With S streams
// (the multi-stream server's bucket, core/serving.py) every array has a
// leading stream axis, the peaks are a maximum over one stream's channels,
// and blockIdx.y is the stream: a stream's result does not depend on S.
//
// What bounds it: at C = 12, N = 122,880 the FIR is 2 x 48 x C x N = 141.6
// MFLOP (2.1 us at 67 TFLOP/s, which counts an FMA as two) against 5.9 MB
// of input (1.8 us at 3.35 TB/s). The peaks must equal the twin's bit for
// bit, so each product and each sum is rounded on its own (no FMA): at
// most 88 multiplies and adds and 4 maxima a sample and channel, up to
// 136 M instructions, 4.1 us at the card's 128 fp32 instructions a clock
// an SM at 1.98 GHz. The issue rate bounds it, and the design keeps the
// fp32 pipes fed and the loads under the arithmetic:
//   - a warp takes a tile of every channel: its lanes form G channel
//     groups (4; 2 for 2 or 3 channels, 1 for one, so no lane idles), a
//     lane on SPT = 4 consecutive samples of every G-th channel: 32
//     samples a warp at C >= 4 (3840 tiles at N = 122,880, all resident
//     at once), WPC = 2 warps a CTA;
//   - a lane loads the 16 samples its window needs (x[t - 12 .. t + 4),
//     float4 loads where the row is aligned; neighbours' halos meet in L1)
//     straight into registers, the next channel's while it computes this
//     one's: no shared memory and no barrier, so every warp runs on its
//     own and the loads of some overlap the arithmetic of others;
//   - each phase sums its taps in the plain twin's order (i = 0..11, each
//     product and sum rounded to nearest); the two taps that are -0
//     (h[0][0], h[3][11]) are left out, which changes no sum but the sign
//     of a zero, and |.| takes that away; phases 2 and 3 are phases 1 and 0
//     mirrored (h[3 - p][11 - i], bit for bit: a CPU test holds the table
//     to both), so a product serves both phases of a pair where the lane's
//     samples share it (42 multiplies a sample and channel instead of 46;
//     38 with 8 samples a lane, which measured slower, perf/k7_k9.py);
//   - the maxima over the channel groups meet by warp shuffles (exact).
// The taps are in __constant__ memory (the table below; a CPU test holds
// it to truepeak_filters).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int SPT = 4;            // consecutive samples per lane
constexpr int WPC = 2;            // warps a CTA, each on its own tile
constexpr int KB = 2;             // samples whose sums advance together
constexpr int PHASES = 4, TAPS = 12, HIST = TAPS - 1;
constexpr int OFF = 12;           // the window starts 12 samples back
constexpr int WIN = SPT + OFF;    // a lane's window, float4-aligned
static_assert(SPT % 4 == 0 && SPT % KB == 0, "tiling");

// channel groups in a warp: 4, or fewer for fewer channels, so that no
// lane idles; a group's 32 / G lanes take SPT samples each
__host__ __device__ constexpr int groups(int C) {
  return C >= 4 ? 4 : C >= 2 ? 2 : 1;
}

// truepeak_filters(): phase p holds taps h[4 i + p] of the prototype,
// applied to x[t - i]; each phase sums to 1
__constant__ float H[PHASES][TAPS] = {
    {-0.000000000e+00f, 1.743852976e-03f, -8.162993938e-03f, 2.188975550e-02f, -4.995538667e-02f, 1.317152828e-01f, 9.732822180e-01f, -9.876007587e-02f, 4.072107002e-02f, -1.753679849e-02f, 6.005962379e-03f, -9.428827325e-04f},
    {-2.330690040e-04f, 6.836781278e-03f, -2.596531436e-02f, 6.528475881e-02f, -1.487983763e-01f, 4.571782947e-01f, 7.757922411e-01f, -1.861138195e-01f, 8.019617200e-02f, -3.344329447e-02f, 1.023687981e-02f, -9.712851606e-04f},
    {-9.712851606e-04f, 1.023687981e-02f, -3.344329447e-02f, 8.019617200e-02f, -1.861138195e-01f, 7.757922411e-01f, 4.571782947e-01f, -1.487983763e-01f, 6.528475881e-02f, -2.596531436e-02f, 6.836781278e-03f, -2.330690040e-04f},
    {-9.428827325e-04f, 6.005962379e-03f, -1.753679849e-02f, 4.072107002e-02f, -9.876007587e-02f, 9.732822180e-01f, 1.317152828e-01f, -4.995538667e-02f, 2.188975550e-02f, -8.162993938e-03f, 1.743852976e-03f, -0.000000000e+00f},
};

// sample j of hist ++ x for channel c (j < HIST + N)
__device__ __forceinline__ float joined(const float* x, const float* hist,
                                        int N, int c, long j) {
  return j < HIST ? hist[c * HIST + j] : x[(size_t)c * N + (j - HIST)];
}

// phase p's tap i, from the table of phases 0 and 1: h[p][i] =
// h[3 - p][11 - i] bit for bit
__device__ __forceinline__ float tap(int p, int i) {
  return p < 2 ? H[p][i] : H[3 - p][TAPS - 1 - i];
}

// mx[k0 + kk] = max(mx[k0 + kk], |sum_i h[p][i] x[t + k0 + kk - i]|) over
// the phases p, for the NB samples kk < NB: their 4 NB sums advance tap by
// tap side by side (independent chains), each in the twin's order;
// w[OFF + k - i] = x[t + k - i]
template <int NB>
__device__ __forceinline__ void meter(const float (&w)[WIN], int k0,
                                      float (&mx)[SPT]) {
  float acc[NB][PHASES];
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    const int c = OFF + k0 + kk;
    acc[kk][0] = __fmul_rn(tap(0, 1), w[c - 1]);  // h[0][0] = -0
#pragma unroll
    for (int p = 1; p < PHASES; ++p) acc[kk][p] = __fmul_rn(tap(p, 0), w[c]);
  }
#pragma unroll
  for (int i = 1; i < TAPS; ++i)
#pragma unroll
    for (int kk = 0; kk < NB; ++kk)
#pragma unroll
      for (int p = 0; p < PHASES; ++p) {
        if ((p == 0 && i == 1) || (p == 3 && i == TAPS - 1))
          continue;  // phase 0's first product; h[3][11] = -0
        acc[kk][p] = __fadd_rn(
            acc[kk][p], __fmul_rn(tap(p, i), w[OFF + k0 + kk - i]));
      }
#pragma unroll
  for (int kk = 0; kk < NB; ++kk)
#pragma unroll
    for (int p = 0; p < PHASES; ++p)
      mx[k0 + kk] = fmaxf(mx[k0 + kk], fabsf(acc[kk][p]));
}

// w[m] = x[c, t - OFF + m] (hist for t - OFF + m < 0, 0 past N)
__device__ __forceinline__ void load_window(const float* __restrict__ x,
                                            const float* __restrict__ hist,
                                            int N, int c, int t,
                                            float (&w)[WIN]) {
  if ((N & 3) == 0 && t >= OFF && t + SPT <= N) {
    const float4* src =
        reinterpret_cast<const float4*>(x + (size_t)c * N + (t - OFF));
#pragma unroll
    for (int m = 0; m < WIN / 4; ++m) {
      const float4 q = __ldg(src + m);
      w[4 * m] = q.x;
      w[4 * m + 1] = q.y;
      w[4 * m + 2] = q.z;
      w[4 * m + 3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < WIN; ++m) {
    const long j = (long)t - OFF + m + HIST;  // in hist ++ x
    w[m] = j >= 0 && j < (long)N + HIST ? joined(x, hist, N, c, j) : 0.f;
  }
}

__global__ void __launch_bounds__(32 * WPC)
k9_truepeak(const float* __restrict__ x, const float* __restrict__ hist,
            int C, int N, float* __restrict__ peaks,
            float* __restrict__ hist_out) {
  x += (size_t)blockIdx.y * C * N;  // the stream's rows
  hist += (size_t)blockIdx.y * C * HIST;
  peaks += (size_t)blockIdx.y * N;
  hist_out += (size_t)blockIdx.y * C * HIST;
  const int G = groups(C), tpg = 32 / G, ts = SPT * tpg;  // a warp's tile
  const int lane = threadIdx.x & 31, g = lane / tpg;
  const int tile = blockIdx.x * WPC + (threadIdx.x >> 5);
  if (tile * ts >= N) return;
  const int t = tile * ts + SPT * (lane % tpg);  // the lane's first sample
  float mx[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) mx[k] = 0.f;
  float nxt[WIN];
  load_window(x, hist, N, g, t, nxt);
  for (int c = g; c < C; c += G) {
    float w[WIN];
#pragma unroll
    for (int m = 0; m < WIN; ++m) w[m] = nxt[m];
    if (c + G < C) load_window(x, hist, N, c + G, t, nxt);
#pragma unroll
    for (int k0 = 0; k0 < SPT; k0 += KB) meter<KB>(w, k0, mx);
  }
#pragma unroll
  for (int k = 0; k < SPT; ++k)
#pragma unroll
    for (int d = tpg; d < 32; d *= 2)
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], d));
  if (g == 0) {
#pragma unroll
    for (int k = 0; k < SPT; ++k)
      if (t + k < N) peaks[t + k] = mx[k];
  }
  if (tile == 0)
    for (int i = lane; i < C * HIST; i += 32) {
      const int c = i / HIST, k = i - c * HIST;
      hist_out[i] = joined(x, hist, N, c, (long)N + k);
    }
}

}  // namespace

// x: [S, C, N] float32; hist: [S, C, 11] (oldest first); peaks: [S, N];
// hist_out: [S, C, 11] (must not alias hist).
extern "C" int iamf_k9_truepeak(const void* x, const void* hist, int S,
                                int C, int N, void* peaks, void* hist_out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 65535 || C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int per_cta = WPC * 32 / groups(C) * SPT;
  k9_truepeak<<<dim3((N + per_cta - 1) / per_cta, S), 32 * WPC, 0, s>>>(
      (const float*)x, (const float*)hist, C, N, (float*)peaks,
      (float*)hist_out);
  return (int)cudaGetLastError();
}
