// K9: the limiter's true-peak meter for one decode batch.
//
// Replaces the true-peak branch of iamf_tpu/dsp/limiter.py input_peaks
// (jitted inside the limiter block of core/pipeline.py decode_frames): a
// 4x-oversampling polyphase interpolator, 4 phases x 12 taps (the repo's
// own 48-tap Hann-windowed sinc, dsp/limiter.truepeak_filters), over each
// channel with an 11-sample history carried across batches:
//   peaks[t] = max over c, p of |sum_i h[p][i] x[c, t - i]|,
// x[c, t - i] reaching into hist (oldest first) for t < i; hist' = the last
// 11 samples of hist ++ x. The peaks replace K3's sample peaks max_c |x|
// (csrc/limiter.cu seq_peaks takes them as a pointer).
//
// Design: one CTA of 256 threads per tile of TS = 1024 samples (K3's tile),
// 4 samples a thread, all channels, the maximum in registers. The CTA
// stages one channel's tile and its 11-sample halo in shared memory at a
// time; the 48 taps are in __constant__ memory (the table below; a CPU
// test holds it to truepeak_filters). Each phase sums its taps in the
// plain twin's order (i = 0..11, each product and sum rounded to nearest,
// no FMA contraction), so the peaks equal the twin's bit for bit.
//
// What bounds it: at C = 12, N = 122,880 the FIR is 2 x 48 x C x N = 141.6
// MFLOP (2.1 us at 67 TFLOP/s) against 5.9 MB of input (1.8 us at
// 3.35 TB/s): operations, by a little. 120 CTAs fill most of the card's 132
// SMs once.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TS = 1024;       // samples per CTA (K3's tile)
constexpr int THREADS = 256;
constexpr int SPT = TS / THREADS;  // samples per thread
constexpr int PHASES = 4, TAPS = 12, HIST = TAPS - 1;

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

__global__ void __launch_bounds__(THREADS)
k9_truepeak(const float* __restrict__ x, const float* __restrict__ hist,
            int C, int N, float* __restrict__ peaks,
            float* __restrict__ hist_out) {
  __shared__ float xs[TS + HIST];  // hist ++ x at [t0, t0 + TS + HIST)
  const int t0 = blockIdx.x * TS, tid = threadIdx.x;
  float mx[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) mx[s] = 0.f;
  for (int c = 0; c < C; ++c) {
    for (int i = tid; i < TS + HIST; i += THREADS) {
      const long j = (long)t0 + i;
      xs[i] = j < (long)N + HIST ? joined(x, hist, N, c, j) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int t = tid + s * THREADS;
      float w[TAPS];  // w[i] = x[c, t0 + t - i]
#pragma unroll
      for (int i = 0; i < TAPS; ++i) w[i] = xs[t + HIST - i];
#pragma unroll
      for (int p = 0; p < PHASES; ++p) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < TAPS; ++i)
          acc = __fadd_rn(acc, __fmul_rn(H[p][i], w[i]));
        mx[s] = fmaxf(mx[s], fabsf(acc));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int t = t0 + tid + s * THREADS;
    if (t < N) peaks[t] = mx[s];
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < C * HIST; i += THREADS) {
      const int c = i / HIST, k = i - c * HIST;
      hist_out[i] = joined(x, hist, N, c, (long)N + k);
    }
}

}  // namespace

// x: [C, N] float32; hist: [C, 11] (oldest first); peaks: [N];
// hist_out: [C, 11] (must not alias hist).
extern "C" int iamf_k9_truepeak(const void* x, const void* hist, int C, int N,
                                void* peaks, void* hist_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k9_truepeak<<<(N + TS - 1) / TS, THREADS, 0, s>>>(
      (const float*)x, (const float*)hist, C, N, (float*)peaks,
      (float*)hist_out);
  return (int)cudaGetLastError();
}
