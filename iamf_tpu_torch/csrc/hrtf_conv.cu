// K8: binaural HRTF convolution of one decode batch, direct form.
//
// Replaces the HRTF branch of iamf_tpu/core/pipeline.py decode_frames
// (:267-320; segmented overlap-add FFT convolution planned by
// dsp/binaural.py batch_seg_plan). It computes the same linear convolution
// with the same output-overlap carry:
//   y[e, t]   = sum_c sum_k h[e, c, k] * x[c, t - k]  (+ ov[e, t], t < taps-1)
//   ov'[e, j] = sum_c sum_{k > j} h[e, c, k] * x[c, N + j - k]
// with x zero outside [0, N). ov' is the same sum at t = N + j with x zero
// past N (plus ov[N + j] when N < taps - 1), so the grid simply runs the
// output index over [0, N + taps - 1) and writes t >= N into ov'.
//
// What bounds it: 2 * C * taps * N FMAs (755 M at C = 12, taps = 256,
// N = 128 * 960) against ~6 MB of HBM traffic, so it is compute-bound on
// the fp32 CUDA cores (67 TFLOP/s at 700 W: ~23 us at best), if each
// thread has enough independent work in flight. The design:
//   - a block is one ear (blockIdx.y) x TILE = 1024 consecutive outputs,
//     128 threads, each thread R = 8 consecutive outputs in registers;
//   - per channel the block stages the input window [t0 - L, t0 + TILE)
//     (L = taps rounded up to 8) and that channel's taps (zero-padded to
//     L) in shared memory; the window is stored as R planes (sample p at
//     plane p % R, index p / R), so the 32 lanes of a warp, whose outputs
//     are R apart, read 32 consecutive words: no bank conflicts;
//   - the taps go in chunks of 8: a thread holds a 16-sample window of its
//     input in registers, refills half of it with 8 independent loads per
//     chunk, reads the chunk's taps as two broadcast float4 loads, and
//     issues 64 FMAs into its 8 accumulators (10 shared loads per 64 FMAs,
//     8 independent chains). Sliding the window one sample per tap instead
//     puts a dependent shared load on every tap, and each thread's chain of
//     C * taps steps then sets the time whatever the batch size.
// Sums run channel by channel, tap by tap, in fp32 with explicit fmaf.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int R = 8;          // consecutive outputs per thread
constexpr int NT = 128;       // threads per block
constexpr int TILE = R * NT;  // outputs per block
constexpr int KC = 8;         // taps per chunk

__global__ void __launch_bounds__(NT)
hrtf_conv(const float* __restrict__ x, int C, int N,
          const float* __restrict__ h, int taps, int L,
          const float* __restrict__ ov, float* __restrict__ y,
          float* __restrict__ ov_out) {
  extern __shared__ __align__(16) float sm[];
  const int W = TILE + L;  // window length, a multiple of R
  const int PW = W / R;    // plane width
  float* hs = sm;          // this channel's taps for ear e, zero-padded to L
  float* xs = sm + L;      // R planes of PW samples
  const int e = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int i = threadIdx.x;
  const int LR = L / R;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int c = 0; c < C; ++c) {
    __syncthreads();
    const float* xc = x + (size_t)c * N;
    for (int p = i; p < W; p += NT) {
      const int g = t0 - L + p;
      xs[(p % R) * PW + p / R] = (g >= 0 && g < N) ? xc[g] : 0.f;
    }
    const float* hc = h + ((size_t)e * C + c) * taps;
    for (int k = i; k < L; k += NT) hs[k] = k < taps ? hc[k] : 0.f;
    __syncthreads();

    // u[m] = window sample R*i + q + m with q = L - kb - KC for the chunk
    // of taps [kb, kb + KC); output r at tap kb + j reads u[r - j + KC]
    float u[2 * KC];
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      u[m] = xs[m * PW + i + LR - 1];
      u[m + KC] = xs[m * PW + i + LR];
    }
#pragma unroll 2
    for (int kb = 0; kb < L; kb += KC) {
      const float4 h0 = *reinterpret_cast<const float4*>(hs + kb);
      const float4 h1 = *reinterpret_cast<const float4*>(hs + kb + 4);
      const float hk[KC] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int j = 0; j < KC; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fmaf(hk[j], u[r - j + KC], acc[r]);
      }
      if (kb + KC < L) {
        // next chunk: q falls by KC, the window slides by KC samples
        const int qi = i + (L - kb - 2 * KC) / R;
#pragma unroll
        for (int m = 0; m < KC; ++m) {
          u[m + KC] = u[m];
          u[m] = xs[m * PW + qi];
        }
      }
    }
  }

  const int nov = taps - 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + R * i + r;
    float val = acc[r];
    if (t < nov) val += ov[(size_t)e * nov + t];
    if (t < N)
      y[(size_t)e * N + t] = val;
    else if (t < N + nov)
      ov_out[(size_t)e * nov + (t - N)] = val;
  }
}

}  // namespace

// x: [C, N] bed; h: [2, C, taps]; ov: [2, taps-1] carry in; y: [2, N];
// ov_out: [2, taps-1] carry out (must not alias ov).
extern "C" int iamf_k8_hrtf_conv(const void* x, int C, int N, const void* h,
                                 int taps, const void* ov, void* y,
                                 void* ov_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = (taps + KC - 1) / KC * KC;  // >= taps - 1, a multiple of R
  const size_t smem = (size_t)(TILE + 2 * L) * sizeof(float);
  if (smem > 48 * 1024 || C < 1 || taps < 2) return (int)cudaErrorInvalidValue;
  dim3 grid((N + taps - 1 + TILE - 1) / TILE, 2);
  hrtf_conv<<<grid, NT, smem, s>>>(
      (const float*)x, C, N, (const float*)h, taps, L, (const float*)ov,
      (float*)y, (float*)ov_out);
  return (int)cudaGetLastError();
}
