// K10: polyphase sinc resampler (speexdsp quality 4) over a whole stream.
//
// Replaces iamf_tpu/dsp/resample.py _resample_scan / DeviceResampler
// .resample_stream: a lax.scan over input chunks whose carry is only the
// overlap-save input window. Nothing else carries, so every output is
// indexed directly and the stream is one launch: for output j, with
// s = j / out_chunk + 1 and o = j % out_chunk,
//   y[c, j] = clip(sum_f xz[c, s*in_chunk - carry_len + win_start[o] + f]
//                  * W[o, f], -1, 1)
// where xz is the input with zeros outside [0, T_in) (the leading zeros are
// the scan's initial carry, the trailing ones its padding and latency
// drain).
//
// What bounds it: C * T_out * N FMAs (1.1 G for 30 s of 12 channels at
// 44.1 -> 48 kHz, N = 64) against ~150 MB of HBM traffic: ~20-50 us of
// either at the card's peaks, so the limit is the load path. One thread
// per (channel, output); W is passed transposed ([N, out_chunk]) so that a
// warp's 32 outputs read 32 consecutive words of each filter row, and
// their input windows overlap (win_start advances ~num/den per output), so
// the input loads are coalesced too. Both stay in L1/L2 (W is 2.3 MB).
// Each output sums its N taps in order in fp32 with explicit fmaf.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void resample(const float* __restrict__ x, int T_in,
                         const float* __restrict__ Wt,
                         const int* __restrict__ win_start, int N,
                         int in_chunk, int out_chunk, int carry_len,
                         float* __restrict__ y, int T_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= T_out) return;
  const int c = blockIdx.y;
  const int s = j / out_chunk + 1;
  const int o = j - (s - 1) * out_chunk;
  const long long p0 =
      (long long)s * in_chunk - carry_len + win_start[o];
  const float* xc = x + (size_t)c * T_in;
  float acc = 0.f;
  if (p0 >= 0 && p0 + N <= T_in) {
    const float* xp = xc + p0;
    for (int f = 0; f < N; ++f)
      acc = fmaf(xp[f], Wt[(size_t)f * out_chunk + o], acc);
  } else {
    for (int f = 0; f < N; ++f) {
      const long long p = p0 + f;
      const float v = (p >= 0 && p < T_in) ? xc[p] : 0.f;
      acc = fmaf(v, Wt[(size_t)f * out_chunk + o], acc);
    }
  }
  y[(size_t)c * T_out + j] = fminf(fmaxf(acc, -1.f), 1.f);
}

}  // namespace

// x: [C, T_in]; Wt: [N, out_chunk] (filter rows transposed); win_start:
// int[out_chunk]; y: [C, T_out].
extern "C" int iamf_k10_resample(const void* x, int C, int T_in,
                                 const void* Wt, const void* win_start,
                                 int N, int in_chunk, int out_chunk,
                                 int carry_len, void* y, int T_out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int NT = 256;
  if (C == 0 || T_out == 0) return (int)cudaGetLastError();
  dim3 grid((T_out + NT - 1) / NT, C);
  resample<<<grid, NT, 0, s>>>((const float*)x, T_in, (const float*)Wt,
                               (const int*)win_start, N, in_chunk, out_chunk,
                               carry_len, (float*)y, T_out);
  return (int)cudaGetLastError();
}
