// K8: binaural HRTF convolution of one decode batch, overlap-save FFT, for
// S streams that share one HRIR bank.
//
// Replaces the HRTF branch of iamf_tpu/core/pipeline.py decode_frames
// (:267-320; segmented overlap-add FFT convolution planned by
// dsp/binaural.py batch_seg_plan). It computes the same linear convolution
// with the same output-overlap carry:
//   y[e, t]   = sum_c sum_k h[e, c, k] * x[c, t - k]  (+ ov[e, t], t < taps-1)
//   ov'[e, j] = sum_c sum_{k > j} h[e, c, k] * x[c, N + j - k]
// with x zero outside [0, N). ov' is the same sum at t = N + j with x zero
// past N (plus ov[N + j] when N < taps - 1), so the blocks simply cover
// the output index range [0, N + taps - 1) and write t >= N into ov'.
// With S streams (the multi-stream server's bucket, core/serving.py) x, ov,
// y and ov' have a leading stream axis and blockIdx.y is the stream; the
// bank depends only on the layout, which the bucket's streams share, so
// one table serves them all.
//
// What bounds it: as an FFT convolution it needs ~70 M flops at C = 12,
// taps = 256, N = 128 * 960 (chip_smoke.fft_conv_ops) against ~7 MB of
// HBM traffic: ~2 us of bytes, so the limit is latency, not throughput.
// The direct form it replaces did 1.5 G flops on the fp32 cores. The
// design (plan and tables: dsp/binaural.py k8_partition, k8_spectra,
// k8_twiddles; numpy model: tests/k8_model.py):
//   - overlap-save with F = 1024 points. The filter is cut into `parts`
//     parts of lp <= 512 taps (one part for taps <= 512); a block takes
//     V = F - lp + 1 outputs, so all blocks are resident at once (161 at
//     C = 12, taps = 256, N = 122,880), one block a CTA. Part p's window
//     is x[t0 - (lp - 1) - p * lp, ... + F);
//   - two real channels per complex FFT: z = x_a + i x_b. With
//     Zc[k] = conj Z[F - k], the pair contributes
//     Y[k] += P[k] Z[k] + Q[k] Zc[k], P = (G_a - i G_b) / 2F,
//     Q = (G_a + i G_b) / 2F, G_c the FFT of h_L,c + i h_R,c: both ears
//     and the split of the two channels' spectra in one table, made on the
//     host in float64;
//   - both ears in one inverse FFT: conj FFT(conj Y) has the left ear in
//     its real part and the right ear in its imaginary part (1/F is in the
//     table). So a block does parts * ceil(C / 2) + 1 FFTs (7 at C = 12);
//   - the FFT is written here: four-step 1024 = 32 x 32, one warp per
//     transform. A lane holds x[lane + 32 m], m < 32, in registers, does
//     a radix-2 32-point FFT, multiplies by W^(lane k2), and the warp
//     transposes through a padded (stride 33, conflict-free) shared
//     buffer; a second 32-point FFT leaves X[lane + 32 m] in the same
//     registers, the layout the next transform takes (loaded in
//     bit-reversed register order; each radix-2 stage is a template, so
//     no register is indexed at run time). No barrier inside a
//     transform, only __syncwarp;
//   - warp w takes the (part, pair) items w, w + nw, ... and keeps its
//     partial Y in registers; the partials meet in shared memory (one
//     barrier), warp 0 runs the inverse FFT and writes the block.
// fp32 throughout, multiplies and adds as explicit fmaf or separate
// roundings (the library builds with --fmad=false).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int F = 1024;          // FFT length (dsp/binaural.py K8_FFT)
constexpr int MAX_PART = 512;    // longest filter part (K8_PART)
constexpr int NW_MAX = 8;        // warps per block
constexpr int TP = 33;           // padded row of the transpose buffer
constexpr int TBUF = 2 * 32 * TP;  // a warp's buffer: re, then im (floats)
constexpr int NTW = F + 16;      // twiddles: W_1024^(n1 k2), then W_32^k

__host__ __device__ constexpr int brev5(int i) {
  return ((i & 1) << 4) | ((i & 2) << 2) | (i & 4) | ((i & 8) >> 2) |
         ((i & 16) >> 4);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -(a.y * b.y)), fmaf(a.x, b.y, a.y * b.x));
}

// One radix-2 decimation-in-time stage of spans 2^S over a lane's 32
// registers; w32[k] = exp(-2 pi i k / 32), k < 16. A template, so that
// every register index is a constant and the array stays in registers.
template <int S>
__device__ __forceinline__ void dit_stage(float2 (&a)[32],
                                          const float2* __restrict__ w32) {
  constexpr int half = 1 << (S - 1);
#pragma unroll
  for (int g = 0; g < 32; g += 2 * half) {
#pragma unroll
    for (int j = 0; j < half; ++j) {
      float2 t = a[g + j + half];
      if (j != 0) t = cmul(t, w32[j << (5 - S)]);
      const float2 u = a[g + j];
      a[g + j] = make_float2(u.x + t.x, u.y + t.y);
      a[g + j + half] = make_float2(u.x - t.x, u.y - t.y);
    }
  }
}

// In-place 32-point forward DFT of a lane's registers: a[i] = x[brev5(i)]
// in (the callers load in that order), a[k] = X[k] out.
__device__ __forceinline__ void fft32(float2 (&a)[32],
                                      const float2* __restrict__ w32) {
  dit_stage<1>(a, w32);
  dit_stage<2>(a, w32);
  dit_stage<3>(a, w32);
  dit_stage<4>(a, w32);
  dit_stage<5>(a, w32);
}

// One warp's 1024-point forward DFT: a[i] = x[lane + 32 brev5(i)] in,
// a[m] = X[lane + 32 m] out. tb: the warp's transpose buffer.
__device__ __forceinline__ void fft1024(float2 (&a)[32], float* tb,
                                        const float2* __restrict__ tw,
                                        int lane) {
  const float2* w32 = tw + F;
  fft32(a, w32);  // over n2 for n1 = lane: a[k2]
#pragma unroll
  for (int k2 = 0; k2 < 32; ++k2) {
    if (k2 != 0) a[k2] = cmul(a[k2], tw[k2 * 32 + lane]);  // W^(lane k2)
    tb[lane * TP + k2] = a[k2].x;
    tb[32 * TP + lane * TP + k2] = a[k2].y;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32; ++i) {  // n1 = brev5(i)
    const int n1 = brev5(i);
    a[i] = make_float2(tb[n1 * TP + lane], tb[32 * TP + n1 * TP + lane]);
  }
  __syncwarp();
  fft32(a, w32);  // over n1 for k2 = lane: a[k1] = X[lane + 32 k1]
}

__global__ void __launch_bounds__(NW_MAX * 32)
hrtf_fft(const float* __restrict__ x, int C, int N,
         const float4* __restrict__ pq, const float2* __restrict__ tw_g,
         int taps, int parts, int lp, const float* __restrict__ ov,
         float* __restrict__ y, float* __restrict__ ov_out) {
  extern __shared__ __align__(16) float sm[];
  x += (size_t)blockIdx.y * C * N;  // the stream's bed, carries and ears
  ov += (size_t)blockIdx.y * 2 * (taps - 1);
  y += (size_t)blockIdx.y * 2 * N;
  ov_out += (size_t)blockIdx.y * 2 * (taps - 1);
  float2* tw = reinterpret_cast<float2*>(sm);
  float* bufs = sm + 2 * NTW;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int V = F - lp + 1;
  const int t0 = blockIdx.x * V;
  const int pairs = (C + 1) >> 1;
  const int items = parts * pairs;
  for (int i = threadIdx.x; i < NTW; i += blockDim.x) tw[i] = tw_g[i];
  __syncthreads();
  float* tb = bufs + w * TBUF;

  float2 acc[32];
#pragma unroll
  for (int m = 0; m < 32; ++m) acc[m] = make_float2(0.f, 0.f);
  const int src = (32 - lane) & 31;
  for (int it = w; it < items; it += nw) {
    const int p = it / pairs;
    const int ca = 2 * (it - p * pairs);
    const bool has_b = ca + 1 < C;
    const float* xa = x + (size_t)ca * N;
    const float* xb = xa + N;
    const int base = t0 - (lp - 1) - p * lp;
    float2 a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int g = base + lane + 32 * brev5(i);
      const bool in = g >= 0 && g < N;
      a[i] = make_float2(in ? xa[g] : 0.f, (in && has_b) ? xb[g] : 0.f);
    }
    fft1024(a, tb, tw, lane);
    const float4* pqi = pq + (size_t)it * F + lane;
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      // Zc = conj Z[F - k], k = lane + 32 m: lane 32 - lane, register
      // 31 - m; for lane 0, its own register (32 - m) % 32
      const float2 o = a[31 - m];
      float2 zm = make_float2(__shfl_sync(0xffffffffu, o.x, src),
                              __shfl_sync(0xffffffffu, o.y, src));
      if (lane == 0) zm = a[(32 - m) & 31];
      const float4 c = __ldg(pqi + 32 * m);  // P = (c.x, c.y), Q = (c.z, c.w)
      const float2 z = a[m];
      float re = acc[m].x, im = acc[m].y;
      re = fmaf(c.x, z.x, re);
      re = fmaf(-c.y, z.y, re);
      re = fmaf(c.z, zm.x, re);
      re = fmaf(c.w, zm.y, re);
      im = fmaf(c.x, z.y, im);
      im = fmaf(c.y, z.x, im);
      im = fmaf(c.w, zm.x, im);
      im = fmaf(-c.z, zm.y, im);
      acc[m] = make_float2(re, im);
    }
  }
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    tb[lane + 32 * m] = acc[m].x;
    tb[TBUF / 2 + lane + 32 * m] = acc[m].y;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    float re = bufs[j], im = bufs[TBUF / 2 + j];
    for (int v = 1; v < nw; ++v) {
      re += bufs[v * TBUF + j];
      im += bufs[v * TBUF + TBUF / 2 + j];
    }
    bufs[j] = re;
    bufs[TBUF / 2 + j] = im;
  }
  __syncthreads();
  if (w != 0) return;

  // inverse: conj FFT(conj Y); left ear = real part, right ear = imag
  float2 a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int k = lane + 32 * brev5(i);
    a[i] = make_float2(bufs[k], -bufs[TBUF / 2 + k]);
  }
  __syncwarp();
  fft1024(a, bufs, tw, lane);
  const int nov = taps - 1;
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const int k = lane + 32 * m;
    if (k < lp - 1) continue;  // wrapped: not a linear-convolution output
    const int t = t0 + k - (lp - 1);
    float l = a[m].x, r = -a[m].y;
    if (t < nov) {
      l += ov[t];
      r += ov[nov + t];
    }
    if (t < N) {
      y[t] = l;
      y[(size_t)N + t] = r;
    } else if (t < N + nov) {
      ov_out[t - N] = l;
      ov_out[nov + t - N] = r;
    }
  }
}

}  // namespace

// x: [S, C, N] beds; pq: [parts, ceil(C/2), F] float4 (P, Q) per bin; tw:
// [F + 16] float2 twiddles; ov: [S, 2, taps-1] carries in; y: [S, 2, N];
// ov_out: [S, 2, taps-1] carries out (must not alias ov). The filter is
// cut into `parts` parts of lp taps (parts * lp >= taps, lp <= 512).
extern "C" int iamf_k8_hrtf_conv(const void* x, int S, int C, int N,
                                 const void* pq, const void* tw, int taps,
                                 int parts, int lp, const void* ov, void* y,
                                 void* ov_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 65535 || C < 1 || N < 0 || taps < 2 || lp < 1 ||
      lp > MAX_PART || parts < 1 ||
      (long long)parts * lp < taps || (long long)(parts - 1) * lp >= taps)
    return (int)cudaErrorInvalidValue;
  const int items = parts * ((C + 1) / 2);
  const int nw = items < NW_MAX ? items : NW_MAX;
  const size_t smem = (size_t)(2 * NTW + nw * TBUF) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      hrtf_fft, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int V = F - lp + 1;
  const long long nb = ((long long)N + taps - 1 + V - 1) / V;
  hrtf_fft<<<dim3((unsigned)nb, S), nw * 32, smem, s>>>(
      (const float*)x, C, N, (const float4*)pq, (const float2*)tw, taps,
      parts, lp, (const float*)ov, (float*)y, (float*)ov_out);
  return (int)cudaGetLastError();
}
