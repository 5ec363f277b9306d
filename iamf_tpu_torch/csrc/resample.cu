// K10: polyphase sinc resampler (speexdsp quality 4) over a whole stream.
//
// Replaces iamf_tpu/dsp/resample.py _resample_scan / DeviceResampler
// .resample_stream: a lax.scan over input chunks whose carry is only the
// overlap-save input window. Nothing else carries, so every output is
// indexed directly and the stream is one launch. The filter row of output
// j depends only on its phase (num*j) % den, so (dsp/resample.py):
//   y[c, j] = clip(sum_f xz[c, floor(num*j / den) + D + f]
//                  * bank[(num*j) % den, f], -1, 1)
// with xz the input with zeros outside [0, T_in) (the leading zeros are
// the scan's initial carry, the trailing ones its padding and latency
// drain).
//
// What bounds it: C * T_out * N FMAs (1.1 G for 30 s of 12 channels at
// 44.1 -> 48 kHz, N = 64: 33 us at the fp32 peak) against 133 MB of HBM
// traffic (40 us). The first design ran a thread per output with two
// loads per FMA, one of them from a 2.3 MB row table only L2 held, and
// reused nothing. This one reuses every load:
//   - the per-phase bank (40 KB at 44.1 kHz) lives in shared memory, laid
//     out as tiles (dsp/resample.py k10_tiles): R = 4 consecutive outputs
//     share one input window, each one's row shifted to its place in it
//     and zero-padded, so a tap reads one input sample for all R outputs
//     and one float4 of bank values for them;
//   - a lane takes one super-period M (L outputs, L = lcm(R, den), 160 at
//     44.1 kHz) and a warp 32 consecutive ones, all on the same tile u: the
//     bank float4 is a broadcast, and the lanes' input reads are
//     (num*L/den) words apart, conflict-free when that is odd (147 at
//     44.1, 22.05, 11.025 and 88.2 kHz);
//   - a thread holds R outputs of one channel in registers: per tap one
//     broadcast float4 and one conflict-free shared load feed 4 FMAs;
//   - a CTA stages the input span of its 32 super-periods for its
//     channel and a chunk of the bank's tiles (grid z) in shared memory
//     with cp.async, every copy in flight at once; each warp walks its
//     tiles and leaves the outputs in shared memory, and the CTA stores
//     them as runs of consecutive outputs (a lane's own outputs are
//     per_out apart: stored from the registers, they took 0.2 of 0.33
//     ms). The chunks keep a CTA within SMEM_MAX, so that several CTAs
//     share an SM and their staging, taps and stores overlap.
// Each output still sums its N taps in order in fp32 with explicit fmaf:
// the zero taps before and after a row add nothing (fmaf(x, 0, acc) ==
// acc), so the sums are those of the first design, bit for bit.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int R = 4;      // outputs a tile (dsp/resample.py K10_R)
constexpr int CT = 1;     // channels a thread
constexpr int MB = 32;    // super-periods a CTA: one a lane
constexpr int NW = 8;     // warps a CTA
// shared memory a CTA at most: four CTAs an SM, so that one's staging and
// stores overlap the others' taps (perf/k8_k10.py parts: 0.148 ms against
// 0.207 at one CTA an SM of 4 channels; H100, 700 W)
constexpr size_t SMEM_MAX = 56 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, zero-filled where !ok (src then unread)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__global__ void __launch_bounds__(NW * 32)
resample(const float* __restrict__ x, int C, int T_in,
         const float4* __restrict__ rows, const int* __restrict__ start,
         int U, int NE, int UC, int per_in, int per_out, int D, int S,
         float* __restrict__ y, int T_out) {
  extern __shared__ __align__(16) float sm[];
  const int u0 = blockIdx.z * UC;
  const int uc = min(UC, U - u0);
  const int OW = R * uc + 1;  // an output row (odd: conflict-free stores)
  float4* es = reinterpret_cast<float4*>(sm);   // uc tiles of NE float4
  float* xs = sm + (size_t)UC * NE * R;         // CT rows of S samples
  float* ys = xs + (size_t)CT * S;              // CT x MB rows of OW
  const int c0 = blockIdx.y * CT;
  const long long s0 = (long long)per_in * MB * blockIdx.x + D;

  // stage with cp.async: every copy of the CTA in flight at once
  const float4* rg = rows + (size_t)u0 * NE;
  for (int i = threadIdx.x; i < uc * NE; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(es + i)),
                 "l"(rg + i)
                 : "memory");
  for (int c = 0; c < CT; ++c) {
    const bool ok = c0 + c < C;
    const float* xc = x + (size_t)(ok ? c0 + c : 0) * T_in;
    for (int q = threadIdx.x; q < S; q += blockDim.x) {
      const long long g = s0 + q;
      const bool in = ok && g >= 0 && g < T_in;
      cp_async4(xs + c * S + q, in ? xc + g : xc, in);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < uc; t += NW) {
    const float* xp = xs + per_in * lane + start[u0 + t];
    const float4* ep = es + (size_t)t * NE;
    float acc[CT][R];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[c][i] = 0.f;
#pragma unroll 4
    for (int f = 0; f < NE; ++f) {
      const float4 e = ep[f];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float v = xp[c * S + f];
        acc[c][0] = fmaf(v, e.x, acc[c][0]);
        acc[c][1] = fmaf(v, e.y, acc[c][1]);
        acc[c][2] = fmaf(v, e.z, acc[c][2]);
        acc[c][3] = fmaf(v, e.w, acc[c][3]);
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < R; ++i)
        ys[(c * MB + lane) * OW + R * t + i] =
            fminf(fmaxf(acc[c][i], -1.f), 1.f);
  }
  __syncthreads();

  // coalesced stores: per channel and super-period, R * uc consecutive
  // outputs from R * u0 on
  const int row = R * uc;
  for (int c = 0; c < CT && c0 + c < C; ++c) {
    float* yc = y + (size_t)(c0 + c) * T_out;
    for (int q = threadIdx.x; q < MB * row; q += blockDim.x) {
      const int m = q / row, k = q - m * row;
      const long long j =
          ((long long)MB * blockIdx.x + m) * per_out + R * u0 + k;
      if (j < T_out) yc[j] = ys[(c * MB + m) * OW + k];
    }
  }
}

}  // namespace

// x: [C, T_in]; rows: [U, NE, R] float32 (tile u's rows in its window);
// start: int[U] (tile u's window in its super-period); per_in / per_out:
// inputs / outputs a super-period; D: the first window's offset; y:
// [C, T_out].
extern "C" int iamf_k10_resample(const void* x, int C, int T_in,
                                 const void* rows, const void* start, int U,
                                 int NE, int per_in, int per_out, int D,
                                 void* y, int T_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0 || T_out == 0) return (int)cudaGetLastError();
  if (C < 0 || U < 1 || NE < 1 || per_out != U * R || per_in < 1)
    return (int)cudaErrorInvalidValue;
  // the input span of MB super-periods: a tile's window starts below
  // per_in (start[u] < per_in) past its super-period's first input
  const int S = MB * per_in + NE;
  // the input span, then per tile its rows and its outputs
  const size_t in_bytes = (size_t)CT * S * sizeof(float);
  auto smem_for = [&](int uc) {
    return in_bytes + sizeof(float) * ((size_t)uc * NE * R +
                                       (size_t)CT * MB * (R * uc + 1));
  };
  if (smem_for(1) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int UC = U;
  while (smem_for(UC) > SMEM_MAX) UC = (UC + 1) / 2;
  const size_t smem = smem_for(UC);
  const cudaError_t e = cudaFuncSetAttribute(
      resample, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_super = ((long long)T_out + per_out - 1) / per_out;
  dim3 grid((unsigned)((n_super + MB - 1) / MB), (C + CT - 1) / CT,
            (U + UC - 1) / UC);
  resample<<<grid, NW * 32, smem, s>>>(
      (const float*)x, C, T_in, (const float4*)rows, (const int*)start, U,
      NE, UC, per_in, per_out, D, S, (float*)y, T_out);
  return (int)cudaGetLastError();
}
