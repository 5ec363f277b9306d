// K7: the AAC-LC synthesis filterbank (ISO/IEC 14496-3 4.6.11) for one
// decode batch: IMDCT, windows, overlap-add across frames, s16 rounding.
//
// Replaces iamf_tpu/codecs/aac/tpu_synth.py synthesize_packed /
// _synthesize / _windowed_frames (a jitted program of two matmuls at
// HIGHEST precision). Per frame b and lane l (row r = b L + l):
//   long sequences (ONLY_LONG, LONG_START, LONG_STOP): t = the 2048-point
//     IMDCT of the 1024 spectral lines, frame = [t[:1024] * wl[seq, prev
//     shape], t[1024:] * wr[seq, shape]];
//   EIGHT_SHORT: eight 256-point IMDCTs of 128 lines each, windowed by the
//     short halves (window 0's left half by the previous shape) and
//     overlap-added inside the frame at 448 + 128 j;
//   out[b] = rint(clip(frame_b[:1024] + frame_{b-1}[1024:])) / 32768, with
//   the [L, 1024] carry as frame_{-1}'s second half; carry' = frame_{B-1}'s.
// The reference computes both paths for every row and selects; here a row
// takes only the path its sequence selects, which gives the same output.
//
// What bounds it: at B = 128, L = 12 the spectra in and the PCM out are
// 12.6 MB (3.8 us at 3.35 TB/s); by FFT the IMDCTs are ~53 M flops (0.8 us
// at 67 TFLOP/s). So bytes bound it, and the design keeps every
// intermediate out of device memory, in one launch:
//   - a warp takes one lane's run of `run` consecutive frames and first
//     recomputes the frame before the run (the carry stands in at b = 0),
//     so no frame waits for another warp; the caller picks run from B and
//     L so that the grid fills the card (codecs/aac/synth.py k7_run, on
//     iamf_k7_fill below);
//   - an N-point IMDCT is an N/4-point complex inverse FFT with pre- and
//     post-twiddles that fold in the scale 2/N and the phase n0 (the table
//     from codecs/aac/synth.py k7_twiddles, made in float64): a long frame
//     one 512-point FFT in three radix-8 Stockham passes, a short frame
//     eight 64-point FFTs in two, through a padded (conflict-free) buffer
//     in shared memory; a lane holds 16 points in registers;
//   - the output bin c gives the IMDCT samples t[N/4 + 2c] and
//     t[3N/4 - 1 - 2c], and by the IMDCT's symmetries each of those two
//     window products: a lane owns the same 32 positions in both halves
//     of every frame, so it adds frame b's first half to frame b-1's
//     second half, which it alone wrote (to shared memory: registers go
//     to the FFT), rounds and stores;
//   - a short frame's windowed lefts and rights go to shared memory, and
//     a lane reads back its positions adding window j-1's right to window
//     j's left, in the twin's order;
//   - the spectra are loaded as float2, coalesced, each lane's mirror
//     halves exchanged by one shuffle.
// fp32 throughout, multiplies and adds as explicit fmaf or separate
// roundings (the library builds with --fmad=false). The numpy model of
// this plan is tests/k7_model.py.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int K = 1024;           // spectral lines and outputs per frame
constexpr int EIGHT_SHORT = 2;
constexpr int WARPS = 4;          // warps per CTA, each on its own run
constexpr int PADN = 576;         // 512 points, padded i + i / 8
constexpr int SCR = 2 * K;        // a warp's scratch (floats): the FFT's
                                  // re and im, or a short frame's lefts
                                  // and rights
constexpr int SLOTS = 32;         // positions a lane owns in a half
// rows of the twiddle table (codecs/aac/synth.py TW_*)
constexpr int TW_PRE_L = 0, TW_POST_L = 512, TW_PRE_S = 1024,
              TW_POST_S = 1088, TW_64 = 1152, TW_512 = 1216;

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -(a.y * b.y)), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// y = DFT4 of x with exponent +2 pi i / 4
__device__ __forceinline__ void dft4(float2 x0, float2 x1, float2 x2,
                                     float2 x3, float2& y0, float2& y1,
                                     float2& y2, float2& y3) {
  const float2 t0 = cadd(x0, x2), t1 = csub(x0, x2), t2 = cadd(x1, x3);
  const float2 d = csub(x1, x3);
  const float2 t3 = make_float2(-d.y, d.x);  // i (x1 - x3)
  y0 = cadd(t0, t2);
  y2 = csub(t0, t2);
  y1 = cadd(t1, t3);
  y3 = csub(t1, t3);
}

// In-place 8-point DFT with exponent +2 pi i / 8: a[q] = sum_r a[r] w^(r q)
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  constexpr float H = 0.70710678118654752f;
  float2 s[4], d[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    s[r] = cadd(a[r], a[r + 4]);
    d[r] = csub(a[r], a[r + 4]);
  }
  // d[r] * e^(+2 pi i r / 8)
  d[1] = make_float2((d[1].x - d[1].y) * H, (d[1].x + d[1].y) * H);
  d[2] = make_float2(-d[2].y, d[2].x);
  d[3] = make_float2((-d[3].x - d[3].y) * H, (d[3].x - d[3].y) * H);
  dft4(s[0], s[1], s[2], s[3], a[0], a[2], a[4], a[6]);
  dft4(d[0], d[1], d[2], d[3], a[1], a[3], a[5], a[7]);
}

__device__ __forceinline__ void put(float* re, float* im, int i, float2 v) {
  re[pad(i)] = v.x;
  im[pad(i)] = v.y;
}

__device__ __forceinline__ float2 get(const float* re, const float* im,
                                      int i) {
  return make_float2(re[pad(i)], im[pad(i)]);
}

// The inverse FFT of a frame. In: a[t][r] the point that butterfly t of
// pass 0 reads at r (pre-twiddled). Out: a[t][q] the bin c of butterfly t
// at q: LONG, the 512-point FFT, c = lane + 32 t + 64 q; short, eight
// 64-point FFTs, window (lane >> 3) + 4 t, c = (lane & 7) + 8 q. Stockham
// radix-8: butterfly j of a transform reads j + (n/8) r, multiplies by
// W_(8 Ns)^(r (j mod Ns)) and writes (j / Ns) 8 Ns + j mod Ns + Ns q.
template <bool LONG>
__device__ __forceinline__ void inverse_fft(float2 (&a)[2][8], float* re,
                                            float* im,
                                            const float2* __restrict__ tw,
                                            int lane) {
  // pass 0 (Ns = 1)
  __syncwarp();  // the scratch's last readers are done
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    dft8(a[t]);
    const int b = lane + 32 * t;
    const int o = LONG ? 8 * b : 64 * (b >> 3) + 8 * (b & 7);
#pragma unroll
    for (int q = 0; q < 8; ++q) put(re, im, o + q, a[t][q]);
  }
  __syncwarp();
  // pass 1 (Ns = 8)
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int b = lane + 32 * t;
    const int i0 = LONG ? b : 64 * (b >> 3) + (b & 7);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      a[t][r] = get(re, im, i0 + (LONG ? 64 : 8) * r);
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int b = lane + 32 * t, k = b & 7;
#pragma unroll
    for (int r = 1; r < 8; ++r)
      a[t][r] = cmul(a[t][r], __ldg(tw + TW_64 + 8 * k + r));
    dft8(a[t]);
    if (LONG) {
      const int o = (b >> 3) * 64 + k;
#pragma unroll
      for (int q = 0; q < 8; ++q) put(re, im, o + 8 * q, a[t][q]);
    }
  }
  if (!LONG) return;
  __syncwarp();
  // pass 2 (Ns = 64)
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
#pragma unroll
    for (int r = 0; r < 8; ++r) a[t][r] = get(re, im, j + 64 * r);
#pragma unroll
    for (int r = 1; r < 8; ++r)
      a[t][r] = cmul(a[t][r], __ldg(tw + TW_512 + 8 * j + r));
    dft8(a[t]);
  }
}

// A lane's slot (t, q, e) of SLOTS
__device__ __forceinline__ constexpr int slot(int t, int q, int e) {
  return 16 * t + 2 * q + e;
}

// Position of slot (t, q, e) of a lane in each half of a frame: bin
// c = lane + 32 t + 64 q of the long FFT reaches p0 = 512 + 2c and
// p1 = 511 - 2c (c < 256), or p0 = 2c - 512 and p1 = 1535 - 2c.
__device__ __forceinline__ int slot_pos(int lane, int t, int q, int e) {
  const int c = lane + 32 * t + 64 * q;
  if (q < 4) return e == 0 ? 512 + 2 * c : 511 - 2 * c;
  return e == 0 ? 2 * c - 512 : 1535 - 2 * c;
}

// A row's meta and, in raw[t][r], the pair (X[2k], X[2k + 1]) of the
// point k that butterfly t of pass 0 reads at r: long, k = lane + 32 t +
// 64 r; short, window w = (lane >> 3) + 4 t, k = 64 w + (lane & 7) + 8 r
__device__ __forceinline__ void load_frame(const float2* __restrict__ spec,
                                           const int* __restrict__ meta,
                                           size_t row, int lane,
                                           float2 (&raw)[2][8], int (&m)[3]) {
  const float2* x = spec + row * (K / 2);
#pragma unroll
  for (int i = 0; i < 3; ++i) m[i] = __ldg(meta + 3 * row + i);
  const bool lng = m[0] != EIGHT_SHORT;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = lng ? lane + 32 * t + 64 * r
                        : 64 * ((lane >> 3) + 4 * t) + (lane & 7) + 8 * r;
      raw[t][r] = __ldg(x + k);
    }
}

__device__ __forceinline__ float s16(float v) {
  return __fmul_rn(rintf(fminf(fmaxf(v, -32768.f), 32767.f)),
                   1.f / 32768.f);
}

// spec as float2 rows; meta [R][3]; out, carry [.][1024]; tw [1728]
__global__ void __launch_bounds__(WARPS * 32)
k7_synth(const float2* __restrict__ spec, const int* __restrict__ meta,
         const float* __restrict__ carry, int B, int L, int run,
         const float2* __restrict__ tw, const float* __restrict__ wl,
         const float* __restrict__ wr, const float* __restrict__ sh,
         float* __restrict__ out, float* __restrict__ carry_out) {
  __shared__ __align__(16) float scratch[WARPS][SCR];
  // frame b-1's second half at the lanes' positions: slot i of a lane at
  // [i][lane] (kept here, not in registers, which the FFT needs)
  __shared__ float sprev_all[WARPS][SLOTS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int runs = (B + run - 1) / run;
  const int item = blockIdx.x * WARPS + warp;
  if (item >= L * runs) return;
  const int ch = item % L;
  const int b0 = (item / L) * run;
  const int b_end = min(b0 + run, B);
  float* re = scratch[warp];
  float* im = re + PADN;

  float(*sprev)[32] = sprev_all[warp];  // sprev[slot][lane]
  if (b0 == 0) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sprev[slot(t, q, e)][lane] =
              carry[(size_t)ch * K + slot_pos(lane, t, q, e)];
  }

  for (int b = b0 > 0 ? b0 - 1 : 0; b < b_end; ++b) {
    float2 a[2][8];
    int m[3];
    load_frame(spec, meta, (size_t)b * L + ch, lane, a, m);
    const int seq = m[0], shape = m[1], prev = m[2];
    const bool emit = b >= b0;
    const size_t obase = ((size_t)b * L + ch) * K;
    const bool last = b == B - 1;

    if (seq != EIGHT_SHORT) {
      // v[k] = (X[1023 - 2k] + i X[2k]) pre[k]; X[1023 - 2k] is the odd
      // half of pair 511 - k: lane 31 - lane's load at (1 - t, 7 - r)
      float2 v[2][8];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float odd =
              __shfl_xor_sync(0xffffffffu, a[1 - t][7 - r].y, 31);
          const int k = lane + 32 * t + 64 * r;
          v[t][r] = cmul(make_float2(odd, a[t][r].x),
                         __ldg(tw + TW_PRE_L + k));
        }
      inverse_fft<true>(v, re, im, tw, lane);
      const float* wa = wl + (seq * 2 + prev) * K;
      const float* wb = wr + (seq * 2 + shape) * K;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = lane + 32 * t + 64 * q;
          const float2 W = cmul(v[t][q], __ldg(tw + TW_POST_L + c));
          const float u = W.x, w = -W.y;  // t[512 + 2c], t[1535 - 2c]
          // first half: +f0 at p0, -f0 at p1 (c < 256, f0 = u), or v at
          // p1 and -v at p0; second half: the other sample at both
          const float fs = q < 4 ? u : w, ss = q < 4 ? w : u;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = slot_pos(lane, t, q, e);
            const bool neg = (q < 4) == (e == 1);
            const float f = __fmul_rn(neg ? -fs : fs, __ldg(wa + p));
            const float s = __fmul_rn(ss, __ldg(wb + p));
            float& sp = sprev[slot(t, q, e)][lane];
            if (emit) out[obase + p] = s16(__fadd_rn(f, sp));
            sp = s;
            if (last) carry_out[(size_t)ch * K + p] = s;
          }
        }
      continue;
    }

    // EIGHT_SHORT: window w's v[k] = (X_w[127 - 2k] + i X_w[2k]) pre[k];
    // X_w[127 - 2k] is the odd half of pair 63 - k: lane lane ^ 7 at
    // (t, 7 - r)
    float2 v[2][8];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float odd = __shfl_xor_sync(0xffffffffu, a[t][7 - r].y, 7);
        v[t][r] = cmul(make_float2(odd, a[t][r].x),
                       __ldg(tw + TW_PRE_S + (lane & 7) + 8 * r));
      }
    inverse_fft<false>(v, re, im, tw, lane);
    // (pass 1's reads are done) the scratch takes the windowed lefts
    // L[w][p] at 128 w + p and rights R[w][p] at 1024 + 128 w + p
    const float* shl = sh + shape * 128;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int w = (lane >> 3) + 4 * t;
      const float* shl_w = w == 0 ? sh + prev * 128 : shl;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = (lane & 7) + 8 * q;
        const float2 W = cmul(v[t][q], __ldg(tw + TW_POST_S + c));
        const float u = W.x, x = -W.y;  // t[64 + 2c], t[191 - 2c]
        const float fs = q < 4 ? u : x, ss = q < 4 ? x : u;
        const int p0 = q < 4 ? 64 + 2 * c : 2 * c - 64;
        const int p1 = q < 4 ? 63 - 2 * c : 191 - 2 * c;
        const float f0 = __fmul_rn(q < 4 ? fs : -fs, __ldg(shl_w + p0));
        const float f1 = __fmul_rn(q < 4 ? -fs : fs, __ldg(shl_w + p1));
        re[128 * w + p0] = f0;
        re[128 * w + p1] = f1;
        re[K + 128 * w + p0] = __fmul_rn(ss, __ldg(shl + 127 - p0));
        re[K + 128 * w + p1] = __fmul_rn(ss, __ldg(shl + 127 - p1));
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = slot_pos(lane, t, q, e);
          float fv[2];  // frame[p], frame[1024 + p]
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int qq = p + h * K - 448;
            const int j = qq >> 7, o = qq & 127;
            float val = 0.f;
            if (qq >= 0 && j == 0) {
              val = re[o];
            } else if (j == 8) {
              val = re[K + 7 * 128 + o];
            } else if (qq >= 0 && j < 8) {
              val = __fadd_rn(re[K + (j - 1) * 128 + o], re[j * 128 + o]);
            }
            fv[h] = val;
          }
          float& sp = sprev[slot(t, q, e)][lane];
          if (emit) out[obase + p] = s16(__fadd_rn(fv[0], sp));
          sp = fv[1];
          if (last) carry_out[(size_t)ch * K + p] = fv[1];
        }
  }
}

}  // namespace

// spec: [B*L, 1024] float32 (8-byte aligned); meta: [B*L, 3] int32
// (window_sequence, window_shape, previous shape); carry: [L, 1024]; run:
// frames a warp takes (>= 1); tw: [1728, 2] twiddles
// (codecs/aac/synth.py k7_twiddles); wl, wr: [4, 2, 1024] half windows;
// sh: [2, 128] short halves; out: [B*L, 1024]; carry_out: [L, 1024].
extern "C" int iamf_k7_aac_synth(const void* spec, const void* meta,
                                 const void* carry, int B, int L, int run,
                                 const void* tw, const void* wl,
                                 const void* wr, const void* sh, void* out,
                                 void* carry_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || run < 1) return (int)cudaErrorInvalidValue;
  const long long items = (long long)L * ((B + run - 1) / run);
  k7_synth<<<(unsigned)((items + WARPS - 1) / WARPS), WARPS * 32, 0, s>>>(
      (const float2*)spec, (const int*)meta, (const float*)carry, B, L, run,
      (const float2*)tw, (const float*)wl, (const float*)wr,
      (const float*)sh, (float*)out, (float*)carry_out);
  return (int)cudaGetLastError();
}

// Warps of k7_synth that card `device` holds at once: its SMs times the
// CTAs of WARPS warps an SM holds, as the runtime reports them for the
// built kernel (its registers and shared memory decide; on an H100 SXM
// 132 x 2 x 4 = 1056). codecs/aac/synth.py k7_run spreads a batch over
// them. 0 on an error.
extern "C" int iamf_k7_fill(int device) {
  int prev = 0, sms = 0, ctas = 0;
  if (cudaGetDevice(&prev) != cudaSuccess ||
      cudaSetDevice(device) != cudaSuccess)
    return 0;
  const bool ok =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, k7_synth,
                                                    WARPS * 32, 0) ==
          cudaSuccess;
  cudaSetDevice(prev);
  return ok ? sms * ctas * WARPS : 0;
}
