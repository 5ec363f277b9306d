// K3: look-ahead peak limiter + quantize/interleave for one decode batch of
// S streams (the stream axis of the multi-stream server, core/serving.py;
// S = 1 for one decoder).
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
//   1. parallel: S (seq_peaks: the ring, then max_c |x[c, n]|, or with
//      the true-peak meter K9's peaks, csrc/truepeak.cu), then per sample
//      the sliding-window max W[k] = max S[k:k+D], the trigger's target
//      end gain R[k] = thr / W[k] (IEEE division, as the recurrence
//      computes it), and one flag per tile of TS samples, set when a W in
//      the tile exceeds thr;
//   2. gain_walk: the attack/release recurrence of _gain_step over the
//      batch's N samples, bit for bit (below);
//   3. parallel: y = delayed * gain, scale by 2^(bits-1), clip, rint
//      (half to even), interleave to [N, C] int; new delay line, peak ring
//      and entry index.
//
// Phase 2. The envelope's time tc is -1 (idle) or T[m], m steps after the
// last trigger: T[0] = 0, T[m+1] = fl(T[m] + inc), held at T[M], the first
// value >= fl(rel + atk). So everything in a step that does not depend on
// the gain is a table indexed by m (dsp/limiter.walk_tables builds them in
// float32 on the host, with the same IEEE roundings): coef[m] =
// -curve_accel(T[m] / atk) for the attack steps m <= A and
// curve_accel((T[m] - atk) / rel) for the release steps A < m <= M, and 1
// past M. The gain after m <= M steps is
//     m <  A:  fl(tsg + fl(coef[m+1] * fl(tsg - teg)))   (attack)
//     else:    fl(teg + fl(coef[m+1] * fl(1 - teg)))     (release)
// (a - b*c == a + (-b)*c exactly in round-to-nearest). At m = M that is
// fl(teg + fl(1 - teg)) = 1 exactly, the reference's settled gain, for
// every teg a trigger sets (thr / W with W > thr, so 0 < teg < 1) and for
// the idle marker teg = -1; so no step tests for "settled". A trigger,
// fl(W[k] * g) > thr, restarts the envelope at m = 0 with tsg = g,
// teg = R[k]. The serial step holds no division, no shuffle and no branch
// on a float: the gain of the next step is computed both ways (the
// trigger's from g, the other from the state alone) and selected, and the
// coefficient a step reads was loaded from shared memory two steps before
// (coef[2], coef[3], for the two steps after a trigger, live in registers),
// so no load latency sits in the chain.
//
// One block of two warps. Warp 1 produces: one thread streams the tables,
// then the W and R tiles of every flagged tile, into shared memory with
// cp.async.bulk (TMA 1D bulk copies) completing on mbarriers, NS tiles in
// flight; the warp stores the gains the chain leaves in the ring. Warp 0
// walks: its lanes hold the same state and run the same instruction stream
// (one chain; the peak needs no shuffle), one step per sample over a
// flagged tile. A tile whose flag is clear cannot trigger (g <= 1, so
// fl(W * g) <= W <= thr): with the envelope settled or idle its gains are
// all 1, so the tile is marked as such and phase 3 reads no gain for it;
// otherwise the chain walks it as any other, from a tile of zeros in
// place of its W (no trigger either way), its gains stored straight to
// global memory.
//
// Streams. Every array has a leading stream axis, and every phase indexes
// the stream by a grid dimension: phases 1 and 3 by blockIdx.y, the walk
// by blockIdx.x, one block a stream. The peak is a maximum over one
// stream's channels, so each stream has its own gain walk, and the S walks
// run on S SMs at once; the walk tables are shared (one LimiterConfig for
// all S). A stream's arithmetic does not depend on S, so each stream's
// output and state equal those of an S = 1 call on its slice, bit for bit.
//
// What bounds it: phase 2 is a dependency chain of one step per sample
// wherever a tile holds a peak over the threshold (on loud content a
// retrigger every ~1.6 samples, so no search ahead pays): about 25 issued
// instructions a step, all from registers and shared memory, of which nine
// depend on each other from one trigger test to the next (select m, m + 1,
// attack test, select, multiply, add, the trigger's add, W * g, compare),
// so a step takes ~40 cycles on an H100 (PERF.md). Phases 1 and 3 move
// ~12 MB per batch (a few microseconds of HBM time).

#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WT = 256;  // window-max outputs per block
constexpr int TS = 1024;  // samples per tile of the walk (a multiple of WT)
constexpr int NS = 4;     // ring slots: tiles in flight
constexpr unsigned FULL = 0xffffffffu;

// S[i] = peak_data[(idx + i) % D] for i < D, else max_c |x[c, i - D]| or,
// with the true-peak meter, pk[i - D]; also clears the tile flags
// window_max sets
__global__ void seq_peaks(const float* __restrict__ x, int C, int N,
                          const float* __restrict__ pk,
                          const float* __restrict__ peak, const int* __restrict__ eidx,
                          int D, float* __restrict__ S, int* __restrict__ flags,
                          int ntiles, size_t ss) {
  const int st = blockIdx.y;  // the stream
  x += (size_t)st * C * N;
  if (pk != nullptr) pk += (size_t)st * N;
  peak += (size_t)st * D;
  eidx += st;
  S += st * ss;
  flags = reinterpret_cast<int*>(reinterpret_cast<float*>(flags) + st * ss);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < ntiles) flags[i] = 0;
  if (i >= D + N) return;
  if (i < D) {
    S[i] = peak[(*eidx + i) % D];
    return;
  }
  int n = i - D;
  if (pk != nullptr) {
    S[i] = pk[n];
    return;
  }
  float mx = 0.f;
  for (int c = 0; c < C; ++c) mx = fmaxf(mx, fabsf(x[(size_t)c * N + n]));
  S[i] = mx;
}

__global__ void window_max(const float* __restrict__ S, int N, int D, float thr,
                           float* __restrict__ W, float* __restrict__ R,
                           int* __restrict__ flags, size_t ss) {
  extern __shared__ float s[];  // WT + D
  const size_t so = blockIdx.y * ss;  // the stream's scratch
  S += so;
  W += so;
  R += so;
  flags = reinterpret_cast<int*>(reinterpret_cast<float*>(flags) + so);
  const int k0 = blockIdx.x * WT;
  for (int i = threadIdx.x; i < WT + D; i += blockDim.x) {
    int g = k0 + i;
    s[i] = g < N + D ? S[g] : 0.f;
  }
  __syncthreads();
  const int k = k0 + threadIdx.x;
  float mx = 0.f;
  if (k < N) {
    mx = s[threadIdx.x];
    for (int d = 1; d < D; ++d) mx = fmaxf(mx, s[threadIdx.x + d]);
    W[k] = mx;
    R[k] = __fdiv_rn(thr, mx);
  }
  if (__syncthreads_or(k < N && mx > thr) && threadIdx.x == 0)
    atomicOr(&flags[k0 / TS], 1);
}

// The chain's state: the envelope's endpoints, the two differences a step
// multiplies (fixed between triggers), and the step count m (M: settled or
// idle, gain 1).
struct Env {
  float tsg, teg, dA, dR;
  int m;
};

// gain of the step taken from count m <= M
__device__ __forceinline__ float env_gain(const Env& e, const float* sC, int A) {
  const bool att = e.m < A;
  return __fadd_rn(att ? e.tsg : e.teg, __fmul_rn(sC[e.m + 1], att ? e.dA : e.dR));
}

// Walk the n samples of one flagged tile: sW/sR the tile's window maxima
// and target end gains, sG its gains. Returns the last step's gain.
__device__ __forceinline__ float walk_tile(Env& e, const float* sW,
                                           const float* sR, float* sG, int n,
                                           const float* sC, int M, int A,
                                           float thr, float C1, float C2,
                                           float C3) {
  float g = env_gain(e, sC, A);
  float tsg = e.tsg, teg = e.teg, dA = e.dA, dR = e.dR;
  int m = e.m;
  // coef[m + 2] for the first two steps (if no trigger comes before)
  float La = sC[m + 2], Lb = sC[m + 3];
  // one sample: g is this step's gain; leaves the next step's in g. L holds
  // coef[m + 2] as loaded two steps before, unless a trigger came since
  // (then m < 2); it is reloaded for the step after next.
  auto step = [&](float w, float r, float& L) {
    const float c = m == 0 ? C2 : m == 1 ? C3 : L;
    L = sC[m + 4];
    const int mn = min(m + 1, M);
    const bool att = mn < A;
    const float gN = __fadd_rn(att ? tsg : teg, __fmul_rn(c, att ? dA : dR));
    const bool trig = __fmul_rn(w, g) > thr;
    const float dAt = __fsub_rn(g, r);
    const float gT = __fadd_rn(g, __fmul_rn(C1, dAt));
    tsg = trig ? g : tsg;
    teg = trig ? r : teg;
    dA = trig ? dAt : dA;
    dR = trig ? __fsub_rn(1.f, r) : dR;
    m = trig ? 0 : mn;
    g = trig ? gT : gN;
  };
  float last = 1.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(sW + i);
    const float4 r4 = *reinterpret_cast<const float4*>(sR + i);
    float4 g4;
    g4.x = g;
    step(w4.x, r4.x, La);
    g4.y = g;
    step(w4.y, r4.y, Lb);
    g4.z = g;
    step(w4.z, r4.z, La);
    g4.w = g;
    step(w4.w, r4.w, Lb);
    *reinterpret_cast<float4*>(sG + i) = g4;
    last = g4.w;
  }
  // the last tile's tail (fewer than 4), keeping La/Lb's alternation
  if (i < n) {
    sG[i] = last = g;
    step(sW[i], sR[i], La);
    ++i;
  }
  if (i < n) {
    sG[i] = last = g;
    step(sW[i], sR[i], Lb);
    ++i;
  }
  if (i < n) {
    sG[i] = last = g;
    step(sW[i], sR[i], La);
  }
  e = Env{tsg, teg, dA, dR, m};
  return last;
}

// state: [current_gain, target_start_gain, target_end_gain, current_tc]
// tabT/tabC: T (held at T[M] past M) and coef (1 past M), MP >= M + 5
// floats each, a multiple of 4. W, R, gain: NP = ntiles * TS floats each
// (16-byte aligned). unit[t] = 1 marks a tile whose gains are all 1 (not
// written to gain). Block b walks stream b: its W, R, flags, gain and unit
// lie ss floats after stream b - 1's, its state 4 floats.
__global__ void __launch_bounds__(64, 1)
    gain_walk(const float* __restrict__ W, const float* __restrict__ R,
              const int* __restrict__ flags, int N,
              const float* __restrict__ tabT, const float* __restrict__ tabC,
              int M, int A, int MP, const float* __restrict__ st_in, float thr,
              float* __restrict__ gain, int* __restrict__ unit,
              float* __restrict__ st_out, size_t ss) {
  extern __shared__ __align__(16) float sm[];
  {
    const size_t so = blockIdx.x * ss;  // the stream's scratch and state
    W += so;
    R += so;
    gain += so;
    flags = reinterpret_cast<const int*>(reinterpret_cast<const float*>(flags) + so);
    unit = reinterpret_cast<int*>(reinterpret_cast<float*>(unit) + so);
    st_in += 4 * blockIdx.x;
    st_out += 4 * blockIdx.x;
  }
  float* sC = sm;  // first: its addresses are immediate offsets
  float* sT = sm + MP;
  float* ring = sT + MP;  // [NS][W | R | G][TS]
  float* sZ = ring + NS * 3 * TS;  // zeros: W and R of a flag-clear tile
  uint64_t* bar = reinterpret_cast<uint64_t*>(sZ + TS);
  int* sTile = reinterpret_cast<int*>(bar + 2 * NS + 1);
  // bar[s]: slot s's W and R arrived; bar[NS + s]: its gains are done;
  // bar[2 NS]: the tables arrived
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (N + TS - 1) / TS;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2 * NS + 1; ++b) mbar_init(smem_u32(&bar[b]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {  // producer
    if (lane == 0) {
      const uint32_t tb = smem_u32(&bar[2 * NS]);
      mbar_expect_tx(tb, 2u * MP * 4);
      bulk_load(smem_u32(sT), tabT, MP * 4, tb);
      bulk_load(smem_u32(sC), tabC, MP * 4, tb);
    }
    auto store = [&](int s) {
      const float4* src = reinterpret_cast<const float4*>(ring + (s * 3 + 2) * TS);
      float4* dst = reinterpret_cast<float4*>(gain + (size_t)sTile[s] * TS);
      for (int i = lane; i < TS / 4; i += 32) dst[i] = src[i];
    };
    int q = 0;  // flagged tiles issued
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      unsigned mask = __ballot_sync(FULL, t0 + lane < ntiles && flags[t0 + lane]);
      while (mask) {
        const int t = t0 + __ffs(mask) - 1;
        mask &= mask - 1;
        const int s = q % NS;
        if (q >= NS) {
          mbar_wait(smem_u32(&bar[NS + s]), (q / NS - 1) & 1);
          store(s);
          __syncwarp();
        }
        if (lane == 0) {
          sTile[s] = t;
          const uint32_t fb = smem_u32(&bar[s]);
          float* slot = ring + s * 3 * TS;
          mbar_expect_tx(fb, 2u * TS * 4);
          bulk_load(smem_u32(slot), W + (size_t)t * TS, TS * 4, fb);
          bulk_load(smem_u32(slot + TS), R + (size_t)t * TS, TS * 4, fb);
        }
        __syncwarp();
        ++q;
      }
    }
    for (int j = max(0, q - NS); j < q; ++j) {
      mbar_wait(smem_u32(&bar[NS + j % NS]), (j / NS) & 1);
      store(j % NS);
    }
    return;
  }

  // warp 0: the chain
  for (int i = lane; i < TS; i += 32) sZ[i] = 0.f;
  __syncwarp();
  mbar_wait(smem_u32(&bar[2 * NS]), 0);
  const float C1 = sC[1], C2 = sC[2], C3 = sC[3];
  const float tc0 = st_in[3];
  const bool idle0 = tc0 == -1.f;
  Env e;
  e.tsg = st_in[1];
  e.teg = idle0 ? -1.f : st_in[2];  // -1 marks "no trigger yet"
  e.dA = __fsub_rn(e.tsg, e.teg);
  e.dR = __fsub_rn(1.f, e.teg);
  e.m = M;
  if (!idle0) {  // tc0 is some T[m] (convert.limiter_state checks a foreign
                 // state): exact search in the increasing table
    int lo = 0, hi = M;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sT[mid] < tc0) lo = mid + 1; else hi = mid;
    }
    e.m = lo;
  }
  float last = st_in[0];
  int q = 0;  // flagged tiles walked
  for (int t0 = 0; t0 < ntiles; t0 += 32) {
    const unsigned mask =
        __ballot_sync(FULL, t0 + lane < ntiles && flags[t0 + lane]);
    const int t1 = min(t0 + 32, ntiles);
    for (int t = t0; t < t1; ++t) {
      const int n = min(TS, N - t * TS);
      if (mask >> (t - t0) & 1) {
        const int s = q % NS;
        mbar_wait(smem_u32(&bar[s]), (q / NS) & 1);
        const float* slot = ring + s * 3 * TS;
        last = walk_tile(e, slot, slot + TS, ring + (s * 3 + 2) * TS, n, sC,
                         M, A, thr, C1, C2, C3);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(smem_u32(&bar[NS + s]));
          unit[t] = 0;
        }
        ++q;
      } else if (e.m == M) {  // settled or idle: gain 1 throughout
        if (lane == 0) unit[t] = 1;
        last = 1.f;
      } else {  // no trigger possible: walked with W = 0
        last = walk_tile(e, sZ, sZ, gain + (size_t)t * TS, n, sC, M, A, thr,
                         C1, C2, C3);
        if (lane == 0) unit[t] = 0;
      }
    }
  }
  if (lane == 0) {
    const bool idle = idle0 && e.teg == -1.f;
    st_out[0] = last;
    st_out[1] = idle ? st_in[1] : e.tsg;
    st_out[2] = idle ? st_in[2] : e.teg;
    st_out[3] = idle ? -1.f : sT[e.m];
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
                               const int* __restrict__ unit,
                               const float* __restrict__ S, float scale,
                               float lo, float hi, int bits, void* __restrict__ out,
                               float* __restrict__ delay_out,
                               float* __restrict__ peak_out,
                               int* __restrict__ eidx_out, size_t ss) {
  const int st = blockIdx.y;  // the stream
  x += (size_t)st * C * N;
  delay += (size_t)st * C * D;
  eidx += st;
  gain += st * ss;
  unit = reinterpret_cast<const int*>(reinterpret_cast<const float*>(unit) + st * ss);
  S += st * ss;
  out = bits == 16 ? (void*)(static_cast<int16_t*>(out) + (size_t)st * N * C)
                   : (void*)(static_cast<int32_t*>(out) + (size_t)st * N * C);
  delay_out += (size_t)st * C * D;
  peak_out += (size_t)st * D;
  eidx_out += st;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int idx = *eidx;
  const int new_idx = (idx + N) % D;
  if (i < N * C) {
    const int n = i / C, c = i - n * C;
    const float g = unit[n / TS] ? 1.f : gain[n];
    float v = __fmul_rn(__fmul_rn(delayed(x, delay, idx, D, N, c, n), g), scale);
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

// shared memory gain_walk takes for tables of MP floats each
int walk_smem(int MP) {
  return (2 * MP + NS * 3 * TS + TS) * 4 + (2 * NS + 1) * 8 + NS * 4;
}

// scratch floats a stream takes: W, R and gain (NP = ntiles * TS each), S
// (D + N), flags and unit (ntiles each), rounded up to 16 bytes
// (dsp/limiter.k3_scratch)
size_t stream_scratch(int N, int D) {
  const size_t ntiles = (N + TS - 1) / TS;
  return (3 * ntiles * TS + D + N + 2 * ntiles + 3) / 4 * 4;
}

}  // namespace

// Every array has a leading axis of S streams: x: [S, C, N] planar mix;
// pk: [S, N] the true-peak meter's peaks (K9), or null for sample peaks;
// delay: [S, C, D]; peak: [S, D]; eidx: int[S]; st_in/st_out: float[S, 4]
// envelope state; tabT/tabC: walk tables shared by the streams (MP floats
// each, dsp/limiter.walk_tables, padded); scratch: float[S *
// stream_scratch(N, D)], 16-byte aligned; out: [S, N, C] int16 (bits 16)
// or int32; delay_out [S, C, D]; peak_out [S, D]; eidx_out int[S].
extern "C" int iamf_k3_limiter(const void* x, int nstreams, int C, int N,
                               const void* pk, const void* delay,
                               const void* peak, const void* eidx, int D,
                               const void* st_in, float thr, const void* tabT,
                               const void* tabC, int M, int A, int MP, int bits,
                               void* scratch, void* out, void* delay_out,
                               void* peak_out, void* eidx_out, void* st_out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nstreams < 1 || nstreams > 65535 || C < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (N + TS - 1) / TS;
  const size_t NP = (size_t)ntiles * TS;
  const size_t ss = stream_scratch(N, D);
  float* W = static_cast<float*>(scratch);
  float* R = W + NP;
  float* gain = R + NP;
  float* S = gain + NP;
  int* flags = reinterpret_cast<int*>(S + (D + N));
  int* unit = flags + ntiles;
  const float scale = (float)(1ll << (bits - 1));
  const float lo = -scale;
  const float hi = (float)((1ll << (bits - 1)) - 1);
  seq_peaks<<<dim3((D + N + 255) / 256, nstreams), 256, 0, s>>>(
      (const float*)x, C, N, (const float*)pk, (const float*)peak,
      (const int*)eidx, D, S, flags, ntiles, ss);
  window_max<<<dim3((N + WT - 1) / WT, nstreams), WT,
               (WT + D) * sizeof(float), s>>>(S, N, D, thr, W, R, flags, ss);
  const int smem = walk_smem(MP);
  cudaError_t err = cudaFuncSetAttribute(
      gain_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gain_walk<<<nstreams, 64, smem, s>>>(W, R, flags, N, (const float*)tabT,
                                       (const float*)tabC, M, A, MP,
                                       (const float*)st_in, thr, gain, unit,
                                       (float*)st_out, ss);
  const int work = N * C > C * D ? N * C : C * D;
  apply_quantize<<<dim3((work + 255) / 256, nstreams), 256, 0, s>>>(
      (const float*)x, C, N, (const float*)delay, (const int*)eidx, D, gain,
      unit, S, scale, lo, hi, bits, out, (float*)delay_out, (float*)peak_out,
      (int*)eidx_out, ss);
  return (int)cudaGetLastError();
}
