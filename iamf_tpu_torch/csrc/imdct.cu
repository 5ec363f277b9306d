// K1: CELT-960 IMDCT + TDAC overlap as folded constant products.
//
// Replaces the one Pallas kernel of the reference,
// iamf_tpu/codecs/opus/pallas_imdct.py fused_imdct_overlap / _kernel
// (constants from _fused_mats). Every output sample of a frame is linear in
// (spectrum, previous frame's raw 60-sample tail), so
//     y     = freq . A_mode^T + tail_in . C_mode^T   (mode = long | short)
//     tail' = freq . D_mode^T
// with A [960,960], C [960,60], D [60,960] per mode, built in float64 and
// rounded once to float32 on the host (codecs/opus/imdct.py fused_mats).
//
// Design for Hopper, not a copy of the TPU kernel:
// - The TPU kernel walks frames in grid order to carry the tail in VMEM and
//   computes BOTH modes' products, selecting afterwards. Here frame b's
//   incoming tail is just freq[b-1] . D_{mode(b-1)}^T (tail0 for b = 0), so
//   pass 1 computes every row's 60-wide tail, after which all B*L rows are
//   independent.
// - Rows are partitioned by mode into two index lists (atomic slots; the
//   order inside a list does not change any result), and pass 2 is one
//   shared-memory-tiled fp32 product per mode over K = 960 + 60 (spectrum
//   then incoming tail), each row multiplied by its own mode's matrix only.
//
// What bounds it: at B = 128, L = 12 pass 2 is 1536 x 960 x 1020 x 2 =
// 3.0 GFLOP against ~20 MB of traffic (spectra in, PCM out, 7.6 MB of
// constants mostly from L2), about 150 FLOP/byte. TF32 is not allowed (the
// reference contracts at Precision.HIGHEST), so it is compute-bound on the
// fp32 CUDA cores. The tile loop below (64x64 block tile, 4x4 per thread,
// fmaf) is the simple first version; larger register tiles, vector loads
// and double-buffered shared memory are later work.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int N = 960;
constexpr int OVER = 60;
constexpr int KTOT = N + OVER;
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int TR = 12;                          // rows per tails block

__global__ void partition_rows(const uint8_t* __restrict__ trans, int R,
                               int* __restrict__ lists,
                               int* __restrict__ counts) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  int m = trans[r] != 0;
  int slot = atomicAdd(&counts[m], 1);
  lists[m * R + slot] = r;
}

// pass 1: tails[r, j] = sum_k freq[r, k] * DT_mode(r)[k, j], j < 60
__global__ void tails_kernel(const float* __restrict__ freq, int ld,
                             const uint8_t* __restrict__ trans, int R,
                             const float* __restrict__ dtl,
                             const float* __restrict__ dts,
                             float* __restrict__ tails) {
  __shared__ float f[TR][N];
  const int r0 = blockIdx.x * TR;
  for (int e = threadIdx.x; e < TR * N; e += blockDim.x) {
    int i = e / N, k = e - i * N, r = r0 + i;
    f[i][k] = r < R ? freq[(size_t)r * ld + k] : 0.f;
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= OVER) return;
  bool shortm[TR];
  float acc[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    shortm[i] = r0 + i < R && trans[r0 + i] != 0;
    acc[i] = 0.f;
  }
  for (int k = 0; k < N; ++k) {
    float dl = dtl[k * OVER + j], ds = dts[k * OVER + j];
#pragma unroll
    for (int i = 0; i < TR; ++i) acc[i] = fmaf(f[i][k], shortm[i] ? ds : dl, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
    if (r0 + i < R) tails[(size_t)(r0 + i) * OVER + j] = acc[i];
}

// pass 2: y[r] = [freq[r] | tail_in[r]] . [A_mode^T ; C_mode^T]
__global__ void __launch_bounds__(THREADS)
product_kernel(const float* __restrict__ freq, int ld,
               const float* __restrict__ tails,
               const float* __restrict__ tail0, int L, int R,
               const int* __restrict__ lists, const int* __restrict__ counts,
               const float* __restrict__ atl, const float* __restrict__ ats,
               const float* __restrict__ ctl, const float* __restrict__ cts,
               float* __restrict__ y) {
  const int mode = blockIdx.z;
  const int cnt = counts[mode];
  const int m0 = blockIdx.x * BM;
  if (m0 >= cnt) return;
  const int n0 = blockIdx.y * BN;
  const float* __restrict__ at = mode ? ats : atl;
  const float* __restrict__ ct = mode ? cts : ctl;

  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  __shared__ const float* arow[BM];
  __shared__ const float* trow[BM];
  __shared__ int orow[BM];

  const int tid = threadIdx.x;
  if (tid < BM) {
    int i = m0 + tid;
    if (i < cnt) {
      int r = lists[mode * R + i];
      orow[tid] = r;
      arow[tid] = freq + (size_t)r * ld;
      // row r = b*L + l: frame b > 0 takes frame b-1's tail, b = 0 tail0[l]
      trow[tid] = r >= L ? tails + (size_t)(r - L) * OVER
                         : tail0 + (size_t)r * OVER;
    } else {
      orow[tid] = -1;
      arow[tid] = nullptr;
      trow[tid] = nullptr;
    }
  }
  __syncthreads();

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < KTOT; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      int mi = e / BK, kk = e - mi * BK, k = k0 + kk;
      float v = 0.f;
      if (arow[mi] != nullptr && k < KTOT)
        v = k < N ? arow[mi][k] : trow[mi][k - N];
      As[kk][mi] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      int kk = e / BN, ni = e - kk * BN, k = k0 + kk;
      float v = 0.f;
      if (k < N)
        v = at[(size_t)k * N + n0 + ni];
      else if (k < KTOT)
        v = ct[(size_t)(k - N) * N + n0 + ni];
      Bs[kk][ni] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = orow[ty * TM + i];
    if (r < 0) continue;
    float* out = y + (size_t)r * N + n0 + tx * TN;
#pragma unroll
    for (int j = 0; j < TN; ++j) out[j] = acc[i][j];
  }
}

}  // namespace

// freq: [B*L rows] of >= 960 floats, row stride ld (the packed spectra
// buffer is read in place); trans: [B*L] uint8; tail0: [L, 60];
// at*/ct*/dt*: [960,960] / [60,960] / [960,60] fused constants (k-major);
// y: [B*L, 960]; tails: [B*L, 60] (row (B-1)*L+l is lane l's new tail);
// lists: int[2*B*L], counts: int[2] scratch.
extern "C" int iamf_k1_imdct(const void* freq, int ld, const void* trans,
                             const void* tail0, int B, int L,
                             const void* atl, const void* ats,
                             const void* ctl, const void* cts,
                             const void* dtl, const void* dts, void* y,
                             void* tails, void* lists, void* counts,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * L;
  cudaError_t e = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  partition_rows<<<(R + 255) / 256, 256, 0, s>>>(
      (const uint8_t*)trans, R, (int*)lists, (int*)counts);
  tails_kernel<<<(R + TR - 1) / TR, 64, 0, s>>>(
      (const float*)freq, ld, (const uint8_t*)trans, R, (const float*)dtl,
      (const float*)dts, (float*)tails);
  dim3 grid((R + BM - 1) / BM, N / BN, 2);
  product_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)freq, ld, (const float*)tails, (const float*)tail0, L, R,
      (const int*)lists, (const int*)counts, (const float*)atl,
      (const float*)ats, (const float*)ctl, (const float*)cts, (float*)y);
  return (int)cudaGetLastError();
}
