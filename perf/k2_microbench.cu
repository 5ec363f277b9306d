// What a dependent step of K2's phase A costs on the card, with nothing
// else around it: one warp combs chunks of `chunk` samples whose taps
// (lag = chunk + 2) are the previous step's outputs, through a shared-memory
// ring as csrc/comb_deemph.cu does; then block steps, one sample a thread
// and a barrier. Prints cycles per step (clock()). Built and run by
// perf/k2_phase_a.py:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false \
//        -o k2_microbench perf/k2_microbench.cu && ./k2_microbench
#include <cstdio>
#include <cuda_runtime.h>

constexpr int RING = 2048, HIST = 1032, MIRROR = 4;
constexpr unsigned FULL = 0xffffffffu;

enum Variant {
  COMB,     // the comb's sample: 5 taps, six terms, stored to the ring
  ONE_TAP,  // one tap, one product, one sum
  NO_SYNC,  // COMB without __syncwarp()
  SHFL,     // taps of the last two steps by warp shuffle, older ones loaded
  SHFL_ONLY // every tap by shuffle (no load at all)
};

__device__ __forceinline__ void put(float* ring, int j, float v) {
  const int s = (j + HIST) & (RING - 1);
  ring[s] = v;
  if (s < MIRROR) ring[RING + s] = v;
}

__device__ __forceinline__ float comb(float x, const float* a, float g0,
                                      float g1, float g2, float zero) {
  float o = __fadd_rn(x, __fmul_rn(g0, a[2]));
  o = __fadd_rn(o, __fmul_rn(g1, __fadd_rn(a[3], a[1])));
  o = __fadd_rn(o, __fmul_rn(g2, __fadd_rn(a[4], a[0])));
  o = __fadd_rn(o, __fmul_rn(zero, a[2]));
  o = __fadd_rn(o, __fmul_rn(zero, __fadd_rn(a[3], a[1])));
  return __fadd_rn(o, __fmul_rn(zero, __fadd_rn(a[4], a[0])));
}

template <int V>
__global__ void warp_steps(float* io, unsigned* cyc, int chunk, int nsteps) {
  __shared__ float ring[RING + MIRROR];
  __shared__ float yf[1024];
  const int t = threadIdx.x;
  for (int i = t; i < RING + MIRROR; i += blockDim.x) ring[i] = i * 1e-3f;
  for (int i = t; i < 1024; i += blockDim.x) yf[i] = i * 1e-2f;
  __syncthreads();
  const int lag = chunk + 2;
  const float g0 = io[0], g1 = io[1], g2 = io[2], zero = io[3];
  const unsigned c0 = clock();
  if (t < 32) {
    // w1, w2: this lane's outputs of the last two steps (SHFL variants)
    float w1 = ring[(t - chunk + HIST) & (RING - 1)];
    float w2 = ring[(t - 2 * chunk + HIST) & (RING - 1)];
    for (int st = 0, p0 = 0; st < nsteps; ++st, p0 += chunk) {
      const int p = p0 + t;
      const float x = yf[p & 1023];
      const float* r = ring + ((p + HIST - lag - 2) & (RING - 1));
      if (V == SHFL || V == SHFL_ONLY) {
        float a[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const int back = lag + 2 - k - t;  // how far back tap k lies
          const float v1 = __shfl_sync(FULL, w1, chunk - back);
          const float v2 = __shfl_sync(FULL, w2, 2 * chunk - back);
          a[k] = back <= chunk ? v1
                 : (V == SHFL_ONLY || back <= 2 * chunk) ? v2 : r[k];
        }
        const float o = comb(x, a, g0, g1, g2, zero);
        if (t < chunk) put(ring, p, o);
        w2 = w1;
        w1 = o;
        continue;
      }
      if (t < chunk) {
        float o;
        if (V == ONE_TAP) {
          o = __fadd_rn(x, __fmul_rn(g0, r[2]));
        } else {
          float a[5];
#pragma unroll
          for (int k = 0; k < 5; ++k) a[k] = r[k];
          o = comb(x, a, g0, g1, g2, zero);
        }
        put(ring, p, o);
      }
      if (V != NO_SYNC) __syncwarp();
    }
  }
  __syncthreads();
  if (t == 0) {
    cyc[0] = clock() - c0;
    io[4] = ring[5];
  }
}

// block steps: every thread one sample a step, then a barrier
__global__ void block_steps(float* io, unsigned* cyc, int nsteps) {
  __shared__ float ring[RING + MIRROR];
  const int t = threadIdx.x;
  for (int i = t; i < RING + MIRROR; i += blockDim.x) ring[i] = i * 1e-3f;
  __syncthreads();
  const int n = blockDim.x, lag = n + 2;
  const float g0 = io[0];
  const unsigned c0 = clock();
  for (int st = 0, p0 = 0; st < nsteps; ++st, p0 += n) {
    const int p = p0 + t;
    const float* r = ring + ((p + HIST - lag - 2) & (RING - 1));
    put(ring, p, __fadd_rn(__fmul_rn(g0, r[2]), __fadd_rn(r[1], r[3])));
    __syncthreads();
  }
  if (t == 0) {
    cyc[0] = clock() - c0;
    io[4] = ring[5];
  }
}

template <int V>
double per_step(float* io, unsigned* cyc, int threads, int chunk, int n) {
  warp_steps<V><<<1, threads>>>(io, cyc, chunk, n);
  unsigned h = 0;
  cudaMemcpy(&h, cyc, 4, cudaMemcpyDeviceToHost);
  return h / (double)n;
}

int main() {
  float* io;
  unsigned* cyc;
  cudaMalloc(&io, 64);
  cudaMalloc(&cyc, 8);
  const float h[8] = {0.3f, 0.2f, 0.1f, 0.f, 0.f, 0.f, 0.f, 0.f};
  cudaMemcpy(io, h, sizeof h, cudaMemcpyHostToDevice);
  const int N = 4000;
  per_step<COMB>(io, cyc, 256, 16, N);  // warm-up
  printf("warp step, cycles (chunk 16, block of 256): comb %.1f, one tap "
         "%.1f, comb without __syncwarp %.1f, comb at chunk 32 (no idle "
         "lane) %.1f\n",
         per_step<COMB>(io, cyc, 256, 16, N), per_step<ONE_TAP>(io, cyc, 256, 16, N),
         per_step<NO_SYNC>(io, cyc, 256, 16, N), per_step<COMB>(io, cyc, 256, 32, N));
  printf("warp step, cycles, taps of the last two steps by shuffle: %.1f "
         "(chunk 16), %.1f (chunk 32); every tap by shuffle: %.1f\n",
         per_step<SHFL>(io, cyc, 256, 16, N), per_step<SHFL>(io, cyc, 256, 32, N),
         per_step<SHFL_ONLY>(io, cyc, 256, 16, N));
  for (int nw : {1, 2, 4, 8, 16}) {
    block_steps<<<1, nw * 32>>>(io, cyc, N);
    unsigned c = 0;
    cudaMemcpy(&c, cyc, 4, cudaMemcpyDeviceToHost);
    printf("block step of %2d warps (one sample a thread, __syncthreads): "
           "%.1f cycles\n", nw, c / (double)N);
  }
  const cudaError_t e = cudaDeviceSynchronize();
  printf("cuda: %s\n", cudaGetErrorString(e));
  return e != cudaSuccess;
}
