// Device helpers shared by the kernels that use Hopper's asynchronous
// copies and tensor cores: mbarriers, TMA (tensor maps and 1D bulk
// copies), and the split-TF32 wgmma product step of K1.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global to shared, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one box of a 2D tensor map at (k, n) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int n) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(n)
      : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128 B,
// 8-row groups 1024 B apart (SBO), LBO unused for this layout
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// keep the compiler from moving register reads or writes across an
// asynchronous wgmma that uses them
__device__ __forceinline__ void acc_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// d[64 x 64] = (SCALE_D ? d : 0) + a[64 x 8] . b[64 x 8]^T: a tf32 from
// registers (this thread's fragment), b tf32 from shared memory
template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(SCALE_D));
}

// One 32-deep k-step of a split-TF32 product for one warpgroup: the three
// products a_hi.b_hi + a_hi.b_lo + a_lo.b_hi of four 8-deep slices (12
// instructions) into a fresh partial `part`, B's hi and lo tiles (64 n x
// 32 k each, 128-byte swizzle) at shared addresses b_hi and b_lo.
__device__ __forceinline__ void split_tf32_step(float (&part)[32],
                                                const uint32_t (&ahi)[4][4],
                                                const uint32_t (&alo)[4][4],
                                                uint32_t b_hi, uint32_t b_lo) {
  acc_fence(part);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  wgmma_tf32<0>(part, ahi[0], sw128_desc(b_hi));
  wgmma_tf32<1>(part, ahi[0], sw128_desc(b_lo));
  wgmma_tf32<1>(part, alo[0], sw128_desc(b_hi));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) {  // 32 bytes of k per instruction
    const uint32_t o = kk * 32;
    wgmma_tf32<1>(part, ahi[kk], sw128_desc(b_hi + o));
    wgmma_tf32<1>(part, ahi[kk], sw128_desc(b_lo + o));
    wgmma_tf32<1>(part, alo[kk], sw128_desc(b_hi + o));
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// This thread's A fragments of one 32-deep k-step, split in TF32, from an
// fp32 tile of 64 rows `ld` floats apart. In the wgmma fragment of an
// 8-deep slice kk, thread (lane) holds rows g = lane/4 and g + 8 of its
// warp's 16 at k = lane%4 and lane%4 + 4; the staged tile holds them at 8
// consecutive floats, offset 8 (lane%4) + 2 kk + h for k = lane%4 + 4h (the
// B operand's columns are permuted to match on the host: k_order in
// codecs/opus/imdct.py).
__device__ __forceinline__ void load_frags(const float* tile, int ld, int warp,
                                           int lane, uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
  const float* r0 = tile + (warp * 16 + lane / 4) * ld + (lane % 4) * 8;
  const float* r1 = r0 + 8 * ld;
  float x[2][8];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float4 u = reinterpret_cast<const float4*>(r0)[q];
    const float4 v = reinterpret_cast<const float4*>(r1)[q];
    x[0][4 * q] = u.x, x[0][4 * q + 1] = u.y, x[0][4 * q + 2] = u.z,
    x[0][4 * q + 3] = u.w;
    x[1][4 * q] = v.x, x[1][4 * q + 1] = v.y, x[1][4 * q + 2] = v.z,
    x[1][4 * q + 3] = v.w;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a0 (g, k), a1 (g+8, k), a2, a3 at k+4
      const float v = x[i & 1][2 * kk + (i >> 1)];
      const float h = tf32_rna(v);
      hi[kk][i] = __float_as_uint(h);
      lo[kk][i] = __float_as_uint(tf32_rna(__fsub_rn(v, h)));
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no link against libcuda)
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? (EncodeTiled)p
               : nullptr;
  }();
  return fn;
}

// tensor map of a row-major float32 [rows, cols] matrix in boxes of
// box_rows x box_cols, 128-byte swizzle (box_cols * 4 == 128)
inline bool tiled_map(const void* w, int rows, int cols, int box_rows,
                      int box_cols, CUtensorMap* out) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(w),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
