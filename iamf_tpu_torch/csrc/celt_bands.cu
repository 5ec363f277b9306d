// K13: the packed mono band walk of CELT frames (LM = 3, C = 1), a cluster
// of four CTAs a frame.
//
// Replaces iamf_tpu/codecs/opus/device_bands.py run_frame (jitted): a
// 21-band loop over band_pack's flattened tables that threads the
// collapse masks [21], the LCG seed and the norm buffer [800] from band
// to band. In band i of N bins at offset a:
//   - the entry fill: the OR of the collapse masks of bands [fs, fe)
//     (with a lowband), else (1 << B_in) - 1;
//   - the fold source: the window of the norm buffer at eff (its start
//     clamped into the buffer padded by W zeros, as dynamic_slice does)
//     through the band's lowband pre-transform, an [N, N] matrix of the
//     configuration bank;
//   - 16 leaf slots, in order: a slot's fill is its 16-column OR-map of
//     the entry fill; a PVQ slot (k > 0) places its leaf vector, a q0
//     slot noise (LCG draws by jump-ahead from the band's prefix of
//     draws, (int)v >> 20) or the fold source shifted by off (window
//     start clamped likewise) plus or minus 1/256 (bit 15 of the draw),
//     renormalized to its gain; bin j of a slot lands at (j + off) mod N
//     (jnp.roll); its collapse bits are the blocks (j b_leaf / n) that
//     hold energy, or its fill, shifted by cm_shift;
//   - the seed advances by the band's draws; the upward transform is the
//     band's post matrix; the collapse mask is the band's cm OR-map of
//     the slots' bits masked to its blocks; sqrt(N) X goes to the norm
//     buffer unless the band is the last.
//
// What bounds it: the walk is sequential in the bands, so a frame is a
// chain of 21 bands, each two [N, N] matvecs and the slots' placement:
// latency, not bytes (a frame reads its packed tables, 0.2 MB, and two
// [N, N] matrices a band, at most 2 x 124 KB, and writes 3.3 KB). The
// design keeps global memory off that chain, spreads the matvecs and
// shortens every step of the walk:
//   - a cluster of four CTAs a frame (launched as 4 F CTAs): CTA q holds
//     the rows [q N/4, (q + 1) N/4) of the band's pre and post matrices
//     and computes those rows of each matvec; a row's four threads send
//     it to the four CTAs' copies of the result (the fold window's
//     transform, the norm buffer), the CTA's own by a shared store, the
//     others' as asynchronous remote stores (st.async) whose bytes the
//     receiving CTA's mbarrier counts, so a CTA waits for the rows it
//     needs and nothing else; an arrival of each CTA a band on the norm
//     rows' mbarrier keeps a CTA from sending a band's rows while another
//     still reads the band before (on the H100, cluster barriers in
//     their place cost more, PERF.md); the rest of the walk runs the same
//     in each CTA, so it needs no exchange;
//   - its inputs arrive by bulk copy (TMA, completing on mbarriers) before
//     the chain needs them: the frame's slot fields and gains at the
//     start; each of the next band's matrix rows and fill maps as soon
//     as the band before has read its own, into a buffer of each; the
//     leaf vectors two bands ahead, into two buffers, the slots' values
//     taking their band's place; at about 106 KB a CTA, two CTAs share an
//     SM, so the frames of a call run in one wave (at one CTA an SM, 32
//     clusters of four did not);
//   - a matvec row takes four threads, thread r summing the partial over
//     j = 4u + r (u in order), each product and sum rounded on its own,
//     the partials met as ((p0 + p1) + (p2 + p3)): the roundings of a
//     thread a row with four partials, so the outputs equal the block-a-
//     frame design's bit for bit; the banks store each CTA's rows in the
//     order its threads read them ([N/4 u][N/4 rows][4 r]), so a warp
//     reads 32 consecutive floats;
//   - the LCG draws by jump composition: thread t keeps (A^(t+1),
//     B_(t+1)) and a slot's seed after its prefix of draws is staged, so
//     a draw is one multiply-add (no 33 KB jump table);
//   - sixteen lanes that no matvec uses (THREADS - 16 >= W), a lane a
//     slot, OR the band's collapse bits, advance the seed and stage the
//     next band's slots (fills, draws and their prefix) while the post
//     matvec runs; the slots' values are computed branch-free with their
//     energies' butterflies interleaved; a slot's gain once, by a lane;
//   - the placement is a gather: each thread adds into its target bin
//     the value of every active slot that lands there, in slot order
//     (the adds of the slot-by-slot scatter, in its order), behind one
//     barrier instead of one a slot.
// The reference's sums (its matvecs, a q0 slot's energy) run in XLA's
// order and the plain twin's in PyTorch's: results agree within rel 2e-5
// of the spectrum's peak; seeds and collapse masks are exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NBANDS = 21, SLOTS = 16, W = 176, NBINS = 800, NCFG = 14;
constexpr int LCG_MAX = 4096;
// CTAs a frame, each 1/CLUSTER of every matvec's rows (the banks' layout
// follows it, read from the library: iamf_k13_cluster)
constexpr int CLUSTER = 4;
constexpr int BIN_WARPS = (W + 31) / 32;     // the warps that hold bins
constexpr int MV = 4 * W / CLUSTER > W ? 4 * W / CLUSTER : W;  // row threads
constexpr int THREADS = (MV + 16 + 31) / 32 * 32;
constexpr int STAGE0 = THREADS - 16;  // a lane a slot: the stage lanes
constexpr int STAGER = 32;            // the thread that issues the copies
static_assert(SLOTS == 16 && STAGE0 >= MV && STAGE0 % 32 == 16,
              "the stage lanes are the upper half of a warp of no rows");
constexpr int QMAX = W * W / CLUSTER;  // a CTA's part of a matrix, at most

// band_replay.EBANDS; a band's bins at LM = 3 are 8 x its width (a CPU
// test holds this table to EBANDS)
__constant__ int EBANDS[NBANDS + 1] = {0,  1,  2,  3,  4,  5,  6,  7,
                                       8,  10, 12, 14, 16, 20, 24, 28,
                                       34, 40, 48, 60, 78, 100};

// celt_lcg_rand's map s -> A s + B (mod 2^32) applied 2^k times, k < 13
struct Jump {
  unsigned a[13], b[13];
};
constexpr Jump lcg_powers() {
  Jump j{};
  unsigned a = 1664525u, b = 1013904223u;
  for (int k = 0; k < 13; ++k) {
    j.a[k] = a;
    j.b[k] = b;
    b = a * b + b;
    a = a * a;
  }
  return j;
}
__constant__ Jump JUMP = lcg_powers();

// the seed after n <= LCG_MAX draws from s
__device__ __forceinline__ unsigned lcg_jump(unsigned s, int n) {
#pragma unroll
  for (int k = 0; k < 13; ++k)
    if ((n >> k) & 1) s = JUMP.a[k] * s + JUMP.b[k];
  return s;
}

// the packed tables' integer fields, each its own tensor (so that the
// wrapper launches nothing but K13): bt fields [F, 21], lt fields
// [F, 21, 16]
enum { PRESENT, HAS_LB, EFF, FS, FE, LAST, B_IN, CFG_ID, NBT };
enum { LN, LK, LOFF, LBL, LCMS, NLT };
struct Fields {
  const int* bt[NBT];
  const int* lt[NLT];
};
// the mbarriers: the frame's slot fields; a band's inputs; and, by band
// parity, the rows of the transformed window (LB) and of the norm buffer
// (NM) that the cluster's CTAs send each other (NM also counts an arrival
// of each CTA a band: it has sent its rows and read its window)
enum { BAR_TAB, BAR_PRE, BAR_POST, BAR_VEC, BAR_FILL = BAR_VEC + 2,
       BAR_LB = BAR_FILL + 2, BAR_NM = BAR_LB + 2, NBAR = BAR_NM + 2 };

// a CTA's shared memory
struct Smem {
  // the frame's tables, and what the slots' fields give before the walk
  alignas(16) int lt[NLT][NBANDS * SLOTS];
  alignas(16) float gain[NBANDS * SLOTS];
  alignas(16) int src[NBANDS * SLOTS];         // off mod N (C's sign)
  alignas(16) int fold[NBANDS * SLOTS];        // the fold window's start, off in [0, W]
  alignas(16) unsigned magic[NBANDS * SLOTS];  // ceil(2^32 / n) for n in [2, 2^16), or 0
  alignas(16) unsigned cm[NBANDS][16];  // a band's cm OR-map
  int bt[NBT][NBANDS];
  unsigned bm[NBANDS];
  float sq[NBANDS];
  int nact[NBANDS];  // 1 + the band's last active slot
  int span[NBANDS];  // the bins that can hold a value: max(N, n), <= W
  // a band's inputs: the fill maps and the leaf vectors (which the slots'
  // values before their gains replace) by band parity, the matrices one a
  // band
  alignas(16) unsigned fill[2][SLOTS * 16];
  alignas(16) float vec[2][SLOTS * W];
  alignas(16) float pre[QMAX], post[QMAX];  // this CTA's rows
  // the walk
  alignas(16) float norm[NBINS];
  alignas(16) float lbraw[W];
  alignas(16) float lbcat[2 * W];   // the transformed window, then W zeros
  alignas(16) float X[W];
  float red[SLOTS][BIN_WARPS];
  unsigned collapse[NBANDS];
  // the band's slots as the stage lanes leave them
  alignas(16) int prefix_s[SLOTS];
  alignas(16) unsigned f2_s[SLOTS];
  alignas(16) unsigned seedp_s[SLOTS];  // the seed after the slot's prefix
  alignas(16) float g_s[SLOTS];
  unsigned cm_pvq[SLOTS];
  unsigned seed_s;  // the band's entry seed
  int tot_s;        // the band's draws
  alignas(8) unsigned long long bar[NBAR];
};

// u32 x << s as XLA's shift_left: 0 for a shift outside [0, 32)
__device__ __forceinline__ unsigned shl32(unsigned x, int s) {
  return (s >= 0 && s < 32) ? x << s : 0u;
}

// the OR of cols[i] over the bits i set in v (cols: 16 u32 in shared
// memory, 64-byte aligned, read as four vectors)
__device__ __forceinline__ unsigned apply_cols16(const unsigned* cols,
                                                 unsigned v) {
  unsigned c[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 u = reinterpret_cast<const uint4*>(cols)[q];
    c[4 * q] = u.x;
    c[4 * q + 1] = u.y;
    c[4 * q + 2] = u.z;
    c[4 * q + 3] = u.w;
  }
  unsigned out = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if ((v >> i) & 1u) out |= c[i];
  return out;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// a band's 16 slot fields from shared memory (64-byte aligned), as four
// vectors, so that every slot's value is in flight together
template <typename T, typename V>
__device__ __forceinline__ void load16(const T* p, T (&out)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const V u = reinterpret_cast<const V*>(p)[c];
    out[4 * c] = u.x;
    out[4 * c + 1] = u.y;
    out[4 * c + 2] = u.z;
    out[4 * c + 3] = u.w;
  }
}
__device__ __forceinline__ void load16(const int* p, int (&out)[16]) {
  load16<int, int4>(p, out);
}
__device__ __forceinline__ void load16(const unsigned* p,
                                       unsigned (&out)[16]) {
  load16<unsigned, uint4>(p, out);
}
__device__ __forceinline__ void load16(const float* p, float (&out)[16]) {
  load16<float, float4>(p, out);
}

__device__ __forceinline__ int band_n(int i) {
  return 8 * (EBANDS[i + 1] - EBANDS[i]);
}

// the address in CTA `rank`'s shared memory of this CTA's shared address a
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// v to a float of another CTA's shared memory (cluster address dst), its
// bytes counted on that CTA's mbarrier (cluster address bar)
__device__ __forceinline__ void st_async(uint32_t dst, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// an arrival on another CTA's mbarrier (cluster address bar)
__device__ __forceinline__ void remote_arrive(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}

// the phase `parity` of an exchange's mbarrier, the cluster's writes
// acquired; a trap, not a hang, if it has not completed after ~2^31 cycles
__device__ __forceinline__ void exch_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 31)) __trap();
  } while (!done);
}

// band i's expected exchange bytes from the other CTAs (an arrival each):
// their rows of its window if it folds, of its norm rows unless it is
// absent or the last
__device__ __forceinline__ void expect_rows(Smem& S, int i) {
  const int N = band_n(i), peers = (N - N / CLUSTER) * 4;
  const bool present = S.bt[PRESENT][i] > 0;
  mbar_expect_tx(smem_u32(&S.bar[BAR_LB + (i & 1)]),
                 present && S.bt[HAS_LB][i] > 0 ? peers : 0);
  mbar_expect_tx(smem_u32(&S.bar[BAR_NM + (i & 1)]),
                 present && S.bt[LAST][i] == 0 ? peers : 0);
}

// Row t >> 2 of this CTA's part mp of a matrix (R = N / CLUSTER rows,
// stored [u][row][r]) times x, for threads t < 4 R: thread r = t & 3 sums
// m[row][4u + r] x[4u + r] over u in order, each product and sum rounded
// on its own; the four partials meet as ((p0 + p1) + (p2 + p3)), which
// every thread of the row's four then holds.
__device__ __forceinline__ float part_row(const float* mp, const float* x,
                                          int N, int t) {
  const int R4 = 4 * (N / CLUSTER), r = t & 3;
  const float* m = mp + (t >> 2) * 4 + r;
  float acc = 0.f;
#pragma unroll 4
  for (int u = 0; u < N / 4; ++u)
    acc = __fadd_rn(acc, __fmul_rn(m[u * R4], x[4 * u + r]));
  const int live = R4 - (t & ~31);  // lanes of this warp with rows
  const unsigned mask = live >= 32 ? 0xffffffffu : (1u << live) - 1u;
  acc = __fadd_rn(acc, __shfl_xor_sync(mask, acc, 1));
  return __fadd_rn(acc, __shfl_xor_sync(mask, acc, 2));
}

// a bulk copy into a buffer, completing on its mbarrier (thread STAGER)
__device__ __forceinline__ void copy_in(Smem& S, int bar, uint32_t dst,
                                        const void* src, uint32_t bytes) {
  const uint32_t b = smem_u32(&S.bar[bar]);
  mbar_expect_tx(b, bytes);
  bulk_load(dst, src, bytes, b);
}

// band i's leaf vectors of its active slots, into buffer i & 1 (none: the
// phase completes at once)
__device__ __forceinline__ void copy_vec(Smem& S, int i, const float* vecf) {
  const uint32_t bytes = S.nact[i] * W * 4;
  const uint32_t b = smem_u32(&S.bar[BAR_VEC + (i & 1)]);
  mbar_expect_tx(b, bytes);
  if (bytes)
    bulk_load(smem_u32(S.vec[i & 1]), vecf + (size_t)i * SLOTS * W, bytes, b);
}

// this CTA's part of band i's matrix of a bank (configuration cfg_id) into
// a buffer (thread STAGER)
__device__ __forceinline__ void copy_part(Smem& S, int bar, float* dst,
                                          const float* bank, int i, int q) {
  size_t off = 0;  // band i's [NCFG, N, N] block in the bank
  for (int b = 0; b < i; ++b) off += (size_t)NCFG * band_n(b) * band_n(b);
  const int N = band_n(i), part = N * N / CLUSTER;
  copy_in(S, bar, smem_u32(dst),
          bank + off + (size_t)S.bt[CFG_ID][i] * N * N + (size_t)q * part,
          (uint32_t)part * 4);
}

// Band i's slots as far as the walk decides them, by the 16 stage lanes
// (lane j, slot j), from the collapse masks so far and the band's entry
// seed: the entry fill, each slot's fill, its draws and their prefix, and
// the seed after that prefix.
__device__ __forceinline__ void stage_slots(Smem& S, int i, unsigned seed,
                                            int j) {
  constexpr unsigned G = 0xffff0000u;  // the stage lanes
  const int fs = S.bt[FS][i], fe = S.bt[FE][i];
  unsigned cm = 0u;
  for (int b = j; b < NBANDS; b += SLOTS)
    if (b >= fs && b < fe) cm |= S.collapse[b];
  cm = __reduce_or_sync(G, cm);
  const unsigned entry =
      S.bt[HAS_LB][i] > 0 ? cm : shl32(1u, S.bt[B_IN][i]) - 1u;
  const int slot = i * SLOTS + j;
  const int n = S.lt[LN][slot], k = S.lt[LK][slot];
  const unsigned f2 = apply_cols16(S.fill[i & 1] + j * 16, entry) &
                      (shl32(1u, S.lt[LBL][slot]) - 1u);
  const unsigned draws = (k == 0 && f2 != 0u) ? (unsigned)n : 0u;
  unsigned incl = draws;
#pragma unroll
  for (int o = 1; o < SLOTS; o <<= 1) {
    const unsigned u = __shfl_up_sync(G, incl, o);
    if (j >= o) incl += u;
  }
  const int prefix = (int)(incl - draws);
  S.prefix_s[j] = prefix;
  S.f2_s[j] = f2;
  S.cm_pvq[j] = 0u;
  S.seedp_s[j] = lcg_jump(seed, clampi(prefix, 0, LCG_MAX));
  if (j == SLOTS - 1) S.tot_s = (int)incl;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(THREADS, CLUSTER >= 4 ? 2 : 1)
k13_bands(const Fields p, const float* __restrict__ gain,
          const unsigned* __restrict__ fill,
          const float* __restrict__ vec, const unsigned* __restrict__ seed0,
          const float* __restrict__ post, const float* __restrict__ pre,
          const unsigned* __restrict__ cmb, const unsigned* __restrict__ bmb,
          const float* __restrict__ sq, float* __restrict__ spec_out,
          unsigned* __restrict__ seed_out, unsigned* __restrict__ coll_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int f = blockIdx.x / CLUSTER, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, j = t - STAGE0;
  const unsigned* fillf = fill + (size_t)f * NBANDS * SLOTS * 16;
  const float* vecf = vec + (size_t)f * NBANDS * SLOTS * W;
  constexpr uint32_t FILL_B = SLOTS * 16 * 4;

  if (t == 0) {
    for (int b = 0; b < NBAR; ++b)
      mbar_init(smem_u32(&S.bar[b]), b >= BAR_NM ? CLUSTER : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int e = t; e < NBT * NBANDS; e += THREADS)
    S.bt[e / NBANDS][e % NBANDS] = p.bt[e / NBANDS][(size_t)f * NBANDS +
                                                    e % NBANDS];
  __syncthreads();
  if (t == STAGER) {  // the slot fields, bands 0 and 1's fills, band 0
    constexpr uint32_t LTB = NBANDS * SLOTS * 4;
    const uint32_t b = smem_u32(&S.bar[BAR_TAB]);
    mbar_expect_tx(b, (NLT + 1) * LTB);
    for (int k = 0; k < NLT; ++k)
      bulk_load(smem_u32(S.lt[k]), p.lt[k] + (size_t)f * NBANDS * SLOTS, LTB,
                b);
    bulk_load(smem_u32(S.gain), gain + (size_t)f * NBANDS * SLOTS, LTB, b);
    for (int k = 0; k < 2; ++k)
      copy_in(S, BAR_FILL + k, smem_u32(S.fill[k]), fillf + k * SLOTS * 16,
              FILL_B);
    copy_part(S, BAR_PRE, S.pre, pre, 0, q);
    copy_part(S, BAR_POST, S.post, post, 0, q);
  }
  for (int e = t; e < NBANDS * 17; e += THREADS) {  // cm rows and B-masks
    const int i = e / 17, c = i * NCFG + S.bt[CFG_ID][i];
    if (e % 17 < 16)
      S.cm[i][e % 17] = cmb[(size_t)c * 16 + e % 17];
    else
      S.bm[i] = bmb[c];
  }
  if (t < NBANDS) {
    S.sq[t] = sq[t];
    S.collapse[t] = 0u;
  }
  for (int e = t; e < NBINS; e += THREADS) S.norm[e] = 0.f;
  unsigned At = 1u, Bt = 0u;  // t + 1 draws: s -> At s + Bt
#pragma unroll
  for (int k = 0; k < 13; ++k)
    if (((t + 1) >> k) & 1) {
      Bt = JUMP.a[k] * Bt + JUMP.b[k];
      At = JUMP.a[k] * At;
    }
  mbar_wait(smem_u32(&S.bar[BAR_TAB]), 0);
  for (int e = t; e < NBANDS * SLOTS; e += THREADS) {
    const int off = S.lt[LOFF][e], n = S.lt[LN][e];
    S.src[e] = off % band_n(e / SLOTS);
    S.fold[e] = clampi(off, 0, W);
    S.magic[e] = n >= 2 && n < 65536 ? 0xffffffffu / (unsigned)n + 1u : 0u;
  }
  if (t < NBANDS) {
    int last = 0, span = band_n(t);
    for (int s = 0; s < SLOTS; ++s)
      if (S.lt[LK][t * SLOTS + s] > -2) {
        last = s + 1;
        span = max(span, S.lt[LN][t * SLOTS + s]);
      }
    S.nact[t] = last;
    S.span[t] = min(span, W);
  }
  if (t == 0) expect_rows(S, 0);  // band 0's exchanges (each band posts
                                  // the next one's)
  __syncthreads();
  if (t == STAGER)
    for (int k = 0; k < 2; ++k) copy_vec(S, k, vecf);
  // where this thread sends its rows: CTA t & 3 (a row's four threads, a
  // CTA each; the thread for this CTA stores them here)
  const int to = (t & 3) < CLUSTER ? (t & 3) : q;
  const uint32_t lb_at = mapa(smem_u32(S.lbcat), to);
  const uint32_t nm_at = mapa(smem_u32(S.norm), to);
  // every CTA has started, with its mbarriers set up
  cluster.sync();
  if (j >= 0) {  // band 0's slots
    const unsigned s0 = seed0[f];
    if (j == 0) S.seed_s = s0;
    mbar_wait(smem_u32(&S.bar[BAR_FILL]), 0);
    stage_slots(S, 0, s0, j);
  }
  float* spec = spec_out + (size_t)f * NBINS;

  for (int i = 0; i < NBANDS; ++i) {
    const int N = band_n(i), a = 8 * EBANDS[i], R = N / CLUSTER;
    const int nact = S.nact[i], slot0 = i * SLOTS;
    const bool present = S.bt[PRESENT][i] > 0;
    const bool has_lb = S.bt[HAS_LB][i] > 0;
    const bool fold = has_lb && present;
    const bool next = i + 1 < NBANDS;
    const bool bins = warp * 32 < S.span[i];  // this warp holds values
    if (i > 0)  // band i - 1's norm rows from every CTA, and each has read
                // its window (so that this band's rows may go there)
      exch_wait(smem_u32(&S.bar[BAR_NM + ((i - 1) & 1)]), ((i - 1) >> 1) & 1);
    if (t == 0 && next) expect_rows(S, i + 1);
    if (t == STAGER && next && i > 0)  // band i + 1's fills (band 0 did 1's)
      copy_in(S, BAR_FILL + ((i + 1) & 1), smem_u32(S.fill[(i + 1) & 1]),
              fillf + (size_t)(i + 1) * SLOTS * 16, FILL_B);
    if (fold) {  // the fold window of pad(norm, W); the zeros after it
      if (t < N) {
        const int qq = clampi(S.bt[EFF][i], 0, NBINS) + t;
        S.lbraw[t] = qq < NBINS ? S.norm[qq] : 0.f;
      }
      for (int u = N + t; u < 2 * W; u += THREADS) S.lbcat[u] = 0.f;
      mbar_wait(smem_u32(&S.bar[BAR_PRE]), i & 1);
    }
    __syncthreads();  // A: the window, the band's slots
    if (fold) {  // this CTA's rows of the lowband pre-transform, to all
      if (t < 4 * R) {
        const float y = part_row(S.pre, S.lbraw, N, t);
        const int g = q * R + (t >> 2);
        if (to == q)
          S.lbcat[g] = y;
        else if ((t & 3) < CLUSTER)
          st_async(lb_at + g * 4, y,
                   mapa(smem_u32(&S.bar[BAR_LB + (i & 1)]), to));
      }
      __syncthreads();  // P: band i's pre is read
    }
    if (t == STAGER && next) {  // so band i + 1's goes there
      mbar_wait(smem_u32(&S.bar[BAR_PRE]), i & 1);
      copy_part(S, BAR_PRE, S.pre, pre, i + 1, q);
    }

    // every slot's value before its gain: first the PVQ slots' leaf
    // vectors (and their collapse bits), while the pre-transform's rows
    // cross the cluster; then the q0 slots' noise or fold, with their
    // energies (the warps' parts by interleaved butterflies). The slots'
    // fields are read as vectors and their values computed side by side.
    float* vb = S.vec[i & 1];  // the leaf vectors, then the values
    mbar_wait(smem_u32(&S.bar[BAR_VEC + (i & 1)]), (i >> 1) & 1);
    const unsigned seed = S.seed_s;
    int kk[SLOTS], nn[SLOTS];
    load16(&S.lt[LK][slot0], kk);
    load16(&S.lt[LN][slot0], nn);
    float v[SLOTS], e[SLOTS];
    {
      int bl[SLOTS];
      unsigned mg[SLOTS];
      load16(&S.lt[LBL][slot0], bl);
      load16(&S.magic[slot0], mg);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        v[s] = 0.f;
        if (s >= nact || kk[s] <= 0) continue;  // uniform
        unsigned bit = 0u;
        if (bins && t < W && t < nn[s]) {
          v[s] = vb[s * W + t];
          if (v[s] != 0.f) {  // block (t b_leaf) // n (0 <= t < n)
            const int num = t * bl[s];
            int blk;
            if (mg[s] != 0u && num >= 0 && num < 65536) {
              blk = (int)__umulhi((unsigned)num, mg[s]);
            } else {
              blk = num / nn[s];
              if (num % nn[s] != 0 && num < 0) --blk;
            }
            if (blk >= 0 && blk < 8) bit = 1u << blk;
          }
        }
        bit = __reduce_or_sync(0xffffffffu, bit);
        if (lane == 0 && bit) atomicOr(&S.cm_pvq[s], bit);
      }
    }
    if (fold)  // every CTA's rows of the transformed window
      exch_wait(smem_u32(&S.bar[BAR_LB + (i & 1)]), (i >> 1) & 1);
    unsigned q0 = 0u;  // the band's q0 slots (the same in every thread)
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (s < nact && kk[s] <= 0 && kk[s] > -2) q0 |= 1u << s;
    if (bins && q0) {
      int pd[SLOTS], fo[SLOTS];
      unsigned f2[SLOTS], sp[SLOTS];
      load16(S.prefix_s, pd);
      load16(S.f2_s, f2);
      load16(S.seedp_s, sp);
      load16(&S.fold[slot0], fo);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        e[s] = 0.f;
        if (!((q0 >> s) & 1u)) continue;  // uniform
        if (t < W && t < nn[s] && f2[s] != 0u) {
          const unsigned r =
              pd[s] >= 0 && pd[s] + t + 1 <= LCG_MAX
                  ? At * sp[s] + Bt
                  : lcg_jump(seed, clampi(pd[s] + t + 1, 0, LCG_MAX));
          v[s] = has_lb ? __fadd_rn(S.lbcat[fo[s] + t],
                                    (r & 0x8000u) ? 1.f / 256 : -1.f / 256)
                        : (float)((int)r >> 20);
        }
        e[s] = __fmul_rn(v[s], v[s]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
          if ((q0 >> s) & 1u)  // uniform
            e[s] = __fadd_rn(e[s], __shfl_xor_sync(0xffffffffu, e[s], o));
      if (lane == 0)
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
          if ((q0 >> s) & 1u) S.red[s][warp] = e[s];
    }
    if (bins && t < W)
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (s >= nact) break;  // uniform
        vb[s * W + t] = v[s];
      }
    __syncthreads();  // B
    if (t < nact) {  // a q0 slot's gain over its energy (the warps' parts
                     // in order; a warp of no values adds an exact 0); 1
                     // for a PVQ slot
      float g = 1.f;
      if ((q0 >> t) & 1u) {
        float en = S.red[t][0];
        for (int w = 1; w * 32 < S.span[i]; ++w)
          en = __fadd_rn(en, S.red[t][w]);
        g = __fdiv_rn(S.gain[slot0 + t], __fsqrt_rn(__fadd_rn(1e-15f, en)));
      }
      S.g_s[t] = g;
    }
    __syncthreads();  // C
    // the placement: bin j of a slot lands at (j + off) mod N, so target
    // t takes bin (t - off) mod N of each active slot, in slot order
    if (t < N) {
      int sr[SLOTS];
      float g[SLOTS], x[SLOTS];
      load16(&S.src[slot0], sr);
      load16(S.g_s, g);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (s >= nact) break;  // uniform
        int src = t - sr[s];
        if (src < 0)
          src += N;
        else if (src >= N)
          src -= N;
        x[s] = vb[s * W + src];
      }
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (s >= nact) break;  // uniform
        if (kk[s] > -2) acc = __fadd_rn(acc, __fmul_rn(x[s], g[s]));
      }
      S.X[t] = acc;
    }
    // the values written to the buffer are ordered before the bulk copy
    // that refills it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // D: band i's buffer is read
    if (t == STAGER && i + 2 < NBANDS) copy_vec(S, i + 2, vecf);

    // this CTA's rows of the upward transform: the spectrum, and the norm
    // buffer of every CTA
    if (t < 4 * R) {
      float y = 0.f;
      if (present) {
        mbar_wait(smem_u32(&S.bar[BAR_POST]), i & 1);
        y = part_row(S.post, S.X, N, t);
      }
      const int g = a + q * R + (t >> 2);
      if (present && S.bt[LAST][i] == 0) {
        const float nv = __fmul_rn(S.sq[i], y);
        if (to == q)
          S.norm[g] = nv;
        else if ((t & 3) < CLUSTER)
          st_async(nm_at + g * 4, nv,
                   mapa(smem_u32(&S.bar[BAR_NM + (i & 1)]), to));
      }
      if ((t & 3) == 0) spec[g] = y;
    }
    unsigned seed2 = 0u;
    if (j >= 0) {  // band i's collapse mask and the next band's seed
      const int k = S.lt[LK][slot0 + j];
      unsigned cmv = 0u;
      if (k > -2) {
        const unsigned f2 = S.f2_s[j];
        const int bl = S.lt[LBL][slot0 + j];
        cmv = k > 0 ? (bl > 1 ? S.cm_pvq[j] : 1u)
                    : (f2 == 0u ? 0u : (has_lb ? f2 : shl32(1u, bl) - 1u));
        cmv = shl32(cmv, S.lt[LCMS][slot0 + j]);
      }
      const unsigned acc = __reduce_or_sync(0xffff0000u, cmv);
      seed2 = lcg_jump(seed, clampi(S.tot_s, 0, LCG_MAX));
      if (j == 0) {
        S.seed_s = seed2;
        if (present) S.collapse[i] = apply_cols16(S.cm[i], acc) & S.bm[i];
      }
    }
    __syncthreads();  // E: band i's post is read, its collapse mask set
    if (t < CLUSTER && t != q)  // band i is done here: an arrival at the
                                // other CTAs
      remote_arrive(mapa(smem_u32(&S.bar[BAR_NM + (i & 1)]), t));
    if (t == STAGER) {
      mbar_wait(smem_u32(&S.bar[BAR_POST]), i & 1);
      if (next)
        copy_part(S, BAR_POST, S.post, post, i + 1, q);
      else  // no copy in flight when the CTA ends
        mbar_wait(smem_u32(&S.bar[BAR_PRE]), i & 1);
    }
    if (j >= 0 && next) {  // band i + 1's slots, while the rows cross
      mbar_wait(smem_u32(&S.bar[BAR_FILL + ((i + 1) & 1)]),
                ((i + 1) >> 1) & 1);
      stage_slots(S, i + 1, seed2, j);
    }
  }
  // every CTA is done, and no row is still on its way here
  exch_wait(smem_u32(&S.bar[BAR_NM + ((NBANDS - 1) & 1)]),
            ((NBANDS - 1) >> 1) & 1);
  cluster.sync();
  if (q == 0) {
    if (t < NBANDS) coll_out[(size_t)f * NBANDS + t] = S.collapse[t];
    if (t == 0) seed_out[f] = S.seed_s;
  }
}

}  // namespace

// fields: a host array of 13 device pointers, the int32 bt fields [F, 21]
// (present, has_lb, eff, fs, fe, last, B_in, cfg_id) then the int32 lt
// fields [F, 21, 16] (n, k, off, b_leaf, cm_shift); gain f32 [F, 21, 16];
// fill u32 [F, 21, 16, 16]; vec f32 [F, 21, 16, 176]; seed0 u32 [F]; post,
// pre f32 (the 21 bands' [14, N, N] banks in order, each matrix as
// CLUSTER parts of R = N / CLUSTER rows, a part stored [N/4 u][R rows][4
// r]); cm u32
// [21, 14, 16]; bm u32 [21, 14]; sq f32 [21]; out: spec f32 [F, 800], seed
// u32 [F], collapse u32 [F, 21]. The lt fields, gain, fill, vec, post and
// pre are read by bulk copies: 16-byte aligned.
extern "C" int iamf_k13_bands(const void* const* fields,
                              const void* gain, const void* fill,
                              const void* vec, const void* seed0,
                              const void* post, const void* pre,
                              const void* cm, const void* bm, const void* sq,
                              int F, void* spec, void* seed_out, void* coll,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || fields == nullptr) return (int)cudaErrorInvalidValue;
  Fields p;
  for (int k = 0; k < NBT; ++k) p.bt[k] = (const int*)fields[k];
  for (int k = 0; k < NLT; ++k) p.lt[k] = (const int*)fields[NBT + k];
  const void* bulk[] = {p.lt[0], p.lt[1], p.lt[2], p.lt[3], p.lt[4],
                        gain,    fill,    vec,     post,    pre};
  for (const void* a : bulk)
    if ((size_t)a % 16) return (int)cudaErrorMisalignedAddress;
  static const cudaError_t attr = cudaFuncSetAttribute(
      k13_bands, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (attr != cudaSuccess) return (int)attr;
  k13_bands<<<F * CLUSTER, THREADS, sizeof(Smem), s>>>(
      p, (const float*)gain, (const unsigned*)fill, (const float*)vec,
      (const unsigned*)seed0, (const float*)post, (const float*)pre,
      (const unsigned*)cm, (const unsigned*)bm, (const float*)sq,
      (float*)spec, (unsigned*)seed_out, (unsigned*)coll);
  return (int)cudaGetLastError();
}

// CTAs a frame: the banks' layout (device_bands.row_parts) follows it
extern "C" int iamf_k13_cluster(void) { return CLUSTER; }
