// Flash-attention forward for Hopper (sm_90a) on bf16 q, k and v: both
// products on the bf16 tensor cores by wgmma, causal / sliding window / full,
// grouped-query heads.
//
// Replaces the Pallas TPU kernel of the JAX reference
// (src/repro/kernels/flash_attention/kernel.py:28 _flash_kernel, in
// flash_attention_fwd) on bf16 inputs; csrc/flash_attention.cu is its fp32
// form.
//
//   q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) bf16 -> o (B, Sq, Hq, D) bf16
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h/G] * scale) v[b, j, h/G]
//
// over the keys j that the mask lets row i see: j <= i when causal, and
// j > i - window as well when a window is given (window 0 = none); G =
// Hq / Hkv.  A row that sees no key writes 0, as the TPU kernel's finalize
// does.  The TPU kernel's contract: its blocks are cast to fp32 and P stays
// fp32; scale, the running max and sum and the softmax are fp32, and o is
// rounded to bf16 once, from fp32.  Here:
//   * S = Q.K^T is one bf16 product: the products of two bf16 values are
//     exact in fp32 and the tensor cores sum them in fp32;
//   * P is fp32 and goes to P.V as two bf16 halves, P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi) (16 of fp32's 24 bits; P_hi alone, the plain
//     version's rounding, is 8), so P.V is two bf16 products against V;
//   * O accumulates across key tiles in the wgmma accumulator, rescaled in
//     place by each tile's alpha.  The H100's accumulator does not round to
//     nearest; the drift this leaves is measured against float64 in
//     chip_smoke.py (check_bf16_kernels) and sits far below o's bf16 ulp.
//
// What is done differently from the TPU kernel (as in the fp32 form):
// GQA by index (query head h reads kv head h / G, nothing is repeated);
// q, k and v read in the reference's (B, S, H, D) layout through their
// strides; ragged Sq, Skv and D by TMA's zero fill and the mask; key tiles
// wholly in the future (causal) or before the window never visited.
//
// What bounds it on the card: at phi4-mini's step (2, 1,024, 24/8, 128),
// causal, the products of the contract are 1.5 x 12.9 GFLOP (one for Q.K^T,
// two for P.V), 0.0196 ms at 989 TFLOP/s, against 33.6 MB of q, k, v and o,
// 0.010 ms at 3.35 TB/s: the bf16 tensor cores bound it, reached only
// through wgmma.  Measured by ablation (tools/flash_bf16_ablation.py), the
// products take under a third of the kernel's time, the softmax about an
// eighth, and about half is the latency of each warpgroup's chain (S, its
// wait, softmax, P.V, its wait) that the warps in flight do not hide.
// The design:
//   * a block is a copying warp and two warpgroups (three at head_dim <=
//     64) on 64 query rows each, the m64 of wgmma, of one (batch, query
//     head): the warpgroups share each k and v tile and run apart, one's
//     softmax beside another's products, with no block-wide barrier in the
//     loop;
//   * the copying warp fills shared memory by TMA (cp.async.bulk.tensor on
//     4-d maps of (D, H, S, B), one per tensor; the C entry point encodes
//     them): q's tile once, then 64-key tiles of k and v into three stages,
//     each with a "full" barrier (the copy's bytes) and an "empty" one (the
//     warpgroups' release).  Tiles stay bf16 in the 128-byte-swizzled
//     layout wgmma's descriptors read (64-column atoms, row r's 16-byte
//     chunk c at c ^ (r % 8)); there is no fp32 copy of any tile;
//   * S: D/16 wgmma.m64n64k16 with both operands read from shared memory
//     by descriptor (K's rows, D contiguous, are the K-major B operand);
//   * online softmax on the accumulator fragments in registers (a thread
//     holds 16 keys of rows g and g + 8 of its warp's 16; max and sum over
//     the quad by shuffles), in base 2 with scale * log2(e) folded in;
//   * P.V: the S accumulator is already the A fragment of the next
//     product (row g, keys 2t, 2t+1 of each 8 keys), so P_hi and P_lo go
//     to wgmma.m64nDk16 from registers with no trip through shared memory;
//     V's tile (keys x D, D contiguous) is the MN-major B operand;
//   * causal q tiles launch longest first; key tiles in a warpgroup's
//     future or before its window are skipped by that warpgroup;
//   * head_dim padded to 64 or 128 (TMA's zero columns): one or two atoms.
// Tried on the card and slower at phi4-mini's step: blocks of one
// warpgroup, or of two in lockstep, staged by cp.async; P(n-1).V deferred
// to run beside tile n's softmax (more registers, less copy lead).
// int64 offsets in global memory; 32-bit positions and shared offsets.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsWG = 64;                  // query rows of a warpgroup
constexpr int kBlockKV = 64;                 // keys a staged tile
constexpr int kStages = 3;
constexpr int kAtomRow = 128;                // bytes of a row of a 64-column atom
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, s, h;
};

// the warpgroups computing in a block with NA atoms of 64 head-dim
// columns: three at head_dim <= 64 (117 registers a thread: one block of
// 13 warps fits the SM's registers), two at 128 (145 registers); then the
// block's query rows and threads (one warp more: it issues the copies)
template <int NA>
__host__ __device__ constexpr int consumers() {
  return NA == 1 ? 3 : 2;
}
template <int NA>
__host__ __device__ constexpr int block_q() {
  return kRowsWG * consumers<NA>();
}
template <int NA>
__host__ __device__ constexpr int threads() {
  return 128 * consumers<NA>() + 32;
}

// shared bytes of one block: the q tile (an atom of 64 columns after
// another) and kStages stages of a k and a v tile, plus 1,024 bytes to
// align the tiles to the swizzle's 1,024-byte period
template <int NA>
__host__ __device__ constexpr int q_atom_bytes() {
  return block_q<NA>() * kAtomRow;
}
template <int NA>
__host__ __device__ constexpr int q_tile_bytes() {
  return NA * q_atom_bytes<NA>();
}
template <int NA>
__host__ __device__ constexpr int kv_tile_bytes() {
  return NA * kBlockKV * kAtomRow;
}
template <int NA>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + q_tile_bytes<NA>() + kStages * 2 * kv_tile_bytes<NA>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also tells the barrier to wait for `bytes` of copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of the tensor map at coordinates (column, head, row, batch) into
// shared memory at dst, counted on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "r"(bar)
      : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving a register's reads or writes across the
// point: wgmma reads and writes its registers asynchronously
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d (+)= A . B on an m64n64k16 tile: A (64 x 16) and B (64 keys x 16) both
// K-major in shared memory (descriptors); d from zero when !accumulate
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B on an m64n64k16 tile: A (64 x 16) from registers, B (16 keys x
// 64 columns) MN-major in shared memory (transposed descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B on an m64n128k16 tile: A (64 x 16) from registers, B (16 keys x
// 128 columns) MN-major in shared memory (transposed descriptor)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int NA>
__device__ __forceinline__ void wgmma_rs(float (&d)[32 * NA],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NA == 1)
    wgmma_rs_n64(d, a, b);
  else
    wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values as a bf16 pair (lo in the low half) and what rounding
// left of them as another
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int NA>
__global__ void __launch_bounds__(threads<NA>(), 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                      int group, int D, Strides os, int causal, int window,
                      float scale_log2) {
  constexpr int KQ = 4 * NA;          // k16 steps of Q.K^T
  constexpr int NO = 32 * NA;         // O's accumulators a thread
  constexpr int KV16 = kBlockKV / 16; // k16 steps of P.V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the q tile's barrier, then each stage's "full" and "empty" barriers
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  uint8_t* q_sh =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* kv_sh = q_sh + q_tile_bytes<NA>();  // [stage][k, v]
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);  // + 8 * stage

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = static_cast<int>(blockIdx.x / Hq);
  const int h = static_cast<int>(blockIdx.x % Hq);
  const int hk = h / group;
  // causal q tiles longest first: the last tile has the most keys
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * block_q<NA>();

  // the block's key tiles: wholly in the future or before the window are
  // never visited
  const int q_last = (q0 + block_q<NA>() < Sq ? q0 + block_q<NA>() : Sq) - 1;
  int kv_end = Skv, kv_begin = 0;
  if (causal) {
    if (q_last + 1 < kv_end) kv_end = q_last + 1;
    if (window > 0 && q0 - window + 1 > 0)
      kv_begin = ((q0 - window + 1) / kBlockKV) * kBlockKV;
  }
  const int n_tiles =
      kv_begin < kv_end ? (kv_end - kv_begin + kBlockKV - 1) / kBlockKV : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 128 * consumers<NA>());
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * consumers<NA>()) {
    // the producer: q's tile once, then tile n's k and v into stage n % 3
    // once every consumer has released the stage's tile n - 3
    if (lane == 0) {
      mbar_expect_tx(bar_q, q_tile_bytes<NA>());
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load(smem_u32(q_sh) + a * q_atom_bytes<NA>(), &tm_q, bar_q,
                 64 * a, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        if (n >= kStages) mbar_wait(bar_empty + 8 * st, (n / kStages - 1) & 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * kv_tile_bytes<NA>());
        const uint32_t dst = smem_u32(kv_sh) + st * 2 * kv_tile_bytes<NA>();
        const int kv0 = kv_begin + n * kBlockKV;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load(dst + a * kv_tile_bytes<1>(), &tm_k, bar_full + 8 * st,
                   64 * a, hk, kv0, b);
          tma_load(dst + kv_tile_bytes<NA>() + a * kv_tile_bytes<1>(), &tm_v,
                   bar_full + 8 * st, 64 * a, hk, kv0, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: its rows, and this thread's: g and g + 8 of its
  // warp's 16
  const int wg = warp >> 2;
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = q0 + wg * kRowsWG;
  const int wg_last = (row0 + kRowsWG < Sq ? row0 + kRowsWG : Sq) - 1;
  const int rows[2] = {row0 + (warp & 3) * 16 + gq,
                       row0 + (warp & 3) * 16 + gq + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO], s[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_sh) + wg * kRowsWG * kAtomRow;
  mbar_wait(bar_q, 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    const int kv0 = kv_begin + n * kBlockKV;
    mbar_wait(bar_full + 8 * st, (n / kStages) & 1);
    const uint32_t k_addr = smem_u32(kv_sh) + st * 2 * kv_tile_bytes<NA>();
    const uint32_t v_addr = k_addr + kv_tile_bytes<NA>();

    // uniform over the warpgroup: a tile past its last row (causal) or
    // wholly before its first row's window is skipped
    const bool live = row0 < Sq && (!causal || kv0 <= wg_last) &&
                      !(causal && window > 0 &&
                        kv0 + kBlockKV - 1 <= row0 - window);
    if (live) {
      // S = Q . K^T: the warpgroup's 64 rows against the tile's 64 keys
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        // atom kk / 4, its 32-byte column (kk % 4) of the 128-byte rows
        const uint32_t col = (kk & 3) * 32;
        const uint64_t da = desc_sw128(
            q_addr + (kk >> 2) * q_atom_bytes<NA>() + col, 16, 8 * kAtomRow);
        const uint64_t db = desc_sw128(
            k_addr + (kk >> 2) * kv_tile_bytes<1>() + col, 16, 8 * kAtomRow);
        wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // online softmax on the fragments: s[4j + 2r + e] is row g + 8r,
      // key kv0 + 8j + 2t + e; a tile that every key of this thread's rows
      // sees whole needs no mask
      const bool masked =
          kv0 + kBlockKV > Skv ||
          (causal && (kv0 + kBlockKV - 1 > rows[0] ||
                      (window > 0 && kv0 <= rows[1] - window)));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * j + 2 * r + e] * scale_log2;
            if (masked) {
              const int key = kv0 + 8 * j + 2 * tq + e;
              const bool sees =
                  key < Skv &&
                  (!causal || (key <= rows[r] &&
                               (window <= 0 || key > rows[r] - window)));
              x = sees ? x : -INFINITY;
            }
            s[4 * j + 2 * r + e] = x;
            mt = fmaxf(mt, x);
          }
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
        const float m_new = fmaxf(m[r], mt);
        // a row that has seen no key yet keeps P = 0 and O = 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2(m[r] - m_use);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(s[4 * j + 2 * r + e] - m_use);
            s[4 * j + 2 * r + e] = p;
            psum += p;
          }
        m[r] = m_new;
        l[r] = l[r] * alpha + psum;
#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
          acc[4 * j + 2 * r] *= alpha;
          acc[4 * j + 2 * r + 1] *= alpha;
        }
      }

      // P as the A fragments of P.V, each k16 step's four registers
      // (row g keys 2t, 2t+1; row g+8; row g keys 8+2t, 9+2t; row g+8) from
      // S's n8 blocks 2kk and 2kk+1, in high and low bf16 halves
      uint32_t ph[KV16][4], pl[KV16][4];
#pragma unroll
      for (int kk = 0; kk < KV16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i],
                 pl[kk][i]);

      // O += P_lo . V + P_hi . V
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV16; ++kk) {
        const uint64_t dv = desc_sw128(v_addr + kk * 16 * kAtomRow,
                                       kBlockKV * kAtomRow, 8 * kAtomRow);
        wgmma_rs<NA>(acc, pl[kk], dv);
        wgmma_rs<NA>(acc, ph[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
    }
    mbar_arrive(bar_empty + 8 * st);  // this warpgroup is done with it
  }

  // acc[4j + 2r + e] is row g + 8r, column 8j + 2t + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lsum = l[r];
    lsum += __shfl_xor_sync(kFull, lsum, 1);
    lsum += __shfl_xor_sync(kFull, lsum, 2);
    if (rows[r] >= Sq) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // no key seen: 0
    __nv_bfloat16* orow = o + b * os.b + rows[r] * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int d = 8 * j + 2 * tq;
      if (d < D)  // D is even: column d + 1 is in too
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime (the
// library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (B, S, H, D) tensor as a TMA map over (D, H, S, B): boxes of 64
// columns by `rows` rows of one head and batch, swizzled by 128 bytes as
// wgmma reads them, zero past D and S; false where the map is refused
bool tensor_map(CUtensorMap* map, const void* base, int64_t B, int64_t S,
                int64_t H, int64_t D, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // the stride of an axis of size 1 is never used: the packed one
  const int64_t sh = H > 1 ? st.h : D;
  const int64_t ss = S > 1 ? st.s : sh * H;
  const int64_t sb = B > 1 ? st.b : ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * 2),
                                 static_cast<cuuint64_t>(ss * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NA>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, __nv_bfloat16* o, int64_t B,
                   int Sq, int Skv, int64_t Hq, int64_t Hkv, int D,
                   Strides os, int causal, int window, float scale_log2,
                   int smem, cudaStream_t stream) {
  if (smem != smem_bytes<NA>()) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((Sq + block_q<NA>() - 1) /
                                        block_q<NA>()));
  flash_fwd_bf16_kernel<NA><<<grid, threads<NA>(), smem, stream>>>(
      tq, tk, tv, o, Sq, Skv, static_cast<int>(Hq),
      static_cast<int>(Hq / Hkv), D, os, causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// The C entry point: bf16 q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) and o
// (B, Sq, Hq, D), the last axis contiguous, each tensor's (batch, sequence,
// head) strides in elements; causal 0 or 1, window 0 for none (used only
// when causal); smem the launch plan's shared bytes
// (kernels/flash_attention/ops.py launch_plan).  q, k and v are read by
// TMA: D and every stride of an axis longer than 1 a multiple of 8 values,
// the pointers 16-byte aligned; o is written in bf16 pairs (its strides
// even, its pointer 4-byte aligned).  cudaErrorInvalidValue where the
// shared bytes are not the kernel's, for another layout, D outside [8,
// 128], Hq not a multiple of Hkv, B*Hq >= 2^31 or a sequence of 2^30 or
// more.
// Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int64_t D, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t causal, int64_t window, float scale, int smem,
    void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0 ||
      B * Hq >= (1ll << 31) || Sq >= (1ll << 30) || Skv >= (1ll << 30) ||
      window < 0 || window >= (1ll << 30) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 || (o_sb | o_ss | o_sh) % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Sq, Hq, D, qs,
                  D <= 64 ? block_q<1>() : block_q<2>()) ||
      !tensor_map(&tk, k, B, Skv, Hkv, D, ks, kBlockKV) ||
      !tensor_map(&tv, v, B, Skv, Hkv, D, vs, kBlockKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  auto* op = static_cast<__nv_bfloat16*>(o);
  const int c = static_cast<int>(causal != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D <= 64 ? launch<1>(tq, tk, tv, op, B, static_cast<int>(Sq),
                          static_cast<int>(Skv), Hq, Hkv, static_cast<int>(D),
                          os, c, static_cast<int>(window), scale_log2, smem,
                          st)
              : launch<2>(tq, tk, tv, op, B, static_cast<int>(Sq),
                          static_cast<int>(Skv), Hq, Hkv, static_cast<int>(D),
                          os, c, static_cast<int>(window), scale_log2, smem,
                          st);
  return static_cast<int>(err);
}
