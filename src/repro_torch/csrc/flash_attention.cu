// Flash-attention forward for Hopper (sm_90a), fp32 in and out, causal /
// sliding window / full, grouped-query heads, both products on the tensor
// cores in 3xTF32.
//
// Replaces the Pallas TPU kernel of the JAX reference
// (repro/kernels/flash_attention/kernel.py:28 _flash_kernel, in
// flash_attention_fwd) on fp32 inputs; csrc/flash_attention_bf16.cu is its
// bf16 form.
//
//   q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) -> o (B, Sq, Hq, D)
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h/G] * scale) v[b, j, h/G]
//
// over the keys j that the mask lets row i see: j <= i when causal, and
// j > i - window as well when a window is given (window 0 = none); G =
// Hq / Hkv.  A row that sees no key at all writes 0, as the TPU kernel's
// finalize does.
//
// What is done differently from the TPU kernel:
//   * GQA by index: query head h reads kv head h / G.  The TPU wrapper
//     repeats k and v G times into a folded (B*Hq, S, D) copy; here nothing
//     is copied.
//   * q, k and v are read in the reference's (B, S, H, D) layout through
//     their batch / sequence / head strides (the last axis contiguous): no
//     transposed copies.
//   * Ragged lengths are bounds: cp.async's zero fill pads the tiles, and
//     the mask drops keys past Skv.  The TPU wrapper pads S to its block of
//     128 (and so sends non-causal ragged calls to the reference).
//   * KV tiles that lie wholly in the future (causal) or wholly before the
//     window are never visited, by the block or by a warp, where the TPU
//     grid visits and masks them.
//
// What bounds it on the card: at the text path's shapes (B=64, S=64, Hq=Hkv=4,
// D=32, causal) one call reads q, k, v and writes o, 8 MB in all, ~2.5 us
// at 3.35 TB/s; it does 4*D FLOP for each of the 2,080 unmasked (query, key)
// pairs per head, 68 MFLOP: ~1 us at the fp32 CUDA-core peak, 0.4 us in
// 3xTF32 (3 x 68 MFLOP at 495 TFLOP/s).  So it is bytes-bound, and short:
// the design keeps it to ONE launch that never writes the (S, S) scores or
// probabilities to memory, and keeps the arithmetic's dependent chains short
// by giving both products to the tensor cores.  The first form (scalar FMA,
// lane j scoring key j against 8 rows, probabilities through shared memory)
// took 14.4 us there.
//
// Design:
//   * one block of 4 warps per (batch * query head, tile of 64 query rows);
//     each warp owns 16 rows, so at S = 64 a block holds the whole head;
//   * q's tile and 64-key tiles of k and v are staged in shared memory as
//     fp32 (zero fill past D, Sq and Skv), head_dim padded to Dp = 32*NC,
//     rows padded to Dp + 4 floats so every fragment read below is free of
//     bank conflicts, by cp.async into two stages: the next k/v tile's copy
//     is in flight while this one is computed;
//   * S = Q.K^T: per warp a 16 x 64 tile of scores as 8 m16n8 accumulator
//     tiles, over Dp/8 steps of 3xTF32 mma.sync (tf32_mma.cuh);
//   * online softmax on the accumulator fragments: a thread holds two
//     columns of rows g and g + 8 in each tile, the row max is reduced over
//     the quad by two shuffles, the running max and the thread's share of
//     the sum stay in registers (the quad's shares are summed once, at the
//     end), and the output accumulators are rescaled in place;
//   * O += P.V: P goes from the score accumulators to the A operand in
//     registers, without a shared buffer or shuffles.  The accumulator gives
//     a thread keys 2t and 2t+1 of each 8-key step, where the A operand
//     wants keys t and t+4; since the product sums over keys, the step's
//     keys are taken in the permuted order (slot t = key 2t, slot t+4 = key
//     2t+1), and the V fragment is read from the rows of the same keys;
//     in both products each 8-deep step is summed from zero on the tensor
//     cores and added to the accumulators in fp32, so O's error does not
//     grow with the number of keys (the tensor cores' accumulator does not
//     round to nearest);
//   * 8-key tiles past a warp's last causal key (or past Skv) are skipped.
// int64 offsets in global memory; 32-bit inside the shared tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32x3::Split;

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTiles = kBlockKV / 8;  // n8 tiles of scores per warp
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, s, h;
};

// shared bytes of one block: the q tile and two stages of k and v tiles
template <int NC>
constexpr int smem_bytes() {
  constexpr int tile = kBlockKV * (32 * NC + 4) * 4;
  static_assert(kBlockQ == kBlockKV, "the q tile is a k/v tile's size");
  return 5 * tile;
}

// rows [r0, r0 + 64) of a (S, D) slice with row stride rs, into a
// [64][Dp + 4] tile by cp.async (16 bytes a copy where vec); zero past S
// and D
template <int NC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int64_t rs, int64_t r0, int64_t S,
                                           int D, bool vec) {
  constexpr int Dp = 32 * NC, LD = Dp + 4;
  if (vec) {
    constexpr int per_row = Dp / 4;
    for (int e = threadIdx.x; e < kBlockKV * per_row; e += kThreads) {
      const int r = e / per_row, c = (e - r * per_row) * 4;
      const bool in = r0 + r < S && c < D;
      tf32x3::cp_async16(dst + r * LD + c, in ? src + (r0 + r) * rs + c : src,
                         in);
    }
  } else {
    for (int e = threadIdx.x; e < kBlockKV * Dp; e += kThreads) {
      const int r = e / Dp, c = e - r * Dp;
      const bool in = r0 + r < S && c < D;
      tf32x3::cp_async4(dst + r * LD + c, in ? src + (r0 + r) * rs + c : src,
                        in);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int64_t Sq, int64_t Skv, int64_t Hq, int64_t group, int D,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 int64_t window, float scale, int vec) {
  constexpr int Dp = 32 * NC;
  constexpr int LD = Dp + 4;
  constexpr int KS = Dp / 8;  // k8 steps of Q.K^T, n8 tiles of O
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                        // [kBlockQ][LD]
  float* kv_sh = q_sh + kBlockQ * LD;        // 2 x {k [64][LD], v [64][LD]}

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / Hq;
  const int64_t h = bh % Hq;
  const int64_t hk = h / group;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBlockQ;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  // the block's key range: tiles wholly in the future or before the window
  // are skipped
  const int64_t q_last = (q0 + kBlockQ < Sq ? q0 + kBlockQ : Sq) - 1;
  int64_t kv_end = Skv;
  int64_t kv_begin = 0;
  if (causal) {
    if (q_last + 1 < kv_end) kv_end = q_last + 1;
    if (window > 0 && q0 - window + 1 > 0)
      kv_begin = ((q0 - window + 1) / kBlockKV) * kBlockKV;
  }

  // the k/v tile of keys [r0, r0 + 64) into stage st
  auto issue = [&](int st, int64_t r0) {
    float* dst = kv_sh + st * 2 * kBlockKV * LD;
    stage_rows<NC>(dst, kb, ks.s, r0, Skv, D, vec);
    stage_rows<NC>(dst + kBlockKV * LD, vb, vs.s, r0, Skv, D, vec);
  };

  stage_rows<NC>(q_sh, qb, qs.s, q0, Sq, D, vec);
  if (kv_begin < kv_end) issue(0, kv_begin);
  tf32x3::cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  const int64_t row0 = q0 + warp * 16;
  const int64_t rows[2] = {row0 + gq, row0 + gq + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int it = 0;
  for (int64_t kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockKV, ++it) {
    if (kv0 + kBlockKV < kv_end) {
      issue((it + 1) & 1, kv0 + kBlockKV);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_sh = kv_sh + (it & 1) * 2 * kBlockKV * LD;
    const float* v_sh = k_sh + kBlockKV * LD;

    // the key tiles this warp's rows can see: past its last causal key, or
    // past Skv, an 8-key tile is skipped; before the window the whole tile
    int64_t key_end = Skv;
    if (causal && row0 + 16 < key_end) key_end = row0 + 16;
    const int64_t live = key_end - kv0;
    const int nt_end =
        live <= 0 ? 0 : (live >= kBlockKV ? kKeyTiles : static_cast<int>((live + 7) / 8));
    const bool before_window =
        causal && window > 0 && kv0 + kBlockKV - 1 <= row0 - window;
    if (row0 < Sq && nt_end > 0 && !before_window) {
      // S = Q . K^T over the warp's 16 rows and the tile's 64 keys
      float s[kKeyTiles][4];
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const float* qw = q_sh + (warp * 16 + gq) * LD + tq;
#pragma unroll
      for (int ks8 = 0; ks8 < KS; ++ks8) {
        const float av[4] = {qw[ks8 * 8], qw[8 * LD + ks8 * 8],
                             qw[ks8 * 8 + 4], qw[8 * LD + ks8 * 8 + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Split sp = tf32x3::split(av[e]);
          ah[e] = sp.hi;
          al[e] = sp.lo;
        }
        const float* kr = k_sh + gq * LD + ks8 * 8 + tq;
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) {
          if (n < nt_end) {
            const Split b0 = tf32x3::split(kr[n * 8 * LD]);
            const Split b1 = tf32x3::split(kr[n * 8 * LD + 4]);
            tf32x3::mma3_add(s[n], ah, al, b0, b1);
          }
        }
      }

      // online softmax on the fragments: s[n][2r + e] is row g + 8r, key
      // kv0 + 8n + 2t + e
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the row's keys as offsets j in [lo, hi) of this tile
        int64_t hi64 = Skv - kv0, lo64 = 0;
        if (causal) {
          if (rows[r] - kv0 + 1 < hi64) hi64 = rows[r] - kv0 + 1;
          if (window > 0) lo64 = rows[r] - window + 1 - kv0;
        }
        const int hi = static_cast<int>(
            hi64 < 0 ? 0 : (hi64 > kBlockKV ? kBlockKV : hi64));
        const int lo = static_cast<int>(
            lo64 < 0 ? 0 : (lo64 > kBlockKV ? kBlockKV : lo64));
        float mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = n * 8 + 2 * tq + e;
            const bool valid = n < nt_end && j >= lo && j < hi;
            const float sc = valid ? s[n][2 * r + e] * scale : -INFINITY;
            s[n][2 * r + e] = sc;
            mt = fmaxf(mt, sc);
          }
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
        const float m_new = fmaxf(m[r], mt);
        float alpha = 1.f, psum = 0.f;
        if (m_new != -INFINITY) {  // uniform across the quad
          alpha = expf(m[r] - m_new);  // 0 while m[r] is still -inf
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float sc = s[n][2 * r + e];
              const float p = sc == -INFINITY ? 0.f : expf(sc - m_new);
              s[n][2 * r + e] = p;
              psum += p;
            }
        } else {
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) s[n][2 * r + e] = 0.f;
        }
        m[r] = m_new;
        l[r] = l[r] * alpha + psum;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }

      // O += P . V, the keys of each 8-key step in the order (2t, 2t+1) of
      // the accumulator: slot t = key 2t, slot t + 4 = key 2t + 1
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        if (n < nt_end) {
          const float pv[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const Split sp = tf32x3::split(pv[e]);
            ph[e] = sp.hi;
            pl[e] = sp.lo;
          }
          const float* vr = v_sh + (n * 8 + 2 * tq) * LD + gq;
#pragma unroll
          for (int dn = 0; dn < KS; ++dn) {
            const Split b0 = tf32x3::split(vr[dn * 8]);
            const Split b1 = tf32x3::split(vr[LD + dn * 8]);
            tf32x3::mma3_add(acc[dn], ph, pl, b0, b1);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  tf32x3::cp_async_wait<0>();

  // acc[dn][2r + e] is row g + 8r, column 8 dn + 2t + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lsum = l[r];
    lsum += __shfl_xor_sync(kFull, lsum, 1);
    lsum += __shfl_xor_sync(kFull, lsum, 2);
    const int64_t qi = rows[r];
    if (qi >= Sq) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // no key seen: 0
    float* orow = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      const int d = dn * 8 + 2 * tq;
      if (d < D) orow[d] = acc[dn][2 * r] * inv;
      if (d + 1 < D) orow[d + 1] = acc[dn][2 * r + 1] * inv;
    }
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int64_t B,
                   int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int D,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   int64_t window, float scale, int vec, cudaStream_t stream) {
  const int smem = smem_bytes<NC>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((Sq + kBlockQ - 1) / kBlockQ));
  flash_fwd_kernel<NC><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Sq, Skv, Hq, Hq / Hkv, D, qs, ks, vs, os, causal, window,
      scale, vec);
  return cudaGetLastError();
}

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o (B, Sq, Hq, D), the last axis
// contiguous, the other three axes at the given element strides.  D <= 128,
// Hq a multiple of Hkv, B*Hq < 2^31, ceil(Sq/64) < 2^16, and a head's rows
// within 32-bit offsets; causal is 0 or 1, window 0 means none (used only
// when causal).
cudaError_t flash_fwd(const void* q, const void* k, const void* v, void* o,
                      int64_t B, int64_t Sq, int64_t Skv, int64_t Hq,
                      int64_t Hkv, int64_t D, Strides qs, Strides ks,
                      Strides vs, Strides os, int64_t causal, int64_t window,
                      float scale, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  // 16-byte copies where every row start is 16-byte aligned
  const int vec =
      D % 4 == 0 &&
      (qs.b | qs.s | qs.h | ks.b | ks.s | ks.h | vs.b | vs.s | vs.h) % 4 ==
          0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int c = static_cast<int>(causal != 0);
  const int d = static_cast<int>(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1:
      return launch<1>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, d, qs, ks, vs, os,
                       c, window, scale, vec, st);
    case 2:
      return launch<2>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, d, qs, ks, vs, os,
                       c, window, scale, vec, st);
    case 3:
      return launch<3>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, d, qs, ks, vs, os,
                       c, window, scale, vec, st);
    default:
      return launch<4>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, d, qs, ks, vs, os,
                       c, window, scale, vec, st);
  }
}

}  // namespace

// The C entry point: fp32 q, k, v and o as above, each axis's strides in
// the order (batch, sequence, head).  Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int64_t D, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t causal, int64_t window, float scale, void* stream) {
  return static_cast<int>(flash_fwd(
      q, k, v, o, B, Sq, Skv, Hq, Hkv, D, Strides{q_sb, q_ss, q_sh},
      Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
      Strides{o_sb, o_ss, o_sh}, causal, window, scale, stream));
}
