// Flash-attention forward for Hopper (sm_90a), fp32, causal / sliding
// window / full, grouped-query heads.
//
// Replaces the Pallas TPU kernel of the JAX reference:
//   flash_attention_fwd_f32 <- repro/kernels/flash_attention/kernel.py:
//                              _flash_kernel (flash_attention_fwd)
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
//   * Ragged lengths are loop bounds.  The TPU wrapper pads S to its block
//     of 128 (and so sends non-causal ragged calls to the reference); this
//     kernel bounds-checks every row and key.
//   * KV tiles that lie wholly in the future (causal) or wholly before the
//     window are never visited, where the TPU grid visits and masks them.
//
// What bounds it on the card: at the text path's shapes (B=64, S=64, Hq=Hkv=4,
// D=32, causal) one call reads q, k, v and writes o, 8 MB in all, ~2.5 us
// at 3.35 TB/s; it does 4*D FLOP for each of the 2,080 unmasked (query, key)
// pairs per head, 68 MFLOP, ~1 us at the fp32 CUDA-core peak.  So neither
// bound is far from a launch's own latency: the design keeps it to ONE
// launch that never writes the (S, S) scores or probabilities to memory.
//
// Design, simple first (fp32 FMA on the CUDA cores, no tensor cores):
//   * one thread block per (batch * query head, tile of kBlockQ = 32 query
//     rows); 4 warps, each owning 8 of the rows;
//   * the q tile and one kBlockKV = 32 key tile of k and v are staged in
//     shared memory, head_dim zero-padded to Dp = 32 * NC (NC = 1..4), the
//     k rows padded by one float so lane j reading key j hits bank j;
//   * per key tile, lane j scores key j against the warp's 8 rows, the
//     warp reduces the tile's row max with shuffles, and the running max,
//     the lane's share of the exp-sum and the output row (lane owns
//     columns lane + 32 c) stay in registers; the probabilities go through
//     a small per-warp shared buffer into the P.V product;
//   * the lanes' exp-sums are summed once, at the end.
// int64 offsets throughout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 32;
constexpr int kBlockKV = 32;
constexpr int kWarps = 4;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, s, h;
};

// shared floats of one block: q tile, k tile (rows padded by one), v tile,
// per-warp probabilities
template <int NC>
constexpr int64_t smem_floats() {
  return static_cast<int64_t>(kBlockQ) * 32 * NC +
         static_cast<int64_t>(kBlockKV) * (32 * NC + 1) +
         static_cast<int64_t>(kBlockKV) * 32 * NC +
         static_cast<int64_t>(kWarps) * kRows * kBlockKV;
}

template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int64_t Sq, int64_t Skv, int64_t Hq, int64_t group, int64_t D,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 int64_t window, float scale) {
  constexpr int Dp = 32 * NC;
  constexpr int kStride = Dp + 1;
  extern __shared__ float smem[];
  float* q_sh = smem;                              // [kBlockQ][Dp]
  float* k_sh = q_sh + kBlockQ * Dp;               // [kBlockKV][kStride]
  float* v_sh = k_sh + kBlockKV * kStride;         // [kBlockKV][Dp]
  float* p_sh = v_sh + kBlockKV * Dp;              // [kWarps][kRows][kBlockKV]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / Hq;
  const int64_t h = bh % Hq;
  const int64_t hk = h / group;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBlockQ;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < kBlockQ * Dp; idx += kWarps * 32) {
    const int r = idx / Dp, d = idx % Dp;
    const int64_t qi = q0 + r;
    q_sh[idx] = (qi < Sq && d < D) ? qb[qi * qs.s + d] : 0.f;
  }

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

  // this warp's rows
  const int64_t row0 = q0 + warp * kRows;
  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  float* p_warp = p_sh + warp * kRows * kBlockKV;

  for (int64_t kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBlockKV * Dp; idx += kWarps * 32) {
      const int j = idx / Dp, d = idx % Dp;
      const int64_t kj = kv0 + j;
      const bool in = kj < Skv && d < D;
      k_sh[j * kStride + d] = in ? kb[kj * ks.s + d] : 0.f;
      v_sh[j * Dp + d] = in ? vb[kj * vs.s + d] : 0.f;
    }
    __syncthreads();
    // a tile wholly outside every row of this warp adds nothing to them
    if (causal && (kv0 > row0 + kRows - 1 ||
                   (window > 0 && kv0 + kBlockKV - 1 <= row0 - window)))
      continue;

    // scores of key kv0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = k_sh + lane * kStride;
    const float* qw = q_sh + warp * kRows * Dp;
#pragma unroll 8
    for (int d = 0; d < Dp; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qw[r * Dp + d], kd, s[r]);
    }

    const int64_t kj = kv0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t qi = row0 + r;
      bool valid = kj < Skv;
      if (causal) {
        valid = valid && kj <= qi;
        if (window > 0) valid = valid && kj > qi - window;
      }
      const float sc = valid ? s[r] * scale : -INFINITY;
      float mt = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m[r], mt);
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // uniform across the warp
        p = valid ? expf(sc - m_new) : 0.f;
        alpha = expf(m[r] - m_new);  // 0 while m[r] is still -inf
      }
      m[r] = m_new;
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      p_warp[r * kBlockKV + lane] = p;
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] * v[j][lane + 32 c]
#pragma unroll 4
    for (int j = 0; j < kBlockKV; j += 4) {
      float vj[4][NC];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < NC; ++c) vj[t][c] = v_sh[(j + t) * Dp + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_warp + r * kBlockKV + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float a = acc[r][c];
          a = fmaf(p4.x, vj[0][c], a);
          a = fmaf(p4.y, vj[1][c], a);
          a = fmaf(p4.z, vj[2][c], a);
          a = fmaf(p4.w, vj[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();  // p_warp is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float lsum = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(kFull, lsum, off);
    const int64_t qi = row0 + r;
    if (qi >= Sq) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // no key seen: 0
    float* orow = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = acc[r][c] * inv;
    }
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int64_t B, int64_t Sq, int64_t Skv, int64_t Hq,
                   int64_t Hkv, int64_t D, Strides qs, Strides ks, Strides vs,
                   Strides os, int causal, int64_t window, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats<NC>());
  if (smem > 48 * 1024) {  // above 48 KB (NC = 4) needs the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((Sq + kBlockQ - 1) / kBlockQ));
  flash_fwd_kernel<NC><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, o, Sq, Skv, Hq, Hq / Hkv, D, qs, ks, vs, os, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o (B, Sq, Hq, D): fp32, the last
// axis contiguous, the other three axes at the given element strides.
// D <= 128, Hq a multiple of Hkv, B*Hq < 2^31, ceil(Sq/32) < 2^16; causal
// is 0 or 1, window 0 means none (used only when causal).  Returns the
// launch's cudaError_t.
int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, int64_t B, int64_t Sq, int64_t Skv,
                            int64_t Hq, int64_t Hkv, int64_t D,
                            int64_t q_sb, int64_t q_ss, int64_t q_sh,
                            int64_t k_sb, int64_t k_ss, int64_t k_sh,
                            int64_t v_sb, int64_t v_ss, int64_t v_sh,
                            int64_t o_sb, int64_t o_ss, int64_t o_sh,
                            int64_t causal, int64_t window, float scale,
                            void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const int c = static_cast<int>(causal != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((D + 31) / 32) {
    case 1:
      err = launch<1>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, D, qs, ks, vs, os,
                      c, window, scale, st);
      break;
    case 2:
      err = launch<2>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, D, qs, ks, vs, os,
                      c, window, scale, st);
      break;
    case 3:
      err = launch<3>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, D, qs, ks, vs, os,
                      c, window, scale, st);
      break;
    default:
      err = launch<4>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, D, qs, ks, vs, os,
                      c, window, scale, st);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
