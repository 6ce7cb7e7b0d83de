// Fused softmax-KL distillation loss for Hopper (sm_90a): forward and the
// student gradient, fp32; and the row logsumexp of the LM cross-entropy.
//
// Replaces the Pallas TPU kernels of the JAX reference:
//   kd_kl_fwd_f32  <- repro/kernels/kd_kl/kernel.py:_kd_kl_fwd_kernel (kd_kl_fwd)
//   kd_kl_bwd_f32  <- repro/kernels/kd_kl/kernel.py:_kd_kl_bwd_kernel (kd_kl_bwd)
//   row_lse_f32    <- repro/kernels/kd_kl/kernel.py:_row_lse_kernel (row_logsumexp)
//
// Forward, per row of (rows, vocab) teacher/student logits at temperature T:
//   lt = l_T / T, ls = l_S / T
//   m_t, s_t : running max and rescaled exp-sum of lt
//   m_s, s_s : the same for ls
//   acc      : sum exp(lt - m_t) * (lt - ls), rescaled as m_t moves
//   KL = (acc / s_t - lse_t + lse_s) * T^2,  lse = m + log s
// and both row logsumexps are written as the backward's residuals.  KL is
// not clamped at 0, as in the reference.
//
// What bounds it on the card: on the FedGKD main path vocab is the class
// count (10, 100 or 200) and rows = K*B = 256 per local step, so one call
// moves ~20-200 KB: it is bound by launch latency, not by bytes or
// arithmetic.  The design keeps it to ONE pass and ONE launch: a warp per
// row, lanes stride over the vocab keeping the five online accumulators in
// registers, then a shuffle reduction merges the lanes.  No probability
// tensor and no padded copy is ever written: ragged rows and vocab edges
// are handled by the loop bounds instead of the reference's -1e30 padding.
//
// Backward: dL/dls = g_row * (p_S - p_T) * T, rebuilt elementwise from the
// saved logsumexps (no second reduction over the vocab).  This is the
// reference's kernel factor 1/T times the T^2 its wrapper applies.
//
// Row logsumexp: lse = logsumexp(l / T) per row of (rows, vocab).  The TPU
// kernel carries (max, sum) per row across an ordered grid of vocab blocks
// and covers only whole blocks (its grid is rows // 256 by vocab // 1024, so
// a ragged edge is dropped); here any rows and vocab are covered by loop
// bounds.  On the LM path vocab is 50,280 and rows 4,092 (a step) or 8,184
// (evaluation): one call reads 0.8-1.6 GB and writes 16-32 KB, so it is
// bound by bytes.  One block of 256 threads owns a row at every vocab
// (threads past the vocab merge as (-1e30, 0)); each thread keeps an online
// (max, sum) with ONE exp per element (the sum is rescaled only when the max
// moves), and the lanes, then the warps, are merged with the same rescaling
// as B1's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kNegInit = -1e30f;   // finite: exp(kNegInit - kNegInit) = 1
constexpr unsigned kFull = 0xffffffffu;

struct RowStats {
  float mt, st, acc, ms, ss;
};

// (m, s) <- the online (max, exp-sum) pair of the union of two row parts
__device__ __forceinline__ void merge_lse(float& m, float& s, float mo,
                                          float so) {
  const float mn = fmaxf(m, mo);
  s = s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

__device__ __forceinline__ void merge(RowStats& a, const RowStats& b) {
  const float mt = fmaxf(a.mt, b.mt);
  const float ca = expf(a.mt - mt), cb = expf(b.mt - mt);
  a.st = a.st * ca + b.st * cb;
  a.acc = a.acc * ca + b.acc * cb;
  a.mt = mt;
  merge_lse(a.ms, a.ss, b.ms, b.ss);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
kd_kl_fwd_kernel(const float* __restrict__ lt, const float* __restrict__ ls,
                 float* __restrict__ kl, float* __restrict__ lse_t,
                 float* __restrict__ lse_s, int64_t rows, int64_t vocab,
                 float inv_temp, float temp_sq) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp: all lanes share `row`
  const float* t = lt + row * vocab;
  const float* s = ls + row * vocab;

  RowStats r{kNegInit, 0.f, 0.f, kNegInit, 0.f};
  for (int64_t j = lane; j < vocab; j += 32) {
    const float a = t[j] * inv_temp;
    const float b = s[j] * inv_temp;
    const float mt = fmaxf(r.mt, a);
    const float c = expf(r.mt - mt);
    const float e = expf(a - mt);
    r.st = r.st * c + e;
    r.acc = r.acc * c + e * (a - b);
    r.mt = mt;
    const float ms = fmaxf(r.ms, b);
    r.ss = r.ss * expf(r.ms - ms) + expf(b - ms);
    r.ms = ms;
  }
  for (int off = 16; off > 0; off >>= 1) {
    RowStats o;
    o.mt = __shfl_xor_sync(kFull, r.mt, off);
    o.st = __shfl_xor_sync(kFull, r.st, off);
    o.acc = __shfl_xor_sync(kFull, r.acc, off);
    o.ms = __shfl_xor_sync(kFull, r.ms, off);
    o.ss = __shfl_xor_sync(kFull, r.ss, off);
    merge(r, o);
  }
  if (lane == 0) {
    const float lt_row = r.mt + logf(r.st);
    const float ls_row = r.ms + logf(r.ss);
    lse_t[row] = lt_row;
    lse_s[row] = ls_row;
    kl[row] = (r.acc / r.st - lt_row + ls_row) * temp_sq;
  }
}

__global__ void kd_kl_bwd_kernel(const float* __restrict__ lt,
                                 const float* __restrict__ ls,
                                 const float* __restrict__ lse_t,
                                 const float* __restrict__ lse_s,
                                 const float* __restrict__ g,
                                 float* __restrict__ dls, int64_t rows,
                                 int64_t vocab, float inv_temp, float scale) {
  const int64_t n = rows * vocab;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int64_t r = i / vocab;
    const float pt = expf(lt[i] * inv_temp - lse_t[r]);
    const float ps = expf(ls[i] * inv_temp - lse_s[r]);
    dls[i] = g[r] * (ps - pt) * scale;
  }
}

// one thread's online (max, sum) over l[j] * inv_temp for j = j0, j0 + step, ...
__device__ __forceinline__ void lse_scan(const float* __restrict__ l,
                                         int64_t j0, int64_t vocab,
                                         int64_t step, float inv_temp,
                                         float& m, float& s) {
  for (int64_t j = j0; j < vocab; j += step) {
    const float a = l[j] * inv_temp;
    if (a > m) {
      s = s * expf(m - a) + 1.f;
      m = a;
    } else {
      s += expf(a - m);
    }
  }
}

__device__ __forceinline__ void warp_merge_lse(float& m, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(kFull, m, off);
    const float so = __shfl_xor_sync(kFull, s, off);
    merge_lse(m, s, mo, so);
  }
}

constexpr int kLseThreads = 256;

// a block of kLseThreads per row
__global__ void __launch_bounds__(kLseThreads)
row_lse_block_kernel(const float* __restrict__ l, float* __restrict__ out,
                     int64_t vocab, float inv_temp) {
  __shared__ float ms_sh[kLseThreads / 32], ss_sh[kLseThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;
  float m = kNegInit, s = 0.f;
  lse_scan(l + row * vocab, threadIdx.x, vocab, kLseThreads, inv_temp, m, s);
  warp_merge_lse(m, s);
  if (lane == 0) {
    ms_sh[warp] = m;
    ss_sh[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kLseThreads / 32 ? ms_sh[lane] : kNegInit;
    s = lane < kLseThreads / 32 ? ss_sh[lane] : 0.f;
    warp_merge_lse(m, s);
    if (lane == 0) out[row] = m + logf(s);
  }
}

}  // namespace

extern "C" {

// kl, lse_t, lse_s: (rows,) fp32 outputs; lt, ls: (rows, vocab) fp32,
// row-major and contiguous.  Returns the launch's cudaError_t.
int kd_kl_fwd_f32(const void* lt, const void* ls, void* kl, void* lse_t,
                  void* lse_s, int64_t rows, int64_t vocab, float inv_temp,
                  float temp_sq, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kd_kl_fwd_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lt), static_cast<const float*>(ls),
      static_cast<float*>(kl), static_cast<float*>(lse_t),
      static_cast<float*>(lse_s), rows, vocab, inv_temp, temp_sq);
  return static_cast<int>(cudaGetLastError());
}

// dls: (rows, vocab) fp32 output = g[row] * (p_S - p_T) * scale.
int kd_kl_bwd_f32(const void* lt, const void* ls, const void* lse_t,
                  const void* lse_s, const void* g, void* dls, int64_t rows,
                  int64_t vocab, float inv_temp, float scale, void* stream) {
  const int64_t n = rows * vocab;
  if (n == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32/SM
  kd_kl_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lt), static_cast<const float*>(ls),
      static_cast<const float*>(lse_t), static_cast<const float*>(lse_s),
      static_cast<const float*>(g), static_cast<float*>(dls), rows, vocab,
      inv_temp, scale);
  return static_cast<int>(cudaGetLastError());
}

// out: (rows,) fp32 = logsumexp(l[row] * inv_temp); l: (rows, vocab) fp32,
// row-major and contiguous.  Returns the launch's cudaError_t.
int row_lse_f32(const void* l, void* out, int64_t rows, int64_t vocab,
                float inv_temp, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  row_lse_block_kernel<<<static_cast<unsigned>(rows), kLseThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<float*>(out), vocab, inv_temp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
