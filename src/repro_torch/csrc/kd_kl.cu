// Fused softmax-KL distillation loss for Hopper (sm_90a): forward and the
// student gradient, fp32.
//
// Replaces the Pallas TPU kernels of the JAX reference:
//   kd_kl_fwd_f32  <- repro/kernels/kd_kl/kernel.py:_kd_kl_fwd_kernel (kd_kl_fwd)
//   kd_kl_bwd_f32  <- repro/kernels/kd_kl/kernel.py:_kd_kl_bwd_kernel (kd_kl_bwd)
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kNegInit = -1e30f;   // finite: exp(kNegInit - kNegInit) = 1
constexpr unsigned kFull = 0xffffffffu;

struct RowStats {
  float mt, st, acc, ms, ss;
};

__device__ __forceinline__ void merge(RowStats& a, const RowStats& b) {
  const float mt = fmaxf(a.mt, b.mt);
  const float ca = expf(a.mt - mt), cb = expf(b.mt - mt);
  a.st = a.st * ca + b.st * cb;
  a.acc = a.acc * ca + b.acc * cb;
  a.mt = mt;
  const float ms = fmaxf(a.ms, b.ms);
  a.ss = a.ss * expf(a.ms - ms) + b.ss * expf(b.ms - ms);
  a.ms = ms;
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

}  // extern "C"
