// Fused softmax-KL distillation loss for Hopper (sm_90a): forward and the
// student gradient; and the row logsumexp of the LM cross-entropy.  Each
// reads fp32 or bf16 logits (the kernels are templates over the element
// type) and computes in fp32.
//
// Replaces the Pallas TPU kernels of the JAX reference:
//   kd_kl_fwd_{f32,bf16}  <- repro/kernels/kd_kl/kernel.py:_kd_kl_fwd_kernel
//                            (kd_kl_fwd)
//   kd_kl_bwd_{f32,bf16}  <- repro/kernels/kd_kl/kernel.py:_kd_kl_bwd_kernel
//                            (kd_kl_bwd)
//   row_lse_{f32,bf16}    <- repro/kernels/kd_kl/kernel.py:_row_lse_kernel
//                            (row_logsumexp)
//
// As the TPU kernels: the loads are cast to fp32, the forward's kl, lse_t
// and lse_s are fp32, the backward's dls is written in the logits' type
// (rounded once from fp32) and the row logsumexp is fp32.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kNegInit = -1e30f;   // finite: exp(kNegInit - kNegInit) = 1
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
kd_kl_fwd_kernel(const T* __restrict__ lt, const T* __restrict__ ls,
                 float* __restrict__ kl, float* __restrict__ lse_t,
                 float* __restrict__ lse_s, int64_t rows, int64_t vocab,
                 float inv_temp, float temp_sq) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp: all lanes share `row`
  const T* t = lt + row * vocab;
  const T* s = ls + row * vocab;

  RowStats r{kNegInit, 0.f, 0.f, kNegInit, 0.f};
  for (int64_t j = lane; j < vocab; j += 32) {
    const float a = to_f32(t[j]) * inv_temp;
    const float b = to_f32(s[j]) * inv_temp;
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

template <typename T>
__global__ void kd_kl_bwd_kernel(const T* __restrict__ lt,
                                 const T* __restrict__ ls,
                                 const float* __restrict__ lse_t,
                                 const float* __restrict__ lse_s,
                                 const float* __restrict__ g,
                                 T* __restrict__ dls, int64_t rows,
                                 int64_t vocab, float inv_temp, float scale) {
  const int64_t n = rows * vocab;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int64_t r = i / vocab;
    const float pt = expf(to_f32(lt[i]) * inv_temp - lse_t[r]);
    const float ps = expf(to_f32(ls[i]) * inv_temp - lse_s[r]);
    store(dls + i, g[r] * (ps - pt) * scale);
  }
}

// one thread's online (max, sum) over l[j] * inv_temp for j = j0, j0 + step, ...
template <typename T>
__device__ __forceinline__ void lse_scan(const T* __restrict__ l,
                                         int64_t j0, int64_t vocab,
                                         int64_t step, float inv_temp,
                                         float& m, float& s) {
  for (int64_t j = j0; j < vocab; j += step) {
    const float a = to_f32(l[j]) * inv_temp;
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
template <typename T>
__global__ void __launch_bounds__(kLseThreads)
row_lse_block_kernel(const T* __restrict__ l, float* __restrict__ out,
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

template <typename T>
cudaError_t kd_kl_fwd(const void* lt, const void* ls, void* kl, void* lse_t,
                      void* lse_s, int64_t rows, int64_t vocab,
                      float inv_temp, float temp_sq, void* stream) {
  if (rows == 0) return cudaSuccess;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kd_kl_fwd_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lt), static_cast<const T*>(ls),
      static_cast<float*>(kl), static_cast<float*>(lse_t),
      static_cast<float*>(lse_s), rows, vocab, inv_temp, temp_sq);
  return cudaGetLastError();
}

template <typename T>
cudaError_t kd_kl_bwd(const void* lt, const void* ls, const void* lse_t,
                      const void* lse_s, const void* g, void* dls,
                      int64_t rows, int64_t vocab, float inv_temp,
                      float scale, void* stream) {
  const int64_t n = rows * vocab;
  if (n == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32/SM
  kd_kl_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lt), static_cast<const T*>(ls),
      static_cast<const float*>(lse_t), static_cast<const float*>(lse_s),
      static_cast<const float*>(g), static_cast<T*>(dls), rows, vocab,
      inv_temp, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t row_lse(const void* l, void* out, int64_t rows, int64_t vocab,
                    float inv_temp, void* stream) {
  if (rows == 0) return cudaSuccess;
  row_lse_block_kernel<T><<<static_cast<unsigned>(rows), kLseThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<float*>(out), vocab, inv_temp);
  return cudaGetLastError();
}

}  // namespace

// The C entry points, one for each element type of the logits; each
// returns the launch's cudaError_t.
//   kd_kl_fwd_*: kl, lse_t, lse_s (rows,) fp32 outputs; lt, ls (rows,
//     vocab), row-major and contiguous.
//   kd_kl_bwd_*: dls (rows, vocab), the logits' type, = g[row] * (p_S -
//     p_T) * scale; lse_t, lse_s, g (rows,) fp32.
//   row_lse_*: out (rows,) fp32 = logsumexp(l[row] * inv_temp); l (rows,
//     vocab), row-major and contiguous.
#define KD_KL_ENTRIES(SUFFIX, T)                                            \
  extern "C" int kd_kl_fwd_##SUFFIX(const void* lt, const void* ls,        \
                                    void* kl, void* lse_t, void* lse_s,    \
                                    int64_t rows, int64_t vocab,           \
                                    float inv_temp, float temp_sq,         \
                                    void* stream) {                        \
    return static_cast<int>(kd_kl_fwd<T>(lt, ls, kl, lse_t, lse_s, rows,   \
                                         vocab, inv_temp, temp_sq,         \
                                         stream));                         \
  }                                                                        \
  extern "C" int kd_kl_bwd_##SUFFIX(const void* lt, const void* ls,        \
                                    const void* lse_t, const void* lse_s,  \
                                    const void* g, void* dls,              \
                                    int64_t rows, int64_t vocab,           \
                                    float inv_temp, float scale,           \
                                    void* stream) {                        \
    return static_cast<int>(kd_kl_bwd<T>(lt, ls, lse_t, lse_s, g, dls,     \
                                         rows, vocab, inv_temp, scale,     \
                                         stream));                         \
  }                                                                        \
  extern "C" int row_lse_##SUFFIX(const void* l, void* out, int64_t rows,  \
                                  int64_t vocab, float inv_temp,           \
                                  void* stream) {                          \
    return static_cast<int>(row_lse<T>(l, out, rows, vocab, inv_temp,      \
                                       stream));                           \
  }

KD_KL_ENTRIES(f32, float)
KD_KL_ENTRIES(bf16, __nv_bfloat16)
