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
// What bounds it on the card.  On the FedGKD main path vocab is the class
// count (4-200) and rows = K*B = 64-1,024 a call: a call moves 2-800 KB
// and is bound by launch latency.  On the LM paths rows >= 2,048 and vocab
// is 32,000-256,206: a call reads 0.26-4.2 GB (fp32) and is bound by bytes
// (3.35 TB/s); its 12 operations an element take under a quarter of that
// time at the fp32 rate if the exponentials are cheap.  The first form, a
// warp per row with scalar loads and four accurate expf an element, held
// about half the byte bound at 2,048 rows: 256 blocks of 8 warps left an
// SM a quarter of its warps, each lane with 4-8 bytes in flight, and the
// time went per element, not per byte (its bf16 form was hardly faster).
//
// The design: two geometries, picked by vocab at launch.
//   vocab >= kBlockVocab: a block of kFwdThreads = 512 per row (2,048
//     blocks of 16 warps at the LM shapes).  Each thread reads 16 bytes (4
//     fp32 or 8 bf16) of each tensor a load, with kFwdUnroll loads of each
//     in flight before it uses them.  Row starts
//     are not 16-byte aligned in general (vocab 256,206 is odd; a view can
//     carry a storage offset), so each row peels a scalar head up to the
//     teacher row's first 16-byte address, taken from the pointer, then
//     runs the vector body and a scalar tail.  Where the teacher's and the
//     student's addresses differ by other than a multiple of 16 bytes, the
//     same kernel reads both with scalar loads.  A thread takes each
//     vector's max first, rescales (st, acc) or ss once, only when that max
//     moves (an accurate expf), and then spends ONE exponential an element
//     a tensor: 2^(a log2(e) - m log2(e)) on the MUFU's ex2 (one fma forms
//     the argument; results below 2^-126 flush to 0, which the row sums,
//     >= 1, cannot see).  The statistics stay in natural units (m is the
//     largest l / T), so the threads, the lanes (shuffles) and the warps
//     (shared memory) are merged by merge(), in a fixed order: the kernel is
//     deterministic, with no atomics.  A thread with no element merges as
//     (-1e30, 0, 0, -1e30, 0), finite.
//   vocab < kBlockVocab: the first form, a warp per row, lanes striding
//     over the vocab with the branch-free update (a warp covers a row of
//     <= 32 classes in one step).  The main path's class counts (4-200) lie
//     below the switch and every LM vocab (>= 32,000) above it.
// No probability tensor and no padded copy is ever written.
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

constexpr int kWarpsPerBlock = 8;   // the forward's warp-per-row form
// the forward's block-per-row form from kBlockVocab columns up: kFwdThreads
// a row, each with kFwdUnroll 16-byte loads of each tensor in flight
constexpr int64_t kBlockVocab = 1024;
constexpr int kFwdThreads = 512, kFwdUnroll = 2;
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

// the statistics of no element (finite, so merging two of them is exact)
__host__ __device__ __forceinline__ RowStats empty_row() {
  return RowStats{kNegInit, 0.f, 0.f, kNegInit, 0.f};
}

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

__device__ __forceinline__ void warp_merge(RowStats& r) {
  for (int off = 16; off > 0; off >>= 1) {
    RowStats o;
    o.mt = __shfl_xor_sync(kFull, r.mt, off);
    o.st = __shfl_xor_sync(kFull, r.st, off);
    o.acc = __shfl_xor_sync(kFull, r.acc, off);
    o.ms = __shfl_xor_sync(kFull, r.ms, off);
    o.ss = __shfl_xor_sync(kFull, r.ss, off);
    merge(r, o);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One thread's part of a row: RowStats with mt and ms also in log2 units
// (kept in step with them), so that an element costs one fma and one ex2.
struct FwdScan {
  RowStats r = empty_row();
  float mt2 = kNegInit * kLog2e, ms2 = kNegInit * kLog2e;

  // a, b: N teacher and student logits, already scaled by 1 / T
  template <int N>
  __device__ __forceinline__ void add(const float (&a)[N],
                                      const float (&b)[N]) {
    float vt = a[0], vs = b[0];
#pragma unroll
    for (int i = 1; i < N; ++i) {
      vt = fmaxf(vt, a[i]);
      vs = fmaxf(vs, b[i]);
    }
    if (vt > r.mt) {
      const float c = expf(r.mt - vt);
      r.st *= c;
      r.acc *= c;
      r.mt = vt;
      mt2 = vt * kLog2e;
    }
    if (vs > r.ms) {
      r.ss *= expf(r.ms - vs);
      r.ms = vs;
      ms2 = vs * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float e = exp2_approx(fmaf(a[i], kLog2e, -mt2));
      r.st += e;
      r.acc = fmaf(e, a[i] - b[i], r.acc);
      r.ss += exp2_approx(fmaf(b[i], kLog2e, -ms2));
    }
  }

  template <typename T>
  __device__ __forceinline__ void add1(T t, T s, float inv_temp) {
    const float a[1] = {to_f32(t) * inv_temp}, b[1] = {to_f32(s) * inv_temp};
    add(a, b);
  }
};

// 16 bytes of logits, scaled to fp32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 v, float inv_temp,
                                                float (&out)[N]) {
    out[0] = __uint_as_float(v.x) * inv_temp;
    out[1] = __uint_as_float(v.y) * inv_temp;
    out[2] = __uint_as_float(v.z) * inv_temp;
    out[3] = __uint_as_float(v.w) * inv_temp;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;   // the lower address in the lower half-word
  static __device__ __forceinline__ void unpack(uint4 v, float inv_temp,
                                                float (&out)[N]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16) * inv_temp;
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u) * inv_temp;
    }
  }
};

__device__ __forceinline__ void write_row(const RowStats& r, int64_t row,
                                          float* __restrict__ kl,
                                          float* __restrict__ lse_t,
                                          float* __restrict__ lse_s,
                                          float temp_sq) {
  const float lt_row = r.mt + logf(r.st);
  const float ls_row = r.ms + logf(r.ss);
  lse_t[row] = lt_row;
  lse_s[row] = ls_row;
  kl[row] = (r.acc / r.st - lt_row + ls_row) * temp_sq;
}

// vocab < kBlockVocab: a warp per row, scalar loads, the first form's
// branch-free update (four expf an element)
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
kd_kl_fwd_warp_kernel(const T* __restrict__ lt, const T* __restrict__ ls,
                      float* __restrict__ kl, float* __restrict__ lse_t,
                      float* __restrict__ lse_s, int64_t rows, int64_t vocab,
                      float inv_temp, float temp_sq) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp: all lanes share `row`
  const T* t = lt + row * vocab;
  const T* s = ls + row * vocab;
  RowStats r = empty_row();
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
  warp_merge(r);
  if (lane == 0) write_row(r, row, kl, lse_t, lse_s, temp_sq);
}

// vocab >= kBlockVocab: a block of kFwdThreads per row.  kVec: the
// teacher's and the student's addresses differ by a multiple of 16 bytes,
// so one head peeled from the teacher row aligns both.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
kd_kl_fwd_block_kernel(const T* __restrict__ lt, const T* __restrict__ ls,
                       float* __restrict__ kl, float* __restrict__ lse_t,
                       float* __restrict__ lse_s, int64_t vocab,
                       float inv_temp, float temp_sq) {
  using V = Vec16<T>;
  constexpr int kWarps = kFwdThreads / 32;
  __shared__ RowStats part[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const T* t = lt + row * vocab;
  const T* s = ls + row * vocab;
  FwdScan f;
  int64_t head = 0, nvec = 0;
  if constexpr (kVec) {
    const unsigned mis = static_cast<unsigned>(
        reinterpret_cast<uintptr_t>(t) & 15u);
    head = static_cast<int64_t>(((16u - mis) & 15u) / sizeof(T));
    if (head > vocab) head = vocab;
    nvec = (vocab - head) / V::N;
    if (tid < head) f.add1(t[tid], s[tid], inv_temp);
    const uint4* tv = reinterpret_cast<const uint4*>(t + head);
    const uint4* sv = reinterpret_cast<const uint4*>(s + head);
    int64_t v = tid;
    for (; v + (kFwdUnroll - 1) * kFwdThreads < nvec;
         v += kFwdUnroll * kFwdThreads) {
      uint4 rt[kFwdUnroll], rs[kFwdUnroll];
#pragma unroll
      for (int u = 0; u < kFwdUnroll; ++u) {
        rt[u] = tv[v + u * kFwdThreads];
        rs[u] = sv[v + u * kFwdThreads];
      }
#pragma unroll
      for (int u = 0; u < kFwdUnroll; ++u) {
        float a[V::N], b[V::N];
        V::unpack(rt[u], inv_temp, a);
        V::unpack(rs[u], inv_temp, b);
        f.add(a, b);
      }
    }
    for (; v < nvec; v += kFwdThreads) {
      float a[V::N], b[V::N];
      V::unpack(tv[v], inv_temp, a);
      V::unpack(sv[v], inv_temp, b);
      f.add(a, b);
    }
  }
  for (int64_t j = head + nvec * V::N + tid; j < vocab; j += kFwdThreads)
    f.add1(t[j], s[j], inv_temp);
  warp_merge(f.r);
  if (lane == 0) part[warp] = f.r;
  __syncthreads();
  if (warp == 0) {
    RowStats r = lane < kWarps ? part[lane] : empty_row();
    warp_merge(r);
    if (lane == 0) write_row(r, row, kl, lse_t, lse_s, temp_sq);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(lt);
  const T* s = static_cast<const T*>(ls);
  float* out[3] = {static_cast<float*>(kl), static_cast<float*>(lse_t),
                   static_cast<float*>(lse_s)};
  if (vocab < kBlockVocab) {
    const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    kd_kl_fwd_warp_kernel<T><<<static_cast<unsigned>(blocks),
                               kWarpsPerBlock * 32, 0, st>>>(
        t, s, out[0], out[1], out[2], rows, vocab, inv_temp, temp_sq);
  } else if (((reinterpret_cast<uintptr_t>(t) -
               reinterpret_cast<uintptr_t>(s)) & 15u) == 0) {
    kd_kl_fwd_block_kernel<T, true>
        <<<static_cast<unsigned>(rows), kFwdThreads, 0, st>>>(
            t, s, out[0], out[1], out[2], vocab, inv_temp, temp_sq);
  } else {
    kd_kl_fwd_block_kernel<T, false>
        <<<static_cast<unsigned>(rows), kFwdThreads, 0, st>>>(
            t, s, out[0], out[1], out[2], vocab, inv_temp, temp_sq);
  }
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
