// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel of the JAX reference:
//   ssd_scan_fwd_f32 <- repro/kernels/ssd_scan/kernel.py:_ssd_kernel
//                       (ssd_scan_fwd, wrapped by ops.py ssd_scan)
//
//   x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, G, N)
//     -> y (B, L, H, P), final state (B, H, P, N)
//
// Head h reads B/C group g = h / (H / G).  Per (batch b, head h) and chunk
// of Q rows, with da_k = dt_k * A_h and cum_i = sum_{k <= i} da_k inside
// the chunk (S the (P, N) state entering the chunk, zero at the start):
//
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) S C_i
//   S    <- exp(cum_last) S + sum_j dt_j exp(cum_last - cum_j) x_j B_j^T
//
// which is what _ssd_kernel computes per grid step; the TPU's sequential
// chunk grid axis is a loop inside the block here.
//
// What is done differently from the TPU kernel:
//   * The reference's layouts are read through their strides and the group
//     is taken by index: the TPU wrapper's repeat of B/C per head, its
//     transposes to (B*H, L, .) and its tile of A are gone.
//   * The ragged last chunk is bounds-checked, not padded: rows >= L load
//     as dt = 0 (identity steps) and zero B, C and x, and are not stored,
//     so the final state is the unpadded sequence's.
//   * exp(seg) is formed only where i >= j; the TPU kernel exponentiates the
//     whole (Q, Q) square and masks afterwards.  Masked entries are 0 with
//     no inf or NaN on the way.
//   * Precision: the in-chunk decays reach ~-2000 at full width (A = -1..-80
//     at init, 256 rows), so seg = cum_i - cum_j taken from fp32 cumsums
//     (the TPU kernel and the plain version) loses ~1e-4 absolute where it
//     matters, near seg = 0.  The prefix sums here are fp64, so seg is
//     exact to ~1e-12 before it is rounded to fp32 for the exp.
//
// What bounds it on the card: per (b*h, chunk) it does 2 Q^2 N (C.B^T) and
// 2 Q^2 P (the weighted x) FLOP on the i >= j half, and 2 Q N P each for
// C.S^T and the state update; at the LM path's shape (B=4, L=1023, H=80,
// P=64, N=128, Q=256) ~27 GFLOP against ~180 MB of inputs and outputs, so
// it is operations-bound (~0.4 ms at the fp32 CUDA-core peak).
//
// Design, simple first (fp32 FMA on the CUDA cores, no tensor cores):
//   * one block of 256 threads per (b, h); the (P, N) state stays in shared
//     memory across the chunk loop;
//   * a chunk is worked in row tiles of 32 (C rows) against column tiles
//     of 32 (B and x rows) on the causal half; the 32 x 32 block of
//     (C.B^T) exp(seg) dt goes through shared memory into the product with
//     x, each thread holding up to 4 rows x 4 head-dim columns of y;
//   * after a chunk's rows, a second pass over its column tiles folds
//     dt_j exp(cum_last - cum_j) x_j B_j^T into the state in place;
//   * shared rows of C, B and S are 16-byte aligned and padded to an odd
//     number of float4s, so the inner products read 4 values per load and
//     the 8 lanes of a quarter warp that read 8 rows hit 8 bank groups;
//     the state pass reads x transposed for the same reason;
//   * tiles are copied with cp.async, a warp per row and lanes along it,
//     every element of a tile in flight at once; the ragged edge is the
//     copy's zero fill.
// Supported: fp32, P <= 128, N <= 256, chunk <= 256; int64 offsets.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // rows of a row tile and of a column tile
constexpr int kTs = kTile + 4;     // row stride of Mt and of x transposed
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kMaxChunk = 256;
constexpr int kPSlots = kMaxP / 32;             // head-dim columns per lane
constexpr int kRowsPerThread = kTile / kWarps;  // y rows per thread

struct Strides4 {
  int64_t b, l, h, e;   // batch, sequence, head (or group), element
};

// The row stride of S, Ct and Bt: N rounded up to 4 floats (16-byte rows
// for float4 reads), then to an odd number of float4s, so that the 8 lanes
// of a quarter warp reading 8 different rows hit 8 different bank groups.
__host__ __device__ inline int row_stride(int n) {
  const int q = (n + 3) / 4;
  return 4 * (q % 2 == 1 ? q : q + 1);
}

struct Smem {
  double* cum;   // [kMaxChunk]   fp64 inclusive prefix sums of da
  float* dt;     // [kMaxChunk]   dt, then the state pass's weights
  float* S;      // [P][sn]       the state, columns >= N kept at 0
  float* Ct;     // [kTile][sn]
  float* Bt;     // [kTile][sn]
  float* Xt;     // [kTile][P] (y pass) or transposed [P][kTs] (state pass)
  float* Mt;     // [kTile][kTs]
};

__host__ __device__ inline size_t smem_bytes(int P, int N) {
  const int sn = row_stride(N);
  return sizeof(double) * kMaxChunk + sizeof(float) * kMaxChunk +
         sizeof(float) * (static_cast<size_t>(P) * sn + 2 * kTile * sn +
                          kTs * P + kTile * kTs);
}

__device__ inline Smem carve(void* base, int P, int N) {
  const int sn = row_stride(N);
  Smem s;
  s.cum = static_cast<double*>(base);
  s.dt = reinterpret_cast<float*>(s.cum + kMaxChunk);
  s.S = s.dt + kMaxChunk;
  s.Ct = s.S + P * sn;
  s.Bt = s.Ct + kTile * sn;
  s.Xt = s.Bt + kTile * sn;
  s.Mt = s.Xt + kTs * P;
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One 4-byte asynchronous copy from global to shared memory; when !valid
// nothing is read and the destination is filled with 0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Start the copies of kTile rows of a (rows, ncols) slab at `base` (row
// stride rs, element stride es) into dst[r * rstride + c * cstride]: a warp
// per row, lanes along the columns, every copy in flight at once (no
// register staging).  Rows >= nrows and columns in [ncols, cols) are
// filled with 0.  The caller waits with cp_async_wait_all + __syncthreads.
__device__ inline void load_tile(float* dst, int rstride, int cstride,
                                 const float* base, int64_t rs, int64_t es,
                                 int nrows, int ncols, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kTile; r += kWarps) {
    for (int c = lane; c < cols; c += 32) {
      const bool ok = r < nrows && c < ncols;
      cp_async4(dst + r * rstride + c * cstride,
                ok ? base + r * rs + c * es : base, ok);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ state_out, int64_t L, int H, int P, int G,
               int N, int Q, Strides4 xs, Strides4 dts, int64_t as,
               Strides4 bs, Strides4 cs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, P, N);
  const int sn = row_stride(N);
  const int npad = (N + 3) / 4 * 4;       // columns the float4 loops read
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x / H;
  const int h = static_cast<int>(blockIdx.x % H);
  const int g = h / (H / G);
  const double a = static_cast<double>(A[h * as]);

  const float* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const float* Bb = Bm + b * bs.b + g * bs.h;
  const float* Cb = Cm + b * cs.b + g * cs.h;
  // y is written contiguous (B, L, H, P)
  float* yb = y + (b * L * H + h) * P;
  const int64_t ys = static_cast<int64_t>(H) * P;

  for (int e = tid; e < P * sn; e += kThreads) sm.S[e] = 0.f;

  for (int64_t c0 = 0; c0 < L; c0 += Q) {
    const int nrows = static_cast<int>(L - c0 < Q ? L - c0 : Q);
    const float* xc = xb + c0 * xs.l;
    const float* Bc = Bb + c0 * bs.l;
    const float* Cc = Cb + c0 * cs.l;

    // ---- dt and the fp64 prefix sums of da over the chunk
    for (int i = tid; i < nrows; i += kThreads) sm.dt[i] = dtb[(c0 + i) * dts.l];
    __syncthreads();
    if (warp == 0) {
      const int per = (nrows + 31) / 32;
      const int lo = lane * per;
      const int hi = lo + per < nrows ? lo + per : nrows;
      double run = 0.0;
      for (int i = lo; i < hi; ++i) run += static_cast<double>(sm.dt[i]) * a;
      double incl = run;                               // inclusive lane scan
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      double acc = incl - run;                         // exclusive offset
      for (int i = lo; i < hi; ++i) {
        acc += static_cast<double>(sm.dt[i]) * a;
        sm.cum[i] = acc;
      }
    }
    __syncthreads();
    const int ntiles = (nrows + kTile - 1) / kTile;

    // ---- y, one row tile at a time, against the state entering the chunk
    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * kTile;
      load_tile(sm.Ct, sn, 1, Cc + i0 * cs.l, cs.l, cs.e, nrows - i0, N, npad);
      cp_async_wait_all();
      __syncthreads();

      // y[i][p], i = warp + 8 r, p = lane + 32 c
      float acc[kRowsPerThread][kPSlots];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int c = 0; c < kPSlots; ++c) acc[r][c] = 0.f;

      // incoming state: exp(cum_i) sum_n C[i][n] S[p][n]
      for (int n = 0; n < npad; n += 4) {
        float4 cv[kRowsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          cv[r] = ld4(sm.Ct + (warp + 8 * r) * sn + n);
#pragma unroll
        for (int c = 0; c < kPSlots; ++c) {
          const int p = lane + 32 * c;
          if (p < P) {
            const float4 sv = ld4(sm.S + p * sn + n);
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r)
              acc[r][c] = dot4(cv[r], sv, acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = i0 + warp + 8 * r;
        const float d = i < nrows ? expf(static_cast<float>(sm.cum[i])) : 0.f;
#pragma unroll
        for (int c = 0; c < kPSlots; ++c) acc[r][c] *= d;
      }

      // in-chunk: column tiles on the causal half
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        load_tile(sm.Bt, sn, 1, Bc + j0 * bs.l, bs.l, bs.e, nrows - j0, N,
                  npad);
        load_tile(sm.Xt, P, 1, xc + j0 * xs.l, xs.l, xs.e, nrows - j0, P, P);
        cp_async_wait_all();
        __syncthreads();
        {
          // M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for i >= j, as a
          // 2 x 2 micro-tile per thread: rows ia, ia + 16; cols ja, ja + 16
          const int ia = tid / 16, ja = tid % 16;
          const float* c0p = sm.Ct + ia * sn;
          const float* c1p = c0p + 16 * sn;
          const float* b0p = sm.Bt + ja * sn;
          const float* b1p = b0p + 16 * sn;
          float m00 = 0.f, m01 = 0.f, m10 = 0.f, m11 = 0.f;
          for (int n = 0; n < npad; n += 4) {
            const float4 cv0 = ld4(c0p + n), cv1 = ld4(c1p + n);
            const float4 bv0 = ld4(b0p + n), bv1 = ld4(b1p + n);
            m00 = dot4(cv0, bv0, m00);
            m01 = dot4(cv0, bv1, m01);
            m10 = dot4(cv1, bv0, m10);
            m11 = dot4(cv1, bv1, m11);
          }
          const float m[2][2] = {{m00, m01}, {m10, m11}};
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int i = i0 + ia + 16 * u, j = j0 + ja + 16 * v;
              float val = 0.f;
              if (j <= i && i < nrows)   // j < nrows follows
                val = m[u][v] *
                      expf(static_cast<float>(sm.cum[i] - sm.cum[j])) * sm.dt[j];
              sm.Mt[(ia + 16 * u) * kTs + ja + 16 * v] = val;
            }
        }
        __syncthreads();
        for (int j = 0; j < kTile; j += 4) {
          float4 mv[kRowsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
            mv[r] = ld4(sm.Mt + (warp + 8 * r) * kTs + j);
#pragma unroll
          for (int c = 0; c < kPSlots; ++c) {
            const int p = lane + 32 * c;
            if (p < P) {
              const float4 xv = make_float4(
                  sm.Xt[j * P + p], sm.Xt[(j + 1) * P + p],
                  sm.Xt[(j + 2) * P + p], sm.Xt[(j + 3) * P + p]);
#pragma unroll
              for (int r = 0; r < kRowsPerThread; ++r)
                acc[r][c] = dot4(mv[r], xv, acc[r][c]);
            }
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = i0 + warp + 8 * r;
        if (i < nrows) {
          float* yr = yb + (c0 + i) * ys;
#pragma unroll
          for (int c = 0; c < kPSlots; ++c) {
            const int p = lane + 32 * c;
            if (p < P) yr[p] = acc[r][c];
          }
        }
      }
      __syncthreads();
    }

    // ---- state for the next chunk: S <- exp(cum_last) S + sum_j w_j x_j B_j^T
    const double last = sm.cum[nrows - 1];
    const float decay = expf(static_cast<float>(last));
    for (int e = tid; e < P * sn; e += kThreads) sm.S[e] *= decay;
    // w_j = dt_j exp(cum_last - cum_j), kept in the dt buffer from here on
    __syncthreads();
    for (int j = tid; j < nrows; j += kThreads)
      sm.dt[j] *= expf(static_cast<float>(last - sm.cum[j]));
    __syncthreads();
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * kTile;
      // B rows as they are; x transposed, XT[p][j], for float4 reads along j
      load_tile(sm.Bt, sn, 1, Bc + j0 * bs.l, bs.l, bs.e, nrows - j0, N, N);
      load_tile(sm.Xt, 1, kTs, xc + j0 * xs.l, xs.l, xs.e, nrows - j0, P, P);
      cp_async_wait_all();
      __syncthreads();
      for (int n = lane; n < N; n += 32) {
        float bcol[kTile];   // w_j B[j][n]; rows >= nrows load as 0
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          bcol[j] = j0 + j < nrows ? sm.dt[j0 + j] * sm.Bt[j * sn + n] : 0.f;
        for (int p = warp; p < P; p += kWarps) {
          const float* xr = sm.Xt + p * kTs;
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kTile; j += 4) {
            const float4 xv = ld4(xr + j);
            s = fmaf(xv.x, bcol[j], s);
            s = fmaf(xv.y, bcol[j + 1], s);
            s = fmaf(xv.z, bcol[j + 2], s);
            s = fmaf(xv.w, bcol[j + 3], s);
          }
          sm.S[p * sn + n] += s;
        }
      }
      __syncthreads();
    }
  }

  float* so = state_out + (b * H + h) * static_cast<int64_t>(P) * N;
  for (int e = tid; e < P * N; e += kThreads) so[e] = sm.S[(e / N) * sn + e % N];
}

}  // namespace

extern "C" {

// x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, G, N): fp32 at the
// given element strides.  y: (B, L, H, P) contiguous; state: (B, H, P, N)
// contiguous.  Returns the launch's cudaError_t.
int ssd_scan_fwd_f32(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* state,
                     int64_t batch, int64_t L, int64_t H, int64_t P,
                     int64_t G, int64_t N, int64_t chunk, int64_t xsb,
                     int64_t xsl, int64_t xsh, int64_t xsp, int64_t dtsb,
                     int64_t dtsl, int64_t dtsh, int64_t as, int64_t bsb,
                     int64_t bsl, int64_t bsg, int64_t bsn, int64_t csb,
                     int64_t csl, int64_t csg, int64_t csn, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || chunk < 1 ||
      chunk > kMaxChunk || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * H == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = smem_bytes(static_cast<int>(P), static_cast<int>(N));
  // opt in to the largest size once, on the first call, outside any CUDA
  // graph capture that a later call may run under
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxP, kMaxN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  ssd_fwd_kernel<<<static_cast<unsigned>(batch * H), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), L, static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(G), static_cast<int>(N), static_cast<int>(chunk),
      Strides4{xsb, xsl, xsh, xsp}, Strides4{dtsb, dtsl, dtsh, 0}, as,
      Strides4{bsb, bsl, bsg, bsn}, Strides4{csb, csl, csg, csn});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
