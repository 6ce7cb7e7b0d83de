// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a), fp32 in and out,
// every product on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel of the JAX reference:
//   ssd_scan_fwd_f32 <- repro/kernels/ssd_scan/kernel.py:_ssd_kernel
//                       (ssd_scan_fwd, wrapped by ops.py ssd_scan)
//
//   x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, G, N)
//     [, the state entering the sequence S_0 (B, H, P, N)]
//     -> y (B, L, H, P), final state (B, H, P, N)
//
// Head h reads B/C group g = h / (H / G).  Per (batch b, head h) and chunk z
// of Q rows, with da_k = dt_k * A_h and cum_i = sum_{k <= i} da_k inside the
// chunk, and S_in[z] the (P, N) state entering chunk z (S_in[0] = S_0, or 0
// through ssd_scan_fwd_f32):
//
//   y_i       = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) S_in[z] C_i
//   S_z       = sum_j dt_j exp(cum_last - cum_j) x_j B_j^T
//   S_in[z+1] = exp(cum_last) S_in[z] + S_z
//
// which is what _ssd_kernel computes per grid step, walking the chunks in
// order.  Here the work is split as the SSD algorithm splits it (Dao & Gu,
// arXiv:2405.21060, section 6), into three launches:
//
//   1. ssd_chunk_kernel, two kinds of block, neither needing a state:
//      * chunk states: S_z for one (b, z, h) and a 64 x 64 tile of (P, N),
//        a (P x Q).(Q x N) product with the weights dt_j exp(cum_last -
//        cum_j) folded into x as it is read; S_z goes to the scratch
//        `states` (B, nc, H, P, N), exp(cum_last) to `decay` (B, nc, H);
//      * C.B^T: for one (b, z, group g) and one 64 x 64 (i, j) tile with
//        j-tile <= i-tile, written to the scratch `cb` in the accumulator's
//        fragment order.  It is computed ONCE per group, not per head: at
//        mamba2-2.7b G = 1, so its 80 heads share it, and C.B^T is 2/3 of
//        the in-chunk arithmetic at P = 64, N = 128 (the TPU kernel
//        recomputes it per head, since its grid is (batch * head, chunk));
//   2. ssd_pass_kernel: S_in[z] over z in order, elementwise over (b, h,
//      P * N), from S_0 (or 0), written in place of S_z; the final state is
//      the carry after the last chunk.  A long sequence costs O(nc) here,
//      not O(nc^2);
//   3. ssd_out_kernel: y for one (b, z, 64-row tile, h): exp(cum_i)
//      C.S_in[z]^T (skipped at z = 0 when there is no S_0), then for each
//      64-column tile j <= i the C.B^T tile read from `cb` straight into the
//      accumulator layout,
//      masked and weighted by exp(cum_i - cum_j) dt_j in registers, and
//      multiplied into x.
//
// What is done differently from the TPU kernel:
//   * The reference's layouts are read through their strides and the group
//     is taken by index: the TPU wrapper's repeat of B/C per head, its
//     transposes to (B*H, L, .) and its tile of A are gone.
//   * The ragged last chunk is bounds-checked, not padded: rows >= L load as
//     dt = 0 (identity steps) and zero B, C and x (cp.async's zero fill) and
//     are not stored, so the final state is the unpadded sequence's.
//   * exp(cum_i - cum_j) is formed only where i >= j; 8-column groups wholly
//     above a warp's diagonal, and tiles above the block's, are skipped.
//   * Precision: the in-chunk decays reach ~-2000 at full width (A = -1..-80
//     at init, 256 rows), so cum_i - cum_j taken from fp32 cumsums (the TPU
//     kernel and the plain version) loses ~1e-4 absolute near 0.  The prefix
//     sums here are fp64, so every decay is exact to ~1e-12 before it is
//     rounded to fp32 for the exp.  Each product is 3xTF32 (hi/lo split,
//     three TF32 products) with every 8-deep step summed from zero on the
//     tensor cores and added in fp32 (tf32_mma.cuh mma3_add): the tensor
//     cores' accumulator does not round to nearest.
//
// What bounds it on the card: at the LM path's shape (B=4, L=1023, H=80,
// P=64, G=1, N=128, Q=256) the function needs 16.2 GFLOP (C.B^T once per
// group, the weighted x and C.S^T and the chunk states per head), 3 x that
// in TF32 on the tensor cores: ~0.098 ms at 495 TFLOP/s, against ~184 MB of
// inputs and outputs (~0.055 ms at 3.35 TB/s), so it is operations-bound.
// The scratch adds ~42 MB written by stage 1, read and written by stage 2
// and read by stage 3.
//
// Fragment layouts: tf32_mma.cuh.  Every shared tile's row stride is 4 or 8
// mod 32 floats, chosen per read pattern so that the 32 lanes of a fragment
// read hit 32 banks.  Tiles are staged by cp.async: 16-byte copies where
// the wrapper's plan says every row start is 16-byte aligned (checked again
// here), 4-byte copies at any element stride otherwise.
// Supported: fp32, P <= 128, N <= 256, 1 <= chunk <= 256; int64 offsets.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32x3::Split;

constexpr int kThreads = 128;     // 4 warps: the chunk and output kernels
constexpr int kTile = 64;         // rows (and C.B^T's columns) of a tile
constexpr int kTileK = 32;        // N columns staged at once: C.B^T, C.S^T
constexpr int kLdK = kTileK + 4;  // 4 mod 32: fragments read along rows
constexpr int kTileS = 64;        // p and n of a chunk-state block
constexpr int kTileJ = 32;        // j rows staged at once: a chunk state
constexpr int kLdS = kTileS + 8;  // 8 mod 32: fragments read down columns
constexpr int kFrag = kTile * kTile;  // floats of one C.B^T tile in `cb`
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kMaxChunk = 256;
constexpr int kPassThreads = 256;
constexpr int kPassPer = 4;         // state elements a pass thread carries
constexpr int kPassAhead = 4;       // chunks a pass thread loads at once

struct Strides4 {
  int64_t b, l, h, e;   // batch, sequence, head (or group), element
};

struct Problem {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  float* y;
  float* state;
  float* states;   // (B, nc, H, P, N): S_z from stage 1, S_in[z] after stage 2
  float* cb;       // (B, nc, G, tri, kFrag): C.B^T tiles, fragment order
  float* decay;    // (B, nc, H): exp(sum of da over the chunk)
  int64_t L, as;
  int H, P, G, N, Q, nc, nt, tri;
  Strides4 xs, dts, bs, cs;
  int vec_x, vec_bc, vec_s;
  int has_init;    // S_in[0] = S_0, read by stage 2 (else 0)
};

// bytes of dynamic shared memory: the fp64 prefix sums and the dt (or
// weight) row of a chunk, then the stages of staged tiles
constexpr int kScanBytes = kMaxChunk * (sizeof(double) + sizeof(float));

__host__ __device__ constexpr int chunk_smem_bytes() {
  // chunk states: 2 stages of x [32][72] and B [32][72]; C.B^T: 2 stages
  // of C [64][36] and B [64][36] (the same 9,216 floats)
  return kScanBytes + 4 * (2 * 2 * kTileJ * kLdS > 2 * 2 * kTile * kLdK
                               ? 2 * 2 * kTileJ * kLdS
                               : 2 * 2 * kTile * kLdK);
}

__host__ __device__ constexpr int out_smem_bytes(int pc) {
  // C.S^T: 2 stages of C [64][36] and S [32 pc][36]; then, in the same
  // space, 2 stages of x [64][32 pc + 4]
  return kScanBytes +
         4 * (2 * (kTile + 32 * pc) * kLdK > 2 * kTile * (32 * pc + 4)
                  ? 2 * (kTile + 32 * pc) * kLdK
                  : 2 * kTile * (32 * pc + 4));
}

// Start copying a ROWS x COLS tile into dst (row stride ld floats):
// dst[r][c] = src[r * rs + c * es] for r < nrows and c < ncols, 0 elsewhere.
// vec4: 16-byte copies (es == 1, ncols and every row start a multiple of 4
// floats, src 16-byte aligned).  The caller commits and waits.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(float* dst, int ld, const float* src,
                                           int64_t rs, int64_t es, int nrows,
                                           int ncols, bool vec4) {
  if (vec4) {
    constexpr int per = COLS / 4;
    for (int e = threadIdx.x; e < ROWS * per; e += kThreads) {
      const int r = e / per, c = (e % per) * 4;
      const bool in = r < nrows && c < ncols;
      tf32x3::cp_async16(dst + r * ld + c, in ? src + r * rs + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kThreads) {
      const int r = e / COLS, c = e % COLS;
      const bool in = r < nrows && c < ncols;
      tf32x3::cp_async4(dst + r * ld + c, in ? src + r * rs + c * es : src,
                        in);
    }
  }
}

// dt of the chunk's rows [0, upto) into dts (0 past nrows) and their
// inclusive prefix sums of dt * a * log2(e) into cum, in fp64 (constant past
// nrows): every decay exp(cum_i - cum_j) is then one exp2f of an fp64
// difference rounded to fp32
__device__ void chunk_scan(const float* dtc, int64_t stride, double a_h,
                           int nrows, int upto, float* dts, double* cum) {
  const double a = a_h * 1.4426950408889634;   // log2(e)
  for (int i = threadIdx.x; i < upto; i += kThreads)
    dts[i] = i < nrows ? dtc[i * stride] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (upto + 31) / 32;
    const int lo = lane * per;
    const int hi = lo + per < upto ? lo + per : upto;
    double run = 0.0;
    for (int i = lo; i < hi; ++i) run += static_cast<double>(dts[i]) * a;
    double incl = run;                               // inclusive lane scan
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    double acc = incl - run;                         // exclusive offset
    for (int i = lo; i < hi; ++i) {
      acc += static_cast<double>(dts[i]) * a;
      cum[i] = acc;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Split s = tf32x3::split(v[e]);
    hi[e] = s.hi;
    lo[e] = s.lo;
  }
}

__device__ __forceinline__ int chunk_rows(const Problem& pb, int z) {
  const int64_t left = pb.L - static_cast<int64_t>(z) * pb.Q;
  return static_cast<int>(left < pb.Q ? left : pb.Q);
}

// 8-column groups of a 64 x 64 (i, j) tile that a warp's 16 rows need:
// none past the chunk's last row, none above the diagonal
__device__ __forceinline__ int live_groups(int i0, int j0, int nrows,
                                           int warp) {
  int live = (nrows - j0 + 7) / 8;
  if (live > 8) live = 8;
  if (i0 == j0 && live > 2 * warp + 2) live = 2 * warp + 2;
  return live;
}

// ---- stage 1a: S_z for one (b, z, h) and a 64 x 64 tile of (P, N); FULL:
// the tile's 64 n columns all lie inside N (no guard on the 8-column groups)
template <bool FULL>
__device__ void chunk_states(const Problem& pb, int64_t idx, double* cum,
                             float* w, float* buf) {
  const int ptiles = (pb.P + kTileS - 1) / kTileS;
  const int ntiles = (pb.N + kTileS - 1) / kTileS;
  const int nt = static_cast<int>(idx % ntiles);
  idx /= ntiles;
  const int pt = static_cast<int>(idx % ptiles);
  idx /= ptiles;
  const int h = static_cast<int>(idx % pb.H);
  idx /= pb.H;
  const int z = static_cast<int>(idx % pb.nc);
  const int64_t b = idx / pb.nc;
  const int g = h / (pb.H / pb.G);
  const int64_t c0 = static_cast<int64_t>(z) * pb.Q;
  const int nrows = chunk_rows(pb, z);
  const int njt = (nrows + kTileJ - 1) / kTileJ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;

  chunk_scan(pb.dt + b * pb.dts.b + h * pb.dts.h + c0 * pb.dts.l, pb.dts.l,
             static_cast<double>(pb.A[h * pb.as]), nrows, njt * kTileJ, w,
             cum);
  // w_j = dt_j exp(cum_last - cum_j), in place of dt; 0 past nrows
  const double last = cum[nrows - 1];
  for (int j = tid; j < njt * kTileJ; j += kThreads)
    w[j] *= exp2f(static_cast<float>(last - cum[j]));
  const int64_t slot = (b * pb.nc + z) * pb.H + h;
  if (pt == 0 && nt == 0 && tid == 0)
    pb.decay[slot] = exp2f(static_cast<float>(last));
  __syncthreads();

  const int p0 = pt * kTileS, n0 = nt * kTileS;
  const float* xsrc =
      pb.x + b * pb.xs.b + h * pb.xs.h + c0 * pb.xs.l + p0 * pb.xs.e;
  const float* bsrc =
      pb.Bm + b * pb.bs.b + g * pb.bs.h + c0 * pb.bs.l + n0 * pb.bs.e;
  constexpr int kStage = 2 * kTileJ * kLdS;   // x then B
  auto stage = [&](int jt) {
    float* xb = buf + (jt & 1) * kStage;
    const int j0 = jt * kTileJ;
    stage_tile<kTileJ, kTileS>(xb, kLdS, xsrc + j0 * pb.xs.l, pb.xs.l,
                               pb.xs.e, nrows - j0, pb.P - p0, pb.vec_x);
    stage_tile<kTileJ, kTileS>(xb + kTileJ * kLdS, kLdS, bsrc + j0 * pb.bs.l,
                               pb.bs.l, pb.bs.e, nrows - j0, pb.N - n0,
                               pb.vec_bc);
    tf32x3::cp_async_commit();
  };

  // this warp: p rows p0 + 16 warp + {g, g + 8}, n columns n0 + 8 nj + 2t
  const bool live = p0 + 16 * warp < pb.P;
  int ngroups = FULL ? 8 : (pb.N - n0 + 7) / 8;
  if (ngroups > 8) ngroups = 8;
  float acc[8][4];
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nj][e] = 0.f;

  stage(0);
  for (int jt = 0; jt < njt; ++jt) {
    if (jt + 1 < njt) {
      stage(jt + 1);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* xb = buf + (jt & 1) * kStage;
      const float* bb = xb + kTileJ * kLdS;
#pragma unroll
      for (int ks = 0; ks < kTileJ / 8; ++ks) {
        // A[p][j] = x_j[p] w_j: the x tile read down its columns
        const int k = ks * 8 + tq;
        const float w0 = w[jt * kTileJ + k], w1 = w[jt * kTileJ + k + 4];
        const float* xr = xb + k * kLdS + 16 * warp + gq;
        const float av[4] = {xr[0] * w0, xr[8] * w0, xr[4 * kLdS] * w1,
                             xr[4 * kLdS + 8] * w1};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        const float* br = bb + k * kLdS + gq;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          if (nj < ngroups) {
            const Split b0 = tf32x3::split(br[8 * nj]);
            const Split b1 = tf32x3::split(br[4 * kLdS + 8 * nj]);
            tf32x3::mma3_add(acc[nj], ah, al, b0, b1);
          }
        }
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

  if (!live) return;
  float* out = pb.states + slot * pb.P * pb.N;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 16 * warp + gq + 8 * (e >> 1);
      const int n = n0 + 8 * nj + 2 * tq + (e & 1);
      if (p < pb.P && n < pb.N) out[p * pb.N + n] = acc[nj][e];
    }
}

// ---- stage 1b: C.B^T for one (b, z, g) and one (i, j) tile, j-tile <= i-tile
__device__ void chunk_cb(const Problem& pb, int64_t idx, float* buf) {
  const int tile = static_cast<int>(idx % pb.tri);
  idx /= pb.tri;
  const int g = static_cast<int>(idx % pb.G);
  idx /= pb.G;
  const int z = static_cast<int>(idx % pb.nc);
  const int64_t b = idx / pb.nc;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= tile) ++it;
  const int jt = tile - it * (it + 1) / 2;
  const int64_t c0 = static_cast<int64_t>(z) * pb.Q;
  const int nrows = chunk_rows(pb, z);
  const int i0 = it * kTile, j0 = jt * kTile;
  if (i0 >= nrows) return;   // rows stage 3 never computes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;

  const float* csrc =
      pb.Cm + b * pb.cs.b + g * pb.cs.h + (c0 + i0) * pb.cs.l;
  const float* bsrc =
      pb.Bm + b * pb.bs.b + g * pb.bs.h + (c0 + j0) * pb.bs.l;
  constexpr int kStage = 2 * kTile * kLdK;    // C then B
  auto stage = [&](int kt) {
    float* cbuf = buf + (kt & 1) * kStage;
    const int n0 = kt * kTileK;
    stage_tile<kTile, kTileK>(cbuf, kLdK, csrc + n0 * pb.cs.e, pb.cs.l,
                              pb.cs.e, nrows - i0, pb.N - n0, pb.vec_bc);
    stage_tile<kTile, kTileK>(cbuf + kTile * kLdK, kLdK, bsrc + n0 * pb.bs.e,
                              pb.bs.l, pb.bs.e, nrows - j0, pb.N - n0,
                              pb.vec_bc);
    tf32x3::cp_async_commit();
  };

  const bool live = i0 + 16 * warp < nrows;
  const int ngroups = live_groups(i0, j0, nrows, warp);
  float acc[8][4];
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nj][e] = 0.f;

  const int nk = (pb.N + kTileK - 1) / kTileK;
  stage(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage(kt + 1);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* cbuf = buf + (kt & 1) * kStage;
      const float* bbuf = cbuf + kTile * kLdK;
#pragma unroll
      for (int ks = 0; ks < kTileK / 8; ++ks) {
        const float* cr = cbuf + (16 * warp + gq) * kLdK + ks * 8 + tq;
        const float av[4] = {cr[0], cr[8 * kLdK], cr[4], cr[8 * kLdK + 4]};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        const float* br = bbuf + gq * kLdK + ks * 8 + tq;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          if (nj < ngroups) {
            const Split b0 = tf32x3::split(br[8 * nj * kLdK]);
            const Split b1 = tf32x3::split(br[8 * nj * kLdK + 4]);
            tf32x3::mma3_add(acc[nj], ah, al, b0, b1);
          }
        }
      }
    }
    __syncthreads();
  }

  // fragment order: thread (warp, lane) keeps its 4 values of group nj at
  // ((warp * 8 + nj) * 32 + lane) * 4, which stage 3's same thread reads
  float* out = pb.cb +
               (((b * pb.nc + z) * pb.G + g) * pb.tri + tile) * kFrag +
               (warp * 8 * 32 + lane) * 4;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
    *reinterpret_cast<float4*>(out + nj * 32 * 4) =
        make_float4(acc[nj][0], acc[nj][1], acc[nj][2], acc[nj][3]);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const Problem pb, int64_t state_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);
  float* w = reinterpret_cast<float*>(cum + kMaxChunk);
  float* buf = w + kMaxChunk;
  const int64_t idx = blockIdx.x;
  const int ntiles = (pb.N + kTileS - 1) / kTileS;
  if (idx < state_blocks && pb.N - (idx % ntiles) * kTileS >= kTileS)
    chunk_states<true>(pb, idx, cum, w, buf);
  else if (idx < state_blocks)
    chunk_states<false>(pb, idx, cum, w, buf);
  else
    chunk_cb(pb, idx - state_blocks, buf);
}

// ---- stage 2: S_in[z] over the chunks in order, in place of S_z.  A
// thread carries kPassPer elements of one (b, h) state, kPassThreads apart
// (coalesced), and loads kPassAhead chunks of them before it stores any, so
// that 16 loads are in flight where one would be if each store came first
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                const float* __restrict__ init, float* __restrict__ state_out,
                int nc, int H, int64_t PN, int64_t per_bh) {
  const int64_t bh = blockIdx.x / per_bh;
  const int64_t e0 =
      (blockIdx.x % per_bh) * (kPassThreads * kPassPer) + threadIdx.x;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  float carry[kPassPer];
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) {
    const int64_t e = e0 + k * kPassThreads;
    carry[k] = init != nullptr && e < PN ? init[bh * PN + e] : 0.f;
  }
  for (int z0 = 0; z0 < nc; z0 += kPassAhead) {
    float sz[kPassAhead][kPassPer];
#pragma unroll
    for (int dz = 0; dz < kPassAhead; ++dz)
#pragma unroll
      for (int k = 0; k < kPassPer; ++k) {
        const int64_t e = e0 + k * kPassThreads;
        sz[dz][k] = z0 + dz < nc && e < PN
            ? states[((b * nc + z0 + dz) * H + h) * PN + e]
            : 0.f;
      }
#pragma unroll
    for (int dz = 0; dz < kPassAhead; ++dz) {
      if (z0 + dz >= nc) break;
      const int64_t slot = (b * nc + z0 + dz) * H + h;
      const float d = decay[slot];
#pragma unroll
      for (int k = 0; k < kPassPer; ++k) {
        const int64_t e = e0 + k * kPassThreads;
        if (e < PN) {
          states[slot * PN + e] = carry[k];
          carry[k] = fmaf(d, carry[k], sz[dz][k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) {
    const int64_t e = e0 + k * kPassThreads;
    if (e < PN) state_out[bh * PN + e] = carry[k];
  }
}

// ---- stage 3: y for one (b, z, 64-row tile, h); head dim padded to 32 PC,
// EXACT where P = 32 PC (no guard on y's 8-column groups)
template <int PC, bool EXACT>
__global__ void __launch_bounds__(kThreads)
ssd_out_kernel(const Problem pb) {
  constexpr int Pp = 32 * PC;
  constexpr int LDX = Pp + 4;     // 4 mod 32: x read at rows 2t, 2t + 1
  constexpr int NPT = Pp / 8;     // n8 tiles of y per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(cum + kMaxChunk);
  float* buf = dts + kMaxChunk;

  int64_t idx = blockIdx.x;
  const int h = static_cast<int>(idx % pb.H);
  idx /= pb.H;
  const int it = static_cast<int>(idx % pb.nt);
  idx /= pb.nt;
  const int z = static_cast<int>(idx % pb.nc);
  const int64_t b = idx / pb.nc;
  const int g = h / (pb.H / pb.G);
  const int64_t c0 = static_cast<int64_t>(z) * pb.Q;
  const int nrows = chunk_rows(pb, z);
  const int i0 = it * kTile;
  if (i0 >= nrows) return;        // a tile past the ragged last chunk's end
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;

  chunk_scan(pb.dt + b * pb.dts.b + h * pb.dts.h + c0 * pb.dts.l, pb.dts.l,
             static_cast<double>(pb.A[h * pb.as]), nrows, i0 + kTile, dts,
             cum);

  // this thread's rows of the chunk, and whether the warp has any
  const int r0 = i0 + 16 * warp + gq, r1 = r0 + 8;
  const bool live = i0 + 16 * warp < nrows;
  const int npt = EXACT ? NPT : (pb.P + 7) / 8;   // y's n8 tiles inside P
  float acc[NPT][4];
#pragma unroll
  for (int pn = 0; pn < NPT; ++pn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pn][e] = 0.f;

  // the incoming state: exp(cum_i) sum_n C[i][n] S_in[p][n]
  if (z > 0 || pb.has_init) {
    const float* csrc =
        pb.Cm + b * pb.cs.b + g * pb.cs.h + (c0 + i0) * pb.cs.l;
    const float* ssrc =
        pb.states + ((b * pb.nc + z) * pb.H + h) * pb.P * pb.N;
    constexpr int kStage = (kTile + Pp) * kLdK;   // C then S
    auto stage = [&](int kt) {
      float* cbuf = buf + (kt & 1) * kStage;
      const int n0 = kt * kTileK;
      stage_tile<kTile, kTileK>(cbuf, kLdK, csrc + n0 * pb.cs.e, pb.cs.l,
                                pb.cs.e, nrows - i0, pb.N - n0, pb.vec_bc);
      stage_tile<Pp, kTileK>(cbuf + kTile * kLdK, kLdK, ssrc + n0, pb.N, 1,
                             pb.P, pb.N - n0, pb.vec_s);
      tf32x3::cp_async_commit();
    };
    const int nk = (pb.N + kTileK - 1) / kTileK;
    stage(0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        stage(kt + 1);
        tf32x3::cp_async_wait<1>();
      } else {
        tf32x3::cp_async_wait<0>();
      }
      __syncthreads();
      if (live) {
        const float* cbuf = buf + (kt & 1) * kStage;
        const float* sbuf = cbuf + kTile * kLdK;
#pragma unroll
        for (int ks = 0; ks < kTileK / 8; ++ks) {
          const float* cr = cbuf + (16 * warp + gq) * kLdK + ks * 8 + tq;
          const float av[4] = {cr[0], cr[8 * kLdK], cr[4], cr[8 * kLdK + 4]};
          uint32_t ah[4], al[4];
          split4(av, ah, al);
          const float* sr = sbuf + gq * kLdK + ks * 8 + tq;
#pragma unroll
          for (int pn = 0; pn < NPT; ++pn) {
            if (pn < npt) {
              const Split b0 = tf32x3::split(sr[8 * pn * kLdK]);
              const Split b1 = tf32x3::split(sr[8 * pn * kLdK + 4]);
              tf32x3::mma3_add(acc[pn], ah, al, b0, b1);
            }
          }
        }
      }
      __syncthreads();   // the space is refilled next, or by x below
    }
    const float e0 = r0 < nrows ? exp2f(static_cast<float>(cum[r0])) : 0.f;
    const float e1 = r1 < nrows ? exp2f(static_cast<float>(cum[r1])) : 0.f;
#pragma unroll
    for (int pn = 0; pn < NPT; ++pn) {
      acc[pn][0] *= e0;
      acc[pn][1] *= e0;
      acc[pn][2] *= e1;
      acc[pn][3] *= e1;
    }
  }

  // in-chunk: column tiles jt <= it, (C.B^T o decay o dt) x
  const float* xsrc = pb.x + b * pb.xs.b + h * pb.xs.h + c0 * pb.xs.l;
  const float* cbt = pb.cb +
                     ((((b * pb.nc + z) * pb.G + g) * pb.tri) +
                      it * (it + 1) / 2) * kFrag +
                     (warp * 8 * 32 + lane) * 4;
  constexpr int kStage = kTile * LDX;
  auto stage = [&](int jt) {
    const int j0 = jt * kTile;
    stage_tile<kTile, Pp>(buf + (jt & 1) * kStage, LDX, xsrc + j0 * pb.xs.l,
                          pb.xs.l, pb.xs.e, nrows - j0, pb.P, pb.vec_x);
    tf32x3::cp_async_commit();
  };
  stage(0);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    if (jt < it) stage(jt + 1);
    const int ngroups = live ? live_groups(i0, j0, nrows, warp) : 0;
    float4 gv[8];                 // this thread's C.B^T values, in flight
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
      if (nj < ngroups)
        gv[nj] = __ldg(reinterpret_cast<const float4*>(cbt + jt * kFrag +
                                                       nj * 32 * 4));
    if (jt < it)
      tf32x3::cp_async_wait<1>();
    else
      tf32x3::cp_async_wait<0>();
    __syncthreads();
    const float* xb = buf + (jt & 1) * kStage;
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      if (nj < ngroups) {
        // M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i < nrows:
        // gv holds rows r0, r1 and columns ja, ja + 1 of the group
        const int ja = j0 + 8 * nj + 2 * tq;
        auto decayed = [&](float cb_ij, int i, int j) {
          return j <= i && i < nrows
                     ? cb_ij * exp2f(static_cast<float>(cum[i] - cum[j])) *
                           dts[j]
                     : 0.f;
        };
        // the accumulator gives this thread columns 2t and 2t + 1, where the
        // A operand wants keys t and t + 4: the group's keys are taken in
        // the permuted order (slot t = key 2t, slot t + 4 = key 2t + 1) and
        // x's fragment is read from the same keys' rows
        const float av[4] = {decayed(gv[nj].x, r0, ja),
                             decayed(gv[nj].z, r1, ja),
                             decayed(gv[nj].y, r0, ja + 1),
                             decayed(gv[nj].w, r1, ja + 1)};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        const float* xr = xb + (8 * nj + 2 * tq) * LDX + gq;
#pragma unroll
        for (int pn = 0; pn < NPT; ++pn) {
          if (pn < npt) {
            const Split b0 = tf32x3::split(xr[8 * pn]);
            const Split b1 = tf32x3::split(xr[LDX + 8 * pn]);
            tf32x3::mma3_add(acc[pn], ah, al, b0, b1);
          }
        }
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

  if (!live) return;
  // y is written contiguous (B, L, H, P)
#pragma unroll
  for (int pn = 0; pn < NPT; ++pn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? r0 : r1;
      const int p = 8 * pn + 2 * tq + (e & 1);
      if (i < nrows && p < pb.P)
        pb.y[((b * pb.L + c0 + i) * pb.H + h) * pb.P + p] = acc[pn][e];
    }
}

// 16-byte copies of rows of `width` floats are safe: unit element stride,
// the width and every other stride a multiple of 4 floats, base aligned
bool rows16(const void* base, int64_t width, int64_t es, int64_t s0,
            int64_t s1, int64_t s2) {
  return es == 1 && width % 4 == 0 && (s0 | s1 | s2) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

template <int PC>
cudaError_t launch_out(const Problem& pb, int64_t blocks, int smem,
                       cudaStream_t st) {
  if (pb.P == 32 * PC)
    ssd_out_kernel<PC, true>
        <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(pb);
  else
    ssd_out_kernel<PC, false>
        <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(pb);
  return cudaGetLastError();
}

template <int PC>
cudaError_t opt_in_out() {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_out_kernel<PC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      out_smem_bytes(PC));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_out_kernel<PC, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              out_smem_bytes(PC));
}

int ssd_fwd(const float* init, const void* x, const void* dt, const void* A,
            const void* Bm, const void* Cm, void* y, void* state,
            void* states, void* cb, void* decay, int64_t batch,
            int64_t L, int64_t H, int64_t P, int64_t G, int64_t N,
            int64_t chunk, int64_t xsb, int64_t xsl, int64_t xsh,
            int64_t xsp, int64_t dtsb, int64_t dtsl, int64_t dtsh,
            int64_t as, int64_t bsb, int64_t bsl, int64_t bsg,
            int64_t bsn, int64_t csb, int64_t csl, int64_t csg,
            int64_t csn, int vec_x, int vec_bc, int chunk_smem,
            int out_smem, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || chunk < 1 ||
      chunk > kMaxChunk || G < 1 || H < 0 || H % G != 0 || L < 0 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pc = static_cast<int>((P + 31) / 32);
  if ((vec_x && !rows16(x, P, xsp, xsb, xsl, xsh)) ||
      (vec_bc && !(rows16(Bm, N, bsn, bsb, bsl, bsg) &&
                   rows16(Cm, N, csn, csb, csl, csg))) ||
      chunk_smem != chunk_smem_bytes() || out_smem != out_smem_bytes(pc))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || H == 0) return static_cast<int>(cudaSuccess);
  // opt in to each kernel's shared memory once, on the first call, outside
  // any CUDA graph capture that a later call may run under
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t errs[] = {
        cudaFuncSetAttribute(ssd_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             chunk_smem_bytes()),
        opt_in_out<1>(), opt_in_out<2>(), opt_in_out<3>(), opt_in_out<4>()};
    for (const cudaError_t err : errs)
      if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }

  Problem pb;
  pb.x = static_cast<const float*>(x);
  pb.dt = static_cast<const float*>(dt);
  pb.A = static_cast<const float*>(A);
  pb.Bm = static_cast<const float*>(Bm);
  pb.Cm = static_cast<const float*>(Cm);
  pb.y = static_cast<float*>(y);
  pb.state = static_cast<float*>(state);
  pb.states = static_cast<float*>(states);
  pb.cb = static_cast<float*>(cb);
  pb.decay = static_cast<float*>(decay);
  pb.L = L;
  pb.as = as;
  pb.H = static_cast<int>(H);
  pb.P = static_cast<int>(P);
  pb.G = static_cast<int>(G);
  pb.N = static_cast<int>(N);
  pb.Q = static_cast<int>(chunk);
  pb.nc = static_cast<int>((L + chunk - 1) / chunk);
  pb.nt = static_cast<int>((chunk + kTile - 1) / kTile);
  pb.tri = pb.nt * (pb.nt + 1) / 2;
  pb.xs = Strides4{xsb, xsl, xsh, xsp};
  pb.dts = Strides4{dtsb, dtsl, dtsh, 0};
  pb.bs = Strides4{bsb, bsl, bsg, bsn};
  pb.cs = Strides4{csb, csl, csg, csn};
  pb.vec_x = vec_x;
  pb.vec_bc = vec_bc;
  pb.vec_s = N % 4 == 0;
  pb.has_init = init != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (pb.nc > 0) {
    const int64_t state_blocks = batch * pb.nc * H *
                                 ((P + kTileS - 1) / kTileS) *
                                 ((N + kTileS - 1) / kTileS);
    const int64_t cb_blocks = batch * pb.nc * G * pb.tri;
    ssd_chunk_kernel<<<static_cast<unsigned>(state_blocks + cb_blocks),
                       kThreads, chunk_smem, st>>>(pb, state_blocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t per_bh =
      (P * N + kPassThreads * kPassPer - 1) / (kPassThreads * kPassPer);
  ssd_pass_kernel<<<static_cast<unsigned>(batch * H * per_bh), kPassThreads,
                    0, st>>>(pb.states, pb.decay, init, pb.state, pb.nc,
                             pb.H, P * N, per_bh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pb.nc == 0) return static_cast<int>(err);
  const int64_t out_blocks = batch * pb.nc * pb.nt * H;
  switch (pc) {
    case 1: err = launch_out<1>(pb, out_blocks, out_smem, st); break;
    case 2: err = launch_out<2>(pb, out_blocks, out_smem, st); break;
    case 3: err = launch_out<3>(pb, out_blocks, out_smem, st); break;
    default: err = launch_out<4>(pb, out_blocks, out_smem, st); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, G, N): fp32 at the
// given element strides.  y: (B, L, H, P) contiguous; state: (B, H, P, N)
// contiguous.  Scratch, contiguous fp32: states (B, nc, H, P, N), cb (B, nc,
// G, tri, 4096) with nc = ceil(L / chunk), nt = ceil(chunk / 64), tri =
// nt (nt + 1) / 2, decay (B, nc, H).  The plan (kernels/ssd_scan/ops.py
// ssd_plan): vec_x / vec_bc ask for 16-byte copies of x / of B and C, which
// are refused where a row start would be misaligned; chunk_smem and
// out_smem are the two tiled kernels' shared bytes, recounted here.  After
// the call `states` holds the state entering each chunk.  Returns the
// first failing launch's cudaError_t.
int ssd_scan_fwd_f32(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* state,
                     void* states, void* cb, void* decay, int64_t batch,
                     int64_t L, int64_t H, int64_t P, int64_t G, int64_t N,
                     int64_t chunk, int64_t xsb, int64_t xsl, int64_t xsh,
                     int64_t xsp, int64_t dtsb, int64_t dtsl, int64_t dtsh,
                     int64_t as, int64_t bsb, int64_t bsl, int64_t bsg,
                     int64_t bsn, int64_t csb, int64_t csl, int64_t csg,
                     int64_t csn, int vec_x, int vec_bc, int chunk_smem,
                     int out_smem, void* stream) {
  return ssd_fwd(nullptr, x, dt, A, Bm, Cm, y, state, states, cb, decay,
                 batch, L, H, P, G, N, chunk, xsb, xsl, xsh, xsp, dtsb, dtsl,
                 dtsh, as, bsb, bsl, bsg, bsn, csb, csl, csg, csn, vec_x,
                 vec_bc, chunk_smem, out_smem, stream);
}

// The same, with the state entering the first chunk: init (B, H, P, N)
// contiguous fp32, read by the state pass; the output kernel then adds
// exp(cum_i) C.S_0^T in the first chunk as in every other.
int ssd_scan_fwd_init_f32(const void* init, const void* x, const void* dt,
                          const void* A, const void* Bm, const void* Cm,
                          void* y, void* state, void* states, void* cb,
                          void* decay, int64_t batch, int64_t L, int64_t H,
                          int64_t P, int64_t G, int64_t N, int64_t chunk,
                          int64_t xsb, int64_t xsl, int64_t xsh, int64_t xsp,
                          int64_t dtsb, int64_t dtsl, int64_t dtsh, int64_t as,
                          int64_t bsb, int64_t bsl, int64_t bsg, int64_t bsn,
                          int64_t csb, int64_t csl, int64_t csg, int64_t csn,
                          int vec_x, int vec_bc, int chunk_smem, int out_smem,
                          void* stream) {
  return ssd_fwd(static_cast<const float*>(init), x, dt, A, Bm, Cm, y, state,
                 states, cb, decay, batch, L, H, P, G, N, chunk, xsb, xsl,
                 xsh, xsp, dtsb, dtsl, dtsh, as, bsb, bsl, bsg, bsn, csb,
                 csl, csg, csn, vec_x, vec_bc, chunk_smem, out_smem, stream);
}

}  // extern "C"
