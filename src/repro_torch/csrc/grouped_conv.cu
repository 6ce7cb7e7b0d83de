// Client-batched convolution for Hopper (sm_90a), fp32 in and out, as
// implicit GEMMs on the tensor cores in 3xTF32: the forward and the filters'
// gradient.
//
// Replaces the Pallas TPU kernel of the JAX reference:
//   grouped_conv_fwd_f32 <- repro/kernels/grouped_conv/kernel.py:36
//                           _fwd_kernel (grouped_conv_fwd)
// grouped_conv_dw_f32 replaces no TPU kernel: the reference computes the
// weight gradient outside Pallas (repro/kernels/grouped_conv/ref.py, per-tap
// matmuls that XLA fuses).  It was added because the port's first form, one
// K-batched fp32 cuBLAS bmm a filter tap (ref.py shift_gemm_dw), tiles its
// long, thin reduction badly: at ResNet-8's K=4, N=64 each of the 81 calls a
// step covers a client's 16x16 to 64x64 output with one 32x32 tile and does
// not split the 4,096-65,536 pixels, so it runs on ~4 of the 132 SMs and
// took 78% of a FedGKD round.  Its design is below the forward's.
//
//   x (K, N, H, W, Cin) (*) w (K, kh, kw, Cin, Cout) -> y (K, N, OH, OW, Cout)
//
// every client k convolving its own examples with ITS OWN filters, NHWC and
// HWIO as in the reference.  Per client this is the GEMM
//   Y[k] (N*OH*OW, Cout) = A[k] (N*OH*OW, kh*kw*Cin) . W[k] (kh*kw*Cin, Cout)
// with A never formed.  SAME padding is not materialised: the kernel takes
// pad_top / pad_left (JAX puts the odd pixel at the bottom and right, so a
// stride-2 3x3 conv of 32 pixels pads 0 on top, 1 below) and the staging
// copy zero-fills every tap that falls outside the input, where the
// reference pads a copy of the input and its channels to 128 TPU lanes.
//
// What bounds it on the card: ResNet-8's convs move 1-34 MB each (inputs
// once, outputs once) and do 2*Cout*Cin*taps FLOP per output pixel.  In
// fp32 on the CUDA cores (67 TFLOP/s) the 3x3 layers are bound by their
// operations; in 3xTF32 on the tensor cores (three TF32 products for each
// fp32 one, 495 / 3 = 165 TFLOP/s of fp32 work) they are bound by their
// bytes, and the stem (Cin = 3) is bytes-bound either way.  The first form,
// one thread per output element reading kh*kw*Cin taps from device memory
// with int64 index math, reached 6% of the fp32 bound.
//
// Design:
//   * a block owns a box of output pixels of one client, <= 128 of them
//     (whole output rows, or whole images when an image has fewer pixels:
//     4 rows x 32 at 32x32, 8 x 16 at 16x16, two images at 8x8; the
//     plan comes from the wrapper, kernels/grouped_conv/ops.py conv_plan),
//     and a tile of BN <= 64 output channels (grid y covers wider Cout);
//   * its receptive window, (rows - 1) * stride + kh input rows by
//     (cols - 1) * stride + kw columns by a chunk of Cin, is staged in
//     shared memory by cp.async, whose zero fill covers the SAME pads, the
//     ragged edge and the channels past Cin; each filter tap is then a
//     shifted view of the window, where the first form read each input
//     element kh*kw times from device memory;
//   * beside it the filter slice w[k, :, :, c0:c0+chunk, n0:n0+BN] is
//     staged as a row-major [(i, j, c)][co] tile; Cin is streamed in chunks,
//     double-buffered when there are several;
//   * the GEMM's reduction index kk = (i, j, c) reaches the window through
//     a table of offsets in shared memory, off[kk] = (i*WC + j)*CCp + c, so
//     every operand read is window[pixel base + off[kk]]: no division per
//     element or per operand (the staging loops divide per copy, by a
//     multiply and a shift), and the stem's kh*kw*Cin = 27 pads to 32 with
//     zero filter rows and takes the same MMA path as the other layers
//     (measured on the H100 at K=4, N=64: 0.0215 ms against cuDNN's
//     0.036 and the first form's 0.161, 3.6x its bytes bound; a separate
//     CUDA-core path for it was not built);
//   * 4 warps, each owning 32 pixels x BN channels as 2 x BN/8 m16n8
//     accumulator tiles in registers, accumulate over kk with 3xTF32
//     mma.sync (tf32_mma.cuh), each 8-deep step's products summed from
//     zero on the tensor cores and added to the accumulators in fp32 (the
//     tensor cores' own accumulator drifts over a long reduction: a 1x1
//     conv over Cin = 2,048 with unit-variance outputs came 5.8e-5 from
//     fp32 when it carried the whole sum, past the 1e-5 relative gate, and
//     2.6e-6 with the fp32 adds, which cost 2-3% of the time); the
//     window's channel stride CCp is 4 mod 8
//     and the filter's row stride BN + 8, so the fragment reads of a
//     stride-1 conv are free of bank conflicts;
//   * int64 only for the base offsets of a client and an image; 32-bit
//     index math inside an image (the wrapper checks that it fits).
//
// The weight gradient, per client k the GEMM
//   dW[k] (kh*kw*Cin, Cout) = A[k]^T (kh*kw*Cin, N*OH*OW) . dY[k] (N*OH*OW, Cout)
// with A[k] the same implicit im2col, reduces over the output pixels: a
// long, thin product (65,536 pixels into a 144 x 16 output at ResNet-8's
// first block).  It moves the forward's bytes (x and dy read once, dw
// written once: 12-34 MB a conv at K=4, N=64, each bound by its bytes) and
// does its FLOP.  Design:
//   * the grid is (Cin chunks x output-channel tiles, splits of the pixel
//     axis, K); a block owns every filter tap of one Cin chunk by BN <= 32
//     output channels and reduces a run of whole pixel tiles of one client
//     (the forward's tiles, <= 128 pixels), so the output tiles and the
//     splits together fill the card where the output alone would not;
//   * each pixel tile's receptive window is staged by the forward's
//     stage_window (cp.async, zero fill for the pads, the ragged edge and
//     channels past Cin), its rows of dy beside it, double-buffered over
//     the split's tiles; each tap is a shifted view of the window through
//     per-row offsets held in registers: no padded or tap copy of x; a 1x1
//     conv's window is just the input pixels its outputs read, strided over
//     the input (a stride-2 projection stages no pixel it does not use);
//   * 4 warps share the tile's m16 row tiles (w, w + 4, ...), 3xTF32
//     mma.sync with each 8-pixel step added in fp32 (mma3_add), as the
//     forward, over reductions of up to 65,536 pixels a client here;
//   * the plan (kernels/grouped_conv/ops.py conv_dw_plan) fills a block's
//     rows with as many channels as its warps' m16 tiles hold, in chunks as
//     even as it can (a 1x1 conv up to 256 a chunk, on a smaller pixel
//     tile; a tile of several images shrinks first), and picks the splits
//     from the shapes: at least two blocks an SM where the pixels allow,
//     at least two tiles a split, the partials at most twice x's bytes;
//     one split writes dw directly, more write partials to the wrapper's
//     scratch and conv_dw_sum_splits adds them in split order, so every
//     call gives the same bits (no atomics).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32_mma.cuh"

namespace {

using tf32x3::Split;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileM = 32 * kWarps;  // output pixels of a block
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90

// n / d for 0 <= n < 2^31 by a multiply and a shift (division by an
// invariant integer: p = 31 + ceil(log2 d), mul = ceil(2^p / d)), so the
// staging loops and the pixel decode divide by the plan's runtime sizes in
// three instructions instead of an integer division's ~20
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv make_fast_div(int d) {
  if (d == 1) return {1u, 0u, 0u};
  int l = 0;
  while ((1u << l) < static_cast<unsigned>(d)) ++l;
  const unsigned p = 31 + l;
  return {static_cast<unsigned>(d),
          static_cast<unsigned>(((uint64_t{1} << p) + d - 1) / d), p - 32};
}

__device__ __forceinline__ int operator/(int n, FastDiv f) {
  return f.d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >>
                                     f.shr);
}

struct Geometry {
  int N, H, W, Cin, OH, OW, Cout, kh, kw, stride, pad_top, pad_left;
  int timgs, trows, tcols, cc, stages;  // the wrapper's tile plan
  int WR, WC, CCp, KP, BNp;             // window rows / cols / channel
                                        // stride, padded reduction, filter
                                        // row stride
  int nrb, ncb;                         // row / column blocks of an image
  int xvec, wvec;                       // floats per cp.async of x and w
  // divisors of the staging loops, the offset table and the pixel decode
  FastDiv by_row_vecs, by_cvs, by_wr, by_nvec, by_cc, by_kw, by_tcols,
      by_trows;
  // the weight gradient's: dy's row stride in shared memory, floats per
  // cp.async of dy, output-channel tiles, pixel tiles of a client, splits
  // of them, the block's m16 tiles, a tile's pixels and their round-up to 8
  int DYP, dvec, nct, ntiles, splits, mtb, tpix, kpix;
  FastDiv by_dvecs;
  // input pixels between neighbouring window pixels (1: the window is a
  // box of the input; a 1x1 conv's stride in the weight gradient, whose
  // window is then just the input pixels its outputs read), and window
  // pixels between neighbouring output pixels there (the stride, or 1)
  int step, wstride;
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// the window's channel stride: a multiple of 4 (16-byte copies) that is 4
// mod 8, so 8 neighbouring pixels x 4 channels hit 32 distinct banks
__host__ __device__ inline int channel_stride(int cc) {
  const int c4 = round_up(cc, 4);
  return c4 % 8 == 0 ? c4 + 4 : c4;
}

// the weight gradient's window channel stride: a multiple of 4 whose
// product with the window pixels' stride is 8 mod 16, so 4 neighbouring
// output pixels x 8 channels (a fragment of dw's A, pixels along the
// reduction) hit 32 distinct banks; where no such stride exists (a stride
// that is a multiple of 4), the channels rounded up to 4
__host__ __device__ inline int dw_channel_stride(int cc, int stride) {
  const int c4 = round_up(cc, 4);
  for (int c = c4; c < c4 + 16; c += 4)
    if (stride * c % 16 == 8) return c;
  return c4;
}

// the receptive window of a box of output pixels (images from img0, rows
// from oh0, columns from ow0) for Cin channels [c0, c0 + cc) into buf, as
// [image][window row][window col][channel] with channel stride CCp, its
// pixels g.step input pixels apart, by cp.async; zero outside the input and
// past Cin, so the SAME pads, the ragged edge and a last partial chunk read
// as zeros
__device__ __forceinline__ void stage_window(const Geometry& g,
                                             const float* __restrict__ x,
                                             const float* __restrict__ xk,
                                             int img0, int oh0, int ow0,
                                             int c0, float* buf) {
  const int64_t img_elems = static_cast<int64_t>(g.H) * g.W * g.Cin;
  const int cvs = g.cc / g.xvec;
  const int row_vecs = g.WC * cvs;
  const int total = g.timgs * g.WR * row_vecs;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / g.by_row_vecs;
    const int rem = e - r * row_vecs;
    const int wc = rem / g.by_cvs;
    const int c = (rem - wc * cvs) * g.xvec;
    const int im = r / g.by_wr;
    const int ih = oh0 * g.stride - g.pad_top + (r - im * g.WR) * g.step;
    const int iw = ow0 * g.stride - g.pad_left + wc * g.step;
    const int n = img0 + im;
    const bool in = n < g.N && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W &&
                    c0 + c < g.Cin;
    const float* src = in ? xk + static_cast<int64_t>(n) * img_elems +
                                (ih * g.W + iw) * g.Cin + c0 + c
                          : x;
    float* dst = buf + (r * g.WC + wc) * g.CCp + c;
    if (g.xvec == 4)
      tf32x3::cp_async16(dst, src, in);
    else
      tf32x3::cp_async4(dst, src, in);
  }
}

template <int NT>  // BN = 8 * NT output channels per block
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, Geometry g) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) float smem[];
  int* off = reinterpret_cast<int*>(smem);
  const int win_floats = g.timgs * g.WR * g.WC * g.CCp;
  const int stage_floats = win_floats + g.KP * g.BNp;
  float* stage0 = smem + g.KP;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int k = blockIdx.z;
  const int co0 = blockIdx.y * BN;
  int bx = blockIdx.x;
  const int cb = bx % g.ncb;
  bx /= g.ncb;
  const int rb = bx % g.nrb;
  const int img0 = (bx / g.nrb) * g.timgs;
  const int oh0 = rb * g.trows, ow0 = cb * g.tcols;

  // the offsets of the reduction index kk = (i, j, c) into the window; the
  // rows past kh*kw*cc (the K padding) read offset 0 against zero filters
  const int taps_cc = g.kh * g.kw * g.cc;
  for (int kk = tid; kk < g.KP; kk += kThreads) {
    int o = 0;
    if (kk < taps_cc) {
      const int tap = kk / g.by_cc;
      const int i = tap / g.by_kw;
      o = (i * g.WC + (tap - i * g.kw)) * g.CCp + (kk - tap * g.cc);
    }
    off[kk] = o;
  }
  for (int s = 0; s < g.stages; ++s) {
    float* fil = stage0 + s * stage_floats + win_floats;
    for (int e = taps_cc * g.BNp + tid; e < g.KP * g.BNp; e += kThreads)
      fil[e] = 0.f;
  }

  const int64_t img_elems = static_cast<int64_t>(g.H) * g.W * g.Cin;
  const float* xk = x + static_cast<int64_t>(k) * g.N * img_elems;
  const float* wk =
      w + static_cast<int64_t>(k) * g.kh * g.kw * g.Cin * g.Cout;

  auto stage = [&](int chunk, float* buf) {
    const int c0 = chunk * g.cc;
    stage_window(g, x, xk, img0, oh0, ow0, c0, buf);
    // the filter slice [(i, j, c)][co], zero past Cin and Cout
    float* fil = buf + win_floats;
    const int nvec = BN / g.wvec;
    const int ftotal = taps_cc * nvec;
    for (int e = tid; e < ftotal; e += kThreads) {
      const int kk = e / g.by_nvec;
      const int nn = (e - kk * nvec) * g.wvec;
      const int tap = kk / g.by_cc;
      const int c = kk - tap * g.cc;
      const bool in = c0 + c < g.Cin && co0 + nn < g.Cout;
      const float* src =
          in ? wk + (static_cast<int64_t>(tap) * g.Cin + c0 + c) * g.Cout +
                   co0 + nn
             : w;
      float* dst = fil + kk * g.BNp + nn;
      if (g.wvec == 4)
        tf32x3::cp_async16(dst, src, in);
      else
        tf32x3::cp_async4(dst, src, in);
    }
  };

  // this thread's 4 accumulator rows: pixels g, g+8 of the warp's two m16
  // tiles; their window bases and output offsets, found once
  int pbase[2][2];
  int64_t ybase[2][2];
  bool pvalid[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = warp * 32 + mt * 16 + h * 8 + gq;
      const int q = p / g.by_tcols;
      const int pc = p - q * g.tcols;
      const int pi = q / g.by_trows;
      const int pr = q - pi * g.trows;
      const bool valid = pi < g.timgs && img0 + pi < g.N &&
                         oh0 + pr < g.OH && ow0 + pc < g.OW;
      pvalid[mt][h] = valid;
      pbase[mt][h] =
          valid ? ((pi * g.WR + pr * g.stride) * g.WC + pc * g.stride) * g.CCp
                : 0;
      ybase[mt][h] =
          valid ? ((static_cast<int64_t>(k) * g.N + img0 + pi) * g.OH +
                   oh0 + pr) * static_cast<int64_t>(g.OW) * g.Cout +
                      static_cast<int64_t>(ow0 + pc) * g.Cout
                : 0;
    }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nchunks = (g.Cin + g.cc - 1) / g.cc;
  stage(0, stage0);
  tf32x3::cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    float* cur = stage0 + (g.stages == 2 ? (ch & 1) * stage_floats : 0);
    if (g.stages == 2 && ch + 1 < nchunks) {
      stage(ch + 1, stage0 + ((ch + 1) & 1) * stage_floats);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();

    const float* win = cur;
    const float* fil = cur + win_floats;
    for (int k0 = 0; k0 < g.KP; k0 += 8) {
      const int o0 = off[k0 + tq], o1 = off[k0 + tq + 4];
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float v[4] = {win[pbase[mt][0] + o0], win[pbase[mt][1] + o0],
                            win[pbase[mt][0] + o1], win[pbase[mt][1] + o1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Split s = tf32x3::split(v[e]);
          ah[mt][e] = s.hi;
          al[mt][e] = s.lo;
        }
      }
      const float* f0 = fil + (k0 + tq) * g.BNp + gq;
      const float* f1 = f0 + 4 * g.BNp;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const Split b0 = tf32x3::split(f0[nt * 8]);
        const Split b1 = tf32x3::split(f1[nt * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tf32x3::mma3_add(acc[mt][nt], ah[mt], al[mt], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if (g.stages == 1 && ch + 1 < nchunks) {
      stage(ch + 1, stage0);
      tf32x3::cp_async_commit();
    }
  }

  // c0, c1 are row g's channels 2t, 2t+1; c2, c3 row g+8's
  const bool pair = g.Cout % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!pvalid[mt][h]) continue;
      float* yp = y + ybase[mt][h];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + nt * 8 + 2 * tq;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pair && co + 1 < g.Cout) {
          *reinterpret_cast<float2*>(yp + co) = make_float2(v0, v1);
        } else {
          if (co < g.Cout) yp[co] = v0;
          if (co + 1 < g.Cout) yp[co + 1] = v1;
        }
      }
    }
}

template <int NT>
cudaError_t launch(const float* x, const float* w, float* y, const Geometry& g,
                   int K, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_fwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t gx = static_cast<int64_t>((g.N + g.timgs - 1) / g.timgs) *
                     g.nrb * g.ncb;
  const dim3 grid(static_cast<unsigned>(gx),
                  static_cast<unsigned>((g.Cout + 8 * NT - 1) / (8 * NT)),
                  static_cast<unsigned>(K));
  conv_fwd_kernel<NT><<<grid, kThreads, smem, stream>>>(x, w, y, g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the weight gradient: dw[k] ((i, j, c), co) = sum over output pixels p of
// x_tap(i, j)[k][p][c] * dy[k][p][co], split-K over the pixels
// ---------------------------------------------------------------------------

// The block's output tile is every tap of one Cin chunk by BN output
// channels: row r = tap * cc + c of the chunk, m16 tile r / 16.  Warp w owns
// the m16 tiles w, w + 4, w + 8, ... (at most 16 / NT of them, so a thread
// holds 64 accumulators whatever BN is) and every n8 tile.  Each pixel tile
// of the block's split stages its receptive window (stage_window) and its
// rows of dy, [pixel][co] with row stride DYP = 8 mod 16; the reduction's
// 8-deep steps are 8 pixels, read through the table of the pixels' window
// bases.  The window's channel stride times its pixels' stride (wstride) is
// 8 mod 16 (the wrapper's dw_channel_stride), so a fragment's 4 pixels x 8
// channels and dy's 4 pixels x 8 channels each hit 32 distinct banks.
template <int NT>
__global__ void __launch_bounds__(kThreads)
conv_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
               float* __restrict__ out, Geometry g) {
  constexpr int BN = 8 * NT;
  constexpr int MT = 16 / NT;
  extern __shared__ __align__(16) float smem[];
  int* ptab = reinterpret_cast<int*>(smem);
  const int win_floats = g.timgs * g.WR * g.WC * g.CCp;
  const int stage_floats = win_floats + g.kpix * g.DYP;
  float* stage0 = smem + kTileM;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int k = blockIdx.z, split = blockIdx.y;
  const int chunk = blockIdx.x / g.nct;
  const int co0 = (blockIdx.x - chunk * g.nct) * BN;
  const int c0 = chunk * g.cc;

  // the window base of each of a tile's pixels (the same for every tile);
  // the pixels past the tile read base 0 against zero rows of dy
  for (int p = tid; p < kTileM; p += kThreads) {
    const int q = p / g.by_tcols;
    const int pc = p - q * g.tcols;
    const int pi = q / g.by_trows;
    const int pr = q - pi * g.trows;
    ptab[p] = pi < g.timgs
                  ? ((pi * g.WR + pr * g.wstride) * g.WC + pc * g.wstride) *
                        g.CCp
                  : 0;
  }
  // this thread's rows g, g + 8 of each m16 tile it owns: their offsets in
  // the window, and whether they are rows of dw (c0 + c < Cin)
  const int taps_cc = g.kh * g.kw * g.cc;
  int off[MT][2], grow[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp + 4 * i) * 16 + h * 8 + gq;
      const int tap = r / g.by_cc;
      const int c = r - tap * g.cc;
      const int ii = tap / g.by_kw;
      const bool row = r < taps_cc && c0 + c < g.Cin;
      off[i][h] = row ? (ii * g.WC + tap - ii * g.kw) * g.CCp + c : 0;
      grow[i][h] = row ? tap * g.Cin + c0 + c : -1;
    }

  const float* xk = x + static_cast<int64_t>(k) * g.N * g.H * g.W * g.Cin;
  const float* dyk = dy + static_cast<int64_t>(k) * g.N * g.OH * g.OW * g.Cout;
  const int nrb = g.nrb, ncb = g.ncb;

  auto stage = [&](int64_t tile, float* buf) {
    const int cb = static_cast<int>(tile % ncb);
    const int64_t rest = tile / ncb;
    const int rb = static_cast<int>(rest % nrb);
    const int img0 = static_cast<int>(rest / nrb) * g.timgs;
    const int oh0 = rb * g.trows, ow0 = cb * g.tcols;
    stage_window(g, x, xk, img0, oh0, ow0, c0, buf);
    // dy's rows of the tile's pixels, zero past the output and past Cout
    float* dys = buf + win_floats;
    const int dvecs = BN / g.dvec;
    const int total = g.kpix * dvecs;
    for (int e = tid; e < total; e += kThreads) {
      const int p = e / g.by_dvecs;
      const int nn = (e - p * dvecs) * g.dvec;
      const int q = p / g.by_tcols;
      const int pc = p - q * g.tcols;
      const int pi = q / g.by_trows;
      const int pr = q - pi * g.trows;
      const bool in = p < g.tpix && img0 + pi < g.N && oh0 + pr < g.OH &&
                      ow0 + pc < g.OW && co0 + nn < g.Cout;
      const float* src =
          in ? dyk + (static_cast<int64_t>(img0 + pi) * g.OH + oh0 + pr) *
                         static_cast<int64_t>(g.OW) * g.Cout +
                   static_cast<int64_t>(ow0 + pc) * g.Cout + co0 + nn
             : dy;
      float* dst = dys + p * g.DYP + nn;
      if (g.dvec == 4)
        tf32x3::cp_async16(dst, src, in);
      else
        tf32x3::cp_async4(dst, src, in);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  // this split's pixel tiles, spread evenly (the plan keeps splits <=
  // ntiles, so none is empty)
  const int64_t t0 = static_cast<int64_t>(split) * g.ntiles / g.splits;
  const int64_t t1 = static_cast<int64_t>(split + 1) * g.ntiles / g.splits;
  stage(t0, stage0);
  tf32x3::cp_async_commit();
  for (int64_t t = t0; t < t1; ++t) {
    float* cur =
        stage0 + (g.stages == 2 ? static_cast<int>((t - t0) & 1) * stage_floats
                                : 0);
    if (g.stages == 2 && t + 1 < t1) {
      stage(t + 1, stage0 + static_cast<int>((t + 1 - t0) & 1) * stage_floats);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();

    const float* win = cur;
    const float* dys = cur + win_floats;
    for (int k0 = 0; k0 < g.kpix; k0 += 8) {
      const int pb0 = ptab[k0 + tq], pb1 = ptab[k0 + tq + 4];
      const float* d0 = dys + (k0 + tq) * g.DYP + gq;
      const float* d1 = d0 + 4 * g.DYP;
      Split b0[NT], b1[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b0[nt] = tf32x3::split(d0[nt * 8]);
        b1[nt] = tf32x3::split(d1[nt * 8]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (warp + 4 * i >= g.mtb) continue;  // warp-uniform
        const float v[4] = {win[pb0 + off[i][0]], win[pb0 + off[i][1]],
                            win[pb1 + off[i][0]], win[pb1 + off[i][1]]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Split s = tf32x3::split(v[e]);
          ah[e] = s.hi;
          al[e] = s.lo;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tf32x3::mma3_add(acc[i][nt], ah, al, b0[nt], b1[nt]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if (g.stages == 1 && t + 1 < t1) {
      stage(t + 1, stage0);
      tf32x3::cp_async_commit();
    }
  }

  // dw[k] itself where there is one split, else this split's partial
  // [k][split] of the scratch, both laid out as dw: row (tap, c), column co
  const int64_t dw_elems =
      static_cast<int64_t>(g.kh) * g.kw * g.Cin * g.Cout;
  float* dst = out + (static_cast<int64_t>(k) * g.splits + split) * dw_elems;
  const bool pair = g.Cout % 2 == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (grow[i][h] < 0) continue;
      float* row = dst + static_cast<int64_t>(grow[i][h]) * g.Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + nt * 8 + 2 * tq;
        const float v0 = acc[i][nt][2 * h], v1 = acc[i][nt][2 * h + 1];
        if (pair && co + 1 < g.Cout) {
          *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
        } else {
          if (co < g.Cout) row[co] = v0;
          if (co + 1 < g.Cout) row[co + 1] = v1;
        }
      }
    }
}

// dw[k][e] = the splits' partials [k][s][e] summed in split order, so every
// call gives the same bits
__global__ void conv_dw_sum_splits(const float* __restrict__ part,
                                   float* __restrict__ dw, int64_t dw_elems,
                                   int splits, int64_t total) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t k = e / dw_elems;
    const float* p = part + k * splits * dw_elems + (e - k * dw_elems);
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += p[j * dw_elems];
    dw[e] = s;
  }
}

template <int NT>
cudaError_t launch_dw(const float* x, const float* dy, float* out,
                      const Geometry& g, int K, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_dw_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const int chunks = (g.Cin + g.cc - 1) / g.cc;
  const dim3 grid(static_cast<unsigned>(chunks * g.nct),
                  static_cast<unsigned>(g.splits), static_cast<unsigned>(K));
  conv_dw_kernel<NT><<<grid, kThreads, smem, stream>>>(x, dy, out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors fp32, contiguous, on the stream's device.  The tile plan
// (tile_imgs x tile_rows x tile_cols output pixels, Cin chunk, bn output
// channels, stages) comes from the wrapper's conv_plan, with the shared
// memory it computed for it; a plan this kernel does not take, or whose
// bytes it counts otherwise, returns cudaErrorInvalidValue.  Returns the
// launch's cudaError_t.
int grouped_conv_fwd_f32(const void* x, const void* w, void* y, int64_t K,
                         int64_t N, int64_t H, int64_t W, int64_t Cin,
                         int64_t OH, int64_t OW, int64_t Cout, int kh, int kw,
                         int stride, int pad_top, int pad_left, int tile_imgs,
                         int tile_rows, int tile_cols, int chunk, int bn,
                         int stages, int smem_bytes, void* stream) {
  if (K * N * OH * OW * Cout == 0) return static_cast<int>(cudaSuccess);
  const int64_t kLim = int64_t{1} << 31;
  const bool bn_ok = bn == 8 || bn == 16 || bn == 32 || bn == 64;
  if (!bn_ok || K > 65535 || H * W * Cin >= kLim || OH * OW * Cout >= kLim ||
      kh * kw * Cin * Cout >= kLim || chunk < 1 || chunk > Cin ||
      stages < 1 || stages > 2 || tile_imgs < 1 || tile_rows < 1 ||
      tile_cols < 1 || tile_imgs * tile_rows * tile_cols > kTileM ||
      (tile_imgs > 1 && (tile_rows < OH || tile_cols < OW)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{};
  g.N = static_cast<int>(N);
  g.H = static_cast<int>(H);
  g.W = static_cast<int>(W);
  g.Cin = static_cast<int>(Cin);
  g.OH = static_cast<int>(OH);
  g.OW = static_cast<int>(OW);
  g.Cout = static_cast<int>(Cout);
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.pad_top = pad_top;
  g.pad_left = pad_left;
  g.timgs = tile_imgs;
  g.trows = tile_rows;
  g.tcols = tile_cols;
  g.cc = chunk;
  g.stages = stages;
  g.step = 1;
  g.WR = (tile_rows - 1) * stride + kh;
  g.WC = (tile_cols - 1) * stride + kw;
  g.CCp = channel_stride(chunk);
  g.KP = round_up(kh * kw * chunk, 8);
  g.BNp = bn + 8;
  g.nrb = (g.OH + tile_rows - 1) / tile_rows;
  g.ncb = (g.OW + tile_cols - 1) / tile_cols;
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w16 = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  g.xvec = (x16 && Cin % 4 == 0 && chunk % 4 == 0) ? 4 : 1;
  g.wvec = (w16 && Cout % 4 == 0) ? 4 : 1;
  g.by_row_vecs = make_fast_div(g.WC * (chunk / g.xvec));
  g.by_cvs = make_fast_div(chunk / g.xvec);
  g.by_wr = make_fast_div(g.WR);
  g.by_nvec = make_fast_div(bn / g.wvec);
  g.by_cc = make_fast_div(chunk);
  g.by_kw = make_fast_div(kw);
  g.by_tcols = make_fast_div(tile_cols);
  g.by_trows = make_fast_div(tile_rows);
  const int64_t smem =
      4 * (static_cast<int64_t>(g.KP) +
           static_cast<int64_t>(stages) *
               (static_cast<int64_t>(tile_imgs) * g.WR * g.WC * g.CCp +
                static_cast<int64_t>(g.KP) * g.BNp));
  if (smem != smem_bytes || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);

  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(K);
  const int sm = static_cast<int>(smem);
  cudaError_t err;
  switch (bn) {
    case 8:
      err = launch<1>(xp, wp, yp, g, k, sm, st);
      break;
    case 16:
      err = launch<2>(xp, wp, yp, g, k, sm, st);
      break;
    case 32:
      err = launch<4>(xp, wp, yp, g, k, sm, st);
      break;
    default:
      err = launch<8>(xp, wp, yp, g, k, sm, st);
      break;
  }
  return static_cast<int>(err);
}

// The weight gradient dw (K, kh, kw, Cin, Cout) of the conv of x (K, N, H,
// W, Cin) whose output gradient is dy (K, N, OH, OW, Cout), all fp32,
// contiguous, on the stream's device.  The plan (the pixel tile, the Cin
// chunk, bn, stages, the pixel splits, shared-memory bytes) comes from the
// wrapper's conv_dw_plan; with more than one split, scratch holds
// K * splits * kh * kw * Cin * Cout floats for the partials, which a second
// launch sums in split order.  A plan this kernel does not take, or whose
// bytes it counts otherwise, returns cudaErrorInvalidValue.  Returns the
// launches' cudaError_t.
int grouped_conv_dw_f32(const void* x, const void* dy, void* dw, void* scratch,
                        int64_t K, int64_t N, int64_t H, int64_t W,
                        int64_t Cin, int64_t OH, int64_t OW, int64_t Cout,
                        int kh, int kw, int stride, int pad_top, int pad_left,
                        int tile_imgs, int tile_rows, int tile_cols, int chunk,
                        int bn, int stages, int splits, int smem_bytes,
                        void* stream) {
  if (K * kh * kw * Cin * Cout == 0 || N * OH * OW == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t kLim = int64_t{1} << 31;
  const bool bn_ok = bn == 8 || bn == 16 || bn == 32;
  if (!bn_ok || K > 65535 || H * W * Cin >= kLim || OH * OW * Cout >= kLim ||
      kh * kw * Cin * Cout >= kLim || chunk < 1 || chunk > Cin ||
      stages < 1 || stages > 2 || tile_imgs < 1 || tile_rows < 1 ||
      tile_cols < 1 || tile_imgs * tile_rows * tile_cols > kTileM ||
      (tile_imgs > 1 && (tile_rows < OH || tile_cols < OW)) ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{};
  g.N = static_cast<int>(N);
  g.H = static_cast<int>(H);
  g.W = static_cast<int>(W);
  g.Cin = static_cast<int>(Cin);
  g.OH = static_cast<int>(OH);
  g.OW = static_cast<int>(OW);
  g.Cout = static_cast<int>(Cout);
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.pad_top = pad_top;
  g.pad_left = pad_left;
  g.timgs = tile_imgs;
  g.trows = tile_rows;
  g.tcols = tile_cols;
  g.cc = chunk;
  g.stages = stages;
  // a 1x1 conv stages only the input pixels its outputs read
  const bool pointwise = kh == 1 && kw == 1;
  g.step = pointwise ? stride : 1;
  g.wstride = pointwise ? 1 : stride;
  g.WR = (tile_rows - 1) * g.wstride + kh;
  g.WC = (tile_cols - 1) * g.wstride + kw;
  g.CCp = dw_channel_stride(chunk, g.wstride);
  g.nrb = (g.OH + tile_rows - 1) / tile_rows;
  g.ncb = (g.OW + tile_cols - 1) / tile_cols;
  const int64_t ntiles =
      (N + tile_imgs - 1) / tile_imgs * g.nrb * static_cast<int64_t>(g.ncb);
  const int nt = bn / 8;
  g.nct = static_cast<int>((Cout + bn - 1) / bn);
  g.mtb = (kh * kw * chunk + 15) / 16;
  const int64_t chunks = (Cin + chunk - 1) / chunk;
  if (ntiles >= kLim || splits < 1 || splits > ntiles || splits > 65535 ||
      g.mtb > 4 * (16 / nt) || chunks * g.nct >= kLim)
    return static_cast<int>(cudaErrorInvalidValue);
  g.ntiles = static_cast<int>(ntiles);
  g.splits = splits;
  g.tpix = tile_imgs * tile_rows * tile_cols;
  g.kpix = round_up(g.tpix, 8);
  g.DYP = bn % 16 == 8 ? bn : bn + 8;
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool dy16 = reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  g.xvec = (x16 && Cin % 4 == 0 && chunk % 4 == 0) ? 4 : 1;
  g.dvec = (dy16 && Cout % 4 == 0) ? 4 : 1;
  g.by_row_vecs = make_fast_div(g.WC * (chunk / g.xvec));
  g.by_cvs = make_fast_div(chunk / g.xvec);
  g.by_wr = make_fast_div(g.WR);
  g.by_cc = make_fast_div(chunk);
  g.by_kw = make_fast_div(kw);
  g.by_tcols = make_fast_div(tile_cols);
  g.by_trows = make_fast_div(tile_rows);
  g.by_dvecs = make_fast_div(bn / g.dvec);
  const int64_t smem =
      4 * (kTileM + static_cast<int64_t>(stages) *
                        (static_cast<int64_t>(tile_imgs) * g.WR * g.WC * g.CCp +
                         static_cast<int64_t>(g.kpix) * g.DYP));
  if (smem != smem_bytes || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);

  const float* xp = static_cast<const float*>(x);
  const float* dyp = static_cast<const float*>(dy);
  float* out = static_cast<float*>(splits > 1 ? scratch : dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(K);
  const int sm = static_cast<int>(smem);
  cudaError_t err;
  switch (bn) {
    case 8:
      err = launch_dw<1>(xp, dyp, out, g, k, sm, st);
      break;
    case 16:
      err = launch_dw<2>(xp, dyp, out, g, k, sm, st);
      break;
    default:
      err = launch_dw<4>(xp, dyp, out, g, k, sm, st);
      break;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t dw_elems = static_cast<int64_t>(kh) * kw * Cin * Cout;
  const int64_t total = K * dw_elems;
  const int64_t blocks = std::min<int64_t>((total + 255) / 256, 132 * 8);
  conv_dw_sum_splits<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      out, static_cast<float*>(dw), dw_elems, splits, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
