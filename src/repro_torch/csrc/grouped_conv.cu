// Client-batched convolution forward for Hopper (sm_90a), fp32 in and out,
// as an implicit GEMM on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel of the JAX reference:
//   grouped_conv_fwd_f32 <- repro/kernels/grouped_conv/kernel.py:36
//                           _fwd_kernel (grouped_conv_fwd)
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

#include <cuda_runtime.h>
#include <stdint.h>

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
    // the receptive window, zero outside the input and past Cin
    const int cvs = g.cc / g.xvec;
    const int row_vecs = g.WC * cvs;
    const int total = g.timgs * g.WR * row_vecs;
    for (int e = tid; e < total; e += kThreads) {
      const int r = e / g.by_row_vecs;
      const int rem = e - r * row_vecs;
      const int wc = rem / g.by_cvs;
      const int c = (rem - wc * cvs) * g.xvec;
      const int im = r / g.by_wr;
      const int ih = oh0 * g.stride - g.pad_top + (r - im * g.WR);
      const int iw = ow0 * g.stride - g.pad_left + wc;
      const int n = img0 + im;
      const bool in = n < g.N && ih >= 0 && ih < g.H && iw >= 0 &&
                      iw < g.W && c0 + c < g.Cin;
      const float* src =
          in ? xk + static_cast<int64_t>(n) * img_elems +
                   (ih * g.W + iw) * g.Cin + c0 + c
             : x;
      float* dst = buf + (r * g.WC + wc) * g.CCp + c;
      if (g.xvec == 4)
        tf32x3::cp_async16(dst, src, in);
      else
        tf32x3::cp_async4(dst, src, in);
    }
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
  Geometry g;
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

}  // extern "C"
