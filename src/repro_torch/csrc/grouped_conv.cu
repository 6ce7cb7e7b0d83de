// Client-batched convolution forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel of the JAX reference:
//   grouped_conv_fwd_f32 <- repro/kernels/grouped_conv/kernel.py:_fwd_kernel
//                           (grouped_conv_fwd)
//
//   x (K, N, H, W, Cin) (*) w (K, kh, kw, Cin, Cout) -> y (K, N, OH, OW, Cout)
//
// every client k convolving its own examples with ITS OWN filters, NHWC and
// HWIO as in the reference.  SAME padding is not materialised: the kernel
// takes pad_top / pad_left (JAX's SAME puts the odd pixel at the bottom and
// right, so a stride-2 3x3 conv of 32 pixels pads 0 on top, 1 below) and
// bounds-checks each tap, where the reference pads a copy of the input and
// pads the channels to 128 TPU lanes.
//
// What bounds it on the card: ResNet-8's convs at K=4, N=64 do ~25 MFLOP
// per example forward, 6.4 GFLOP per local step over 9 launches; the bytes
// (inputs once, outputs once) are ~40 MB per step, so at the fp32 CUDA-core
// peak the step is bound by arithmetic (~0.1 ms) rather than by memory
// (~0.012 ms).  This first kernel is a direct convolution: one thread per
// output element, the kh*kw*Cin taps of that client's filter accumulated
// in an fp32 register with FMA, neighbouring threads on neighbouring output
// channels so the filter reads coalesce and the input reads broadcast.  It
// leaves the tensor cores and shared-memory tiling to a later change.
// Offsets are int64: later models (ResNet-50 at 64x64) exceed 2^31 elements
// per stacked activation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
grouped_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ y, int64_t K, int64_t N, int64_t H,
                        int64_t W, int64_t Cin, int64_t OH, int64_t OW,
                        int64_t Cout, int kh, int kw, int stride, int pad_top,
                        int pad_left) {
  const int64_t total = K * N * OH * OW * Cout;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const int64_t co = idx % Cout;
    int64_t t = idx / Cout;
    const int64_t ow = t % OW;
    t /= OW;
    const int64_t oh = t % OH;
    t /= OH;
    const int64_t n = t % N;
    const int64_t k = t / N;

    const float* xk = x + (k * N + n) * H * W * Cin;
    const float* wk = w + k * kh * kw * Cin * Cout + co;
    float acc = 0.f;
    for (int i = 0; i < kh; ++i) {
      const int64_t ih = oh * stride - pad_top + i;
      if (ih < 0 || ih >= H) continue;
      for (int j = 0; j < kw; ++j) {
        const int64_t iw = ow * stride - pad_left + j;
        if (iw < 0 || iw >= W) continue;
        const float* xp = xk + (ih * W + iw) * Cin;
        const float* wp = wk + static_cast<int64_t>(i * kw + j) * Cin * Cout;
        for (int64_t c = 0; c < Cin; ++c) acc = fmaf(xp[c], wp[c * Cout], acc);
      }
    }
    y[idx] = acc;
  }
}

}  // namespace

extern "C" {

// All tensors fp32, contiguous, on the stream's device.  Returns the
// launch's cudaError_t.
int grouped_conv_fwd_f32(const void* x, const void* w, void* y, int64_t K,
                         int64_t N, int64_t H, int64_t W, int64_t Cin,
                         int64_t OH, int64_t OW, int64_t Cout, int kh, int kw,
                         int stride, int pad_top, int pad_left, void* stream) {
  const int64_t total = K * N * OH * OW * Cout;
  if (total == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;  // grid-stride
  grouped_conv_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), K, N, H, W, Cin, OH, OW, Cout, kh, kw, stride,
      pad_top, pad_left);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
