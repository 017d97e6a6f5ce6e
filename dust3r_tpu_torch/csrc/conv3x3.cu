// 3x3 stride-1 same-pad convolution for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces dust3r_tpu/ops/conv3x3.py::_conv3x3_pallas_raw (the Pallas TPU
// kernel _tap_kernel plus its vertical combine). Per output pixel (b, h, w)
// and output channel n:
//   y[b, h, w, n] = bias[n] + sum_{dy, dx, c} x[b, h+dy-1, w+dx-1, c] * W[dy, dx, c, n]
// with x and W rounded to bf16, the products summed in fp32, zero padding
// outside the image. x and y are NHWC fp32 (a channels_last tensor); W comes
// packed by the wrapper as bf16 (9 * Cin, Cout), row (dy * 3 + dx) * Cin + c.
//
// What bounds it on an H100: at the DPT heads' shapes (Cin 96-768, Cout
// 32-256, up to 8 x 384 x 512 pixels) a conv is an implicit GEMM with
// M = B*H*W pixels, N = Cout and K = 9*Cin: 2*M*N*K FLOPs against about
// 4*M*(Cin + Cout) bytes of x and y, hundreds of FLOPs per byte, so the bf16
// tensor-core rate is the bound, and the nine shifted copies of x that a
// plain GEMM would need must never reach device memory. The design:
//   * one block per (64 or 32 output channels, 128 output pixels) tile,
//     four warps of 64 x 32 (or 64 x 16); blockIdx.x walks the channel
//     tiles, so the blocks that read the same pixels run side by side and
//     share them in L2;
//   * the k-loop of conv3x3_igemm.cuh over the nine taps x Cin/32 channel
//     chunks (x rounded to bf16 on its way to a double-buffered shared tile,
//     the next step's global loads in flight during this step's products),
//     mma.sync m16n8k16 bf16 with fp32 accumulators in registers;
//   * the bias added in the epilogue, y stored once in fp32.
// Not carried over from the TPU design: the three tap-column matmuls into a
// bf16 Z of 3 * Cout channels and the vertical combine outside the kernel
// (Z never exists here, so it is not rounded), and the row-block sizing
// against VMEM. wgmma, TMA and a deeper pipeline are later work.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include "conv3x3_igemm.cuh"

namespace {

using namespace conv3x3_igemm;

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv3x3_igemm_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                     const float* __restrict__ bias, float* __restrict__ y, int H, int W,
                     int cin, int cout, int npix) {
  constexpr int kWN = BN / 2;  // channels per warp
  constexpr int kNT = kWN / 8;  // 8-column mma tiles per warp
  __shared__ __align__(16) Tiles<BN> sm;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  Acc<BN> acc;
  mainloop<BN>(x, wp, H, W, cin, cout, npix, n0, m0, sm, acc);

  // epilogue: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of
  // each 16 x 8 tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + warp_n * kWN + nt * 8 + 2 * t;
    const float b0 = bias ? bias[col] : 0.f;
    const float b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + warp_m * 64 + mt * 16 + g + 8 * half;
        if (m < npix) {
          *reinterpret_cast<float2*>(y + (size_t)m * cout + col) =
              make_float2(acc[mt][nt][2 * half] + b0, acc[mt][nt][2 * half + 1] + b1);
        }
      }
    }
  }
}

template <int BN>
int launch(const float* x, const __nv_bfloat16* wp, const float* bias, float* y, int batch,
           int H, int W, int cin, int cout, cudaStream_t stream) {
  const int npix = batch * H * W;
  const dim3 grid(cout / BN, (npix + kBM - 1) / kBM);
  conv3x3_igemm_kernel<BN><<<grid, kThreads, 0, stream>>>(x, wp, bias, y, H, W, cin, cout,
                                                          npix);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, H, W, cin) fp32; wp: (9 * cin, cout) bf16; bias: (cout,) fp32
// or null; y: (batch, H, W, cout) fp32; all contiguous, 16-byte aligned.
// cin and cout multiples of 32. Returns the CUDA error code of the launch;
// -1 for channel counts it does not take.
extern "C" int dust3r_conv3x3(const void* x, const void* wp, const void* bias, void* y,
                              int batch, int H, int W, int cin, int cout, void* stream) {
  if (cin % kBK || cout % 32 || cin <= 0 || cout <= 0) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wp);
  const float* b = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  if (cout % 64 == 0) return launch<64>(xf, w, b, yf, batch, H, W, cin, cout, s);
  return launch<32>(xf, w, b, yf, batch, H, W, cin, cout, s);
}
