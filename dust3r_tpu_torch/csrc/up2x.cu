// 2x bilinear upsample with align_corners=True for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces scripts/exp_up_pallas_r2.py::up2x_phase_pallas (the Pallas TPU
// kernel _up_kernel), which computes dust3r_tpu/models/heads.py::
// upsample2x_align_corners. For x (B, Hc, Wc, C) NHWC fp32 it writes
// y (B, 2Hc, 2Wc, C) NHWC fp32. Per axis of n coarse samples, output o reads
// src(o) = o (n - 1) / (2n - 1), whose floor index and weight have a closed
// form with k = o / 2 (the even/odd form of heads.py:_up2x_axis_lerp):
//   o = 2k:      x[max(k-1, 0)] * k/(2n-1)       + x[k] * (1 - k/(2n-1))
//   o = 2k + 1:  x[k] * (1 - (n-1-k)/(2n-1))     + x[min(k+1, n-1)] * (n-1-k)/(2n-1)
// The rows are blended first, then the columns, as the plain version does.
//
// What bounds it on an H100: ~6 FLOPs per output value against 4 bytes
// written and 1 read, so memory: each input byte read once and each output
// byte written once is 5 x 4 * B*Hc*Wc*C bytes at 3.35 TB/s. The design:
//   * one thread per output pixel and group of 4 channels, channels fastest,
//     so a warp reads and writes 512 contiguous bytes;
//   * four 16-byte loads (the 2 x 2 source pixels; the reuse between
//     neighbouring outputs is served by L1 and L2) and one 16-byte store;
//   * the weights computed from the indices in fp32, no tables.
// Not carried over from the TPU design: the four phase channel groups
// (B, Hc, Wc, 4C) that spared the TPU its sublane relayouts. Here they would
// only cost a permute, so the kernel writes the fine NHWC map directly, and
// takes any Hc, Wc >= 1 (no 4-row blocks).
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Source indices and weights of output index o along an axis of n samples.
__device__ __forceinline__ void axis_taps(int o, int n, int& i0, int& i1, float& a0,
                                          float& a1) {
  const int k = o >> 1;
  const float den = static_cast<float>(2 * n - 1);
  if ((o & 1) == 0) {
    i0 = max(k - 1, 0);
    i1 = k;
    a0 = static_cast<float>(k) / den;
    a1 = 1.f - a0;
  } else {
    i0 = k;
    i1 = min(k + 1, n - 1);
    a1 = static_cast<float>(n - 1 - k) / den;
    a0 = 1.f - a1;
  }
}

__device__ __forceinline__ float4 lerp4(float a0, float4 u, float a1, float4 v) {
  return make_float4(a0 * u.x + a1 * v.x, a0 * u.y + a1 * v.y, a0 * u.z + a1 * v.z,
                     a0 * u.w + a1 * v.w);
}

__global__ void __launch_bounds__(kThreads)
up2x_align_corners_kernel(const float4* __restrict__ x, float4* __restrict__ y, int Hc,
                          int Wc, int c4, int total) {
  // every offset below is under total < 2^31 float4s: 32-bit index math
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int Wo = 2 * Wc;
  const int Ho = 2 * Hc;
  const int c = idx % c4;
  int rest = idx / c4;
  const int ow = rest % Wo;
  rest /= Wo;
  const int oh = rest % Ho;
  const int b = rest / Ho;

  int r0, r1, q0, q1;
  float h0, h1, w0, w1;
  axis_taps(oh, Hc, r0, r1, h0, h1);
  axis_taps(ow, Wc, q0, q1, w0, w1);
  const float4* row0 = x + (b * Hc + r0) * Wc * c4 + c;
  const float4* row1 = x + (b * Hc + r1) * Wc * c4 + c;
  const float4 x00 = row0[q0 * c4];
  const float4 x01 = row0[q1 * c4];
  const float4 x10 = row1[q0 * c4];
  const float4 x11 = row1[q1 * c4];
  const float4 t0 = lerp4(h0, x00, h1, x10);  // rows first, at column q0
  const float4 t1 = lerp4(h0, x01, h1, x11);  // and at column q1
  y[idx] = lerp4(w0, t0, w1, t1);
}

}  // namespace

// x: (batch, Hc, Wc, C) fp32; y: (batch, 2 Hc, 2 Wc, C) fp32; both
// contiguous and 16-byte aligned; C a multiple of 4 and y under 2^31 float4s.
// Returns the CUDA error code of the launch; -1 for sizes it does not take.
extern "C" int dust3r_up2x(const void* x, void* y, int batch, int Hc, int Wc, int C,
                           void* stream) {
  if (batch <= 0 || Hc <= 0 || Wc <= 0 || C <= 0 || C % 4) return -1;
  const long long total = static_cast<long long>(batch) * 4 * Hc * Wc * (C / 4);
  if (total >= 0x7fffffffLL) return -1;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  up2x_align_corners_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), Hc, Wc, C / 4,
      static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}
