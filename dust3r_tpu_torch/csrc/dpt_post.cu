// The DPT head's epilogue as a kernel of its own for Hopper (sm_90a), with
// a plain C interface: the 1x1 conv (32 -> 4) plus bias and the exp
// postprocess, on the ReLU'd conv2 output h.
//
// Replaces scripts/exp_tailk2_r2.py::post_pallas (TPU row 13, the epilogue
// of rows 12/14 split off their conv). Per pixel p of h (B, H, W, 32) NHWC
// fp32:
//   o[p, j]  = b3[j] + sum_n h[p, n] * w3[j, n]
//   pts[p]   = o[p, 0:3] / max(|o[p, 0:3]|, 1e-8) * expm1(|o[p, 0:3]|)
//   conf[p]  = conf_vmin + exp(o[p, 3])
// all in fp32, by dpt_post.cuh's finish_pixel, the body dpt_tail.cu's
// epilogue runs.
//
// What bounds it on an H100: 128 bytes of h in and 16 bytes out a pixel
// against ~300 FLOPs a pixel: memory, 144 bytes a pixel at 3.35 TB/s
// (0.068 ms at batch 8 and 384 x 512). The design: one thread a pixel, its
// 32 channels read as eight 16-byte loads (the warp's 4 KB are contiguous,
// so every byte of each line it touches is used by the warp); w3 and b3 in
// shared memory, loaded once a block; three stores to pts, one to conf.
// Not carried over: the TPU's 32-row blocks and the 4-wide matmul on the
// MXU (lane underfill there; here the 128 FMAs a pixel are scalar fp32).
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include "dpt_post.cuh"

namespace {

using dpt_post::kHid;
using dpt_post::kOut;
constexpr int kThreads = 128;  // pixels a block

__global__ void __launch_bounds__(kThreads)
dpt_post_kernel(const float* __restrict__ h, const float* __restrict__ w3,
                const float* __restrict__ b3, float conf_vmin, float* __restrict__ pts,
                float* __restrict__ conf, long long npix) {
  __shared__ float w3s[kOut][kHid];
  __shared__ float b3s[kOut];
  static_assert(kOut * kHid == kThreads, "one w3 value per thread");
  const int tid = threadIdx.x;
  w3s[tid / kHid][tid % kHid] = w3[tid];
  if (tid < kOut) b3s[tid] = b3[tid];
  __syncthreads();

  const long long m = (long long)blockIdx.x * kThreads + tid;
  if (m >= npix) return;
  float hr[kHid];
  const float4* src = reinterpret_cast<const float4*>(h + m * kHid);
#pragma unroll
  for (int i = 0; i < kHid / 4; ++i) {
    const float4 v = src[i];
    hr[4 * i] = v.x;
    hr[4 * i + 1] = v.y;
    hr[4 * i + 2] = v.z;
    hr[4 * i + 3] = v.w;
  }
  dpt_post::finish_pixel(hr, &w3s[0][0], b3s, conf_vmin, pts + m * 3, conf + m);
}

}  // namespace

// h: (npix, 32) fp32 (NHWC over batch, H, W), contiguous and 16-byte
// aligned; w3: (4, 32) fp32; b3: (4,) fp32; pts: (npix, 3) fp32; conf:
// (npix,) fp32. Returns the CUDA error code of the launch; -1 for sizes it
// does not take.
extern "C" int dust3r_dpt_post(const void* h, const void* w3, const void* b3, float conf_vmin,
                               void* pts, void* conf, long long npix, void* stream) {
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (npix <= 0 || blocks > 0x7fffffffLL) return -1;
  dpt_post_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w3),
      static_cast<const float*>(b3), conf_vmin, static_cast<float*>(pts),
      static_cast<float*>(conf), npix);
  return static_cast<int>(cudaGetLastError());
}
