// The DPT head's tail for Hopper (sm_90a), with a plain C interface: conv2
// (3x3, 128 -> 32) + bias, ReLU, conv3 (1x1, 32 -> 4) + bias and the exp
// postprocess, in one kernel.
//
// Replaces scripts/exp_tailk_r2.py::tail_pallas and scripts/exp_tailk2_r2.py::
// tail3_pallas (two TPU blockings of one function, the last four lines of
// dust3r_tpu/models/heads.py::DPTHead). Per pixel p of y (B, H, W, 128) NHWC
// fp32:
//   h[p, n]  = relu(b2[n] + sum_{dy, dx, c} bf16(y[p + (dy-1, dx-1), c]) * bf16(W2[dy, dx, c, n]))
//   o[p, j]  = b3[j] + sum_n h[p, n] * w3[j, n]                   (fp32)
//   d        = |o[p, 0:3]|
//   pts[p]   = o[p, 0:3] / max(d, 1e-8) * expm1(d)
//   conf[p]  = conf_vmin + exp(o[p, 3])
// with fp32 sums and zero padding outside the image: the depth mode
// ('exp', -inf, inf) and conf mode ('exp', conf_vmin, inf) of every published
// config. W2 comes packed by the wrapper as bf16 (9 * 128, 32), row
// (dy * 3 + dx) * 128 + c; w3 is (4, 32) fp32.
//
// What bounds it on an H100: y is read once (4 * 128 bytes a pixel) and
// 16 bytes a pixel are written; the conv is 2 * 32 * 1152 FLOPs a pixel on
// bf16 tensor cores, 144 FLOPs per byte of y, under the card's ~295, so
// memory is the bound: 0.25 ms at batch 8 and 384 x 512. The (B, H, W, 32)
// conv output, the ReLU pass, the 1x1 conv, the layout permute and the
// postprocess passes of the unfused head never reach device memory. The
// design:
//   * the k-loop of conv3x3_igemm.cuh at BN = 32 over K = 9 * 128 (one tap
//     and 32 channels a step, the zero halo applied in the load, y rounded
//     to bf16 on its way to shared memory, mma.sync m16n8k16 with fp32
//     accumulators): one block per 128 pixels, four warps of 64 x 16;
//   * the epilogue: the block's 128 x 32 accumulators get b2 and the ReLU
//     and are staged in fp32 in the A tile's shared memory (rows padded to
//     33 floats, so the per-pixel reads below are free of bank conflicts);
//     then each thread finishes one pixel: four dot products of length 32
//     against w3 in shared memory, the postprocess, three stores to pts and
//     one to conf (dpt_post.cuh's finish_pixel, which dpt_post.cu, TPU row
//     13 as a kernel of its own, shares).
// Not carried over from the TPU design: the gathered 2-row halo inputs (row
// 12) and the W-pre-padded copy of y (row 14), which answered BlockSpecs that
// cannot overlap; here the halo is a masked load. The 9-fold re-read of y
// from L2, one tap at a time, is what a faster version would cut (a row
// band of y staged once in shared memory; wgmma, TMA).
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include "conv3x3_igemm.cuh"
#include "dpt_post.cuh"

namespace {

using namespace conv3x3_igemm;

constexpr int kCin = 128;       // conv2's input channels
constexpr int kHid = dpt_post::kHid;  // conv2's output channels = conv3's input
constexpr int kOut = dpt_post::kOut;  // conv3's output channels: xyz and conf
constexpr int kHStride = kHid + 1;

__global__ void __launch_bounds__(kThreads)
dpt_tail_kernel(const float* __restrict__ y, const __nv_bfloat16* __restrict__ w2p,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, float conf_vmin, float* __restrict__ pts,
                float* __restrict__ conf, int H, int W, int npix) {
  constexpr int kWN = kHid / 2;  // channels per warp
  constexpr int kNT = kWN / 8;   // 8-column mma tiles per warp
  __shared__ __align__(16) Tiles<kHid> sm;
  __shared__ float w3s[kOut][kHid];
  __shared__ float b2s[kHid];
  __shared__ float b3s[kOut];
  static_assert(sizeof(float) * kBM * kHStride <= sizeof(sm.a), "h staging");
  static_assert(kOut * kHid == kThreads, "one w3 value per thread");

  const int tid = threadIdx.x;
  w3s[tid / kHid][tid % kHid] = w3[tid];
  if (tid < kHid) b2s[tid] = b2[tid];
  if (tid < kOut) b3s[tid] = b3[tid];

  const int m0 = blockIdx.x * kBM;
  Acc<kHid> acc;
  mainloop<kHid>(y, w2p, H, W, kCin, kHid, npix, 0, m0, sm, acc);
  // mainloop ends with __syncthreads(): the tiles are free, w3s, b2s and b3s
  // are written

  // h = relu(acc + b2) into shared memory; lane (g, t) holds rows g and
  // g + 8, columns 2t and 2t + 1 of each 16 x 8 tile
  float(*hs)[kHStride] = reinterpret_cast<float(*)[kHStride]>(&sm.a[0][0][0]);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = warp_n * kWN + nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = warp_m * 64 + mt * 16 + g + 8 * half;
        hs[row][col] = fmaxf(acc[mt][nt][2 * half] + b2s[col], 0.f);
        hs[row][col + 1] = fmaxf(acc[mt][nt][2 * half + 1] + b2s[col + 1], 0.f);
      }
    }
  }
  __syncthreads();

  // one pixel per thread: conv3, then the postprocess (dpt_post.cuh)
  const int m = m0 + tid;
  if (m >= npix) return;
  dpt_post::finish_pixel(hs[tid], &w3s[0][0], b3s, conf_vmin, pts + (size_t)m * 3, conf + m);
}

}  // namespace

// y: (batch, H, W, 128) fp32, contiguous and 16-byte aligned; w2p:
// (9 * 128, 32) bf16; b2: (32,) fp32; w3: (4, 32) fp32; b3: (4,) fp32;
// pts: (batch, H, W, 3) fp32; conf: (batch, H, W) fp32. Returns the CUDA
// error code of the launch; -1 for sizes it does not take.
extern "C" int dust3r_dpt_tail(const void* y, const void* w2p, const void* b2,
                               const void* w3, const void* b3, float conf_vmin, void* pts,
                               void* conf, int batch, int H, int W, void* stream) {
  const long long npix = static_cast<long long>(batch) * H * W;
  if (batch <= 0 || H <= 0 || W <= 0 || npix * kCin >= 0x7fffffffLL) return -1;
  const int blocks = static_cast<int>((npix + kBM - 1) / kBM);
  dpt_tail_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const __nv_bfloat16*>(w2p),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), conf_vmin, static_cast<float*>(pts),
      static_cast<float*>(conf), H, W, static_cast<int>(npix));
  return static_cast<int>(cudaGetLastError());
}
