// The per-pixel finish of the DPT head shared by dpt_tail.cu and
// dpt_post.cu (sm_90a): the 1x1 conv (32 -> 4) plus its bias, then the exp
// postprocess of the depth mode ('exp', -inf, inf) and the conf mode ('exp',
// conf_vmin, inf):
//   o[j]  = b3[j] + sum_n h[n] * w3[j, n]                   (fp32 FMAs, n in order)
//   d     = |o[0:3]|
//   pts   = o[0:3] / max(d, 1e-8) * expm1(d)
//   conf  = conf_vmin + exp(o[3])
// One body for both kernels, so the fused tail and its epilogue as a kernel
// of its own cannot drift apart.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dpt_post {

constexpr int kHid = 32;  // the 1x1 conv's input channels (conv2's outputs)
constexpr int kOut = 4;   // its outputs: xyz and conf

// h: anything indexable by n < 32 (a shared-memory row, a register array);
// w3 (4, 32) row-major and b3 (4,) fp32; pts: the pixel's 3 floats, conf:
// its one.
template <class Row>
__device__ __forceinline__ void finish_pixel(const Row& h, const float* w3, const float* b3,
                                             float conf_vmin,
                                             float* __restrict__ pts,
                                             float* __restrict__ conf) {
  float o[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < kHid; ++n) s = fmaf(h[n], w3[j * kHid + n], s);
    o[j] = s + b3[j];
  }
  const float d = sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2]);
  const float dc = fmaxf(d, 1e-8f);
  const float e = expm1f(d);
  pts[0] = o[0] / dc * e;
  pts[1] = o[1] / dc * e;
  pts[2] = o[2] / dc * e;
  *conf = conf_vmin + expf(o[3]);
}

}  // namespace dpt_post
