// 3x3 stride-1 same-pad convolution for Hopper (sm_90a) built on TMA and
// wgmma, with a plain C interface.
//
// Replaces dust3r_tpu/ops/conv3x3.py::_conv3x3_pallas_raw (the Pallas TPU
// kernel _tap_kernel plus its vertical combine). Per output pixel (b, h, w)
// and output channel n:
//   y[b, h, w, n] = bias[n] + sum_{dy, dx, c} x[b, h+dy-1, w+dx-1, c] * W[dy, dx, c, n]
// with x and W rounded to bf16, the products summed in fp32, zero padding
// outside the image. x and y are NHWC (a channels_last tensor), both fp32 or
// both bf16 (the bf16 mode, the DPT heads' serving configuration: x read
// as it is, fp32 sums and bias, y rounded once to bf16); W comes
// packed by the wrapper (ops/conv3x3.py::pack_weight) as bf16
// (cin / 32, 9, cout, 32): chunk c of 32 input channels, tap dy * 3 + dx,
// output channel n, channel c * 32 + i at [c, tap, n, i].
//
// What bounds it on an H100: at the DPT heads' shapes (cin 96-768, cout
// 32-256, up to 8 x 192 x 256 pixels) a conv is an implicit GEMM with
// M = B*H*W pixels, N = cout and K = 9*cin, hundreds of FLOPs a byte of x
// and y: the bf16 tensor-core rate is the bound, and the nine shifted
// copies of x that a plain GEMM would need must never reach device memory.
// The design:
//   * a block computes an 8 x 16 patch of output pixels of one image (128
//     pixels, M) for BN output channels (BN = the largest of 128, 64, 32
//     dividing cout; at 256 the accumulators spill): two consumer
//     warpgroups of 4 pixel rows (64 rows of M each) and one producer warp;
//   * the reduction walks (32-channel chunk, tap row dy) steps: the producer
//     keeps a ring of stages in flight with TMA, each the 8 x 18 x 32 fp32
//     patch of x at (h0 + dy - 1, w0 - 1) (128-byte swizzle; in the bf16
//     mode 64-byte pixel rows, 64-byte swizzle; out-of-image
//     coordinates, negative ones too, arrive as zeros: that is the halo)
//     and the step's three taps of packed W (3 x BN x 32 bf16, 64-byte
//     swizzle), so the three taps dx share one load of x;
//   * each consumer warp rounds its pixel row's 16 x 3 taps x 32 channels
//     of the x stage (at the taps' column offsets dx) to bf16 into its
//     warpgroup's A tiles in shared memory (in the bf16 mode it copies them:
//     the taps' windows overlap, so the 18-pixel rows of the stage are not
//     the 16-row groups wgmma reads; 64-byte swizzle, two buffers, so
//     one step's rounding overlaps the previous step's products), fences
//     them for the async proxy, and the warpgroup runs six wgmma m64nBNk16
//     (3 taps x 2 k16 slices) on A and the stage's W, both K-major; A from
//     registers would serialise the products behind the rounding;
//   * grids whose tiles fill under half the card's SMs (the 12x16 grids at
//     batch 8: 32 tiles) split the reduction over up to 16 blocks a tile,
//     as many as keep the blocks to one wave: each writes its fp32 partial tile to a workspace and
//     the last block to arrive (an atomic count per tile, which it resets)
//     sums the partials in split order, so the result does not depend on
//     which block finishes last;
//   * the bias is added in the epilogue, y stored once in fp32, or rounded
//     once to bf16 in the bf16 mode (rows and columns past the image
//     masked). The bf16 mode moves half the bytes of x and y.
// Not carried over from the TPU design: the three tap-column matmuls into a
// bf16 Z of 3 * cout channels and the vertical combine outside the kernel
// (Z never exists here, so it is not rounded), and the row-block sizing
// against VMEM. conv3x3_igemm.cuh's mma.sync k-loop, which this kernel
// replaced, still carries conv3x3_taps_mma.cu (the tap-sum conv's baseline).
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include "sm90.cuh"

namespace {

constexpr int kBH = 8, kBW = 16;                 // output patch: 8 rows x 16 columns
constexpr int kBM = kBH * kBW;                   // 128 pixels, M of a block
constexpr int kBK = 32;                          // input channels a step (128 bytes of fp32)
constexpr int kConsumers = 2;                    // warpgroups of 4 output rows
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kARows = kBH * (kBW + 2);          // pixels of a step's x patch
constexpr int kMaxSplits = 16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int BN, typename T>
struct Stage {  // every member a multiple of 1024 bytes
  T a[kARows * kBK];                     // x patch, rows of 128 (fp32) or 64 (bf16) bytes, swizzled
  __nv_bfloat16 b[3 * BN * kBK];         // 3 taps x BN rows of 64 bytes, 64-byte swizzle
};

constexpr int kATile = 64 * kBK * 2;  // a warpgroup's 64 rows x 32 channels in bf16: 4 KB

template <int BN, typename T>
struct Smem {
  static constexpr size_t kFixed = 2 * kConsumers * 3 * kATile + 1024;
  static constexpr int kStages = (225 * 1024 - kFixed) / sizeof(Stage<BN, T>) < 8
                                     ? (225 * 1024 - kFixed) / sizeof(Stage<BN, T>)
                                     : 8;
  Stage<BN, T> st[kStages];
  // each consumer warpgroup's A: two buffers of 3 taps x 64 rows x 32 channels
  __nv_bfloat16 a[kConsumers][2][3][kATile / 2];
  uint64_t full[kStages];   // the step's x and W landed (TMA bytes)
  uint64_t empty[kStages];  // the stage consumed (one arrival a consumer warp)
  int last;                 // split reduction: this block sums the tile
};

// One step of a consumer warp: wait for stage i % S; round its pixel row
// hh (16 pixels, wgmma rows 16 * (hh % 4) .. + 15 of its warpgroup) of the
// three taps' x patches (patch rows hh * 18 + pixel + dx) to bf16 (copy
// them, in the bf16 mode) into A buffer i % 2 of its warpgroup (rows of 64
// bytes, 64-byte swizzle: chunk c of row m at c ^ ((m >> 1) & 3)), fence it
// for the async proxy; once the
// warpgroup's four warps have written, issue the six wgmma, then wait until
// the previous step's products are done (its A buffer is free again) and
// hand its stage back.
template <int BN, typename T>
__device__ __forceinline__ void step(Smem<BN, T>& sm, int i, int cw, int hh, int lane,
                                     float (&acc)[BN / 2]) {
  constexpr int S = Smem<BN, T>::kStages;
  const int s = i % S;
  sm90::mbar_wait(&sm.full[s], (i / S) & 1);
  const unsigned char* x = reinterpret_cast<const unsigned char*>(sm.st[s].a);
  unsigned char* a = reinterpret_cast<unsigned char*>(sm.a[cw][i & 1]);
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int it = 0; it < 6; ++it) {  // 3 taps x 16 pixels x 4 chunks of 8 bf16 a warp
      const int idx = lane + 32 * it;
      const int dx = idx >> 6, px = (idx >> 2) & 15, q = idx & 3;
      const int r = hh * (kBW + 2) + px + dx;
      const int m = (hh % 4) * 16 + px;
      *reinterpret_cast<uint4*>(a + dx * kATile + m * 64 + ((q ^ ((m >> 1) & 3)) << 4)) =
          *reinterpret_cast<const uint4*>(x + r * 64 + ((q ^ ((r >> 1) & 3)) << 4));
    }
  } else {
#pragma unroll
    for (int it = 0; it < 12; ++it) {  // 3 taps x 16 pixels x 8 fp32 chunks a warp
      const int idx = lane + 32 * it;
      const int dx = idx >> 7, px = (idx >> 3) & 15, c4 = idx & 7;
      const int r = hh * (kBW + 2) + px + dx;
      const float4 v = *reinterpret_cast<const float4*>(x + r * 128 + ((c4 ^ (r & 7)) << 4));
      const int m = (hh % 4) * 16 + px;
      uint2 u;
      u.x = pack_bf16(v.x, v.y);
      u.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(a + dx * kATile + m * 64 + (((c4 >> 1) ^ ((m >> 1) & 3)) << 4) +
                                (c4 & 1) * 8) = u;
    }
  }
  sm90::fence_proxy_async();
  sm90::named_barrier_sync(1 + cw, 128);
  const uint64_t adesc = sm90::smem_desc(a, 16, 512, sm90::kSwizzle64B);
  const uint64_t bdesc = sm90::smem_desc(sm.st[s].b, 16, 512, sm90::kSwizzle64B);
  sm90::wgmma_fence();
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      sm90::wgmma_ss<0, 0>(acc, sm90::desc_advance(adesc, dx * kATile + kk * 32),
                           sm90::desc_advance(bdesc, dx * BN * 64 + kk * 32), 1);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<1>();
  if (i > 0) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[(i - 1) % S]);
  }
}

template <int BN, typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                    T* __restrict__ y, float* __restrict__ ws,
                    unsigned int* __restrict__ counters, int H, int W, int cout, int steps,
                    int splits) {
  constexpr int S = Smem<BN, T>::kStages;
  extern __shared__ unsigned char smem_raw[];
  Smem<BN, T>& sm = *reinterpret_cast<Smem<BN, T>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tile = blockIdx.x;
  const int ntn = cout / BN;
  const int n0 = (tile % ntn) * BN;
  const int mt = tile / ntn;
  const int tiles_w = (W + kBW - 1) / kBW;
  const int tiles_h = (H + kBH - 1) / kBH;
  const int w0 = (mt % tiles_w) * kBW;
  const int h0 = ((mt / tiles_w) % tiles_h) * kBH;
  const int img = mt / (tiles_w * tiles_h);
  const int split = blockIdx.y;
  const int k0 = split * steps / splits;
  const int nsteps = (split + 1) * steps / splits - k0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 4 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    if (lane == 0) {
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % S;
        if (i >= S) sm90::mbar_wait(&sm.empty[s], ((i / S) & 1) ^ 1);
        const int c = (k0 + i) / 3, dy = (k0 + i) % 3;
        sm90::mbar_arrive_expect_tx(&sm.full[s],
                                    kARows * kBK * (int)sizeof(T) + 3 * BN * kBK * 2);
        sm90::tma_load_4d(sm.st[s].a, &xmap, &sm.full[s], c * kBK, w0 - 1, h0 + dy - 1, img);
        sm90::tma_load_4d(sm.st[s].b, &wmap, &sm.full[s], 0, n0, 3 * dy, c);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int hh = warp;  // output row of the patch: 4 a warpgroup, one a warp
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nsteps; ++i) step<BN, T>(sm, i, warp / 4, hh, lane, acc);
  sm90::wgmma_wait<0>();
  sm90::fence_operand(acc);

  if (splits > 1) {
    // this split's partial tile, then the last block of the tile sums them
    // in split order; the layout (value i of consumer thread c at i * 256 +
    // c) makes each store and load a coalesced row
    constexpr int kTileFloats = kBM * BN;
    const int ct = threadIdx.x;
    float* part = ws + ((size_t)tile * splits + split) * kTileFloats;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i * 128 * kConsumers + ct] = acc[i];
    __threadfence();
    sm90::named_barrier_sync(1 + kConsumers, 128 * kConsumers);
    if (ct == 0) sm.last = atomicAdd(&counters[tile], 1u) == static_cast<unsigned>(splits - 1);
    sm90::named_barrier_sync(1 + kConsumers, 128 * kConsumers);
    if (!sm.last) return;
    __threadfence();
    const float* parts = ws + (size_t)tile * splits * kTileFloats + ct;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = __ldcg(parts + i * 128 * kConsumers);
    for (int p = 1; p < splits; ++p) {  // a partial's loads all in flight at once
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] += __ldcg(parts + (size_t)p * kTileFloats + i * 128 * kConsumers);
      }
    }
    if (ct == 0) counters[tile] = 0;  // ready for the next launch
  }

  // epilogue: acc[4j + 2 * h2 + e] is pixel (hh, g + 8 * h2), channel
  // n0 + 8j + 2t + e
  const int h = h0 + hh;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float b0 = bias ? bias[col] : 0.f;
    const float b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int w = w0 + g + 8 * h2;
      if (h < H && w < W) {
        T* out = y + (((size_t)img * H + h) * W + w) * cout + col;
        const float v0 = acc[4 * j + 2 * h2] + b0, v1 = acc[4 * j + 2 * h2 + 1] + b1;
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int BN, typename T>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* bias, T* y,
           float* ws, unsigned int* counters, int batch, int H, int W, int cin, int cout,
           int splits, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(Smem<BN, T>) + 1024;
  static_assert(kSmem <= 232448, "a block's shared memory on sm_90");
  static devattr::SmemLimit limit;
  const cudaError_t attr =
      limit.raise_on_current_device(conv3x3_sm90_kernel<BN, T>, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = batch * ((H + kBH - 1) / kBH) * ((W + kBW - 1) / kBW) * (cout / BN);
  const dim3 grid(tiles, splits);
  conv3x3_sm90_kernel<BN, T><<<grid, kThreads, kSmem, stream>>>(
      xmap, wmap, bias, y, ws, counters, H, W, cout, 3 * (cin / kBK), splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bn(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* bias, void* y,
              float* ws, unsigned int* counters, int batch, int H, int W, int cin, int cout,
              int bn, int splits, cudaStream_t s) {
  T* yt = static_cast<T*>(y);
  switch (bn) {
    case 128:
      return launch<128, T>(xmap, wmap, bias, yt, ws, counters, batch, H, W, cin, cout, splits,
                            s);
    case 64:
      return launch<64, T>(xmap, wmap, bias, yt, ws, counters, batch, H, W, cin, cout, splits,
                           s);
    case 32:
      return launch<32, T>(xmap, wmap, bias, yt, ws, counters, batch, H, W, cin, cout, splits,
                           s);
    default:
      return -1;
  }
}

}  // namespace

// x: (batch, H, W, cin) fp32 (bf16 = 0) or bf16 (bf16 = 1); wp: (cin / 32,
// 9, cout, 32) bf16 (ops/conv3x3.py::pack_weight); bias: (cout,) fp32 or
// null; y: (batch, H, W, cout) in x's type; all contiguous, 16-byte
// aligned. cin a multiple of 32; bn,
// the output channels of a block, 32, 64 or 128, dividing cout.
// splits: blocks a tile splits the reduction over (1 to min(16, 3 * cin /
// 32)); above 1, ws holds splits fp32 tiles of 128 x bn for each of the
// batch * ceil(H / 8) * ceil(W / 16) * cout / bn tiles and counters as many
// zeroed uint32 (the kernel leaves them zero). Returns the CUDA error code
// of the launch, or of encoding a tensor map offset by 1000 (1000 +
// CUresult; sm90::kNoEncoder when the runtime gives no encoder); -1 for
// arguments it does not take.
extern "C" int dust3r_conv3x3(const void* x, const void* wp, const void* bias, void* y,
                              void* ws, void* counters, int batch, int H, int W, int cin,
                              int cout, int bn, int splits, int bf16, void* stream) {
  if (cin <= 0 || cout <= 0 || cin % kBK || bn <= 0 || cout % bn) return -1;
  if (splits < 1 || splits > kMaxSplits || splits > 3 * (cin / kBK)) return -1;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return -1;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {(uint64_t)cin, (uint64_t)W, (uint64_t)H, (uint64_t)batch};
  const uint64_t xb = bf16 ? 2 : 4;  // bytes a value of x
  const uint64_t xstrides[3] = {xb * cin, xb * cin * W, xb * cin * W * H};
  const uint32_t xbox[4] = {kBK, kBW + 2, kBH, 1};
  int err = sm90::encode_tensor_map(
      &xmap, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x,
      xdims, xstrides, xbox, bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  const uint64_t wdims[4] = {kBK, (uint64_t)cout, 9, (uint64_t)(cin / kBK)};
  const uint64_t wstrides[3] = {2ull * kBK, 2ull * kBK * cout, 18ull * kBK * cout};
  const uint32_t wbox[4] = {kBK, (uint32_t)bn, 3, 1};
  if (err == 0) {
    err = sm90::encode_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, wp, wdims,
                                  wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err != 0) return err == sm90::kNoEncoder ? err : 1000 + err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* w = static_cast<float*>(ws);
  unsigned int* c = static_cast<unsigned int*>(counters);
  if (bf16) {
    return launch_bn<__nv_bfloat16>(xmap, wmap, b, y, w, c, batch, H, W, cin, cout, bn, splits,
                                    s);
  }
  return launch_bn<float>(xmap, wmap, b, y, w, c, batch, H, W, cin, cout, bn, splits, s);
}
