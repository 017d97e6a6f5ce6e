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
// config. W2 comes packed by the wrapper (ops/dpt_tail.py::pack_w2) as bf16
// (9 * 128, 32), row (dy * 3 + dx) * 128 + c; w3 is (4, 32) fp32. In the
// bf16 mode (the serving configuration's bf16 heads) y is bf16: the same
// function, with nothing left to round, and half the bytes of y read.
//
// What bounds it on an H100: y is read once (4 * 128 bytes a pixel) and
// 16 bytes a pixel are written; the conv is 2 * 32 * 1152 FLOPs a pixel on
// bf16 tensor cores, 144 FLOPs per byte of y, under the card's ~295, so
// device memory is the bound: 0.25 ms at batch 8 and 384 x 512. The
// (B, H, W, 32) conv output, the ReLU pass, the 1x1 conv and the
// postprocess passes of the unfused head never reach device memory. Inside
// the SM the shared-memory traffic (the TMA's writes, the rounding's reads
// and writes, the fragments' ldmatrix reads: about 4 KB a pixel) and the
// mma.sync products come close to that time, so the design cuts the first
// and overlaps the three. What it must keep off the path: re-reading y once
// a tap (the k-loop this kernel replaced moved every byte of y from L2 to
// the SMs nine times and rounded it to bf16 nine times, which held it at
// the L2's rate) and a serial load -> round -> products -> epilogue. The
// design:
//   * persistent blocks, one an SM (about 213 KB of shared memory), each
//     walking output tiles of 16 x 16 pixels of one image, tile
//     blockIdx.x + k * gridDim.x in raster order (image, row band,
//     column), so the card's blocks work on neighbouring tiles at once and
//     a tile's halo is still in L2 from its neighbour's load;
//   * TMA loads each tile's 18 x 18 pixel halo box, 32 channels in fp32 a
//     stage (128-byte swizzle; out-of-image coordinates, negative ones too,
//     arrive as zeros: that is the zero padding), four stages a tile into a
//     two-stage mbarrier ring, so y crosses from L2 324 / 256 = 1.27 times;
//   * warp specialisation, two warpgroups. The rounding warpgroup rounds
//     each arrived stage to bf16 once, into a patch of the box's 324
//     pixels x 32 channels (two buffers, handed over by mbarriers; 64-byte
//     pixel rows, the 16-byte chunk q of pixel p at q ^ ((p >> 1) & 3), so
//     the eight rows of an ldmatrix, eight successive pixels from any
//     start, hit eight distinct bank groups), and its thread 0 refills the
//     stage by TMA once the warpgroup is done with it. The MMA warpgroup
//     runs the products of one patch buffer while the other is rounded and
//     the next stages land, so the loads, the rounding and the products
//     overlap (with both phases in the same four warps, one a scheduler,
//     the tensor cores stood idle while the warps rounded);
//   * the nine taps read windows of the patch shifted by (dy, dx) through
//     ldmatrix, which takes any 16-byte aligned row address, so a shift
//     costs nothing; W2 stays resident in shared memory (72 KB, loaded once
//     a block, the same swizzle on its 64-byte rows) and reaches the
//     products through ldmatrix.trans. An MMA warp owns four output rows,
//     so an A fragment of a patch row serves the taps dy of up to three
//     rows and a B fragment all four: 12 fragment loads for 48 products,
//     where a warp of one row would take 9 for 12;
//   * the products are mma.sync m16n8k16 (bf16 in, fp32 accumulators, 64 a
//     thread), the fragments loaded one (k16, dx) step ahead. Not wgmma:
//     its A operand would come either from registers rewritten every step
//     (ptxas serialises a wgmma whose A registers are redefined while it is
//     in flight, warning C7513, as conv3x3.cu found) or from one more
//     rounded copy of each tap's window in wgmma's own shared-memory layout,
//     which is what this design removes; and N = 32 is wgmma's narrow end.
//     At mma.sync's rate the products take less than the memory time;
//   * the epilogue, in the MMA warps: each stages two output rows of
//     relu(acc + b2) in fp32 in shared memory (rows padded to 33 floats),
//     then each lane finishes one pixel (dpt_post.cuh's finish_pixel, which
//     dpt_post.cu, TPU row 13 as a kernel of its own, shares): the 1x1
//     against w3 in shared memory, the postprocess, 16 bytes stored. No
//     atomics: the sums run in one fixed order, so two calls give the same
//     bits.
// The bf16 mode: TMA loads each stage's box of bf16 y (64-byte pixel rows,
// 64-byte swizzle: the patch's own layout) straight into a patch buffer, a
// ring of five of them in the space of the fp32 stages and patches; the
// rounding warpgroup's thread 0 only issues the loads, the MMA warpgroup
// runs as in the fp32 mode.
// Not carried over from the TPU design: the gathered 2-row halo inputs (row
// 12) and the W-pre-padded copy of y (row 14), which answered BlockSpecs that
// cannot overlap; here the halo is part of the TMA box.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include "conv3x3_igemm.cuh"  // the mma.sync and ldmatrix helpers
#include "dpt_post.cuh"
#include "sm90.cuh"

namespace {

constexpr int kCin = 128;             // conv2's input channels
constexpr int kHid = dpt_post::kHid;  // conv2's output channels = conv3's input
constexpr int kOut = dpt_post::kOut;  // conv3's output channels: xyz and conf
constexpr int kTH = 16, kTW = 16;     // output tile: 16 rows x 16 columns
constexpr int kPH = kTH + 2, kPW = kTW + 2;  // its halo box: 18 x 18 pixels
constexpr int kBoxPix = kPH * kPW;           // 324
constexpr int kChunk = 32;                   // channels a stage (128 bytes of fp32)
constexpr int kChunks = kCin / kChunk;       // stages a tile
constexpr int kStages = 2;
constexpr int kRows = 4;                     // output rows of an MMA warp
constexpr int kMmaWarps = kTH / kRows;       // 4: warpgroup 0
constexpr int kRoundWarps = 4;               // warpgroup 1; its thread 0 also issues the TMA loads
constexpr int kThreads = 32 * (kMmaWarps + kRoundWarps);
constexpr int kStageBytes = kBoxPix * kChunk * 4;                  // 41472, one TMA box
constexpr int kStageStride = (kStageBytes + 1023) / 1024 * 1024;   // 128-byte swizzle: 1 KB aligned
constexpr int kPatchBytes = kBoxPix * kChunk * 2;                  // 20736, one bf16 TMA box
constexpr int kPatchStride = (kPatchBytes + 1023) / 1024 * 1024;   // 64-byte swizzle: 1 KB aligned
constexpr int kRingBytes = kStages * kStageStride + 2 * kPatchStride;
constexpr int kMaxPatches = kRingBytes / kPatchStride;             // 5, the bf16 mode's ring
constexpr int kW2Rows = 9 * kCin;                                  // rows of 64 bytes
constexpr int kHStride = kHid + 1;

// patch buffers: 2 after the fp32 stages; in the bf16 mode the whole ring
__host__ __device__ constexpr int patches(bool bf16) { return bf16 ? kMaxPatches : 2; }

struct Smem {
  unsigned char ring[kRingBytes];  // the fp32 stages, then the patches (see `stage`, `patch`)
  unsigned char w2[kW2Rows * kHid * 2];
  float hs[kMmaWarps][32][kHStride];  // an MMA warp's 32 pixels of h, two output rows at a time
  float w3[kOut * kHid];
  float b2[kHid];
  float b3[kOut];
  uint64_t full[kStages];               // the stage's box landed (TMA bytes)
  uint64_t patch_full[kMaxPatches];     // the patch buffer rounded (one arrival a rounding
                                        // warp) or, in the bf16 mode, landed (TMA bytes)
  uint64_t patch_empty[kMaxPatches];    // its products done (one arrival an MMA warp)
};
constexpr size_t kSmem = sizeof(Smem) + 1024;
static_assert(kSmem <= 232448, "a block's shared memory on sm_90");

__device__ __forceinline__ unsigned char* stage(Smem& sm, int s) {
  return sm.ring + s * kStageStride;
}
template <bool kBf16>
__device__ __forceinline__ unsigned char* patch(Smem& sm, int b) {
  return sm.ring + (kBf16 ? 0 : kStages * kStageStride) + b * kPatchStride;
}

// 16-byte chunk q of a 64-byte row r (a patch pixel, a W2 row), swizzled
__device__ __forceinline__ int row64(int r, int q) { return r * 64 + ((q ^ ((r >> 1) & 3)) << 4); }

struct Tile {
  int img, h0, w0;
};

__device__ __forceinline__ Tile decode(int tile, int tiles_w, int tiles_img) {
  const int rem = tile % tiles_img;
  return Tile{tile / tiles_img, (rem / tiles_w) * kTH, (rem % tiles_w) * kTW};
}

// The rounding of one stage (324 pixels x 32 fp32, 128-byte rows, 16-byte
// chunk c of pixel p at c ^ (p & 7)) into a patch buffer by the rounding
// warpgroup's thread rt: 1296 items of 8 channels; a warp's eight lanes of
// one 16-byte access phase take eight successive pixels of one chunk, so
// reads and writes are free of bank conflicts.
__device__ __forceinline__ void round_stage(const unsigned char* x, unsigned char* patch, int rt) {
  constexpr int kN = 32 * kRoundWarps;
#pragma unroll
  for (int k = 0; k < (kBoxPix * 4 + kN - 1) / kN; ++k) {
    const int q = rt + kN * k;
    const int p = (q >> 5) * 8 + (q & 7);
    const int c = (q >> 3) & 3;  // 8-channel chunk
    if (p < kBoxPix) {
      const float4 lo = *reinterpret_cast<const float4*>(x + p * 128 + (((2 * c) ^ (p & 7)) << 4));
      const float4 hi =
          *reinterpret_cast<const float4*>(x + p * 128 + (((2 * c + 1) ^ (p & 7)) << 4));
      const uint2 a = conv3x3_igemm::to_bf16x4(lo), b = conv3x3_igemm::to_bf16x4(hi);
      *reinterpret_cast<uint4*>(patch + row64(p, c)) = make_uint4(a.x, a.y, b.x, b.y);
    }
  }
}

// The fragments of one (k16, dx) step of an MMA warp: B of the three taps
// dy (4 n-tiles of (b0, b1) each) and A of its kRows + 2 patch rows.
struct Frags {
  uint32_t b[3][4][2];
  uint32_t a[kRows + 2][4];
};

__device__ __forceinline__ void load_frags(Frags& f, const unsigned char* patch,
                                           const unsigned char* w2, int chunk, int step,
                                           int warp, int lane) {
  const int kk = step / 3, dx = step % 3;
  const int lrow = lane & 15, lhi = lane >> 4;  // ldmatrix: the row a lane passes, its 8-col half
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int wr = (3 * dy + dx) * kCin + chunk * kChunk + kk * 16 + lrow;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t r[4];
      conv3x3_igemm::ldmatrix_x4_trans(
          r, reinterpret_cast<const __nv_bfloat16*>(w2 + row64(wr, 2 * half + lhi)));
      f.b[dy][2 * half][0] = r[0];
      f.b[dy][2 * half][1] = r[1];
      f.b[dy][2 * half + 1][0] = r[2];
      f.b[dy][2 * half + 1][1] = r[3];
    }
  }
#pragma unroll
  for (int j = 0; j < kRows + 2; ++j) {
    const int p = (kRows * warp + j) * kPW + lrow + dx;
    conv3x3_igemm::ldmatrix_x4(
        f.a[j], reinterpret_cast<const __nv_bfloat16*>(patch + row64(p, 2 * kk + lhi)));
  }
}

// One chunk's products of an MMA warp: its kRows output rows kRows * warp
// + r of the tile (acc[r]: 16 pixels x 32 channels each) over the chunk's 32
// channels and the nine taps, in six (k16, dx) steps whose fragments are
// loaded one step ahead. Patch row kRows * warp + r + dy feeds output row r
// at tap dy, so each A fragment (patch row, dx, k16) is loaded once and
// serves up to three rows, and each B fragment the warp's kRows rows; the
// dy-outer order puts 16 products between two updates of one accumulator.
__device__ __forceinline__ void products(const unsigned char* patch, const unsigned char* w2,
                                         int chunk, int warp, int lane,
                                         float (&acc)[kRows][4][4]) {
  Frags f[2];
  load_frags(f[0], patch, w2, chunk, 0, warp, lane);
#pragma unroll
  for (int step = 0; step < 6; ++step) {
    if (step + 1 < 6) load_frags(f[(step + 1) & 1], patch, w2, chunk, step + 1, warp, lane);
    const Frags& c = f[step & 1];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          conv3x3_igemm::mma_bf16(acc[r][n], c.a[r + dy], c.b[dy][n][0], c.b[dy][n][1]);
        }
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
dpt_tail_sm90_kernel(const __grid_constant__ CUtensorMap ymap,
                     const __nv_bfloat16* __restrict__ w2p, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3, float conf_vmin,
                     float* __restrict__ pts, float* __restrict__ conf, int H, int W,
                     int tiles_w, int tiles_img, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023));
  constexpr int P = patches(kBf16);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this block's chunks: chunk i is chunk i % 4 of its tile i / 4
  const int nchunks = kChunks * ((tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&sm.full[s], 1);
    for (int b = 0; b < P; ++b) {
      sm90::mbar_init(&sm.patch_full[b], kBf16 ? 1 : kRoundWarps);
      sm90::mbar_init(&sm.patch_empty[b], kMmaWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kMmaWarps) {  // the rounding warpgroup
    const int rt = threadIdx.x - 32 * kMmaWarps;
    // chunk i of this block by TMA into `dst`, completing on `bar`
    auto load = [&](int i, unsigned char* dst, uint64_t* bar, int bytes) {
      const Tile t = decode(blockIdx.x + (i / kChunks) * gridDim.x, tiles_w, tiles_img);
      sm90::mbar_arrive_expect_tx(bar, bytes);
      sm90::tma_load_4d(dst, &ymap, bar, (i % kChunks) * kChunk, t.w0 - 1, t.h0 - 1, t.img);
    };
    if constexpr (kBf16) {  // nothing to round: its thread 0 feeds the patches
      if (rt == 0) {
        for (int i = 0; i < nchunks; ++i) {
          const int b = i % P;
          if (i >= P) sm90::mbar_wait(&sm.patch_empty[b], ((i / P) & 1) ^ 1);
          load(i, patch<kBf16>(sm, b), &sm.patch_full[b], kPatchBytes);
        }
      }
      return;
    }
    if (rt == 0) {
      for (int i = 0; i < kStages && i < nchunks; ++i) {
        load(i, stage(sm, i), &sm.full[i], kStageBytes);
      }
    }
    for (int i = 0; i < nchunks; ++i) {
      const int s = i % kStages, b = i % P;
      sm90::mbar_wait(&sm.full[s], (i / kStages) & 1);
      if (i >= P) sm90::mbar_wait(&sm.patch_empty[b], ((i / P) & 1) ^ 1);
      round_stage(stage(sm, s), patch<kBf16>(sm, b), rt);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.patch_full[b]);
      // every rounding warp is done with stage s: refill it
      sm90::named_barrier_sync(2, 32 * kRoundWarps);
      if (rt == 0 && i + kStages < nchunks) {
        load(i + kStages, stage(sm, s), &sm.full[s], kStageBytes);
      }
    }
    return;
  }

  // the MMA warpgroup: W2 (swizzled), w3, b2, b3 into shared memory once,
  // while the first chunks are loaded and rounded
  const int ct = threadIdx.x;
  for (int v = ct; v < kW2Rows * 4; v += 32 * kMmaWarps) {
    *reinterpret_cast<uint4*>(sm.w2 + row64(v >> 2, v & 3)) =
        __ldg(reinterpret_cast<const uint4*>(w2p) + v);
  }
  for (int v = ct; v < kOut * kHid; v += 32 * kMmaWarps) sm.w3[v] = w3[v];
  if (ct < kHid) sm.b2[ct] = b2[ct];
  if (ct < kOut) sm.b3[ct] = b3[ct];
  sm90::named_barrier_sync(1, 32 * kMmaWarps);

  const int g = lane >> 2, t4 = lane & 3;
  float(*hs)[kHStride] = sm.hs[warp];
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = decode(tile, tiles_w, tiles_img);
    float acc[kRows][4][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;

    for (int c = 0; c < kChunks; ++c, ++i) {
      const int b = i % P;
      sm90::mbar_wait(&sm.patch_full[b], (i / P) & 1);
      products(patch<kBf16>(sm, b), sm.w2, c, warp, lane, acc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.patch_empty[b]);
    }

    // epilogue, two output rows at a time: acc[r][n][2 * e2 + e] is pixel
    // (kRows * warp + r, g + 8 * e2), channel 8n + 2 * t4 + e
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += 2) {
#pragma unroll
      for (int r = r0; r < r0 + 2; ++r) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = 8 * n + 2 * t4;
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            float* row = &hs[16 * (r - r0) + g + 8 * e2][col];
            row[0] = fmaxf(acc[r][n][2 * e2] + sm.b2[col], 0.f);
            row[1] = fmaxf(acc[r][n][2 * e2 + 1] + sm.b2[col + 1], 0.f);
          }
        }
      }
      __syncwarp();
      const int h = t.h0 + kRows * warp + r0 + (lane >> 4), w = t.w0 + (lane & 15);
      if (h < H && w < W) {
        const size_t m = ((size_t)t.img * H + h) * W + w;
        dpt_post::finish_pixel(hs[lane], sm.w3, sm.b3, conf_vmin, pts + m * 3, conf + m);
      }
      __syncwarp();  // hs is rewritten next
    }
  }
}

}  // namespace

template <bool kBf16>
int launch(const CUtensorMap& ymap, const void* w2p, const void* b2, const void* w3,
           const void* b3, float conf_vmin, void* pts, void* conf, int H, int W, int tiles_w,
           int tiles_img, int tiles, int grid, cudaStream_t stream) {
  static devattr::SmemLimit limit;
  const cudaError_t attr =
      limit.raise_on_current_device(dpt_tail_sm90_kernel<kBf16>, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dpt_tail_sm90_kernel<kBf16><<<grid, kThreads, kSmem, stream>>>(
      ymap, static_cast<const __nv_bfloat16*>(w2p), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3), conf_vmin,
      static_cast<float*>(pts), static_cast<float*>(conf), H, W, tiles_w, tiles_img, tiles);
  return static_cast<int>(cudaGetLastError());
}

// y: (batch, H, W, 128) fp32 (bf16 = 0) or bf16 (bf16 = 1), contiguous and
// 16-byte aligned; w2p:
// (9 * 128, 32) bf16, 16-byte aligned; b2: (32,) fp32; w3: (4, 32) fp32;
// b3: (4,) fp32; pts: (batch, H, W, 3) fp32; conf: (batch, H, W) fp32.
// Launches min(tiles, SMs of the current device) persistent blocks. Returns
// the CUDA error code of the launch, or of encoding y's tensor map offset by
// 1000 (1000 + CUresult; sm90::kNoEncoder when the runtime gives no
// encoder); -1 for sizes it does not take.
extern "C" int dust3r_dpt_tail(const void* y, const void* w2p, const void* b2,
                               const void* w3, const void* b3, float conf_vmin, void* pts,
                               void* conf, int batch, int H, int W, int bf16, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return -1;
  const long long tiles_w = (W + kTW - 1) / kTW;
  const long long tiles_img = tiles_w * ((H + kTH - 1) / kTH);
  const long long tiles = tiles_img * batch;
  if (tiles >= 0x7fffffffLL) return -1;
  int device = 0, sms = 0;
  cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err == cudaSuccess) {
    dev_err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  CUtensorMap ymap;
  const uint64_t dims[4] = {(uint64_t)kCin, (uint64_t)W, (uint64_t)H, (uint64_t)batch};
  const uint64_t yb = bf16 ? 2 : 4;  // bytes a value of y
  const uint64_t strides[3] = {yb * kCin, yb * kCin * W, yb * kCin * W * H};
  const uint32_t box[4] = {kChunk, kPW, kPH, 1};
  const int err = sm90::encode_tensor_map(
      &ymap, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y,
      dims, strides, box, bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err == sm90::kNoEncoder ? err : 1000 + err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tw = static_cast<int>(tiles_w), ti = static_cast<int>(tiles_img);
  const int nt = static_cast<int>(tiles);
  return bf16 ? launch<true>(ymap, w2p, b2, w3, b3, conf_vmin, pts, conf, H, W, tw, ti, nt,
                             grid, s)
              : launch<false>(ymap, w2p, b2, w3, b3, conf_vmin, pts, conf, H, W, tw, ti, nt,
                              grid, s);
}
