// The tap-sum form of the 3x3 stride-1 same-pad conv for Hopper (sm_90a),
// built on TMA and wgmma, with a plain C interface: the three horizontal
// taps' products into a bf16 Z, for a vertical combine outside the kernel.
//
// Replaces scripts/exp_convk_r3.py::conv3x3_pallas (TPU row 10: one W-padded
// bf16 x, the taps cut in VMEM) and scripts/exp_convk2_r3.py::conv3x3_pallas
// (row 11: three W-shifted bf16 copies of x made outside the kernel). Per
// pixel m (flat over batch, H, W) and column n = dy * Cout + c of Z:
//   Z[m, n] = bf16( sum_{dx, ci} x_dx[m, ci] * Wk[dx, n, ci] )
// with fp32 sums, where x_dx[m] is bf16 x at (b, h, w + dx - 1), zero
// outside the image's width, and Wk is the weight packed by the wrapper
// (ops/conv3x3_taps.py::pack_tap_weight_kmajor) as bf16 (3, 3 * Cout, Cin):
// [dx, dy * Cout + c, ci], row 11's packing with its last two dims swapped,
// so each tap's weight is K-major for wgmma. The wrapper then forms
// y[h] = Z_0[h-1] + Z_1[h] + Z_2[h+1] in PyTorch, as the JAX functions do
// in XLA outside their pallas_call. Z mixes pixels only along a row, so the
// kernel sees x as rows = batch * H rows of W pixels and never crosses one.
//
// What bounds it on an H100: an implicit GEMM of M = B*H*W pixels, N =
// 3*Cout, K = 3*Cin: the conv's 2*M*9*Cin*Cout bf16 FLOPs against 2 bytes a
// value of x (three times that for the copies) and 6*Cout bytes a pixel of
// Z. At the DPT shapes (Cin 96-256, Cout 32-256) the larger shapes are
// bound by the tensor cores, head_conv2 (Cout 32) and layer1_rn by bytes.
// The mma.sync kernel this one replaced (conv3x3_taps_mma.cu, the baseline)
// took 32 or 64 columns a block, so every column block reloaded its A
// (x crossed L2 36 times at N = 768), loaded A through registers with a
// halo test on every load, and issued m16n8k16 products. The design:
//   * persistent blocks, one an SM, each walking units (M tile, N tile)
//     blockIdx.x + k * gridDim.x in raster order, N fastest, so the N
//     tiles of one M tile run at once on neighbouring SMs and its x is read
//     from HBM once; the producer runs on into the next unit's loads while
//     the consumers store the last unit's Z;
//   * an M tile is a Wt x Ht patch of 128 pixels of consecutive rows: Wt
//     the smallest power of two >= W, between 8 and 128, so a row of W <=
//     128 wastes under half a patch row and W >= 128 takes flat 128-pixel
//     strips of one row; the TMA box is the patch itself;
//   * wide N tiles: BN = N where N <= 256 (head_conv2's 96), else the
//     largest of 256, 192, 96 dividing N (N is a multiple of 96: 384 ->
//     192, 768 -> 256), so x crosses L2 3 taps x N / BN <= 9 times;
//   * the K loop walks (tap dx, channel chunk) steps, 64 channels a chunk
//     (128-byte rows, 128-byte swizzle) where 64 divides Cin, else 32
//     (64-byte rows and swizzle; layer1_rn's Cin = 96). One producer thread
//     keeps a ring of stages in flight with TMA: the step's A box, 128
//     pixels x the chunk, from one 3-D tensor map over bf16 x at (c0, w0 +
//     dx - 1, r0) for "slices" (out-of-range coordinates, -1 included,
//     arrive as zeros: that is the W halo; the kernel has no halo test),
//     or from the dx-th copy's own map at (c0, w0, r0) for "copies"; and
//     the step's weight tile, BN rows x the chunk of Wk[dx] (K-major, the
//     same swizzle). The two variants differ only in which map a step
//     reads and its shift, so they walk one K order and give the same bits;
//   * two consumer warpgroups take 64 pixels each and issue m64nBNk16
//     wgmma with both operands read from the stage (x is bf16 already: no
//     rounding pass), up to 128 fp32 accumulators a thread at BN = 256;
//     setmaxnreg moves registers from the producer warpgroup (40) to them
//     (232). A step's stage goes back to the producer once the next step's
//     products are issued and the step's own are done (wgmma_wait<1>);
//   * the epilogue rounds the accumulators to bf16 into a 64-pixel x 32-
//     channel box in shared memory (64-byte swizzle, two buffers a
//     warpgroup) and stores each box with one TMA store, which leaves out
//     pixels past the image (the ragged last patch, W not a multiple of
//     Wt). No split reduction, no atomics: the same bits call to call.
// Not carried over from the TPU design: the TPU's row blocks (row 10's
// (B, H/Th) grid, row 11's rows sized to 16 MB of scoped VMEM).
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;                          // pixels of an M tile
constexpr int kConsumers = 2;                     // warpgroups of 64 pixels
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kZCols = 32;                  // Z channels of a store box (64-byte rows)
constexpr int kZBox = 64 * kZCols;          // a warpgroup's box: 64 pixels, bf16
constexpr int kSmemLimit = 232448;          // a block's shared memory on sm_90

template <int BN, int kChunk>
struct Smem {  // every array a multiple of 1024 bytes
  static constexpr int kABytes = kBM * kChunk * 2;
  static constexpr int kBBytes = BN * kChunk * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kFree = kSmemLimit - 1024 - kConsumers * 2 * kZBox * 2 - 256;
  static constexpr int kStages = kFree / kStageBytes < 8 ? kFree / kStageBytes : 8;
  __nv_bfloat16 a[kStages][kBM * kChunk];  // 128 pixels x the chunk
  __nv_bfloat16 b[kStages][BN * kChunk];   // BN columns x the chunk
  __nv_bfloat16 z[kConsumers][2][kZBox];   // each warpgroup's two Z boxes
  uint64_t full[kStages];   // the step's A and B landed (TMA bytes)
  uint64_t empty[kStages];  // the stage consumed (one arrival a consumer warp)
};

struct Geometry {
  int wt, ht;     // the patch: Wt pixels of Ht consecutive rows
  int tiles_w;    // patches across a row
  int ntn;        // N tiles
  int units;      // M tiles x N tiles
  int chunks;     // channel chunks a tap
  int shift;      // 1: tap dx reads x at w + dx - 1 ("slices"); 0: its copy at w
};

struct Tile {
  int n0, w0, r0;  // first column of Z, first pixel of a row, first row
};

template <int BN>
__device__ __forceinline__ Tile tile_of(int u, const Geometry& g) {
  const int mt = u / g.ntn;
  return Tile{(u - mt * g.ntn) * BN, (mt % g.tiles_w) * g.wt, (mt / g.tiles_w) * g.ht};
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The epilogue of consumer warpgroup cw: its 64 pixels x BN columns, box
// by box of 32 columns. Pixel r of the warpgroup is A row 64 * cw + r of
// the patch, so its box starts at patch pixel 64 * cw and spans min(Wt, 64)
// pixels of 64 / min(Wt, 64) rows, as the Z map's box does. e counts the
// warpgroup's boxes so far: box e goes to buffer e & 1, once the store of
// box e - 2 has read it.
template <int BN>
__device__ __forceinline__ void store_z(unsigned char* zbuf, const CUtensorMap* zmap,
                                        const float (&acc)[BN / 2], const Tile& t,
                                        const Geometry& g, int cw, int& e) {
  const int ct = threadIdx.x % 128;
  const int w4 = ct / 32, gr = (ct % 32) / 4, t4 = ct % 4;
  const int wq = (64 * cw) % g.wt, rq = (64 * cw) / g.wt;
#pragma unroll
  for (int j = 0; j < BN / kZCols; ++j, ++e) {
    unsigned char* buf = zbuf + (e & 1) * kZBox * 2;
    if (ct == 0) sm90::bulk_wait_read<1>();
    sm90::named_barrier_sync(1 + cw, 128);
    // acc[4 * jj + 2 * h2 + i]: pixel 16 * w4 + gr + 8 * h2, column 8 * jj
    // + 2 * t4 + i; 16-byte chunk q of a 64-byte row at q ^ ((r >> 1) & 3)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jj = 4 * j + q;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = 16 * w4 + gr + 8 * h2;
        *reinterpret_cast<uint32_t*>(buf + r * 64 + ((q ^ ((r >> 1) & 3)) << 4) + 4 * t4) =
            pack_bf16(acc[4 * jj + 2 * h2], acc[4 * jj + 2 * h2 + 1]);
      }
    }
    sm90::fence_proxy_async();
    sm90::named_barrier_sync(1 + cw, 128);
    if (ct == 0) {
      sm90::tma_store_3d(zmap, buf, t.n0 + kZCols * j, t.w0 + wq, t.r0 + rq);
      sm90::bulk_commit();
    }
  }
}

template <int BN, int kChunk>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_taps_sm90_kernel(const __grid_constant__ CUtensorMap x0map,
                         const __grid_constant__ CUtensorMap x1map,
                         const __grid_constant__ CUtensorMap x2map,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap zmap, const Geometry g) {
  using S = Smem<BN, kChunk>;
  constexpr int kS = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                ~static_cast<uintptr_t>(1023));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int steps = 3 * g.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 4 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one thread issues the loads
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;  // the ring's steps so far: stage it % kS, phase (it / kS) & 1
      for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
        const Tile t = tile_of<BN>(u, g);
        for (int k = 0; k < steps; ++k, ++it) {
          const int s = it % kS;
          if (it >= kS) sm90::mbar_wait(&sm.empty[s], ((it / kS) & 1) ^ 1);
          const int dx = k / g.chunks;
          const int c0 = (k - dx * g.chunks) * kChunk;
          const CUtensorMap* xmap = dx == 0 ? &x0map : dx == 1 ? &x1map : &x2map;
          sm90::mbar_arrive_expect_tx(&sm.full[s], S::kStageBytes);
          sm90::tma_load_3d(sm.a[s], xmap, &sm.full[s], c0, t.w0 + g.shift * (dx - 1), t.r0);
          sm90::tma_load_3d(sm.b[s], &wmap, &sm.full[s], c0, t.n0, dx);
        }
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  constexpr uint32_t kRowBytes = kChunk * 2;
  constexpr uint64_t kSwizzle = kChunk == 64 ? sm90::kSwizzle128B : sm90::kSwizzle64B;
  const int cw = warp / 4;
  unsigned char* zbuf = reinterpret_cast<unsigned char*>(sm.z[cw]);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int it = 0, e = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Tile t = tile_of<BN>(u, g);
    for (int k = 0; k < steps; ++k, ++it) {
      const int s = it % kS;
      sm90::mbar_wait(&sm.full[s], (it / kS) & 1);
      const uint64_t adesc =
          sm90::smem_desc(sm.a[s] + 64 * kChunk * cw, 16, 8 * kRowBytes, kSwizzle);
      const uint64_t bdesc = sm90::smem_desc(sm.b[s], 16, 8 * kRowBytes, kSwizzle);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        sm90::wgmma_ss<0, 0>(acc, sm90::desc_advance(adesc, 32 * kk),
                             sm90::desc_advance(bdesc, 32 * kk), k > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (k > 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&sm.empty[(it - 1) % kS]);
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[(it - 1) % kS]);
    store_z<BN>(zbuf, &zmap, acc, t, g, cw, e);
  }
  if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();
}

// A 3-D bf16 tensor map (d0, d1, d2), d0 contiguous, rows of d0 values and
// planes of d1 rows, boxes of (b0, b1, b2).
int map3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
          uint32_t b0, uint32_t b1, uint32_t b2, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint64_t strides[2] = {2 * d0, 2 * d0 * d1};
  const uint32_t box[3] = {b0, b1, b2};
  return sm90::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides,
                                 box, swizzle);
}

template <int BN, int kChunk>
int launch(const void* x0, const void* x1, const void* x2, const void* wk, void* z, int rows,
           int W, int cin, int n, bool copies, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(Smem<BN, kChunk>) + 1024;
  static_assert(kSmem <= static_cast<size_t>(kSmemLimit) && Smem<BN, kChunk>::kStages >= 2,
                "shared memory");
  Geometry g;
  g.wt = 8;
  while (g.wt < W && g.wt < kBM) g.wt *= 2;
  g.ht = kBM / g.wt;
  g.tiles_w = (W + g.wt - 1) / g.wt;
  g.ntn = n / BN;
  const long long units = (long long)g.tiles_w * ((rows + g.ht - 1) / g.ht) * g.ntn;
  if (units >= 0x7fffffffLL) return -1;
  g.units = static_cast<int>(units);
  g.chunks = cin / kChunk;
  g.shift = copies ? 0 : 1;

  const CUtensorMapSwizzle swizzle =
      kChunk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint32_t zw = g.wt < 64 ? g.wt : 64;
  CUtensorMap xmap[3], wmap, zmap;
  int err = 0;
  for (int dx = 0; dx < 3 && err == 0; ++dx) {
    err = map3d(&xmap[dx], copies ? (dx == 0 ? x0 : dx == 1 ? x1 : x2) : x0, cin, W, rows,
                kChunk, g.wt, g.ht, swizzle);
  }
  if (err == 0) err = map3d(&wmap, wk, cin, n, 3, kChunk, BN, 1, swizzle);
  if (err == 0) {
    err = map3d(&zmap, z, n, W, rows, kZCols, zw, 64 / zw, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err != 0) return err == sm90::kNoEncoder ? err : 1000 + err;

  static devattr::SmemLimit limit;
  const cudaError_t attr = limit.raise_on_current_device(conv3x3_taps_sm90_kernel<BN, kChunk>,
                                                         static_cast<int>(kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;
  cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err == cudaSuccess) {
    dev_err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const int grid = g.units < sms ? g.units : sms;
  conv3x3_taps_sm90_kernel<BN, kChunk><<<grid, kThreads, kSmem, stream>>>(
      xmap[0], xmap[1], xmap[2], wmap, zmap, g);
  return static_cast<int>(cudaGetLastError());
}

template <int kChunk>
int launch_bn(int bn, const void* x0, const void* x1, const void* x2, const void* wk, void* z,
              int rows, int W, int cin, int n, bool copies, cudaStream_t s) {
  switch (bn) {
    case 256:
      return launch<256, kChunk>(x0, x1, x2, wk, z, rows, W, cin, n, copies, s);
    case 192:
      return launch<192, kChunk>(x0, x1, x2, wk, z, rows, W, cin, n, copies, s);
    default:
      return launch<96, kChunk>(x0, x1, x2, wk, z, rows, W, cin, n, copies, s);
  }
}

}  // namespace

// copies = 0 ("slices"): x0 is x, (npix, cin) bf16 with npix = batch * H * W
// pixels of rows W wide; x1, x2 unused (may be null). copies = 1: x0, x1,
// x2 are the dx = 0, 1, 2 shifted copies, each (npix, cin) bf16. wk: (3,
// 3 * cout, cin) bf16 (pack_tap_weight_kmajor); z: (npix, 3 * cout) bf16.
// All contiguous, 16-byte aligned; cin and cout multiples of 32. Launches
// min(units, SMs of the current device) persistent blocks. Returns the CUDA
// error code of the launch, or of encoding a tensor map offset by 1000
// (1000 + CUresult; sm90::kNoEncoder when the runtime gives no encoder);
// -1 for sizes it does not take.
extern "C" int dust3r_conv3x3_taps(const void* x0, const void* x1, const void* x2,
                                   const void* wk, void* z, int npix, int W, int cin, int cout,
                                   int copies, void* stream) {
  if (cin % 32 || cout % 32 || cin <= 0 || cout <= 0 || npix <= 0 || W <= 0) return -1;
  const long long n = 3LL * cout;
  if ((long long)npix * (cin > n ? cin : n) >= 0x7fffffffLL || (npix + kBM - 1) / kBM > 65535) {
    return -1;
  }
  if (npix % W || (copies && (x1 == nullptr || x2 == nullptr))) return -1;
  // N is a multiple of 96: BN = N up to 256, else the largest of 256, 192,
  // 96 dividing it (128 never comes first: 96 and 128 dividing N make 192 do)
  const int nn = static_cast<int>(n);
  const int bn = nn <= 256 ? nn : nn % 256 == 0 ? 256 : nn % 192 == 0 ? 192 : 96;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = npix / W;
  return cin % 64 == 0 ? launch_bn<64>(bn, x0, x1, x2, wk, z, rows, W, cin, nn, copies != 0, s)
                       : launch_bn<32>(bn, x0, x1, x2, wk, z, rows, W, cin, nn, copies != 0, s);
}
