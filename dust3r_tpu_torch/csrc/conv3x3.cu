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
//   * a k-loop over the nine taps x Cin/32 channel chunks: each step stages
//     a 128 x 32 slice of x (fp32, 16-byte loads, the tap's shift applied
//     to the pixel index and the zero halo applied in the load) and the
//     matching 32 x BN slice of W in registers, rounds x to bf16 and stores
//     both to a double-buffered shared-memory tile, so the global loads of
//     step k+1 are in flight while the tensor cores work on step k;
//   * mma.sync m16n8k16 bf16 with fp32 accumulators in registers, A
//     fragments by ldmatrix and B fragments by ldmatrix.trans; rows padded
//     by 8 elements so fragment loads hit distinct banks;
//   * the bias added in the epilogue, y stored once in fp32.
// Not carried over from the TPU design: the three tap-column matmuls into a
// bf16 Z of 3 * Cout channels and the vertical combine outside the kernel
// (Z never exists here, so it is not rounded), and the row-block sizing
// against VMEM. wgmma, TMA and a deeper pipeline are later work.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // output pixels per block
constexpr int kBK = 32;             // input channels per k-step (one tap)
constexpr int kThreads = 128;       // four warps: 2 (pixels) x 2 (channels)
constexpr int kAStride = kBK + 8;   // bf16 per A row in shared memory (80 bytes)
constexpr int kRowsPerPass = kThreads / (kBK / 4);  // A rows one pass of 16-byte loads covers
constexpr int kARows = kBM / kRowsPerPass;          // A rows each thread stages

// acc (16x8 fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16x16 tile: lane i passes row (i % 16), column
// 8 * (i / 16) of the tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// B fragments of two adjacent 8-column tiles of a row-major (16 k-rows,
// 16 n-columns) tile: lane i passes k-row (i % 16), column 8 * (i / 16);
// r[0], r[1] are the first tile's (b0, b1), r[2], r[3] the second's.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint2 to_bf16x4(float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  return u;
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv3x3_igemm_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                     const float* __restrict__ bias, float* __restrict__ y, int H, int W,
                     int cin, int cout, int npix) {
  constexpr int kBStride = BN + 8;           // bf16 per B row in shared memory
  constexpr int kWN = BN / 2;                // channels per warp
  constexpr int kNT = kWN / 8;               // 8-column mma tiles per warp
  constexpr int kMT = 4;                     // 16-row mma tiles per warp (64 rows)
  constexpr int kBVecs = kBK * BN / 8 / kThreads;  // 16-byte B loads per thread
  static_assert(kNT % 2 == 0 && kBVecs >= 1, "tile shape");

  __shared__ __align__(16) __nv_bfloat16 as[2][kBM][kAStride];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kBK][kBStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;

  // the pixels this thread stages: rows r0 + kRowsPerPass * i of the tile
  const int quad = tid % (kBK / 4);  // which 4 of the chunk's 32 channels
  const int r0 = tid / (kBK / 4);
  int pix[kARows], ph[kARows], pw[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + r0 + kRowsPerPass * i;
    pix[i] = m;
    ph[i] = m < npix ? (m / W) % H : -2;  // -2: every tap falls outside
    pw[i] = m % W;
  }

  const int chunks = cin / kBK;
  const int nk = 9 * chunks;
  float4 areg[kARows];
  uint4 breg[kBVecs];

  auto load = [&](int kc) {
    const int tap = kc / chunks;
    const int c0 = (kc - tap * chunks) * kBK + quad * 4;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    const int shift = dy * W + dx;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int hh = ph[i] + dy;
      const int ww = pw[i] + dx;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        areg[i] = *reinterpret_cast<const float4*>(
            x + (size_t)(pix[i] + shift) * cin + c0);
      } else {
        areg[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      const int row = v / (BN / 8);
      const int col = (v % (BN / 8)) * 8;
      breg[i] = *reinterpret_cast<const uint4*>(
          wp + (size_t)(kc * kBK + row) * cout + n0 + col);
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      *reinterpret_cast<uint2*>(&as[buf][r0 + kRowsPerPass * i][quad * 4]) =
          to_bf16x4(areg[i]);
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&bs[buf][v / (BN / 8)][(v % (BN / 8)) * 8]) = breg[i];
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < nk) load(kc + 1);  // in flight during the products below
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        ldmatrix_x4(a[mt], &as[cur][warp_m * 64 + mt * 16 + (lane & 15)]
                             [ks * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &bs[cur][ks * 16 + (lane & 15)]
                                 [warp_n * kWN + np * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (kc + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of
  // each 16 x 8 tile
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
