// The tap-sum form of the 3x3 stride-1 same-pad conv on mma.sync (sm_90a),
// with a plain C interface: the three horizontal taps' products into a bf16
// Z, for a vertical combine outside the kernel. It is the baseline of
// conv3x3_taps.cu (TMA + wgmma), which replaced it on the default route;
// ops/conv3x3_taps.py reaches it by core="mma".
//
// Replaces scripts/exp_convk_r3.py::conv3x3_pallas (TPU row 10: one W-padded
// bf16 x, the taps cut in VMEM) and scripts/exp_convk2_r3.py::conv3x3_pallas
// (row 11: three W-shifted bf16 copies of x made outside the kernel). Per
// pixel m (flat over batch, H, W) and column n = dy * Cout + c of Z:
//   Z[m, n] = bf16( sum_{dx, ci} x_dx[m, ci] * Wt[dx, ci, n] )
// with fp32 sums, where x_dx[m] is bf16 x at (b, h, w + dx - 1), zero
// outside the image's width, and Wt is the weight packed by the wrapper as
// bf16 (3 * Cin, 3 * Cout), row dx * Cin + ci, column dy * Cout + c. The
// wrapper then forms y[h] = Z_0[h-1] + Z_1[h] + Z_2[h+1] in PyTorch, as the
// JAX functions do in XLA outside their pallas_call.
//
// What bounds it on an H100: an implicit GEMM of M = B*H*W pixels, N =
// 3*Cout, K = 3*Cin: the conv's 2*M*9*Cin*Cout FLOPs, against 2 bytes a
// value of x (three times that for the copies) and 6*Cout bytes a pixel of
// Z; at the DPT shapes (Cin 96-256, Cout 32-256) that is 100-400 FLOPs a
// byte, near or above the card's ~295, so the bf16 tensor cores bound the
// larger shapes and the Z round trip the narrow ones. The design: the
// k-loop of conv3x3_igemm.cuh (128-pixel M tiles, four warps, mma.sync
// m16n8k16 bf16 with fp32 accumulators, double-buffered shared tiles) over
// K = 3 * Cin, one dx tap and 32 channels a step, with a bf16 A loader of
// 16-byte loads (8 values); the epilogue rounds Z to bf16 and stores it.
// Variant "slices" (row 10) reads one bf16 x and applies the W halo in the
// load; variant "copies" (row 11) reads the three shifted copies, with no
// halo test. Not carried over: the TPU's row blocks (row 10's (B, H/Th)
// grid, row 11's rows sized to 16 MB of scoped VMEM); both variants take
// the same M tiles here.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include "conv3x3_igemm.cuh"

namespace {

using namespace conv3x3_igemm;

// bf16 A loader: k-step kc takes tap dx = kc / (cin / 32) and 32 channels;
// a thread stages kARows pixels, 8 channels each, by 16-byte loads.
template <bool kCopies>
struct Bf16TapLoader {
  static constexpr int kVec = 8;  // bf16 channels a load
  static constexpr int kRowsPerPass = kThreads / (kBK / kVec);
  static constexpr int kARows = kBM / kRowsPerPass;
  const __nv_bfloat16* __restrict__ x0;  // "slices": x; "copies": the dx = 0 copy
  const __nv_bfloat16* __restrict__ x1;  // "copies": the dx = 1 and dx = 2 copies
  const __nv_bfloat16* __restrict__ x2;
  int W, cin, chunks, oct, r0;
  int pix[kARows], pw[kARows];
  uint4 areg[kARows];

  __device__ __forceinline__ Bf16TapLoader(const __nv_bfloat16* x0_, const __nv_bfloat16* x1_,
                                           const __nv_bfloat16* x2_, int W_, int cin_,
                                           int npix, int m0)
      : x0(x0_), x1(x1_), x2(x2_), W(W_), cin(cin_), chunks(cin_ / kBK),
        oct(threadIdx.x % (kBK / kVec)), r0(threadIdx.x / (kBK / kVec)) {
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int m = m0 + r0 + kRowsPerPass * i;
      pix[i] = m < npix ? m : -1;  // -1: past the last pixel, loads zeros
      pw[i] = m % W;
    }
  }

  __device__ __forceinline__ void load(int kc) {
    const int dx = kc / chunks;
    const int c0 = (kc - dx * chunks) * kBK + oct * kVec;
    const __nv_bfloat16* src = kCopies ? (dx == 0 ? x0 : dx == 1 ? x1 : x2) : x0;
    const int shift = kCopies ? 0 : dx - 1;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int ww = pw[i] + shift;
      const bool inside = pix[i] >= 0 && (kCopies || (ww >= 0 && ww < W));
      areg[i] = inside ? *reinterpret_cast<const uint4*>(src + (size_t)(pix[i] + shift) * cin + c0)
                       : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16 (*a)[kAStride]) {
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      *reinterpret_cast<uint4*>(&a[r0 + kRowsPerPass * i][oct * kVec]) = areg[i];
    }
  }
};

template <int BN, bool kCopies>
__global__ void __launch_bounds__(kThreads)
conv3x3_taps_kernel(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ x1,
                    const __nv_bfloat16* __restrict__ x2, const __nv_bfloat16* __restrict__ wt,
                    __nv_bfloat16* __restrict__ z, int W, int cin, int n, int npix) {
  constexpr int kWN = BN / 2;   // columns per warp
  constexpr int kNT = kWN / 8;  // 8-column mma tiles per warp
  __shared__ __align__(16) Tiles<BN> sm;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  Bf16TapLoader<kCopies> al(x0, x1, x2, W, cin, npix, m0);
  Acc<BN> acc;
  gemm_loop<BN>(al, wt, n, 3 * (cin / kBK), n0, sm, acc);

  // epilogue: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of
  // each 16 x 8 tile; Z rounded to bf16
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + warp_n * kWN + nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + warp_m * 64 + mt * 16 + g + 8 * half;
        if (m < npix) {
          *reinterpret_cast<__nv_bfloat162*>(z + (size_t)m * n + col) =
              __floats2bfloat162_rn(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
    }
  }
}

template <int BN, bool kCopies>
int launch(const __nv_bfloat16* x0, const __nv_bfloat16* x1, const __nv_bfloat16* x2,
           const __nv_bfloat16* wt, __nv_bfloat16* z, int npix, int W, int cin, int n,
           cudaStream_t stream) {
  const dim3 grid(n / BN, (npix + kBM - 1) / kBM);
  conv3x3_taps_kernel<BN, kCopies><<<grid, kThreads, 0, stream>>>(x0, x1, x2, wt, z, W, cin, n,
                                                                  npix);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// copies = 0 ("slices"): x0 is x, (npix, cin) bf16 with npix = batch * H * W
// pixels of rows W wide; x1, x2 unused (may be null). copies = 1: x0, x1,
// x2 are the dx = 0, 1, 2 shifted copies, each (npix, cin) bf16. wt: (3 *
// cin, 3 * cout) bf16; z: (npix, 3 * cout) bf16. All contiguous, 16-byte
// aligned; cin and cout multiples of 32. Returns the CUDA error code of the
// launch; -1 for sizes it does not take.
extern "C" int dust3r_conv3x3_taps_mma(const void* x0, const void* x1, const void* x2,
                                       const void* wt, void* z, int npix, int W, int cin,
                                       int cout, int copies, void* stream) {
  if (cin % kBK || cout % 32 || cin <= 0 || cout <= 0 || npix <= 0 || W <= 0) return -1;
  const long long n = 3LL * cout;
  if ((long long)npix * (cin > n ? cin : n) >= 0x7fffffffLL || (npix + kBM - 1) / kBM > 65535) {
    return -1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const __nv_bfloat16*>(x0);
  const auto* b = static_cast<const __nv_bfloat16*>(x1);
  const auto* c = static_cast<const __nv_bfloat16*>(x2);
  const auto* w = static_cast<const __nv_bfloat16*>(wt);
  auto* zz = static_cast<__nv_bfloat16*>(z);
  const int nn = static_cast<int>(n);
  if (copies) {
    return nn % 64 == 0 ? launch<64, true>(a, b, c, w, zz, npix, W, cin, nn, s)
                        : launch<32, true>(a, b, c, w, zz, npix, W, cin, nn, s);
  }
  return nn % 64 == 0 ? launch<64, false>(a, b, c, w, zz, npix, W, cin, nn, s)
                      : launch<32, false>(a, b, c, w, zz, npix, W, cin, nn, s);
}
