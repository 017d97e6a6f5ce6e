// The int8 serving mode's two passes around the int8 product, for Hopper
// (sm_90a), with a plain C interface: the per-token quantize of the
// activations and the dequant epilogue of the int32 product.
//
// Replaces no Pallas kernel: dust3r_tpu/ops/quant.py::QuantDense computes
// both in XLA around lax.dot_general (quant.py:72-87). The product itself is
// torch._int_mm (cuBLASLt), as the JAX mode leaves it to XLA.
//
// quantize_rows, for x (rows, K) fp32 or bf16, one row a token:
//   amax     = max_k |x[k]|
//   inv_r    = bf16-or-fp32(126 / max(amax, 1e-12))          (IEEE division)
//   xq[k]    = clip(rint(T(x[k] * inv_r)), -127, 127)         int8
// with T the rounding to x's dtype of the exact fp32 product (bf16 x bf16
// fits fp32), rint rounding half to even, as jnp.round and torch.round do;
// inv_r is written in fp32 (the rounded value, exactly).
// dequant, for acc (rows, N) int32:
//   y[n]     = ((float(acc[n]) * (1 / inv_r)) * scale[n]) + bias[n]
// in fp32, each operation rounded on its own (no FMA contraction), in the
// plain version's order, then rounded once to y's dtype (fp32 or bf16).
//
// What bounds them on an H100: a handful of operations a value against
// 3 bytes (bf16 x in, int8 out) or 6 bytes (int32 acc in, bf16 y out):
// memory, x read once (the second pass finds the row in L1 or L2) and acc
// read once. The design:
//   * quantize: one warp a row, 16-byte loads (8 bf16 or 4 fp32 a lane),
//     the row's max by shuffles, then the quantize pass writing 8 or 4
//     bytes a lane; eight rows a block;
//   * dequant: one thread for 4 values of a row (a 16-byte load of acc,
//     16-byte loads of scale and bias, an 8- or 16-byte store), the row's
//     reciprocal by __frcp_rn (IEEE 1 / x).
// A GEMM of its own on int8 wgmma with this epilogue fused would spare the
// int32 round trip (12 bytes a value of y at N = 4096); that is later work.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError() after its
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // quantize: one warp a row
constexpr int kThreads = 256;

// 16 bytes of x as fp32 values: 4 fp32 or 8 bf16
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  __device__ static float round(float v) { return v; }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

__device__ __forceinline__ uint32_t q8(float v) {
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ inv_out, int rows, int K) {
  constexpr int V = Pack<T>::n;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * K;
  float amax = 0.f;
  for (int c = lane * V; c < K; c += 32 * V) {
    float v[V];
    Pack<T>::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float inv = Pack<T>::round(__fdiv_rn(126.f, fmaxf(amax, 1e-12f)));
  if (lane == 0) inv_out[row] = inv;
  int8_t* qr = xq + static_cast<size_t>(row) * K;
  for (int c = lane * V; c < K; c += 32 * V) {
    float v[V];
    Pack<T>::load(xr + c, v);
    uint32_t w[V / 4];
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      w[j] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[j] |= q8(Pack<T>::round(__fmul_rn(v[4 * j + i], inv))) << (8 * i);
      }
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(qr + c) = w[0];
    }
  }
}

__device__ __forceinline__ void store4(float* y, const float (&o)[4]) {
  *reinterpret_cast<float4*>(y) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* y, const float (&o)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(y) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

template <typename To>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int4* __restrict__ acc, const float* __restrict__ inv,
               const float* __restrict__ scale, const float* __restrict__ bias,
               To* __restrict__ y, int n4, int total) {
  // every offset is under total < 2^31 groups of 4: 32-bit index math
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int row = idx / n4;
  const int c = (idx - row * n4) * 4;
  const int4 a = acc[idx];
  const float r = __frcp_rn(inv[row]);
  const float4 s = *reinterpret_cast<const float4*>(scale + c);
  const float4 b = *reinterpret_cast<const float4*>(bias + c);
  const float o[4] = {
      __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(a.x), r), s.x), b.x),
      __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(a.y), r), s.y), b.y),
      __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(a.z), r), s.z), b.z),
      __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(a.w), r), s.w), b.w)};
  store4(y + static_cast<size_t>(idx) * 4, o);
}

}  // namespace

// x: (rows, K) fp32 (bf16 = 0) or bf16 (bf16 = 1), contiguous, 16-byte
// aligned, K a multiple of 8; xq: (rows, K) int8; inv: (rows,) fp32.
// Returns the CUDA error code of the launch; -1 for sizes it does not take.
extern "C" int dust3r_quantize_rows(const void* x, void* xq, void* inv, int rows, int K,
                                    int bf16, void* stream) {
  if (rows <= 0 || K <= 0 || K % 8) return -1;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    quantize_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(inv), rows, K);
  } else {
    quantize_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(inv),
        rows, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc: (rows, N) int32; inv: (rows,) fp32; scale, bias: (N,) fp32; y:
// (rows, N) fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1); all contiguous; acc,
// scale, bias and y 16-byte aligned (y 8-byte for bf16); N a multiple of 8.
// Returns the CUDA error code of the launch; -1 for sizes it does not take.
extern "C" int dust3r_dequant(const void* acc, const void* inv, const void* scale,
                              const void* bias, void* y, int rows, int N, int out_bf16,
                              void* stream) {
  if (rows <= 0 || N <= 0 || N % 8) return -1;
  const long long total = static_cast<long long>(rows) * (N / 4);
  if (total >= 0x7fffffffLL) return -1;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* a = static_cast<const int4*>(acc);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (out_bf16) {
    dequant_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        a, iv, sc, bi, static_cast<__nv_bfloat16*>(y), N / 4, static_cast<int>(total));
  } else {
    dequant_kernel<float><<<blocks, kThreads, 0, s>>>(a, iv, sc, bi, static_cast<float*>(y),
                                                      N / 4, static_cast<int>(total));
  }
  return static_cast<int>(cudaGetLastError());
}
