"""int8 serving mode of the transformer GEMMs: `QuantLinear`, the weight
conversion, and the wrappers of the two CUDA kernels around the int8
product.

Counterpart of `dust3r_tpu/ops/quant.py`. Symmetric int8 with
per-output-channel weight scales (made once, at conversion) and per-token
activation scales (made on every call):

    amax  = max |x| over the token's K values
    inv   = 126 / max(amax in fp32, 1e-12), rounded once to x's dtype (inv_r)
    xq    = clip(round_half_even(x * inv_r in x's dtype), -127, 127)   int8
    acc   = xq . wq                                                    int32
    y     = acc * (1 / inv_r) * scale + bias                           fp32, in that order

then cast to the module's compute dtype. JAX pins the rounding of inv_r
with an `optimization_barrier` against XLA's excess precision; here it is
rounded explicitly, and nothing needs the barrier.

Quantized, as in JAX: every `qkv`, `proj`, `projq`, `projk`, `projv`,
`fc1` and `fc2` inside `enc_blocks`, `dec_blocks` and `dec_blocks2`, and
`decoder_embed`. Attention cores, LayerNorms, the patch embed and the heads
stay as they are. A quantized model is inference-only (rounding has no
gradient): `training` refuses one.

* `quantize_rows_ref` / `dequant_ref` are the plain versions of the two
  kernels of `csrc/quant_int8.cu`; `quantize_rows` / `dequant` their
  wrappers (the plain version for CPU tensors; for CUDA tensors the kernel,
  or they raise). `quantize_rows.launches` and `dequant.launches` count
  kernel launches.
* `int8_matmul` is the int32 product: `torch._int_mm` on the card (as the
  JAX mode leaves it to XLA's `dot_general`), an int32 `torch.mm` on the
  CPU. A shape `_int_mm` refuses raises; nothing falls back.
* `quant_linear` chains the three; `quant_linear_ref` is the same function
  in plain PyTorch on any device.
* `QuantLinear` holds buffers `weight_q` (int8 (N, K), `nn.Linear`'s
  layout, which `_int_mm` reads transposed), `weight_scale` (fp32 (N,)) and
  `bias` (fp32 (N,)); `quantize_linear` makes one from a `Linear`, as
  `quantize_dense_params` does from a Dense; `quantize_for_inference`
  swaps the targeted `Linear`s of a model in place.
"""
from __future__ import annotations

import ctypes

import torch
from torch import nn

from ._build import count_launch

# Linear names quantized inside the encoder and decoder blocks
BLOCK_TARGETS = frozenset({"qkv", "proj", "projq", "projk", "projv", "fc1", "fc2"})
BLOCK_STACKS = ("enc_blocks", "dec_blocks", "dec_blocks2")
QMAX = 127  # int8 range of both operands
X_TARGET = 126.0  # the activations' scale targets +-126: one level of margin for the rounding
MIN_ROWS = 17  # torch._int_mm's limits on the card: more than 16 rows,
K_MULTIPLE = 8  # K and N multiples of 8


def quantize_rows_ref(x):
    """x (T, K) fp32 or bf16 -> (xq int8 (T, K), inv_r fp32 (T,)): inv_r is
    the per-row scale rounded to x's dtype, held exactly in fp32."""
    amax = x.abs().amax(dim=-1, keepdim=True).float().clamp_min(1e-12)
    # a tensor over a tensor: torch computes `number / t` as `reciprocal(t)
    # * number`, a unit of the last place away from JAX's quotient
    inv_r = (torch.full_like(amax, X_TARGET) / amax).to(x.dtype)
    xq = torch.round(x * inv_r).clamp_(-QMAX, QMAX).to(torch.int8)
    return xq, inv_r.float().reshape(-1)


def dequant_ref(acc, inv_r, scale, bias, dtype):
    """acc (T, N) int32 -> acc * (1 / inv_r) * scale + bias in fp32, in that
    order, cast to `dtype`."""
    y = acc.float() * (1.0 / inv_r)[:, None] * scale + bias
    return y.to(dtype)


def int8_matmul_ref(xq, wq):
    """xq (T, K) int8 . wq (N, K) int8 transposed -> (T, N) int32, exactly."""
    return torch.mm(xq.to(torch.int32), wq.t().to(torch.int32))


_LIB = {}


def _kernel(name, argtypes):
    if name not in _LIB:
        from ._build import load_library

        fn = getattr(load_library("quant_int8"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIB[name] = fn
    return _LIB[name]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_rows(x):
    """`quantize_rows_ref` of x (T, K): the plain version for a CPU tensor;
    for a CUDA tensor (fp32 or bf16, contiguous, K a multiple of 8, 16-byte
    aligned) the kernel, one launch, or it raises."""
    if x.device.type == "cpu":
        return quantize_rows_ref(x)
    if not x.is_cuda:
        raise ValueError("x must lie on the CPU or a CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the quantize kernel takes fp32 or bf16 x, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"want a contiguous, 16-byte aligned (T, K) x, got {tuple(x.shape)}")
    rows, K = x.shape
    if rows == 0 or K == 0 or K % K_MULTIPLE or x.numel() >= 2 ** 31:
        raise ValueError(f"unsupported size {tuple(x.shape)} (K a multiple of {K_MULTIPLE})")
    xq = torch.empty((rows, K), dtype=torch.int8, device=x.device)
    inv_r = torch.empty(rows, dtype=torch.float32, device=x.device)
    fn = _kernel("dust3r_quantize_rows", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), xq.data_ptr(), inv_r.data_ptr(), rows, K,
                 int(x.dtype == torch.bfloat16), _stream(x))
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)} {x.dtype})")
    count_launch(quantize_rows, "launches")
    return xq, inv_r


quantize_rows.launches = 0


def dequant(acc, inv_r, scale, bias, dtype):
    """`dequant_ref`: the plain version for CPU tensors; for CUDA tensors
    (acc contiguous int32 (T, N), N a multiple of 8; inv_r (T,), scale and
    bias (N,) contiguous fp32; dtype fp32 or bf16) the kernel, one launch,
    or it raises."""
    if acc.device.type == "cpu":
        return dequant_ref(acc, inv_r, scale, bias, dtype)
    tensors = (acc, inv_r, scale, bias)
    if not (acc.is_cuda and all(t.device == acc.device for t in tensors)):
        raise ValueError("acc, inv_r, scale and bias must lie on one CUDA device")
    if acc.dtype != torch.int32 or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError(f"the dequant kernel takes int32 acc and fp32 inv_r, scale, bias, "
                        f"got {[t.dtype for t in tensors]}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the dequant kernel writes fp32 or bf16, not {dtype}")
    if acc.dim() != 2 or not all(t.is_contiguous() for t in tensors) or any(
            t.data_ptr() % 16 for t in (acc, scale, bias)):
        raise ValueError("acc (T, N), inv_r, scale and bias must be contiguous; acc, scale "
                         "and bias 16-byte aligned")
    rows, N = acc.shape
    if (inv_r.shape != (rows,) or scale.shape != (N,) or bias.shape != (N,) or rows == 0
            or N % K_MULTIPLE or acc.numel() >= 2 ** 31):
        raise ValueError(f"want acc (T, N), N a multiple of {K_MULTIPLE}, inv_r (T,), scale "
                         f"and bias (N,); got {[tuple(t.shape) for t in tensors]}")
    y = torch.empty((rows, N), dtype=dtype, device=acc.device)
    fn = _kernel("dust3r_dequant", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p])
    with torch.cuda.device(acc.device):
        err = fn(acc.data_ptr(), inv_r.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), rows, N, int(dtype == torch.bfloat16), _stream(acc))
    if err != 0:
        raise RuntimeError(f"dequant kernel launch failed: CUDA error {err} "
                           f"(acc {tuple(acc.shape)})")
    count_launch(dequant, "launches")
    return y


dequant.launches = 0


def int8_matmul(xq, wq):
    """xq (T, K) int8 . wq (N, K) int8 transposed -> (T, N) int32: on the
    card `torch._int_mm`, which reads wq's transpose in column-major order
    (wq as stored); on the CPU `int8_matmul_ref`. A shape `_int_mm` does not
    take raises."""
    if xq.device.type == "cpu":
        return int8_matmul_ref(xq, wq)
    rows, K = xq.shape
    if rows < MIN_ROWS or K % K_MULTIPLE or wq.shape[0] % K_MULTIPLE or wq.shape[1] != K:
        raise ValueError(f"torch._int_mm takes more than {MIN_ROWS - 1} rows and K, N "
                         f"multiples of {K_MULTIPLE}: got xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}")
    return torch._int_mm(xq, wq.t())


def quant_linear(x, weight_q, weight_scale, bias, dtype):
    """x (..., K) -> (..., N) in `dtype`: quantize, int8 product, dequant."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, inv_r = quantize_rows(x.reshape(-1, K).contiguous())
    y = dequant(int8_matmul(xq, weight_q), inv_r, weight_scale, bias, dtype)
    return y.reshape(*lead, weight_q.shape[0])


def quant_linear_ref(x, weight_q, weight_scale, bias, dtype):
    """`quant_linear` in plain PyTorch, on any device (the exact int32
    product in int64 on the card, whose matmul takes no int32)."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, inv_r = quantize_rows_ref(x.reshape(-1, K))
    if xq.is_cuda:  # exact: |acc| < 2^31 and every partial sum is an integer below 2^53
        acc = torch.mm(xq.double(), weight_q.t().double()).to(torch.int32)
    else:
        acc = int8_matmul_ref(xq, weight_q)
    return dequant_ref(acc, inv_r, weight_scale, bias, dtype).reshape(*lead, -1)


class QuantLinear(nn.Module):
    """Drop-in for the blocks' `Linear`, its product on int8 operands (the
    JAX `QuantDense`). x is quantized in its own dtype; the output is in
    `dtype`, the module's compute dtype. Made by `quantize_linear`; the
    zero / one buffers of a fresh module only give the state dict its
    shapes."""

    def __init__(self, in_features, out_features, dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_features, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device))

    def forward(self, x):
        return quant_linear(x, self.weight_q, self.weight_scale, self.bias, self.compute_dtype)


@torch.no_grad()
def quantize_linear(linear):
    """A `Linear` (weight (N, K), bias (N,)) -> its `QuantLinear`: scale = max(
    max |w| over K, 1e-12) / 127 per output channel, weight_q = round(w /
    scale) clipped to +-127 (a division, as the JAX `quantize_dense_params`
    divides, so the two agree bit for bit)."""
    w = linear.weight.detach().float()
    amax = w.abs().amax(dim=1).clamp_min(1e-12)
    scale = amax / torch.full_like(amax, QMAX)  # on the card `t / number` is t * (1 / number)
    q = QuantLinear(w.shape[1], w.shape[0], getattr(linear, "compute_dtype", torch.float32),
                    device=w.device)
    q.weight_q.copy_(torch.round(w / scale[:, None]).clamp_(-QMAX, QMAX).to(torch.int8))
    q.weight_scale.copy_(scale)
    if linear.bias is not None:
        q.bias.copy_(linear.bias.detach().float())
    return q


def quantize_for_inference(model):
    """Swap the targeted `Linear`s of an `AsymmetricCroCo3DStereo` for their
    `QuantLinear`s, in place (the fp32 weights are freed), and return the
    model. Untargeted tensors are left as they are, bit for bit."""
    for stack in BLOCK_STACKS:
        for parent in getattr(model, stack).modules():
            for name, child in list(parent.named_children()):
                if name in BLOCK_TARGETS and isinstance(child, nn.Linear):
                    setattr(parent, name, quantize_linear(child))
    if isinstance(model.decoder_embed, nn.Linear):
        model.decoder_embed = quantize_linear(model.decoder_embed)
    return model


def is_quantized(model):
    """Whether a module holds any `QuantLinear`."""
    return any(isinstance(m, QuantLinear) for m in model.modules())
