"""Fused 2D-RoPE attention: the CUDA kernels' wrapper and its plain version.

Replaces `dust3r_tpu/ops/pallas_attention.py::fused_attention`. Two
hand-written sm_90a kernels serve it, each named by its `core`:

* "sm90", `csrc/fused_attention_sm90.cu`: TMA rings of K and V tiles, K
  rotated by a producer warpgroup, the products on wgmma, online softmax in
  fp32. It takes bf16 with head dim 64 and any number of heads a block that
  divides the heads: every call of the model's path, the grouped calls
  of the TPU experiments (rows 3 and 5), and as modes of its consumer loop
  the softmax variants (`attention_variants`) and two floors.
* "mma", `csrc/fused_attention.cu` on the core of `csrc/attention_core.cuh`:
  mma.sync bf16 tensor cores, K/V streamed through shared memory, online
  softmax in fp32. It takes everything else (fp32, head dims 16, 24, 32)
  and, with `core="mma"`, the bf16 d = 64 calls too: it is the baseline of
  the sm90 kernel, of the grouped calls, of the softmax variants and of
  the floors. Its bf16 kernel runs 1, 2 or 4 heads a block
  (128 threads a head); a call's G is served there at the largest of those
  that divides it (`kernel_heads_per_program`), its fp32 kernel runs one
  head a block.

Both compute the same function (the headers say what bounds each on the
card and how its design answers that), and in either a head's arithmetic
does not depend on the heads beside it, so every G gives the bits of G = 1.
Their addressing is strided, so q, k and v may be head views of the
projections (`(B, N, 3C)` or `(B, N, C)` seen as `(B, H, N, d)`) and the
output lands head-packed.

* `attention_ref` is the plain PyTorch version, the counterpart of the JAX
  `attention_ref`: RoPE in the token dtype, logits from the fp32 upcasts
  of the rotated q and k (exact products, fp32 sums, as the JAX einsum
  with `preferred_element_type=float32`), softmax in fp32, P cast to the
  value dtype, P.v with fp32 sums (the JAX einsum's too) rounded to the
  value dtype. The CPU tests and the card-side comparison use it.
* `fused_attention` is the wrapper. It resolves `heads_per_program` as the
  JAX kernel does (`resolve_heads_per_program`). For a CPU tensor it
  returns the plain version (the kernels cannot run there); for a CUDA
  tensor it launches the kernel of its core (`route`) or raises.
  `fused_attention.launches` counts launches of the sm90 kernel and
  `fused_attention.grouped_launches` those of them with more than one head
  a block; `fused_attention.core_launches` counts launches of the mma.sync
  core and `fused_attention.core_grouped_launches` those of its bf16 kernel
  with more than one head a block.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from ._build import count_launch
from .rope import apply_rope2d, rope_tables

SUPPORTED_HEAD_DIMS = (16, 24, 32, 64)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)
# heads a block of the mma.sync core's bf16 kernel, 128 threads each,
# largest first; 8 (1024 threads at most 64 registers each) does not fit
CORE_HEADS_PER_PROGRAM = (4, 2, 1)
CORES = ("sm90", "mma")
SM90_HEAD_DIM = 64
# the JAX kernel's VMEM budget for its softmax tiles, from which it picks
# the heads a program when given none (a copy of
# dust3r_tpu/ops/pallas_attention.py's _LOGITS_VMEM_BUDGET)
_LOGITS_VMEM_BUDGET = 6 * 1024 * 1024


def _auto_heads_per_program(H, Nq, Nk):
    """The JAX kernel's choice for heads_per_program=None: the largest of
    8, 4, 2 dividing H whose live set (G bf16 probability tiles and one
    fp32 logits tile) fits the budget, else 1."""
    for G in (8, 4, 2, 1):
        if H % G == 0 and (G * 2 + 4) * Nq * Nk <= _LOGITS_VMEM_BUDGET:
            return G
    return 1


def resolve_heads_per_program(H, Nq, Nk, G):
    """The heads a program the JAX `fused_attention` runs for
    `heads_per_program=G` with H heads: `_auto_heads_per_program` for None,
    then halved until it divides H. G must be None or a positive integer."""
    if G is None:
        G = _auto_heads_per_program(H, Nq, Nk)
    elif isinstance(G, bool) or not isinstance(G, numbers.Integral) or G < 1:
        raise ValueError(f"heads_per_program must be None or a positive integer, got {G!r}")
    G = int(G)
    while H % G:
        G //= 2
    return G


def route(dtype, head_dim):
    """The core that serves a call on the card: "sm90" for bf16 with head
    dim 64, at any heads a block (the model's calls and the grouped ones),
    "mma" for the rest."""
    return "sm90" if dtype == torch.bfloat16 and head_dim == SM90_HEAD_DIM else "mma"


def kernel_heads_per_program(core, G):
    """The heads a block `core`'s kernel runs for a resolved G: G itself on
    the sm90 kernel, the largest of 4, 2, 1 dividing G on the mma.sync
    core's bf16 kernel. Either gives the bits of G = 1."""
    if core == "sm90":
        return G
    return next(g for g in CORE_HEADS_PER_PROGRAM if G % g == 0)


def attention_ref(q, k, v, positions_q=None, positions_k=None, rope_base=100.0):
    """Plain attention. q, k, v: (B, H, N, d); positions: (B, N, 2) or None.

    RoPE rotates q and k (not v) in their dtype, then softmax(q k^T /
    sqrt(d)) v: the logits from fp32 upcasts of the rotated q and k, the
    softmax in fp32, P cast to v's dtype, P.v from fp32 upcasts rounded to
    v's dtype (a bf16 matmul on the CPU rounds differently with and
    without oneDNN)."""
    if positions_q is not None:
        q = apply_rope2d(q, positions_q, rope_base)
    if positions_k is not None:
        k = apply_rope2d(k, positions_k, rope_base)
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype).float(), v.float()).to(v.dtype)


_LIB = None
_SM90 = None


def _sm90_kernel():
    """`csrc/fused_attention_sm90.cu`'s C entry, built at first use: q, k,
    v, four tables, o, the 12 strides; batch, heads, nq, nk, heads a
    block, softmax code, use_rope; scale, stream."""
    global _SM90
    if _SM90 is None:
        from ._build import load_library

        fn = load_library("fused_attention_sm90").dust3r_fused_attention_sm90
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SM90 = fn
    return _SM90


def _kernel():
    """`csrc/fused_attention.cu`'s C entry, built at first use: q, k, v,
    four tables, o, the 12 strides; batch, heads, nq, nk, d, heads a block,
    softmax, bf16, use_rope; scale, stream."""
    global _LIB
    if _LIB is None:
        from ._build import load_library

        fn = load_library("fused_attention").dust3r_fused_attention
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def check(q, k, v, positions_q, positions_k, heads_per_program=1):
    """Refuse what the kernel cannot serve, naming it."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention takes bf16 or fp32 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, N, d)")
    B, H, Nq, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    Nk = k.shape[2]
    if k.shape != (B, H, Nk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if Nq == 0 or Nk == 0 or B * H == 0 or B * H // heads_per_program > 65535:
        raise ValueError(f"unsupported sizes B*H={B * H}, Nq={Nq}, Nk={Nk}")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in the head dim, got strides "
                             f"{t.stride()}")
        # (batch, head, row) strides address 16-byte loads; a dim of size 1
        # is never stepped over
        if any(s % align for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{name}'s batch, head and row strides {t.stride()[:3]} must be "
                             f"multiples of {align} elements (16 bytes)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned address")
        # the kernel's head and row offsets within a batch entry are 32-bit
        if sum((n - 1) * s for s, n in zip(t.stride()[1:], t.shape[1:])) >= 2 ** 31:
            raise ValueError(f"{name}'s offsets within a batch entry pass 2^31 elements "
                             f"(strides {t.stride()}, shape {tuple(t.shape)})")
    if (positions_q is None) != (positions_k is None):
        raise ValueError("give positions for both q and k, or for neither")
    if positions_q is not None:
        for pos, n in ((positions_q, Nq), (positions_k, Nk)):
            if pos.shape != (B, n, 2) or pos.device != q.device:
                raise ValueError(f"positions must be (B, N, 2) on {q.device}, got "
                                 f"{tuple(pos.shape)} on {pos.device}")
            if pos.dtype.is_floating_point or pos.dtype.is_complex:
                raise TypeError(f"positions must be integer, got {pos.dtype}")


def _kernel_tables(positions, tables, head_dim, base):
    """The kernel's fp32 (cos, sin) of `positions`: `tables` when the caller
    built them (`rope_tables`, once for many layers), else built here."""
    if tables is None:
        tables = rope_tables(positions, head_dim, base)
    cos, sin = (t.contiguous() for t in tables)
    want = (*positions.shape[:2], head_dim)
    for t in (cos, sin):
        if t.shape != want or t.dtype != torch.float32 or t.device != positions.device:
            raise ValueError(f"rope tables must be fp32 {want} on {positions.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return cos, sin


def _operands(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k):
    """A launch's four fp32 tables (cos_q, sin_q, cos_k, sin_k; None
    without RoPE), its new head-packed output seen as (B, H, Nq, d), and the
    12 (batch, head, row) strides of q, k, v and the output."""
    B, H, Nq, d = q.shape
    tables = None
    if positions_q is not None:
        tables = (*_kernel_tables(positions_q, tables_q, d, rope_base),
                  *_kernel_tables(positions_k, tables_k, d, rope_base))
    out = torch.empty(B, Nq, H, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    return tables, out, strides


def _pointers(tables):
    return [None] * 4 if tables is None else [t.data_ptr() for t in tables]


def launch(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k,
           heads_per_program=1, softmax=0, entry=None):
    """Launch the mma.sync core on checked CUDA q, k, v with
    `heads_per_program` heads a block and the softmax code `softmax` (0:
    exact; the variants' codes are in `attention_variants`); returns the
    (B, H, Nq, d) view of a new head-packed (B, Nq, H, d) output, or raises.
    entry: another C entry of the same arguments (`attention_floors'`
    kernels), else `fused_attention.cu`'s."""
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    tables, out, strides = _operands(q, k, v, positions_q, positions_k, rope_base, tables_q,
                                     tables_k)
    fn = _kernel() if entry is None else entry
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_pointers(tables), out.data_ptr(),
                 ctypes.addressof(strides), B, H, Nq, Nk, d, heads_per_program, softmax,
                 int(q.dtype == torch.bfloat16), int(positions_q is not None), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err} "
                           f"(q {tuple(q.shape)} {q.dtype}, Nk={Nk}, G={heads_per_program}, "
                           f"softmax {softmax})")
    return out


def launch_sm90(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k,
                heads_per_program=1, softmax=0):
    """Launch the sm90 kernel on checked bf16 CUDA q, k, v of head dim 64
    with `heads_per_program` heads a block (dividing H) and the softmax
    code `softmax` (0: exact; `attention_variants`' softmax variants and
    `attention_floors`' product floors pass theirs); returns as `launch`
    does, or raises."""
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    tables, out, strides = _operands(q, k, v, positions_q, positions_k, rope_base, tables_q,
                                     tables_k)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _sm90_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_pointers(tables),
                             out.data_ptr(), ctypes.addressof(strides), B, H, Nq, Nk,
                             heads_per_program, softmax, int(positions_q is not None),
                             d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"sm90 attention kernel launch failed: error {err} (q "
                           f"{tuple(q.shape)}, Nk={Nk}, G={heads_per_program}, softmax "
                           f"{softmax}; above 1000: 1000 + the CUresult of encoding a "
                           f"tensor map)")
    return out


def fused_attention(q, k, v, positions_q=None, positions_k=None, rope_base=100.0,
                    tables_q=None, tables_k=None, heads_per_program=1, core=None):
    """q, k, v: (B, H, N, d), Nq may differ from Nk, any strides with unit
    stride in d; positions (B, N, 2) integer (y, x) or None for no RoPE.
    Returns (B, H, Nq, d) in q's dtype; on the card it is a view of a
    head-packed (B, Nq, H, d) tensor, so `out.transpose(1, 2).reshape(B,
    Nq, H * d)` copies nothing.

    tables_q / tables_k: optional fp32 (cos, sin) of the positions from
    `rope_tables(positions, d, rope_base)`, for a caller that shares them
    across layers; building them takes some twenty small launches. The
    kernels read them; the plain version builds its own in the token dtype,
    as the JAX reference does. heads_per_program: the JAX argument of the
    same name, resolved as the JAX kernel resolves it (None picks by the
    JAX kernel's VMEM budget; any positive G is halved until it divides H;
    see `resolve_heads_per_program`); the heads a block of the kernel. With
    these kernels G only orders the work: every G gives the bits of G = 1,
    so the default stays 1. core: None (`route` picks), "sm90" or "mma"
    (see the module docstring); a core that cannot serve the call raises."""
    G = resolve_heads_per_program(q.shape[1], q.shape[-2], k.shape[-2], heads_per_program)
    if core is not None and core not in CORES:
        raise ValueError(f"core {core!r} not in {CORES} or None")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, positions_q, positions_k, rope_base)
    routed = route(q.dtype, q.shape[-1])
    if core == "sm90" and routed != "sm90":
        raise ValueError(f"the sm90 kernel takes bf16 with head dim {SM90_HEAD_DIM}, got "
                         f"{q.dtype}, d={q.shape[-1]}")
    core = core or routed
    G = kernel_heads_per_program(core, G)
    check(q, k, v, positions_q, positions_k, G)
    if core == "sm90":
        out = launch_sm90(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k, G)
        count_launch(fused_attention, "launches")
        count_launch(fused_attention, "grouped_launches", int(G > 1))
        return out
    out = launch(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k, G)
    count_launch(fused_attention, "core_launches")
    # the core's fp32 kernel runs one head a block for any G
    count_launch(fused_attention, "core_grouped_launches",
                 int(G > 1 and q.dtype == torch.bfloat16))
    return out


fused_attention.launches = 0
fused_attention.grouped_launches = 0
fused_attention.core_launches = 0
fused_attention.core_grouped_launches = 0
