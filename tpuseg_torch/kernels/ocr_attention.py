"""Fused OCR object attention: CUDA kernel wrapper and its plain version.

Port of ``tpuseg/kernels/ocr_attention.py``. Per image,
``ctx = softmax_K(Q Kᵀ / √d) V`` with f32 similarities and softmax, the
attention rounded to V's dtype before the second product, f32 accumulation
and the result in Q's dtype. The kernel is ``csrc/ocr_attention.cu``; its
header says what bounds it on the H100 and how it is laid out.

Dispatch: a CPU tensor takes :func:`object_attention_reference`; a CUDA
tensor launches the kernel or raises. There is no fallback. The wrapper is
the registered op ``tpuseg_torch::ocr_attention`` with a shape function
(``register_fake``), so an exported program (``tpuseg_torch.serving``)
holds the kernel as one node and launches it when run on the card.
"""

import torch
import torch.utils.flop_counter

from tpuseg_torch.kernels import _build
from tpuseg_torch.ops.precision import upcast

# kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

MAX_KEYS = 128
MAX_DIM = 1024
_SMEM_LIMIT = 232448  # H100 dynamic shared memory a block may use
_WARPS = 8            # f32 kernel: warps a block
_TC_WARPS = 4         # bf16 kernel: warps a block, 16 Q rows a warp tile


def object_attention_reference(q: torch.Tensor, key: torch.Tensor,
                               val: torch.Tensor) -> torch.Tensor:
    """Plain version (tpuseg ``reference_object_attention``): q (B, N, d),
    key/val (B, K, d) -> (B, N, d) in q's dtype. Products and softmax in
    f32 for the kernel's bf16 and f32 inputs (in f64 for the model's f64
    forward, which no kernel takes)."""
    d = q.shape[-1]
    sim = torch.bmm(upcast(q), upcast(key).transpose(1, 2)) * (d ** -0.5)
    attn = torch.softmax(sim, dim=-1)
    ctx = torch.bmm(upcast(attn.to(val.dtype)), upcast(val))
    return ctx.to(q.dtype)


def _check(q, key, val):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("key", key), ("val", val)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dim() != 3 or key.shape != val.shape or key.dim() != 3 \
            or key.shape[0] != q.shape[0] or key.shape[2] != q.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, key {tuple(key.shape)}"
                         f", val {tuple(val.shape)}: want (B, N, d), "
                         f"(B, K, d), (B, K, d)")
    b, n, d = q.shape
    k = key.shape[1]
    if not 1 <= k <= MAX_KEYS:
        raise ValueError(f"class axis {k} outside 1..{MAX_KEYS}")
    if d % 8 or d > MAX_DIM:
        raise ValueError(f"head width {d} must be a multiple of 8, <= "
                         f"{MAX_DIM}")
    smem = 2 * k * d * q.element_size() + _WARPS * k * 4
    if q.dtype == torch.bfloat16:
        # tensor-core kernel: K and V padded to 16 keys, a ring of at least
        # two 16-row Q tiles a warp
        smem = 2 * (-(-k // 16) * 16) * d * 2 + _TC_WARPS * 2 * 16 * d * 2
    if smem > _SMEM_LIMIT:
        raise ValueError(f"K={k}, d={d} {q.dtype} needs {smem} B of shared "
                         f"memory, above {_SMEM_LIMIT}")


def fused_object_attention(q: torch.Tensor, key: torch.Tensor,
                           val: torch.Tensor) -> torch.Tensor:
    """q (B, N, d) pixel queries; key/val (B, K, d) class proxies ->
    (B, N, d) context in q's dtype. Calls the registered op
    ``tpuseg_torch::ocr_attention``, which ``torch.export`` keeps as one
    opaque node of the exported graph."""
    return torch.ops.tpuseg_torch.ocr_attention(q, key, val)


@torch.library.custom_op("tpuseg_torch::ocr_attention", mutates_args=())
def _ocr_attention(q: torch.Tensor, key: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    _check(q, key, val)
    if q.device.type == "cpu":
        return object_attention_reference(q, key, val)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype == torch.bfloat16 and q.shape[-1] % 64:
        raise ValueError(f"bf16 head width {q.shape[-1]} must be a multiple "
                         f"of 64 on CUDA (the tensor-core kernel's tiles)")
    for name, t in (("q", q), ("key", key), ("val", val)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, n, d = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    global LAUNCHES
    lib = _build.library()
    err = lib.tpuseg_ocr_attention(
        q.data_ptr(), key.data_ptr(), val.data_ptr(), out.data_ptr(),
        b, n, key.shape[1], d, float(d) ** -0.5,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ocr_attention")
    LAUNCHES += 1
    return out


@_ocr_attention.register_fake
def _(q, key, val):
    _check(q, key, val)
    return q.new_empty(q.shape)


@torch.utils.flop_counter.register_flop_formula(
    torch.ops.tpuseg_torch.ocr_attention)
def _flops(q_shape, key_shape, *args, **kwargs) -> int:
    b, n, d = q_shape
    return 4 * b * n * key_shape[1] * d  # Q.K^T and P.V
