"""Fused eval-mode HRNet stage-1 Bottleneck: CUDA kernel wrapper, its plain
version and the BN folding.

Port of ``tpuseg/kernels/bottleneck_fused.py``. With each BN folded into
its conv, ``relu(conv1x1(relu(conv3x3(relu(conv1x1(x)+b1))+b2))+b3 + x)``
with bf16 operands and intermediates and f32 accumulation. Two CUDA
kernels compute it; each source's header says what bounds it on the H100
and how it is laid out:

- ``csrc/bottleneck_fused.cu`` (wgmma + TMA, weights resident in shared
  memory) at HRNet's stage-1 width, (C, M) = KERNEL_SHAPE = (256, 64);
- ``csrc/bottleneck_fused_any.cu`` (persistent wgmma + TMA halo windows;
  weights resident in shared memory where they fit, else streamed in
  chunks through a TMA ring) at every other (C, M) with C and M multiples
  of 8, C <= 1024 and M <= 256 (ANY_MAX): see :func:`supports`.

Both compute the block's math, i.e. ``reference_bottleneck``: the 3x3
reads zero at taps outside the image. (The TPU kernel reads relu(b1)
there; see ROADMAP Queue 3.)

Folded weights, NHWC-friendly as in ``tpuseg``:
  w1 (C, M)      b1 (M,)   conv1 1x1 + bn1
  w2 (9, M, M)   b2 (M,)   conv2 3x3, tap-major (ky * 3 + kx, in, out)
  w3 (M, C)      b3 (C,)   conv3 1x1 + bn3
weights bf16, biases f32.

Each CUDA kernel reads its weights from one parameter block in the layout
its products read, which its CUDA source alone defines and packs on the
host (:func:`pack_weights`, built once per weight state by the model):
at (256, 64) ``tpuseg_bottleneck_pack``, at the other widths
``tpuseg_bottleneck_any_pack``.

Dispatch: a CPU tensor takes :func:`bottleneck_reference`; a CUDA tensor
launches the kernel of its width or raises. There is no fallback. The
wrapper is the registered op ``tpuseg_torch::bottleneck_fused`` with a
shape function (``register_fake``), so an exported program
(``tpuseg_torch.serving``) holds the kernel as one node and launches it
when run on the card; the model freezes the folded weights (and the
packed block) for it (``Bottleneck.freeze_folded``).
"""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.flop_counter

from tpuseg_torch.kernels import _build

# launches since the last reset (chip_smoke.py reads and resets them): of
# the (256, 64) kernel, and of the kernel of the other widths
LAUNCHES = 0
ANY_LAUNCHES = 0

KERNEL_SHAPE = (256, 64)  # (C, M) bottleneck_fused.cu is laid out for
ANY_MAX = (1024, 256)     # the largest (C, M) bottleneck_fused_any.cu takes


def fold_bn(weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5):
    """Fold an eval-mode BN into the preceding bias-free conv (OIHW):
    ``w' = w * s``, ``b' = bias - mean * s``, ``s = scale / sqrt(var+eps)``.
    Returns (weight', bias') in f32."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return (weight.float() * s[:, None, None, None],
            bias.float() - mean.float() * s)


def bottleneck_reference(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain version (tpuseg ``reference_bottleneck``): three convs over the
    folded weights, with the operands rounded to bf16, f32 accumulation and
    bf16 intermediates. x (B, H, W, C) NHWC -> same shape, x's dtype."""
    bf = torch.bfloat16
    m = w1.shape[-1]

    def conv(t, w_oihw, pad):
        # bf16-rounded operands, f32 products and sums
        return F.conv2d(t.to(bf).float(), w_oihw.to(bf).float(), padding=pad)

    xc = x.permute(0, 3, 1, 2)
    t = conv(xc, w1.t()[:, :, None, None], 0)
    t = torch.relu(t + b1.float()[:, None, None]).to(bf)
    w2_oihw = w2.reshape(3, 3, m, m).permute(3, 2, 0, 1)
    t = conv(t, w2_oihw, 1)
    t = torch.relu(t + b2.float()[:, None, None]).to(bf)
    t = conv(t, w3.t()[:, :, None, None], 0)
    y = torch.relu(t + b3.float()[:, None, None] + xc.float())
    return y.to(x.dtype).permute(0, 2, 3, 1)


class PackedWeights(NamedTuple):
    """Folded weights (``weights`` = w1, b1, w2, b2, w3, b3) and, for CUDA
    tensors of a width a kernel takes, its parameter block built from
    them."""
    weights: tuple
    blob: Optional[torch.Tensor]


def _check_weights(c, w1, b1, w2, b2, w3, b3):
    m = w1.shape[-1]
    want = {"w1": (c, m), "b1": (m,), "w2": (9, m, m), "b2": (m,),
            "w3": (m, c), "b3": (c,)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} shape {tuple(got[name].shape)} != "
                             f"{shape} (C={c}, M={m})")
        if got[name].device != w1.device:
            raise ValueError(f"{name} on {got[name].device}, w1 on "
                             f"{w1.device}")


def any_supports(c: int, m: int) -> bool:
    """Whether ``csrc/bottleneck_fused_any.cu`` takes (C, M): both multiples
    of 8, up to ANY_MAX."""
    return (c % 8 == 0 and m % 8 == 0 and 8 <= c <= ANY_MAX[0]
            and 8 <= m <= ANY_MAX[1])


def supports(device: torch.device, c: int, m: int) -> bool:
    """Whether the wrapper takes a block of C channels and width M on this
    device: any shape on the CPU (the plain version); on CUDA
    KERNEL_SHAPE (the wgmma kernel) and every width :func:`any_supports`
    (the kernel of the other widths)."""
    return device.type == "cpu" or any_supports(c, m)


def _host(weights) -> list:
    """The folded weights in host memory, as the packers read them: bf16
    weights, f32 biases."""
    return [t.detach().to("cpu", torch.float32 if i % 2 else torch.bfloat16)
            .contiguous() for i, t in enumerate(weights)]


def pack_blob(w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The (256, 64) kernel's parameter block, a uint8 tensor on the
    weights' device: packed on the host by ``csrc/bottleneck_fused.cu``'s
    ``tpuseg_bottleneck_pack``, which owns its layout."""
    lib = _build.library()
    host = _host((w1, b1, w2, b2, w3, b3))
    blob = torch.empty(lib.tpuseg_bottleneck_param_bytes(), dtype=torch.uint8)
    _build.check(lib.tpuseg_bottleneck_pack(
        *(t.data_ptr() for t in host), blob.data_ptr()), "bottleneck pack")
    return blob.to(w1.device)


def pack_any_blob(w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The parameter block of the kernel of the other widths at (C, M) =
    w1's shape, a uint8 tensor on the weights' device: packed on the host
    by ``csrc/bottleneck_fused_any.cu``'s ``tpuseg_bottleneck_any_pack``,
    which owns its layout."""
    c, m = w1.shape
    lib = _build.library()
    host = _host((w1, b1, w2, b2, w3, b3))
    blob = torch.empty(lib.tpuseg_bottleneck_any_param_bytes(c, m),
                       dtype=torch.uint8)
    _build.check(lib.tpuseg_bottleneck_any_pack(
        *(t.data_ptr() for t in host), c, m, blob.data_ptr()),
        "bottleneck_fused_any pack")
    return blob.to(w1.device)


def any_plan(c: int, m: int, shape) -> dict:
    """How ``csrc/bottleneck_fused_any.cu`` runs (C, M) on an input of
    ``shape`` (B, H, W) on the current card, from its host code: weights
    resident or streamed, consumer warpgroups a block, output tiles a round
    (1: the consumers split one tile's channels), x and weight ring stages,
    shared memory a block, and MP (M padded to the products' N)."""
    import ctypes

    got = (ctypes.c_int * 7)()
    _build.check(_build.library().tpuseg_bottleneck_any_plan(
        c, m, *shape, ctypes.addressof(got)), "bottleneck_fused_any plan")
    return dict(zip(("resident", "consumers", "tiles", "x_stages",
                     "w_stages", "smem", "mp"), got))


def pack_weights(w1, b1, w2, b2, w3, b3) -> PackedWeights:
    """Folded weights ready for :func:`fused_bottleneck_packed`: for CUDA
    weights the parameter block of the kernel that takes their width
    (KERNEL_SHAPE: the wgmma kernel's; any other width
    :func:`any_supports`: the kernel of the other widths'); else None."""
    _check_weights(w1.shape[0], w1, b1, w2, b2, w3, b3)
    weights = (w1, b1, w2, b2, w3, b3)
    blob = None
    if w1.device.type == "cuda":
        if tuple(w1.shape) == KERNEL_SHAPE:
            blob = pack_blob(*weights)
        elif any_supports(*w1.shape):
            blob = pack_any_blob(*weights)
    return PackedWeights(weights, blob)


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Fused block over NHWC ``x`` (B, H, W, C) bf16 with folded weights
    (see the module docstring). Returns the same shape and dtype."""
    return fused_bottleneck_packed(x, pack_weights(w1, b1, w2, b2, w3, b3))


def fused_bottleneck_packed(x, packed: PackedWeights) -> torch.Tensor:
    """The kernel's wrapper: :func:`fused_bottleneck` over weights packed
    once by :func:`pack_weights`. Calls the registered op
    ``tpuseg_torch::bottleneck_fused``, which ``torch.export`` keeps as one
    opaque node of the exported graph."""
    return torch.ops.tpuseg_torch.bottleneck_fused(x, *packed.weights,
                                                    packed.blob)


def _check_inputs(x, w1, b1, w2, b2, w3, b3) -> bool:
    """Shapes, devices and, on CUDA, dtypes; True for CPU tensors."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.shape[-1] != w1.shape[0] or x.device != w1.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} does not match "
                         f"w1 {tuple(w1.shape)} on {w1.device}")
    _check_weights(x.shape[-1], w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    names = ("w1", "b1", "w2", "b2", "w3", "b3")
    for name, t in (("x", x), *zip(names, (w1, b1, w2, b2, w3, b3))):
        want = torch.float32 if name.startswith("b") else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    return False


def _check_call(x, w1, b1, w2, b2, w3, b3, blob):
    """What the op takes, from shapes, dtypes and devices alone (the real
    implementation and the shape function both check it)."""
    if _check_inputs(x, w1, b1, w2, b2, w3, b3):
        return
    c, m = x.shape[-1], w1.shape[-1]
    if not supports(x.device, c, m):
        raise ValueError(f"no CUDA kernel takes (C, M) = ({c}, {m}): "
                         f"{KERNEL_SHAPE}, or C and M multiples of 8 up "
                         f"to {ANY_MAX}")
    if (c, m) == KERNEL_SHAPE and (blob is None or blob.device != x.device):
        raise ValueError("CUDA weights of (C, M) = (256, 64) need the packed "
                         "parameter block (pack_weights) on x's device")
    if blob is not None and (blob.device != x.device
                             or blob.dtype != torch.uint8 or blob.dim() != 1):
        raise ValueError(f"the packed parameter block must be a uint8 vector "
                         f"on x's device, got {blob.dtype} "
                         f"{tuple(blob.shape)} on {blob.device}")


@torch.library.custom_op("tpuseg_torch::bottleneck_fused", mutates_args=())
def _bottleneck_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                      b3: torch.Tensor,
                      blob: Optional[torch.Tensor]) -> torch.Tensor:
    _check_call(x, w1, b1, w2, b2, w3, b3, blob)
    if x.device.type == "cpu":
        # contiguous, as the shape function and the kernel give it
        return bottleneck_reference(x, w1, b1, w2, b2, w3, b3).contiguous()
    if tuple(w1.shape) != KERNEL_SHAPE:
        if blob is None:  # packed once a call (the model packs once)
            blob = pack_any_blob(w1, b1, w2, b2, w3, b3)
        return _launch_any(x, w1, b1, w2, b2, w3, b3, blob)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    b, h, w, _ = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    global LAUNCHES
    lib = _build.library()
    err = lib.tpuseg_bottleneck(
        x.data_ptr(), blob.data_ptr(), out.data_ptr(), b, h, w,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bottleneck_fused")
    LAUNCHES += 1
    return out


def _launch_any(x, w1, b1, w2, b2, w3, b3, blob) -> torch.Tensor:
    """``csrc/bottleneck_fused_any.cu`` over CUDA tensors that
    :func:`_check_call` has passed and the parameter block packed from
    w1..b3 (:func:`pack_any_blob`); the kernel reads the weights from the
    block alone."""
    for name, t in (("x", x), ("blob", blob)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    global ANY_LAUNCHES
    lib = _build.library()
    err = lib.tpuseg_bottleneck_any(
        x.data_ptr(), blob.data_ptr(), blob.numel(), out.data_ptr(), b, h, w,
        c, w1.shape[-1], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bottleneck_fused_any")
    ANY_LAUNCHES += 1
    return out


def fused_bottleneck_any(x, w1, b1, w2, b2, w3, b3,
                         blob: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel of the other widths at any width it takes, (256, 64)
    included, where the model runs the wgmma kernel: so the two can be
    timed side by side. ``blob``: its parameter block packed once
    (:func:`pack_any_blob`), else packed in this call. A CPU tensor takes
    the plain version."""
    if _check_inputs(x, w1, b1, w2, b2, w3, b3):
        return bottleneck_reference(x, w1, b1, w2, b2, w3, b3).contiguous()
    if not any_supports(x.shape[-1], w1.shape[-1]):
        raise ValueError(f"bottleneck_fused_any.cu takes C and M multiples "
                         f"of 8 up to {ANY_MAX}, got {tuple(w1.shape)}")
    if blob is None:
        blob = pack_any_blob(w1, b1, w2, b2, w3, b3)
    elif blob.device != x.device:
        raise ValueError(f"blob on {blob.device}, x on {x.device}")
    return _launch_any(x, w1, b1, w2, b2, w3, b3, blob)


@_bottleneck_fused.register_fake
def _(x, w1, b1, w2, b2, w3, b3, blob):
    _check_call(x, w1, b1, w2, b2, w3, b3, blob)
    return x.new_empty(x.shape)


@torch.utils.flop_counter.register_flop_formula(
    torch.ops.tpuseg_torch.bottleneck_fused)
def _flops(x_shape, w1_shape, *args, **kwargs) -> int:
    b, h, w, c = x_shape
    m = w1_shape[-1]
    return 2 * b * h * w * (c * m + 9 * m * m + m * c)
