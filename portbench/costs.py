"""The benchmark's yardstick of work: the card's peaks, the least time a
kernel launch could take, and the model FLOPs of a step, counted on the
frozen reference (never on the program, which later changes may alter).

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense:
989 TFLOP/s in bfloat16 on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 tensor-core rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def quarter(n: int) -> int:
    """A side after HRNet's two stride-2 3x3 stem convs."""
    return math.ceil(math.ceil(n / 2) / 2)


def attention_launch_s(b: int, n: int, k: int, d: int) -> float:
    """OCR object attention over bf16 (B, N, d) queries and (B, K, d) keys
    and values: queries read and context written once, keys and values
    read once; Q.K^T and P.V."""
    q_bytes, kv_bytes = 2 * b * n * d, 2 * b * k * d
    return bound_s(2 * q_bytes + 2 * kv_bytes, 4.0 * b * n * k * d)


def bottleneck_launch_s(b: int, h: int, w: int, c: int, m: int) -> float:
    """The stage-1 identity bottleneck over a bf16 (B, H, W, C) map: the
    map read and the result written once, bf16 weights and f32 biases
    once; 1x1 C->M, 3x3 M->M, 1x1 M->C."""
    weights = 2 * (c * m + 9 * m * m + m * c) + 4 * (2 * m + c)
    return bound_s(4 * b * h * w * c + weights,
                   2.0 * b * h * w * (c * m + 9 * m * m + m * c))


def _meta_inputs(b: int, hw):
    image = torch.zeros((b, *hw, 3), dtype=torch.uint8, device="meta")
    label = torch.zeros((b, *hw), dtype=torch.long, device="meta")
    return image, label


def eval_flops_per_image(ref, m: dict, hw) -> float:
    """Matrix-product and convolution FLOPs of the reference's eval
    forward of one image (the multiply-adds counted twice)."""
    with torch.device("meta"):
        model = ref.build(m).eval()
    image, _ = _meta_inputs(1, hw)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.eval_logits(model, image, m)
    return float(fc.get_total_flops())


def train_flops_per_image(ref, m: dict, hw, batch: int) -> float:
    """FLOPs of the reference's train step over ``batch`` crops, forward
    and backward with no recomputation, per crop."""
    with torch.device("meta"):
        model = ref.build(m).train()
    image, label = _meta_inputs(batch, hw)
    with FlopCounterMode(display=False) as fc:
        loss = ref.train_loss(model, image, label, m)
        loss.backward()
    return float(fc.get_total_flops()) / batch
