"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks each against its plain PyTorch version at the main path's shapes of
the three eval scales (and at ragged and wider cases) and times it there
beside its bound (and beside F.scaled_dot_product_attention, or the
model's unfused cuDNN block), with inputs from device memory, drives
the W48 3-scale eval recipe as shipped (with its image dumps) through the
CLI's code, compares kernels on vs off, and profiles one image. The
bottleneck's second kernel, for every width but W48's (256, 64), is held
at four widths and ragged cases, timed beside the first and the cuDNN
block, and driven by ``MscaleOCR`` with a 32-wide stage 1 at three scales
([s1w32-eval]). ASPP's dilated conv kernel is held and timed at the
DeepLabV3+ train cell's rate-12 conv beside its bound, its plain version
and cuDNN's NCHW conv (its other rates and shapes are held in
tests/test_torch_kernels_cuda.py); [zoo-eval] times it beside cuDNN on
HRNet_ASPP_OCR's rate-12 conv, and every phase that holds launch counts
holds its launches, 3 an ASPP forward. Then the eval surfaces over a
seeded 1024x2048 Cityscapes tree: ``dump`` in four modes ([dump]),
``export`` of the W48 3-scale program with both kernels as registered
ops, served in process and over HTTP ([serve]), and ``summary``
([summary]). Then the training slice: one tiny f32 train step
on the card vs the CPU and remat on vs off ([train-parity]), the W48
``train_cityscapes.yaml`` run through the CLI's code for two short epochs
over the same tree with both kernels in its validations ([train]), remat
on vs off at W48 ([train-remat]) and a profile of one train step
([train-profile]). Then the ASPP-headed zoo: every DeepLabV3 / V3+ factory
and HRNet_ASPP_OCR at full width, card vs CPU in f32 ([zoo-parity]) and
at 1024x2048 in bf16 ([zoo-eval]); HRNet_ASPP_OCR's 3-scale eval through
EvalRunner with both kernels ([aspp-ocr]); the
``train_cityscapes_deepv3.yaml`` run through the CLI's code over the same
tree, checkpointed and resumed ([deepv3-train]); and the same recipe with
label relaxation ([relaxed]). Then the attention-scale family: one factory
a class in [zoo-parity] and all 25 in [zoo-eval]; ``mscale.HRNet``'s
3-scale eval through EvalRunner with the bottleneck kernel
([mscale-eval]); ``mscale.DeepV3W38`` trained through the CLI's code on the
DeepLabV3+ recipe ([mscale-train]); and over a seeded Mapillary tree,
``eval_mapillary.yaml`` as shipped through ``evaluate_only`` with both
kernels at 65 classes ([mapillary-eval]) and ``train_mapillary.yaml``
through the CLI's code ([mapillary-train]). Then data-parallel training:
the process loader against the threaded one and the DeepLabV3+ recipe's
data wait through it ([loader]); a tiny f32 step as two gloo ranks on the
card vs one process ([ddp-parity]); ``train_cityscapes.yaml`` at W48 as two
ranks on the card under ``torch.distributed.run`` with the CLI's
``--multi-host``, stopped, resumed, both kernels in each rank's
validations ([ddp-train]); and one NCCL rank ([ddp-nccl]). Then dp x sp
spatial sharding (``mesh.model_parallelism: 2``): a W48 f32 step as two
gloo ranks of one sp group, each on its band of the image's rows, vs one
process ([sp-parity]); and ``train_cityscapes.yaml`` at W48 1024x2048 as
two spatial ranks through ``torch.distributed.run`` and ``--multi-host``,
both kernels in each rank's whole-image validation ([sp-train]). Then
dp x sp for every trunk and head: one factory a trunk or head family as
two spatial ranks vs one process ([sp-zoo-parity]), and
``train_cityscapes_deepv3.yaml`` (DeepV3PlusW38, 800x800) as two spatial
ranks ([sp-deepv3-train]). Then uneven bands, each band padded to
``ceil(H / sp)`` rows: W48 HRNet_Mscale, DeepV3PlusW38 and attnscale's
plain head as three spatial ranks vs one process at crops whose maps
split unevenly ([sp-uneven-parity]), and ``train_cityscapes_deepv3.yaml``
as three spatial ranks, its 800, 400, 200 and 100 rows none divisible by
3 ([sp-uneven-train]). The ranks of the parity phases run in the
background beside [zoo-parity].

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and this checkout; exits non-zero otherwise
and on any failed phase. ``--child`` runs one process of its own
multi-process phases; each such process runs in a process group of its
own, killed and waited for when the phase ends, and no process this
script starts outlives it. The profiles' whole tables go to
``chiprun_out/profile_top.txt``, ``serve_profile_top.txt``,
``eager_profile_top.txt`` and ``train_profile_top.txt``,
the eval and train runs' logs to ``chiprun_out/logs/``,
``chiprun_out/train/``, ``chiprun_out/deepv3_train/``,
``chiprun_out/mscale_train/``, ``chiprun_out/mapillary_train/``, the
child processes' logs to ``chiprun_out/loader/``,
``chiprun_out/ddp_parity/``, ``chiprun_out/ddp_train/``,
``chiprun_out/ddp_nccl/``, ``chiprun_out/sp_parity/``,
``chiprun_out/sp_train/``, ``chiprun_out/sp_zoo_parity/``,
``chiprun_out/sp_deepv3_train/``, ``chiprun_out/sp_uneven_parity/`` and
``chiprun_out/sp_uneven_train/``, and every line this script logs to
``chiprun_out/chip_smoke.log``; checkpoints, dumped images and the
exported bundle stay in a
temporary directory. The line before the last is a JSON record of the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

RECIPE = "tpuseg_torch/cli/recipes/eval_cityscapes.yaml"
MAIN_IMAGES = 5  # train.test_mode stops the eval loop after 5 images
REPS = 20
ON_OFF_REPS = 3  # timed images a side in each half of phase 5


def log(msg: str) -> None:
    print(msg, flush=True)
    with open(LOG_COPY, "a") as f:
        f.write(msg + "\n")


# a copy of every log line: a run's captured output may keep only its end
LOG_COPY = Path("chiprun_out/chip_smoke.log")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, copies: list, inner: int = 10) -> float:
    """Device time of one ``fn(*args)``: CUDA events around ``inner`` calls
    issued back to back (so the host's enqueue time overlaps the device's
    work), divided by ``inner``; the median of REPS such runs after one
    warm-up. The calls cycle through ``copies`` of the arguments (see
    :func:`copies_past_l2`)."""
    fn(*copies[0])
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(inner):
            fn(*copies[i % len(copies)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def profiled_ms(fn, copies: list, inner: int = 10):
    """(device ms, host ms) of one ``fn(*args)`` over ``inner`` calls
    cycling through ``copies``, after one warm-up: the device time is the
    kernels' own time as torch.profiler records it (so host gaps between
    launches do not count), the host time the wall time of issuing the
    calls (outside the profiler). Where the host time exceeds the
    kernel's, :func:`time_ms` measures the host."""
    from torch.profiler import ProfilerActivity, profile

    fn(*copies[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(inner):
        fn(*copies[i % len(copies)])
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(inner):
            fn(*copies[i % len(copies)])
        torch.cuda.synchronize()
    device_us = sum(
        getattr(e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return device_us / 1e3 / inner, host * 1e3 / inner


def copies_past_l2(args: tuple, nbytes: int, clone=lambda t: t.clone()):
    """``args`` and enough clones of them that the calls between two uses of
    one copy move three times the card's L2 (``nbytes`` a call), so that a
    call finds its inputs in device memory, not in the L2, as ``bound_ms``
    assumes. ``clone`` copies one argument (a shared one returns it)."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 * 2 ** 20)
    n = max(1, math.ceil(3 * l2 / nbytes))
    return [args] + [tuple(map(clone, args)) for _ in range(n - 1)]


def compare(got: torch.Tensor, want: torch.Tensor):
    g, w = got.double(), want.double()
    max_abs = float((g - w).abs().max())
    l1 = float((g - w).abs().sum() / w.abs().sum().clamp_min(1e-30))
    return max_abs, l1


# kernel vs plain version: attention bf16 max|d| (f32 cases: 1e-4); the
# bottleneck's L1-relative overall and on the image border, and its max|d|,
# a few bf16 ulps of |out| < 32, which one wrong 8x8 tile exceeds
ATTN_BF16_TOL = 5e-2
BNECK_L1_TOL = 2e-2
BNECK_MAX_TOL = 0.25


def held_attention(tag: str, got, want, tol: float) -> float:
    """Kernel vs plain version, logged; raises past ``tol``. Returns
    max|d|."""
    torch.cuda.synchronize()
    max_abs, l1 = compare(got, want)
    log(f"[kernel] ocr_attention {tag} {got.dtype}: max|d|={max_abs:.3e} "
        f"l1_rel={l1:.3e} (bound max|d| < {tol})")
    if not max_abs < tol:
        raise AssertionError(f"ocr_attention {tag}: max|d| {max_abs}")
    return max_abs


def held_bottleneck(tag: str, got, want) -> dict:
    """Kernel vs plain version, logged; raises past the bounds. Returns the
    errors."""
    torch.cuda.synchronize()
    max_abs, l1 = compare(got, want)
    border = torch.ones(got.shape[1:3], dtype=torch.bool, device="cuda")
    border[1:-1, 1:-1] = False
    bmax, bl1 = compare(got[:, border], want[:, border])
    log(f"[kernel] bottleneck {tag} x={tuple(got.shape)} bf16, b1>0: "
        f"max|d|={max_abs:.3e} l1_rel={l1:.3e}; border max|d|={bmax:.3e} "
        f"l1_rel={bl1:.3e} (bounds l1_rel < {BNECK_L1_TOL} overall and at "
        f"the border, max|d| < {BNECK_MAX_TOL}; max|out| "
        f"{float(want.float().abs().max()):.3f})")
    if not (l1 < BNECK_L1_TOL and bl1 < BNECK_L1_TOL
            and max_abs < BNECK_MAX_TOL):
        raise AssertionError(f"bottleneck {tag}: l1 {l1}, border {bl1}, "
                             f"max|d| {max_abs}")
    return {"max_abs_err": max_abs, "l1_rel": l1, "border_l1_rel": bl1}


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name!r} count {torch.cuda.device_count()}")
    card_info = card()
    log(card_info)  # the bare nvidia-smi line: name, power limit
    return name, card_info


def phase_build() -> None:
    from tpuseg_torch.kernels import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = so.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            # resources, and any wgmma the compiler had to serialize
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build] ptxas {line.strip()}")


def _attention_case(gen, b, n, k, d, dtype, scale=1.0):
    mk = lambda *s: (torch.randn(*s, generator=gen) * scale).to(
        "cuda", dtype)
    return mk(b, n, d), mk(b, k, d), mk(b, k, d)


def _bottleneck_case(gen, b, h, w, c=256, m=64):
    """Seeded inputs of one block; the weights' scale follows their fan-in
    from 0.1 at (256, 64), so every width's output keeps that width's
    magnitude (|out| < 32, where the max|d| bound is a few bf16 ulps)."""
    r = lambda *s: torch.randn(*s, generator=gen)
    s1, s2 = 0.1 * (256 / c) ** 0.5, 0.1 * (64 / m) ** 0.5
    x = r(b, h, w, c).to("cuda", torch.bfloat16)
    w1 = (r(c, m) * s1).to("cuda", torch.bfloat16)
    b1 = (r(m).abs() + 0.5).cuda()          # positive: pins the border
    w2 = (r(9, m, m) * s2).to("cuda", torch.bfloat16)
    b2 = (r(m) * 0.1).cuda()
    w3 = (r(m, c) * s2).to("cuda", torch.bfloat16)
    b3 = (r(c) * 0.1).cuda()
    return x, w1, b1, w2, b2, w3, b3


# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# eval scales of the main path and the shapes each kernel sees there
SCALES = (0.5, 1.0, 2.0)
ATTN_N = {0.5: 32768, 1.0: 131072, 2.0: 524288}       # (1, N, 256) bf16
BNECK_HW = {0.5: (128, 256), 1.0: (256, 512), 2.0: (512, 1024)}


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_bound(q, key, val):
    b, n, d = q.shape
    nbytes = 2 * q.numel() * q.element_size() + 2 * key.numel() * \
        key.element_size()  # q read, ctx written, K and V read once
    return bound_ms(nbytes, 4.0 * b * n * key.shape[1] * d)


def _bottleneck_bound(x, w1, b1, w2, b2, w3, b3):
    b, h, w, c = x.shape
    m = w1.shape[-1]
    nbytes = 2 * x.numel() * x.element_size() + sum(
        t.numel() * t.element_size() for t in (w1, b1, w2, b2, w3, b3))
    return bound_ms(nbytes, 2.0 * b * h * w * (c * m + 9 * m * m + m * c))


def _check_attention(ak, gen):
    """Kernel vs plain version off the main path's shapes (those are held
    in :func:`_time_attention`): Mapillary's K = 65 in bf16 (ragged N,
    batch 2), the f32 ragged and K = 128 cases. Returns the largest bf16
    max|d|."""
    cases = [("k65", 2, 3001, 65, 256, torch.bfloat16, ATTN_BF16_TOL),
             ("ragged", 2, 3001, 65, 128, torch.float32, 1e-4),
             ("k128", 1, 5001, 128, 128, torch.float32, 1e-4)]
    worst = 0.0
    for tag, b, n, k, d, dt, tol in cases:
        q, key, val = _attention_case(gen, b, n, k, d, dt)
        max_abs = held_attention(
            f"{tag} B={b} N={n} K={k} d={d}",
            ak.fused_object_attention(q, key, val),
            ak.object_attention_reference(q, key, val), tol)
        if dt == torch.bfloat16:
            worst = max(worst, max_abs)
    return worst


def _time_attention(ak, gen, card_info):
    """At each scale's main-path shape: the kernel held against its plain
    version, then the kernel, the plain version and
    F.scaled_dot_product_attention (timed as a yardstick only; the port
    never calls it) timed."""
    import torch.nn.functional as F

    def sdpa(q, key, val):
        return F.scaled_dot_product_attention(q[:, None], key[:, None],
                                              val[:, None])

    rows = {}
    for s in SCALES:
        args = _attention_case(gen, 1, ATTN_N[s], 19, 256, torch.bfloat16)
        err = held_attention(f"{s}x B=1 N={ATTN_N[s]} K=19 d=256",
                             ak.fused_object_attention(*args),
                             ak.object_attention_reference(*args),
                             ATTN_BF16_TOL)
        copies = copies_past_l2(args, 2 * args[0].numel() * 2)
        ms = time_ms(ak.fused_object_attention, copies)
        dev, host = profiled_ms(ak.fused_object_attention, copies)
        plain = time_ms(ak.object_attention_reference, copies)
        with torch.inference_mode():
            lib = time_ms(sdpa, copies)
            # SDPA's own device time: where the host's issue time exceeds
            # a call's work, the events measure dispatch (PERF.md §6)
            lib_dev, lib_host = profiled_ms(sdpa, copies)
        bnd, by = _attention_bound(*args)
        rows[s] = {"ms": ms, "kernel_ms": dev, "host_ms": host,
                   "plain_ms": plain, "library_ms": lib,
                   "library_kernel_ms": lib_dev, "library_host_ms": lib_host,
                   "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
        log(f"[kernel] ocr_attention {s}x (1,{ATTN_N[s]},256) K=19 bf16: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of the bound "
            f"(median of {REPS} x 10 calls over {len(copies)} input "
            f"copies); profiled: kernel {dev:.4f} ms, host {host:.4f} ms a "
            f"call, SDPA {lib_dev:.4f} ms, host {lib_host:.4f} ms a call; "
            f"{card_info}")
    return rows


def _check_bottleneck(bk, gen):
    """Kernel vs plain version off the main path's shapes (those are held
    in :func:`_time_bottleneck`): a ragged batch of 2 and a batch of 3
    smaller than two tiles, with b1 > 0. Returns the largest max|d|."""
    worst = 0.0
    for tag, shape in (("ragged", (2, 37, 75)), ("small", (3, 9, 13))):
        args = _bottleneck_case(gen, *shape)
        err = held_bottleneck(tag, bk.fused_bottleneck(*args),
                              bk.bottleneck_reference(*args))
        worst = max(worst, err["max_abs_err"])
    return worst


def _time_bottleneck(bk, gen, card_info):
    """At each scale's main-path shape: the kernel held against its plain
    version, then the kernel, the plain version and the model's unfused
    eval block (cuDNN bf16 convs with separate BN, ReLU and residual
    passes: what runs with the kernel off) timed. No single PyTorch call
    computes the block, so there is no library time."""
    from tpuseg_torch.models.hrnet import Bottleneck
    from tpuseg_torch.models.layers import init_weights

    block = Bottleneck(256, 64)
    init_weights(block, torch.Generator().manual_seed(0))
    block = block.to("cuda", memory_format=torch.channels_last).eval()

    def unfused(x):
        return block(x.permute(0, 3, 1, 2))  # NCHW view of the NHWC input

    rows = {}
    for s in SCALES:
        args = _bottleneck_case(gen, 1, *BNECK_HW[s])
        x, weights = args[0], args[1:]
        packed = bk.pack_weights(*weights)  # once, as the model does
        err = held_bottleneck(f"{s}x", bk.fused_bottleneck_packed(x, packed),
                              bk.bottleneck_reference(*args))
        # the input cycles through copies; the weights are shared
        copies = copies_past_l2((x,), 2 * x.numel() * 2)
        ms = time_ms(lambda x: bk.fused_bottleneck_packed(x, packed), copies)
        dev, host = profiled_ms(
            lambda x: bk.fused_bottleneck_packed(x, packed), copies)
        plain = time_ms(lambda x: bk.bottleneck_reference(x, *weights),
                        copies)
        with torch.inference_mode():
            unfused_ms = time_ms(unfused, copies)
        bnd, by = _bottleneck_bound(*args)
        rows[s] = {"ms": ms, "kernel_ms": dev, "host_ms": host,
                   "plain_ms": plain, "unfused_ms": unfused_ms,
                   "bound_ms": bnd, "bound_by": by, **err}
        log(f"[kernel] bottleneck {s}x x=(1,{BNECK_HW[s][0]},"
            f"{BNECK_HW[s][1]},256) bf16: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, unfused cuDNN block {unfused_ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of the bound "
            f"(median of {REPS} x 10 calls over {len(copies)} input "
            f"copies); profiled: kernel {dev:.4f} ms, host {host:.4f} ms a "
            f"call; {card_info}")
    return rows


# the kernel of the other widths: the (C, M) and eval scale of each timed
# shape (the [s1w32-eval] model's stage-1 width at its three scales, the
# rest on the 1.0x map), and the one its record leads with (that width at
# 1.0x)
BNECK_ANY_TIMED = ((64, 16, 1.0), (128, 32, 0.5), (128, 32, 1.0),
                   (128, 32, 2.0), (256, 64, 1.0), (512, 128, 1.0),
                   (1024, 256, 1.0))
BNECK_ANY_MAIN = "128x32"
# held off the timed shapes at the ragged batch: a width that is not 4x,
# the widest whose weights stay resident in shared memory along C = 4 M and
# the narrowest streamed, and the widest
BNECK_ANY_HELD = ((96, 40), (192, 48), (224, 56), (1024, 256))


def _any_key(c: int, m: int, scale: float) -> str:
    return f"{c}x{m}" + ("" if scale == 1.0 else f"@{scale}x")


def _any_plan(bk, c: int, m: int, shape) -> str:
    p = bk.any_plan(c, m, shape)
    return (f"{'resident' if p['resident'] else 'streamed'} weights, "
            f"{p['consumers']} consumer warpgroup(s) on {p['tiles']} "
            f"tile(s) a round, x ring {p['x_stages']}, weight ring "
            f"{p['w_stages']}, {p['smem'] / 1024:.1f} KB shared, N = "
            f"{p['mp']}")


def _check_bottleneck_any(bk, gen):
    """The kernel of the other widths vs its plain version off the timed
    shapes, b1 > 0: (128, 32) at a ragged batch of 2, at a batch of 3
    smaller than two tiles and on a ragged map large enough for three
    consumers, and each width of BNECK_ANY_HELD at the ragged batch.
    Returns the largest max|d|."""
    worst = 0.0
    for tag, shape, (c, m) in (
            ("ragged", (2, 37, 75), (128, 32)),
            ("small", (3, 9, 13), (128, 32)),
            ("ragged", (1, 255, 509), (128, 32)),
            *(("ragged", (2, 37, 75), cm) for cm in BNECK_ANY_HELD)):
        args = _bottleneck_case(gen, *shape, c=c, m=m)
        err = held_bottleneck(f"any-width {tag} (C, M) = ({c}, {m}), "
                              f"{_any_plan(bk, c, m, shape)}",
                              bk.fused_bottleneck_any(*args),
                              bk.bottleneck_reference(*args))
        worst = max(worst, err["max_abs_err"])
    return worst


def _time_bottleneck_any(bk, gen, card_info):
    """At each shape of BNECK_ANY_TIMED: the kernel of the other widths
    held against its plain version, then it (its parameter block packed
    once, as the model does), the plain version and the unfused eval block
    ``Bottleneck(C, M)`` (cuDNN bf16 convs) timed; at (256, 64) the wgmma
    kernel, which the model runs there, beside it on the same inputs. No
    single PyTorch call computes the block, so there is no library
    time."""
    from tpuseg_torch.models.hrnet import Bottleneck
    from tpuseg_torch.models.layers import init_weights

    rows = {}
    for c, m, scale in BNECK_ANY_TIMED:
        block = Bottleneck(c, m)
        init_weights(block, torch.Generator().manual_seed(0))
        block = block.to("cuda", memory_format=torch.channels_last).eval()
        hw = BNECK_HW[scale]
        args = _bottleneck_case(gen, 1, *hw, c=c, m=m)
        x, weights = args[0], args[1:]
        blob = bk.pack_any_blob(*weights)

        def run(x):
            return bk.fused_bottleneck_any(x, *weights, blob=blob)

        def unfused(x):
            return block(x.permute(0, 3, 1, 2))  # NCHW view of NHWC

        err = held_bottleneck(f"any-width {scale}x (C, M) = ({c}, {m})",
                              run(x), bk.bottleneck_reference(*args))
        copies = copies_past_l2((x,), 2 * x.numel() * 2)
        ms = time_ms(run, copies)
        dev, host = profiled_ms(run, copies)
        plain = time_ms(lambda x: bk.bottleneck_reference(x, *weights),
                        copies)
        with torch.inference_mode():
            unfused_ms = time_ms(unfused, copies)
        bnd, by = _bottleneck_bound(*args)
        row = {"ms": ms, "kernel_ms": dev, "host_ms": host,
               "plain_ms": plain, "unfused_ms": unfused_ms, "bound_ms": bnd,
               "bound_by": by, "plan": bk.any_plan(c, m, (1, *hw)), **err}
        wgmma = ""
        if (c, m) == bk.KERNEL_SHAPE:
            packed = bk.pack_weights(*weights)
            row["wgmma_ms"] = time_ms(
                lambda x: bk.fused_bottleneck_packed(x, packed), copies)
            wgmma = (f"; the wgmma kernel {row['wgmma_ms']:.4f} ms on the "
                     f"same inputs")
        rows[_any_key(c, m, scale)] = row
        log(f"[kernel] bottleneck any-width {scale}x x=(1,{hw[0]},{hw[1]},"
            f"{c}) M={m} bf16 ({_any_plan(bk, c, m, (1, *hw))}): kernel "
            f"{ms:.4f} ms, "
            f"plain {plain:.4f} ms, unfused cuDNN block {unfused_ms:.4f} "
            f"ms, bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of the bound "
            f"(median of {REPS} x 10 calls over {len(copies)} input "
            f"copies); profiled: kernel {dev:.4f} ms ({bnd / dev:.1%} of "
            f"the bound), host {host:.4f} ms a call{wgmma}; {card_info}")
        del block, x, args, weights, blob, copies
        torch.cuda.empty_cache()
    return rows


# the dilated conv's row: the DeepLabV3+ train cell's rate-12 ASPP conv,
# 4096 -> 256 at 8 x 100 x 100 (rates 24 and 36 and the other shapes are
# held in tests/test_torch_kernels_cuda.py); held on DILATED_HELD images
# against its plain version in f32 by L1-relative and max|d|, a few bf16
# ulps of |out| < 8, which one wrong 128-pixel tile exceeds
DILATED_SHAPE = (8, 4096, 100, 100, 256)
DILATED_RATE = 12
DILATED_HELD = 2
DILATED_L1_TOL = 5e-3
DILATED_MAX_TOL = 0.1


def _dilated_case(b, cin, h, w, cout):
    """Seeded on the card (the 655 MB input takes seconds on the host)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, h, w, cin, generator=gen, device="cuda",
                    dtype=torch.bfloat16).permute(0, 3, 1, 2)
    wt = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") / (
        9 * cin) ** 0.5
    return x, wt.to(torch.bfloat16)


def held_dilated(tag: str, got, want) -> dict:
    """Kernel vs plain version (f32 from the same bf16 inputs), logged;
    raises past the bounds. Returns the errors."""
    torch.cuda.synchronize()
    max_abs, l1 = compare(got, want)
    log(f"[kernel] dilated_conv {tag} out={tuple(got.shape)} bf16: "
        f"max|d|={max_abs:.3e} l1_rel={l1:.3e} (bounds l1_rel < "
        f"{DILATED_L1_TOL}, max|d| < {DILATED_MAX_TOL}; max|out| "
        f"{float(want.abs().max()):.3f})")
    if not (l1 < DILATED_L1_TOL and max_abs < DILATED_MAX_TOL):
        raise AssertionError(f"dilated_conv {tag}: l1 {l1}, max|d| "
                             f"{max_abs}")
    return {"max_abs_err": max_abs, "l1_rel": l1}


def _time_dilated_conv(dc, gen, card_info):
    """The train cell's rate-12 conv: the kernel held against its plain
    version on the first DILATED_HELD images and timed on all of them; the
    plain version (the NCHW copy and cuDNN's conv, the model's route
    before the kernel) and cuDNN's ``F.conv2d`` on NCHW input alone (a
    yardstick only), ~55 ms a call each. The bound is the benchmark's
    (``portbench/metrics/dilated_conv_roofline.py``): the taps in the
    image. The input (655 MB) is past the L2 on its own."""
    import torch.nn.functional as F

    from portbench.metrics.dilated_conv_roofline import launch_s

    t0 = time.perf_counter()
    d, n = DILATED_RATE, DILATED_HELD
    x, wt = _dilated_case(*DILATED_SHAPE)
    wp = dc.pack_weight(wt)
    xn, wn = x.contiguous(), wt.contiguous()
    copies = [(x,)]
    got = dc.dilated_conv3x3(x, wt, (d, d), d)
    err = held_dilated(
        f"rate {d} x={tuple(x.shape)} (images 1-{n})", got[:n],
        dc.dilated_conv3x3_reference(x[:n].float(), wp.float(), d, d, d))
    del got

    def run(x):
        return torch.ops.tpuseg_torch.dilated_conv3x3(x, wp, d, d, d)

    def plain(x):
        return dc.dilated_conv3x3_reference(x, wp, d, d, d)

    def cudnn(x):
        return F.conv2d(xn, wn, None, 1, d, d)

    ms = time_ms(run, copies)
    dev, host = profiled_ms(run, copies)
    with torch.inference_mode():
        plain_ms = time_ms(plain, copies, inner=1)
        lib = time_ms(cudnn, copies, inner=1)
    b, cin, h, w, cout = DILATED_SHAPE
    bnd = launch_s(b, h, w, cin, cout, d) * 1e3
    del x, wt, wp, xn, wn, copies
    torch.cuda.empty_cache()
    row_s = time.perf_counter() - t0
    log(f"[kernel] dilated_conv rate {d} x={DILATED_SHAPE[:4]} -> {cout} "
        f"bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN NCHW "
        f"{lib:.4f} ms, bound {bnd:.4f} ms (in-image taps), {bnd / ms:.1%} "
        f"of the bound (median of {REPS} x 10 calls); profiled: kernel "
        f"{dev:.4f} ms ({bnd / dev:.1%} of the bound), host {host:.4f} ms "
        f"a call; the row took {row_s:.1f} s; {card_info}")
    return {d: {"ms": ms, "kernel_ms": dev, "host_ms": host,
                "plain_ms": plain_ms, "library_ms": lib, "bound_ms": bnd,
                "row_s": row_s, **err}}


def phase_kernels(card_info: str) -> list:
    """Each kernel vs its plain version on the card, then timed at the main
    path's shapes at the three scales (the kernel of the other widths at
    the shapes of BNECK_ANY_TIMED). Returns the JSON records (launches
    filled in by the main path's run)."""
    from tpuseg_torch.kernels import bottleneck_fused as bk
    from tpuseg_torch.kernels import dilated_conv as dc
    from tpuseg_torch.kernels import ocr_attention as ak

    gen = torch.Generator().manual_seed(0)
    records = []
    for name, mod, check, timed, replaces, main_key, rows_key in (
            ("ocr_attention", ak, _check_attention, _time_attention,
             "tpuseg/kernels/ocr_attention.py:92", 1.0, "scales"),
            ("bottleneck_fused", bk, _check_bottleneck, _time_bottleneck,
             "tpuseg/kernels/bottleneck_fused.py:118", 1.0, "scales"),
            ("bottleneck_fused_any", bk, _check_bottleneck_any,
             _time_bottleneck_any, "tpuseg/kernels/bottleneck_fused.py:118",
             BNECK_ANY_MAIN, "widths"),
            # its other rates and shapes (ragged, batch 1, a band) are held
            # in tests/test_torch_kernels_cuda.py
            ("dilated_conv", dc, lambda dc, gen: 0.0, _time_dilated_conv,
             "none (XLA compiles tpuseg's dilated convs)", DILATED_RATE,
             "rates")):
        rows = timed(mod, gen, card_info)
        max_abs = max(check(mod, gen),
                      *(r["max_abs_err"] for r in rows.values()))
        main = rows[main_key]
        records.append({
            "name": name, "route": "cuda",
            "source": f"tpuseg_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": 0, "max_abs_err": max_abs, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main.get("bound_by"),
            "library_ms": main.get("library_ms"),
            **({"unfused_ms": main["unfused_ms"]} if "unfused_ms" in main
               else {}),
            rows_key: {str(s): r for s, r in rows.items()}})
    return records


class _Tee(io.TextIOBase):
    """Copy of everything printed, for reading the eval loop's rate."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


# the same path's rates without the recipe's dumps, as PERF.md §5 records
# them (H100 80GB HBM3, 700 W)
NO_DUMP_IMG_S = (4.11, 6.49)


def _run_cli(argv: list):
    """``python -m tpuseg_torch.cli`` in this process, its output teed:
    -> (stdout text, wall seconds, {kernel: launches in the run}). The
    launch counts are set to 0 just before the run."""
    from tpuseg_torch.cli.main import main as cli_main

    tee = _Tee(sys.stdout)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"tpuseg_torch.cli {argv[0]} returned {rc}")
    return tee.buf.getvalue(), wall, launch_counts()


# every kernel's launch counter, by the name of its record
KERNELS = ("ocr_attention", "bottleneck_fused", "bottleneck_fused_any",
           "dilated_conv")


# the program's launch counter of each (``tpuseg_torch.utils.profiling``)
LAUNCH_COUNTERS = ("kernel.ocr_attention.launches",
                   "kernel.bottleneck.launches",
                   "kernel.bottleneck_any.launches",
                   "kernel.dilated_conv.launches")


def reset_launches() -> None:
    """Every counter of the program to 0, the kernels' launches among
    them."""
    from tpuseg_torch.utils.profiling import reset_counters

    reset_counters()


def launch_counts() -> dict:
    """{kernel: launches since the last :func:`reset_launches`}."""
    from tpuseg_torch.utils.profiling import counters

    now = counters()
    return {k: now.get(c, 0) for k, c in zip(KERNELS, LAUNCH_COUNTERS)}


def sp_collectives() -> dict:
    """{"counts": {kind: sp collectives}, "seconds": {kind: their host
    seconds}} since the program's counters were last reset."""
    from tpuseg_torch.parallel import spatial
    from tpuseg_torch.utils.profiling import counters

    now = counters()
    return {"counts": {k: now.get(f"sp.{k}", 0) for k in spatial.KINDS},
            "seconds": {k: now.get(f"sp.{k}.host_s", 0.0)
                        for k in spatial.KINDS}}


def _hold_launches(tag: str, launches: dict, forwards: int,
                   per: tuple = (3, 9, 0, 0)) -> None:
    """Held: ``per`` = (attention, (256, 64) bottleneck, other-width
    bottleneck, dilated conv) launches a forward (an image), ``forwards``
    of them."""
    want = {k: n * forwards for k, n in zip(KERNELS, per)}
    log(f"[{tag}] launches {launches} (want {want}: {per[0]} attention, "
        f"{per[1]} (256, 64) bottleneck, {per[2]} other-width "
        f"bottleneck and {per[3]} dilated conv calls an image, {forwards} "
        f"images)")
    if launches != want:
        raise AssertionError(f"[{tag}] launch counts {launches} != {want}")


def _rate(text: str):
    """(img/s, Mpx/s) after the first image, from evaluate_only's log."""
    m = re.search(r"after the first: ([\d.]+) img/s, ([\d.]+) Mpx/s", text)
    if m is None:
        raise AssertionError("the eval printed no rate")
    return float(m.group(1)), float(m.group(2))


def _png_seconds(text: str) -> float:
    m = re.search(r"dumped \d+ batches to \S+: ([\d.]+) s on the host", text)
    if m is None:
        raise AssertionError("the eval printed no dump time")
    return float(m.group(1))


def phase_main_path(card_info: str) -> dict:
    """``eval_cityscapes.yaml`` as shipped (W48 HRNet_Mscale, 3 scales,
    1024x2048, bf16, its image dumps on) with both kernels on, through the
    CLI's code path. Returns each kernel's launch count."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["eval", "--config", RECIPE, "--logdir", tmp,
                "--set", "dataset.name=synthetic",
                "--set", "train.test_mode=true",
                "--set", "model.use_pallas=true",
                "--set", "model.fused_stage1=true"]
        torch.cuda.reset_peak_memory_stats()
        text, wall, launches = _run_cli(argv)
        out = Path("chiprun_out/logs")
        out.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(tmp, "log.txt"), out / "log.txt")
        page = Path(tmp, "eval_images", "index.html")
        dumped = []
        if page.exists():
            dumped = sorted(re.findall(r'<img src="([^"]+_prediction\.png)"',
                                       page.read_text()))
            shutil.copy(page, out / "index.html")
        missing = [f for f in dumped
                   if not Path(tmp, "eval_images", f).exists()]
    if "mean mIoU:" not in text:
        raise AssertionError("the eval printed no mIoU")
    _hold_launches("main", launches, MAIN_IMAGES)
    log(f"[main] eval_images/index.html names {len(dumped)} dumped "
        f"images: {dumped}")
    if not dumped or missing:
        raise AssertionError(f"[main] no dump page, or missing {missing}")
    img_s, mpx_s = _rate(text)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[main] W48 HRNet_Mscale 3-scale 1024x2048 bf16, {MAIN_IMAGES} "
        f"images with the recipe's dumps: {img_s} img/s, {mpx_s} Mpx/s "
        f"(images 2-5; without dumps {NO_DUMP_IMG_S[0]}-"
        f"{NO_DUMP_IMG_S[1]} img/s, PERF.md §5), {_png_seconds(text):.3f} s "
        f"writing "
        f"PNGs, whole CLI run {wall:.2f} s, peak device memory {mem:.2f} "
        f"GiB, on {card_info}")
    return launches


def _calibrate_bn(model, x, run=None) -> None:
    """Set every BN's running statistics to the average batch statistics of
    the image at the three eval scales (``run()``, by default MscaleOCR's
    single-scale passes over ``x``), so that a random weight draw keeps
    activations O(1) through the W48 trunk. The BNs over the K class
    proxies (f_object, f_down) and over ASPP's pooled image (img_conv) keep
    unit statistics: the proxies are averages over many pixels and nearly
    equal, and the pooled image is one value a channel, so batch statistics
    over them would blow up any later deviation of their inputs. For the
    same reason each running variance is floored at a tenth of the
    channel's second moment: a channel nearly constant over the pixels is
    not scaled up more than ~3x its RMS."""
    from tpuseg_torch.ops import resize_x

    bns = [m for n, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)
           and not any(k in n for k in (".f_object.", ".f_down.",
                                        ".img_conv."))]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average over the calibration passes
        bn.train()
    with torch.no_grad():
        if run is not None:
            run()
        else:
            for scale in model.n_scales:
                model.single_scale(resize_x(x.permute(0, 3, 1, 2), scale),
                                   need_aux=False)
    for bn in bns:
        bn.eval()
        second = bn.running_mean ** 2 + bn.running_var
        bn.running_var.copy_(torch.maximum(bn.running_var, 0.1 * second))


def _set_kernels(model, on: bool) -> None:
    from tpuseg_torch.models.hrnet import Bottleneck
    from tpuseg_torch.models.ocr import ObjectAttention

    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.fused_kernel = on
        elif isinstance(m, ObjectAttention):
            m.use_pallas = on


S1W32_FORWARDS = 3  # [s1w32-eval]: images; 2..N are timed
# [s1w32-eval]: the model with the kernel of the other widths vs the same
# model with that kernel's plain version in its place, at stage 1's output
# (the three fused blocks' last) at each scale. Each fused call is within
# ~2e-6 L1 of its plain version, as rare one-ulp flips of its bf16
# intermediates, and each block flips more of the next one's: 8.3e-5 to
# 9.4e-5 at stage 1's output on an H100 (PERF.md §6). The logits, past the
# rest of a random net, are printed only (7.1e-2, argmax agreement 0.889
# there)
S1W32_STAGE1_L1 = 1e-3


def _kernel_vs_plain_in_model(tag: str, model, runner, image, label,
                              card_info: str) -> None:
    """The runner's forward with the kernel of the other widths against
    the same forward with its plain version (``bottleneck_reference`` on
    the card) in its place. Held: stage 1's output at every scale within
    S1W32_STAGE1_L1; the logits printed."""
    from tpuseg_torch.kernels import bottleneck_fused as bk

    def plain(x, w1, b1, w2, b2, w3, b3, blob):
        return bk.bottleneck_reference(x, w1, b1, w2, b2, w3, b3).contiguous()

    launch, seen, outs, logits = bk._launch_any, [], [], []
    # the trunk runs stage 1's blocks one by one: its output is the last's
    hook = model.backbone.layer1[-1].register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        with torch.inference_mode():
            for fn in (launch, plain):
                bk._launch_any = fn
                logits.append(runner.forward(image, label,
                                             runner.init_acc())[0])
                outs.append(seen[:])
                seen.clear()
    finally:
        bk._launch_any = launch
        hook.remove()
    stage1 = [compare(a, b) for a, b in zip(*outs)]
    got, want = logits
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[{tag}] the model with the other-width kernel vs with its plain "
        f"version in its place, one image: stage 1's output by scale "
        + ", ".join(f"{tuple(a.shape)} l1_rel {l1:.3e} max|d| {mx:.3e}"
                    for a, (mx, l1) in zip(outs[0], stage1))
        + f" (held: l1_rel < {S1W32_STAGE1_L1}); logits argmax agreement "
        f"{agree:.5f}, l1_rel {compare(got, want)[1]:.3e} (printed), on "
        f"{card_info}")
    if len(stage1) != len(model.n_scales) or not all(
            l1 < S1W32_STAGE1_L1 for _, l1 in stage1) or not (
            torch.isfinite(got).all()):
        raise AssertionError(f"[{tag}] kernel vs plain in the model: "
                             f"stage 1 {stage1}")


def phase_s1w32_eval(card_info: str) -> dict:
    """The slice of the kernel of the other widths: ``MscaleOCR`` with a
    32-wide stage 1 (``HRNetSpec(stage1_channels=32)``: W48 in stages 2-4,
    three identity blocks at (C, M) = (128, 32)), ``fused_stage1`` and
    ``use_pallas`` on, bf16, n-scale {0.5, 1.0, 2.0} through EvalRunner on
    seeded 1024x2048 scenes, seeded weights whose BN statistics are
    calibrated on one scene. Held: 3 attention, 0 (256, 64) and 9
    other-width bottleneck launches an image, each kernel vs its plain
    version at the model's own inputs, and the model with the kernel vs
    with its plain version in its place at stage 1's output. Printed: ms
    an image, and kernels on vs off against the same weights' f32
    forward (held in [mscale-eval]; a draw on this net, see
    :func:`_kernel_vs_plain_in_model`). Returns the launches."""
    from tpuseg_torch.evaluation.inference import EvalRunner
    from tpuseg_torch.models.hrnet import HRNetSpec
    from tpuseg_torch.models.layers import init_weights
    from tpuseg_torch.models.ocrnet import MscaleOCR
    from tpuseg_torch.ops import device_normalize

    model = MscaleOCR(num_classes=19, spec=HRNetSpec(stage1_channels=32),
                      fused_stage1=True, use_pallas=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    scene, _, _ = _fake_scene(1000)
    x = device_normalize(torch.from_numpy(scene[None]).cuda())
    _set_kernels(model, False)
    _calibrate_bn(model, x)
    _set_kernels(model, True)

    runner = EvalRunner(model, 19, device="cuda")
    images = []
    for seed in range(1001, 1001 + S1W32_FORWARDS):
        image, _, tid = _fake_scene(seed)
        images.append((torch.from_numpy(image[None]).cuda(),
                       torch.from_numpy(tid[None].astype(np.uint8)).cuda()))
    times = []
    reset_launches()
    with torch.inference_mode():
        for image, label in images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.forward(image, label, runner.init_acc())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = launch_counts()
    _hold_launches("s1w32-eval", launches, len(images), per=(3, 0, 9, 0))
    log(f"[s1w32-eval] MscaleOCR, HRNetSpec(stage1_channels=32), bf16, "
        f"n-scale {model.n_scales}, {len(images)} 1024x2048 images: "
        f"{np.median(times[1:]) * 1e3:.1f} ms an image (median of images "
        f"2-{len(images)}, host clock), on {card_info}")
    _kernels_at_trained_inputs(model, x, tag="s1w32-eval")
    # on/off vs f32 is printed, not held: the kernel and the unfused bf16
    # block are each a bf16 rounding from the block's math, and the
    # random net compounds either past stage 1, so which side lands nearer
    # f32 is a draw ([mscale-eval] has held it by a 0.1 % margin on an
    # H100; PERF.md §6)
    _on_off_vs_f32("s1w32-eval", model, {"num_classes": 19}, *images[0],
                   card_info, hold=False)
    _kernel_vs_plain_in_model("s1w32-eval", model, runner, *images[0],
                              card_info)
    del model, runner
    torch.cuda.empty_cache()
    return launches


def phase_on_off(card_info: str) -> None:
    """One seeded uint8 1024x2048 image through the port's EvalRunner from
    one seeded weight draw, with both kernels on and off: the logits
    compared, and the time a image in the order on, off, off, on."""
    from tpuseg_torch.evaluation.inference import EvalRunner
    from tpuseg_torch.models.layers import init_weights
    from tpuseg_torch.models.ocrnet import MscaleOCR
    from tpuseg_torch.ops import device_normalize

    # the recipe's model: MscaleOCR's defaults are W48, n-scale {0.5, 1.0,
    # 2.0}, bf16 compute and f32 fusion
    model = MscaleOCR(num_classes=19)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    rng = np.random.RandomState(0)
    image = torch.from_numpy(
        rng.randint(0, 256, (1, 1024, 2048, 3), dtype=np.uint8)).cuda()
    label = torch.from_numpy(
        rng.randint(0, 19, (1, 1024, 2048)).astype(np.uint8)).cuda()
    runner = EvalRunner(model, 19, device="cuda")
    _set_kernels(model, False)
    _calibrate_bn(model, device_normalize(image))

    logits, times = {}, {True: [], False: []}
    for on in (True, False, False, True):  # alternated against drift
        _set_kernels(model, on)
        with torch.inference_mode():
            out = runner.forward(image, label, runner.init_acc())  # warm-up
            logits.setdefault(on, out[0])
            for _ in range(ON_OFF_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runner.forward(image, label, runner.init_acc())
                torch.cuda.synchronize()
                times[on].append(time.perf_counter() - t0)
    on, off = logits[True], logits[False]
    if not (torch.isfinite(on).all() and torch.isfinite(off).all()):
        raise AssertionError("non-finite logits")
    std = float(off.std())
    agree = float((on.argmax(-1) == off.argmax(-1)).float().mean())
    max_d, l1 = compare(on, off)
    log(f"[on/off] logit std {std:.4f} (bound 1e-2..1e2), argmax agreement "
        f"{agree:.5f} (bound >= 0.99), max|d logits| {max_d:.4f}, l1_rel "
        f"{l1:.3e}; one image, median of {2 * ON_OFF_REPS} a side: kernels "
        f"on {np.median(times[True]) * 1e3:.1f} ms, off "
        f"{np.median(times[False]) * 1e3:.1f} ms, on {card_info}")
    if not 1e-2 <= std <= 1e2:
        raise AssertionError(f"logit std {std} outside 1e-2..1e2")
    if agree < 0.99:
        raise AssertionError(f"argmax agreement {agree} < 0.99")
    _set_kernels(model, True)
    with torch.inference_mode():
        runner.forward(image, label, runner.init_acc())  # warm-up
    _profile(lambda: runner.forward(image, label, runner.init_acc()),
             card_info)


def _profile(fn, card_info: str, top: int = 12, what: str = "one image",
             out_name: str = "profile_top.txt", tag: str = "profile",
             inference: bool = True) -> None:
    """Device time by kernel name over one call of ``fn`` (``what``), from
    torch.profiler: the top entries printed, the whole table written to
    chiprun_out/``out_name``. The caller has run ``fn`` before (warm)."""
    from torch.profiler import ProfilerActivity, profile

    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    def device_us(e):
        # device kernels only: a CPU op's entry repeats its kernels' time,
        # and so does the optimizer's annotation range (Optimizer.step#...)
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.key.startswith("Optimizer."):
            return 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    rows = sorted(((device_us(e), e.count, e.key)
                   for e in prof.key_averages() if device_us(e) > 0),
                  reverse=True)
    total = sum(r[0] for r in rows)
    if total <= 0:
        log(f"[{tag}] the profiler saw no device time: not measured")
        return
    lines = [f"device time {total / 1e3:.3f} ms in "
             f"{sum(r[1] for r in rows)} kernels over {wall * 1e3:.3f} ms "
             f"of wall time ({1 - total / 1e6 / wall:.1%} idle), {what}, "
             f"{card_info}"]
    lines += [f"{us / 1e3:9.3f} ms {us / total:6.1%} x{n:<5d} {name[:90]}"
              for us, n, name in rows]
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / out_name).write_text("\n".join(lines) + "\n")
    for line in lines[:top + 1]:
        log(f"[{tag}] {line}")


# ------------------------------------------------------ eval surfaces

DUMP_RECIPE = "tpuseg_torch/cli/recipes/dump_cityscapes.yaml"
SERVE_CALLS = 5  # served and eager calls a side; calls 2..N are timed
# served program vs the eager forward of the same module on the card: the
# same ops on the same inputs, so near-equality (held: L1-relative and
# argmax agreement; max|d| printed)
SERVE_TOL = {"l1_rel": 1e-3, "argmax_agree": 0.999}


def _conditioned_model(root: str):
    """The recipe's W48 HRNet_Mscale (3 scales, bf16) from one seeded draw,
    its BN statistics set by ``_calibrate_bn`` over one val scene, both
    kernels on, on the card; also saved as a reference-format state dict
    ``<root>/conditioned.pth`` for the CLI's ``--checkpoint``. Returns
    (model, path)."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.models import get_model
    from tpuseg_torch.ops import device_normalize

    cfg = load_config(DUMP_RECIPE, [])
    model = get_model(eval_model_config(cfg), seed=cfg.train.seed)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    image, _, _ = _fake_scene(1000)
    _set_kernels(model, False)
    _calibrate_bn(model, device_normalize(
        torch.from_numpy(image[None]).cuda()))
    _set_kernels(model, True)
    path = str(Path(root, "conditioned.pth"))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    return model, path


TOPN_HW = (512, 1024)  # [dump]'s top-N scene: the top left of val scene 0


def _topn_tree(root: str) -> str:
    """A Cityscapes tree beside ``root`` holding the TOPN_HW top left of its
    first val scene (top-N dumps every (image, class) pair it selects: 19
    PNG galleries a selected image, so its pixels set the mode's time)."""
    from PIL import Image

    top = Path(root, "topn_tree")
    lv = "leftImg8bit_trainvaltest/leftImg8bit"
    gt = "gtFine_trainvaltest/gtFine"
    (top / lv / "train" / "aachen").mkdir(parents=True)
    base = "lindau_000000_000019"
    for sub, name in ((lv, f"{base}_leftImg8bit.png"),
                      (gt, f"{base}_gtFine_labelIds.png")):
        d = top / sub / "val" / "lindau"
        d.mkdir(parents=True)
        whole = np.asarray(Image.open(Path(root, sub, "val", "lindau", name)))
        Image.fromarray(whole[:TOPN_HW[0], :TOPN_HW[1]]).save(
            d / name, compress_level=1)
    return str(top)


def _reference_predictions(model, sets: list) -> dict:
    """{image name: argmax of EvalRunner's fused logits} over the dump
    recipe's val images, kernels on (these launches are not counted)."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.evaluation.inference import EvalRunner

    cfg = load_config(DUMP_RECIPE, sets)
    _, loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    runner = EvalRunner(model, 19, device="cuda")
    preds = {}
    with torch.inference_mode():
        for batch in loader:
            image = torch.from_numpy(batch["image"]).cuda()
            label = torch.from_numpy(batch["label"]).cuda()
            logits = runner.forward(image, label, runner.init_acc())[0]
            preds[batch["name"][0]] = logits.argmax(-1)[0].cpu().numpy()
    return preds


def _metrics_only_rate(model, sets: list) -> float:
    """img/s over images 2..N of the pipelined eval loop with no asset
    read (what evaluate_only runs on a batch the dumper skips)."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.evaluation.inference import EvalRunner

    cfg = load_config(DUMP_RECIPE, sets)
    _, loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    runner = EvalRunner(model, 19, device="cuda")
    acc = runner.init_acc()
    batches = list(loader)
    t0 = None
    for i, batch in enumerate(batches):
        _, acc = runner.run_batch(batch, need_assets=False, acc=acc)
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    runner.drain(acc)
    return (len(batches) - 1) / (time.perf_counter() - t0)


def _png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


DUMP_IMAGES = 2  # [dump]: val scenes of the first three modes


def phase_dump(card_info: str, root: str, model, ckpt: str) -> dict:
    """``python -m tpuseg_torch.cli dump --config dump_cityscapes.yaml`` on
    the conditioned W48 weights with both kernels on over DUMP_IMAGES val
    scenes of the seeded Cityscapes tree, in four modes: assets,
    auto-labelling, submission, and top-N (over one val scene). Held: the
    launch counts, each mode's file set, every dumped prediction equal to
    the argmax of EvalRunner's logits for the same image, and the
    auto-label PNGs read back as the same trainIds through
    cityscapes_labels. Returns the launches of the four runs together."""
    from tpuseg_torch.data.cityscapes_labels import (
        PALETTE,
        TRAINID_TO_ID,
        label2trainid,
        trainid2name,
    )

    common = [f"dataset.cityscapes_dir={_subset_tree(root, 1, DUMP_IMAGES)}",
              "train.test_mode=true",
              "model.use_pallas=true", "model.fused_stage1=true",
              f"dataset.centroid_root={Path(root, 'centroids')}"]
    want = _reference_predictions(model, common)
    names = sorted(want)
    classes = ", ".join(str(len(np.unique(p))) for p in want.values())
    log(f"[dump] reference predictions of {len(names)} val images "
        f"(classes an image: {classes})")
    base_rate = _metrics_only_rate(model, common)
    log(f"[dump] metrics-only eval (no asset reads): {base_rate:.4f} img/s "
        f"(images 2-{len(names)}, {card_info})")
    to_tid = np.full(256, 255, np.uint8)
    for k, v in label2trainid.items():
        if 0 <= k < 256 and v >= 0:
            to_tid[k] = v
    modes = (("assets", [], len(names)),
             ("auto_labelling", ["eval.dump_for_auto_labelling=true"],
              len(names)),
             ("submission", ["eval.dump_for_submission=true"], len(names)),
             ("topn", ["eval.dump_topn=2"], 2))
    topn = [f"dataset.cityscapes_dir={_topn_tree(root)}"] + common[1:]
    want_topn = _reference_predictions(model, topn)
    total = dict.fromkeys(KERNELS, 0)
    for mode, extra, forwards in modes:
        sets = (topn if mode == "topn" else common) + extra
        logdir = Path(root, f"dump_{mode}")
        argv = ["dump", "--config", DUMP_RECIPE, "--checkpoint", ckpt,
                "--logdir", str(logdir)]
        for item in sets:
            argv += ["--set", item]
        text, wall, launches = _run_cli(argv)
        _hold_launches(f"dump {mode}", launches, forwards)
        for k in total:
            total[k] += launches[k]
        out = logdir / "eval_images"
        files = {str(p.relative_to(out)) for p in out.rglob("*")
                 if p.is_file()}
        if mode == "assets":
            assets = ("input", "gt", "prediction", "composited", "pred_0.5x",
                      "pred_1.0x", "pred_2.0x", "attn_0.5x", "attn_1.0x",
                      "err_mask")
            expect = {f"{n}_{a}.png" for n in names for a in assets}
            expect.add("index.html")
            checks = {f"{n}_prediction.png": PALETTE[want[n]] for n in names}
        elif mode == "auto_labelling":
            expect = {f"{n}{s}.png" for n in names for s in ("", "_prob")}
            checks = {f"{n}.png": TRAINID_TO_ID[want[n]] for n in names}
            back = [np.array_equal(to_tid[_png(out / f"{n}.png")], want[n])
                    for n in names]
            log(f"[dump] auto-label PNGs read back as trainIds through "
                f"cityscapes_labels: {sum(back)}/{len(back)} equal")
            if not all(back):
                raise AssertionError("[dump] auto-labels do not round-trip")
        elif mode == "submission":
            expect = {f"submit/{n}.png" for n in names}
            checks = {f"submit/{n}.png": TRAINID_TO_ID[want[n]]
                      for n in names}
        else:
            n = names[0]
            pairs = [f"{n}_{trainid2name[c]}" for c in range(19)]
            assets = ("input", "gt", "prediction", "composited", "pred_0.5x",
                      "pred_1.0x", "pred_2.0x", "attn_0.5x", "attn_1.0x",
                      "err_mask")
            expect = {f"best_images/{p}_{a}.png" for p in pairs
                      for a in assets}
            expect.add("best_images/topn_failures.html")
            checks = {f"best_images/{p}_prediction.png":
                      PALETTE[want_topn[n]] for p in pairs}
        if files != expect:
            raise AssertionError(
                f"[dump] {mode}: files {sorted(files ^ expect)[:8]} differ "
                f"from the expected set")
        bad = [f for f, a in checks.items() if not np.array_equal(
            _png(out / f), a.astype(np.uint8))]
        if bad:
            raise AssertionError(f"[dump] {mode}: predictions differ from "
                                 f"EvalRunner's argmax in {bad}")
        rate = (f"{_rate(text)[0]} img/s (images 2-{len(names)})"
                if mode != "topn" else
                f"{forwards / wall:.4f} forwards/s over the whole CLI run")
        png = _png_seconds(text) if mode != "topn" else None
        log(f"[dump] {mode}: {len(files)} files as expected, "
            f"{len(checks)} predictions equal to EvalRunner's argmax; "
            f"{rate} vs metrics-only {base_rate:.4f} img/s; "
            + (f"{png:.3f} s writing PNGs; " if png is not None else "")
            + f"whole CLI run {wall:.2f} s, on {card_info}")
    return total


def phase_serve(card_info: str, root: str, model, ckpt: str) -> dict:
    """``python -m tpuseg_torch.cli export --export-size 1024x2048`` of the
    conditioned W48 3-scale bf16 model with both kernels on; the bundle
    loaded in process (``load_exported``), once, and that program served
    over HTTP as well (``make_http_server(serve=...)`` on an ephemeral
    port: the server's own load of a bundle is held on the CPU, in
    tests/test_torch_serving.py). Held: both ops in the graph, 3 and 9 launches a served call, the logits against the eager
    forward of the same module (SERVE_TOL), the HTTP response byte-equal to
    the in-process call, /healthz the manifest. Returns the launches of
    one served call."""
    import threading
    import urllib.request

    from tpuseg_torch import serving
    from tpuseg_torch.ops import device_normalize

    bundle = Path(root, "bundle")
    argv = ["export", "--config", RECIPE, "--checkpoint", ckpt,
            "--export-size", "1024x2048", "--export-out", str(bundle),
            "--set", "model.use_pallas=true",
            "--set", "model.fused_stage1=true"]
    _, export_s, _ = _run_cli(argv)
    manifest = json.loads((bundle / "manifest.json").read_text())
    (entry,) = manifest["entries"]
    # the bundle is loaded once (each load of the 0.3 GB program takes
    # 11-20 s on the host): the program load_exported reads is the one
    # inspected here and the one the HTTP server below serves
    t0 = time.perf_counter()
    serve = serving.load_exported(str(bundle))
    load_s = time.perf_counter() - t0
    (program,) = serve.programs
    ops = [str(n.target) for n in program.graph.nodes
           if str(n.target).startswith("tpuseg_torch.")]
    counts = {k: ops.count(f"tpuseg_torch.{k}.default")
              for k in ("ocr_attention", "bottleneck_fused")}
    calls = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    del program
    log(f"[serve] exported {entry['input']} on {entry['device']} in "
        f"{export_s:.2f} s (CLI run), {entry['bytes']} bytes; graph ops "
        f"{counts} among {len(calls)} calls, "
        f"{calls.count('aten._assert_tensor_metadata.default')} of them "
        f"dtype assertions; on {card_info}")
    if counts != {"ocr_attention": 3, "bottleneck_fused": 9}:
        raise AssertionError(f"[serve] graph ops {counts}")

    image, _, _ = _fake_scene(1001)
    x32 = device_normalize(torch.from_numpy(image[None]).cuda())
    x = x32.to(torch.bfloat16)

    def timed(fn):
        out, times = None, []
        for _ in range(SERVE_CALLS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return out, float(np.median(times[1:])) * 1e3

    reset_launches()
    served = serve(x)
    torch.cuda.synchronize()
    launches = launch_counts()
    _hold_launches("serve", launches, 1)
    served, served_ms = timed(lambda: serve(x))
    with torch.inference_mode():
        eager, eager_ms = timed(lambda: model(x)["pred"].float())
    max_d, l1 = compare(served, eager)
    agree = float((served.argmax(-1) == eager.argmax(-1)).float().mean())
    log(f"[serve] served vs eager forward of the same module: max|d| "
        f"{max_d:.3e}, l1_rel {l1:.3e} (bound {SERVE_TOL['l1_rel']}), "
        f"argmax agreement {agree:.6f} (bound {SERVE_TOL['argmax_agree']}); "
        f"logit std {float(eager.std()):.4f}")
    if not (torch.isfinite(served).all() and l1 <= SERVE_TOL["l1_rel"]
            and agree >= SERVE_TOL["argmax_agree"]):
        raise AssertionError("[serve] served logits off the eager forward")

    # where the served call's time goes, beside the eager forward's
    _profile(lambda: serve(x), card_info, top=4, what="one served call",
             out_name="serve_profile_top.txt", tag="serve-profile")
    _profile(lambda: model(x)["pred"].float(), card_info, top=4,
             what="one eager forward of the same module",
             out_name="eager_profile_top.txt", tag="serve-profile")

    srv = serving.make_http_server(str(bundle), host="127.0.0.1", port=0,
                                   serve=serve)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        health = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=60).read())
        body = io.BytesIO()
        np.save(body, x32.cpu().numpy())
        t = time.perf_counter()
        reply = urllib.request.urlopen(urllib.request.Request(
            f"{base}/predict", data=body.getvalue(), method="POST"),
            timeout=300).read()
        http_ms = (time.perf_counter() - t) * 1e3
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    local = io.BytesIO()
    np.save(local, serve(x32.cpu().numpy()).cpu().numpy(),
            allow_pickle=False)
    same = reply == local.getvalue()
    log(f"[serve] HTTP /predict of a (1,1024,2048,3) f32 .npy: {http_ms:.1f} "
        f"ms round trip, {len(reply)} bytes, byte-equal to the in-process "
        f"call: {same}; /healthz is the manifest: {health == manifest}; "
        f"on {card_info}")
    if not same or health != manifest:
        raise AssertionError("[serve] HTTP reply or /healthz differ")
    log(f"[serve] W48 HRNet_Mscale 3-scale 1024x2048 bf16: served "
        f"{served_ms:.2f} ms a call vs eager {eager_ms:.2f} ms (median of "
        f"calls 2-{SERVE_CALLS}), load {load_s:.2f} s, export {export_s:.2f}"
        f" s, artifact {entry['bytes'] / 1e6:.1f} MB, on {card_info}")
    return launches


def phase_summary(card_info: str) -> None:
    """``python -m tpuseg_torch.cli summary`` on the eval recipe at
    1024x2048: params held equal to the eval model's parameter count."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.models import get_model

    text, wall, _ = _run_cli(["summary", "--config", RECIPE])
    m = re.search(r"params: [\d.]+M \((\d+)\)  fwd GFLOPs: ([\d.]+)  peak "
                  r"device memory: ([\d.]+)GiB", text)
    cfg = load_config(RECIPE, [])
    want = sum(p.numel() for p in get_model(eval_model_config(cfg))
               .parameters())
    if m is None or int(m.group(1)) != want:
        raise AssertionError(f"[summary] params {m and m.group(1)} != "
                             f"{want}")
    log(f"[summary] W48 HRNet_Mscale 3-scale 1024x2048 bf16: params "
        f"{m.group(1)} (= the eval model's {want}), {m.group(2)} GFLOPs "
        f"counted (convolutions and matrix products), peak device memory "
        f"{m.group(3)} GiB, CLI run {wall:.2f} s, on {card_info}")


# ---------------------------------------------------------------- training

TRAIN_RECIPE = "tpuseg_torch/cli/recipes/train_cityscapes.yaml"
# the seeded tree: [loader]'s train set (two batches of 8) and
# [aspp-ocr]'s and [mscale-eval]'s val scenes; the other phases read
# subsets of it
TRAIN_IMAGES, VAL_IMAGES = 16, 3
# [train], [deepv3-train], [mscale-train] and [loader]'s CLI run: steps an
# epoch, over as many train scenes; val scenes a validation ([relaxed] too)
TRAIN_STEPS = 5
TRAIN_VAL_IMAGES = 2
SCENE_HW, BLOCK = (1024, 2048), 128
REMAT_STEPS = 3
# [train-parity], tiny topology in f32: cuda vs cpu, and remat on vs off
PARITY_TOL = {"loss_rel": 1e-4, "grad_l1": 5e-3, "stats_l1": 1e-4,
              "remat_loss_rel": 1e-6, "remat_stats_l1": 1e-6}
# [train-remat], W48 bf16: remat on vs off after the first step
REMAT_TOL = {"loss_rel": 1e-3, "stats_l1": 1e-3}


def _fake_scene(seed: int, hw=SCENE_HW):
    """A seeded street-scene stand-in: BLOCK x BLOCK squares of random train
    classes, each pixel its class's Cityscapes colour plus noise. Returns
    (uint8 RGB image, raw label ids, train ids)."""
    from tpuseg_torch.data.cityscapes_labels import PALETTE, TRAINID_TO_ID

    rng = np.random.RandomState(seed)
    h, w = hw
    ids = rng.randint(0, 19, (-(-h // BLOCK), -(-w // BLOCK))).astype(
        np.uint8)
    tid = np.repeat(np.repeat(ids, BLOCK, 0), BLOCK, 1)[:h, :w]
    noise = rng.randint(-24, 25, (h, w, 3)).astype(np.int16)
    image = np.clip(PALETTE[tid].astype(np.int16) + noise, 0, 255)
    return image.astype(np.uint8), TRAINID_TO_ID[tid], tid


def _write_fake_cityscapes(root: str) -> None:
    """A Cityscapes tree (leftImg8bit / gtFine labelIds PNGs, one city a
    split) of TRAIN_IMAGES + VAL_IMAGES seeded 1024x2048 scenes, so the
    real data path runs: decode, scale / crop / flip, class-uniform
    sampling, the uint8 wire."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = [("train", "aachen", i) for i in range(TRAIN_IMAGES)] + \
        [("val", "lindau", i) for i in range(VAL_IMAGES)]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: _write_scene(root, *job), jobs))


def _write_scene(root: str, split: str, city: str, i: int) -> None:
    """Scene ``i`` of a split of the seeded Cityscapes tree (image and raw
    label ids as PNGs)."""
    from PIL import Image

    image, ids, _ = _fake_scene(1000 * (split == "val") + i)
    base = f"{city}_{i:06d}_000019"
    img_dir = Path(root, "leftImg8bit_trainvaltest/leftImg8bit", split, city)
    msk_dir = Path(root, "gtFine_trainvaltest/gtFine", split, city)
    img_dir.mkdir(parents=True, exist_ok=True)
    msk_dir.mkdir(parents=True, exist_ok=True)
    Image.fromarray(image).save(img_dir / f"{base}_leftImg8bit.png",
                                compress_level=1)
    Image.fromarray(ids).save(msk_dir / f"{base}_gtFine_labelIds.png",
                              compress_level=1)


def _condition(model, seed: int = 0) -> None:
    """Seeded weights that keep a tiny train-mode net well conditioned
    (convs at 1/sqrt(fan_in), random BN affine and running statistics), so
    its gradients are not dominated by f32 rounding. Drawn on the model's
    device."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=gen)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.copy_(0.7 + 0.3 * torch.randn(
                    m.running_var.shape, generator=gen, device=dev).abs())


def _stats(model) -> dict:
    return {k: v.detach().double().cpu() for k, v in
            model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _tree_l1(got: dict, want: dict) -> float:
    num = sum(float((got[k].double().cpu() - want[k].double().cpu()).abs()
                    .sum()) for k in want)
    return num / sum(float(want[k].double().abs().sum()) for k in want)


def _train_step_of(cfg, model):
    """The Trainer's step (make_train_step over get_loss and
    make_optimizer of ``cfg``): -> (step fn, optimizer)."""
    from tpuseg_torch.losses import get_loss
    from tpuseg_torch.train.optim import make_optimizer
    from tpuseg_torch.train.step import make_train_step

    lc = cfg.loss
    criterion, _ = get_loss(cfg)
    opt, schedule = make_optimizer(cfg, model.parameters(), 10)
    step = make_train_step(criterion, schedule, ocr_alpha=lc.ocr_alpha,
                           aux_rmi=lc.ocr_aux_rmi,
                           supervised_mscale_wt=lc.supervised_mscale_wt,
                           align_corners=cfg.model.align_corners)
    return step, opt


def phase_train_parity() -> None:
    """One train step of the tiny topology in f32 (TF32 off) from one
    seeded weight draw and batch, on the card and on the CPU in this
    process: RMI with cuDNN off (the port's ops on the card, convs as
    cuBLAS f32 GEMMs), CE with cuDNN on, and RMI on the card with every
    stage remat'd vs not. RMI with cuDNN on is printed, not held: cuDNN's
    f32 conv algorithms differ from the CPU's by ~1e-6, which the RMI
    backward through its nearly singular 9x9 factors amplifies (measured
    3.9e-2 on an H100, vs 1.4e-4 with cuDNN off; CE with cuDNN on 2.5e-5)."""
    from tpuseg_torch.config import make_config
    from tpuseg_torch.models import get_model

    sets = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
            "model.compute_dtype": "float32", "model.n_scales": (),
            "model.ocr.dropout": 0.0, "model.remat": False,
            "loss.supervised_mscale_wt": 0.05, "optim.lr": 5e-4}
    base = get_model(make_config(sets))
    _condition(base)
    rng = np.random.RandomState(3)
    image = rng.randint(0, 256, (2, 64, 128, 3)).astype(np.uint8)
    label = rng.randint(0, 19, (2, 2, 4)).astype(np.uint8).repeat(
        32, 1).repeat(32, 2)
    label[:, :4] = 255

    def one_step(device, loss_type, remat=False, cudnn=True):
        cfg = make_config({**sets, "loss.loss_type": loss_type,
                           "model.remat": remat})
        model = get_model(cfg)
        model.load_state_dict(base.state_dict())
        model = model.to(device, memory_format=torch.channels_last).train()
        step, opt = _train_step_of(cfg, model)
        batch = {"image": torch.from_numpy(image).to(device),
                 "label": torch.from_numpy(label).to(device)}
        # cudnn.flags() would also reset allow_tf32 (to True)
        with (contextlib.nullcontext() if cudnn else
              torch.backends.cudnn.flags(enabled=False, allow_tf32=False)):
            loss = float(step(model, opt, batch, 0)["loss"])
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in model.named_parameters()}
        return loss, grads, _stats(model)

    def gaps(got, want):
        return {"loss_rel": abs(got[0] - want[0]) / abs(want[0]),
                "grad_l1": _tree_l1(got[1], want[1]),
                "stats_l1": _tree_l1(got[2], want[2])}

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows = {}
        for crit in ("rmi", "ce"):
            cpu = one_step("cpu", crit)
            for cudnn in (False, True):
                rows[(crit, cudnn)] = (gaps(one_step("cuda", crit,
                                                     cudnn=cudnn), cpu), cpu)
        gpu = one_step("cuda", "rmi")
        remat = one_step("cuda", "rmi", remat=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    held = {("rmi", False), ("ce", True)}
    bad = []
    for (crit, cudnn), (got, cpu) in rows.items():
        hold = (crit, cudnn) in held
        log(f"[train-parity] tiny HRNet_Mscale f32, TF32 off, batch 2 x "
            f"64x128, {crit}, cuDNN {'on' if cudnn else 'off'}, cuda vs cpu "
            f"(cpu loss {cpu[0]:.6f}): " + ", ".join(
                f"{k} {v:.3e}" + (f" (bound {PARITY_TOL[k]})" if hold else "")
                for k, v in got.items()) + ("" if hold else
                                            " (printed, not held)"))
        if hold:
            bad += [f"{crit} {k}" for k, v in got.items()
                    if not v <= PARITY_TOL[k]]
    got = {"remat_loss_rel": abs(remat[0] - gpu[0]) / abs(gpu[0]),
           "remat_stats_l1": _tree_l1(remat[2], gpu[2])}
    log("[train-parity] rmi on cuda, remat of stages 1-4 vs none: "
        + ", ".join(f"{k} {v:.3e} (bound {PARITY_TOL[k]})"
                    for k, v in got.items()))
    bad += [k for k, v in got.items() if not v <= PARITY_TOL[k]]
    if bad:
        raise AssertionError(f"[train-parity] out of bounds: {bad}")


def _spy_validation(recorded: list):
    """Wrap each EvalRunner's forward so that every validation image leaves
    a record (runner, argmax, the fused logits' std) on the device; returns
    the undo."""
    from tpuseg_torch.evaluation import inference

    orig = inference.EvalRunner.__init__

    def init(self, *args, **kw):
        orig(self, *args, **kw)
        forward = self.forward

        def spy(*a, **k):
            out = forward(*a, **k)
            recorded.append((self, out[1], out[0].float().std()))
            return out

        self.forward = spy

    inference.EvalRunner.__init__ = init
    return lambda: setattr(inference.EvalRunner, "__init__", orig)


def _spy_packed_weights(counts: dict):
    """Wrap Bottleneck._folded so that every packed parameter block the
    fused kernel is given is compared with a fresh fold + pack of the
    block's weights at that moment (a stale cache after optimizer.step()
    would differ); returns the undo."""
    from tpuseg_torch.models.hrnet import Bottleneck

    orig = Bottleneck._folded

    def spy(self):
        packed = orig(self)
        cached = self._folded_cache
        self._folded_cache = None
        fresh = orig(self)
        self._folded_cache = cached
        counts["launches"] += 1
        counts["stale"] += not all(
            (a is None and b is None) or torch.equal(a, b)
            for a, b in zip((*packed.weights, packed.blob),
                            (*fresh.weights, fresh.blob)))
        return packed

    Bottleneck._folded = spy
    return lambda: setattr(Bottleneck, "_folded", orig)


def _kernels_at_trained_inputs(model, image, forward=None,
                               tag: str = "train", calls: int = 12) -> None:
    """Each kernel vs its plain version at the inputs a trained model gives
    it on one image at the three eval scales (``forward()``, by default the
    MscaleOCR model's own 3-scale call on ``image``; kernels off while the
    inputs are captured), ``calls`` of them. Raises past the bounds."""
    from tpuseg_torch.kernels import bottleneck_fused as bk
    from tpuseg_torch.kernels import ocr_attention as ak
    from tpuseg_torch.models.hrnet import Bottleneck
    from tpuseg_torch.models.ocr import ObjectAttention, _nhwc_flat

    _set_kernels(model, False)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args)))
        for m in model.modules()
        if isinstance(m, ObjectAttention) or (
            isinstance(m, Bottleneck) and m.downsample is None
            and bk.supports(image.device, 4 * m.planes, m.planes))]
    try:
        with torch.inference_mode():
            if forward is not None:
                forward()
            else:
                model(image)
    finally:
        for h in hooks:
            h.remove()
    worst = {}  # each kernel's worst l1_rel
    unfused = 0.0  # the model's unfused bf16 block vs the same reference
    largest = {}  # each kernel's largest input
    try:
        with torch.inference_mode():
            for mod, args in seen:
                if isinstance(mod, Bottleneck):
                    x = args[0].permute(0, 2, 3, 1).contiguous()
                    packed = mod._folded()
                    got = bk.fused_bottleneck_packed(x, packed)
                    want = bk.bottleneck_reference(x, *packed.weights)
                    name = ("bottleneck_fused" if tuple(
                        packed.weights[0].shape) == bk.KERNEL_SHAPE
                        else "bottleneck_fused_any")
                    unfused = max(unfused, compare(
                        mod(args[0]).permute(0, 2, 3, 1), want)[1])
                else:
                    x, proxy = args
                    proxy_img = proxy.permute(0, 2, 1)[..., None]
                    q = _nhwc_flat(mod.f_pixel(x)).contiguous()
                    key = _nhwc_flat(mod.f_object(proxy_img)).contiguous()
                    val = _nhwc_flat(mod.f_down(proxy_img)).contiguous()
                    got = ak.fused_object_attention(q, key, val)
                    want = ak.object_attention_reference(q, key, val)
                    name = "ocr_attention"
                worst[name] = max(worst.get(name, 0.0),
                                  compare(got, want)[1])
                if x.numel() > largest.get(name, (0,))[0]:
                    largest[name] = (x.numel(), tuple(x.shape))
    finally:
        _set_kernels(model, True)
    log(f"[{tag}] kernel vs plain version at the model's inputs "
        f"(one val image, {len(seen)} calls): worst l1_rel "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (bound < {BNECK_L1_TOL}); largest inputs "
        + ", ".join(f"{k} {v[1]}" for k, v in largest.items())
        + "; the unfused bf16 block vs the same "
        f"plain version {unfused:.3e} (not held)")
    if len(seen) != calls or max(worst.values()) >= BNECK_L1_TOL:
        raise AssertionError(f"kernels at trained inputs: {worst}, "
                             f"{len(seen)} calls")


def phase_train(card_info: str, root: str) -> dict:
    """``train_cityscapes.yaml`` at full width (W48 HRNet_Mscale, two-scale
    1024x2048 fwd+bwd in bf16, RMI + aux + mscale CE, SGD + poly, remat of
    stages 1-3, the uint8 wire) through the CLI's code, bs 1, two epochs of
    TRAIN_STEPS steps over as many train scenes of the seeded Cityscapes
    tree, each epoch validated over TRAIN_VAL_IMAGES images at three scales
    with both kernels on. Held: finite losses,
    weights moved, the checkpoint read back, every packed bottleneck block
    fresh after the optimizer steps, each kernel vs its plain version at
    the trained model's inputs, the launch counts. Returns each kernel's
    launches in the two validations."""
    from tpuseg_torch.cli.main import load_config, main as cli_main
    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.models import get_model
    from tpuseg_torch.ops import device_normalize
    from tpuseg_torch.train.checkpoint import CheckpointManager

    out_dir = Path("chiprun_out/train")
    out_dir.mkdir(parents=True, exist_ok=True)
    # checkpoints (~0.6 GB each at W48) stay out of chiprun_out
    logdir = str(Path(root, "logs"))
    sub = _subset_tree(root, TRAIN_STEPS, TRAIN_VAL_IMAGES)
    sets = ["train.batch_size=1", "train.test_mode=true",
            "train.log_every=1", "model.use_pallas=true",
            "model.fused_stage1=true",
            f"dataset.cityscapes_dir={sub}",
            f"dataset.centroid_root={Path(sub, 'centroids')}"]
    argv = ["train", "--config", TRAIN_RECIPE, "--logdir", logdir]
    for item in sets:
        argv += ["--set", item]

    recorded: list = []
    undo = _spy_validation(recorded)
    stale = {"launches": 0, "stale": 0}
    undo_pack = _spy_packed_weights(stale)
    tee = _Tee(sys.stdout)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            rc = cli_main(argv)
    finally:
        undo()
        undo_pack()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("log.txt", "metrics.jsonl"):
        shutil.copy(Path(logdir, name), out_dir / name)
    if rc != 0:
        raise AssertionError(f"tpuseg_torch.cli train returned {rc}")
    text = tee.buf.getvalue()
    cfg = load_config(TRAIN_RECIPE, sets)

    lines = [json.loads(x) for x in
             Path(logdir, "metrics.jsonl").read_text().splitlines()]
    losses = [x["loss"] for x in lines if x["phase"] == "train"]
    log(f"[train] loss at steps 1..{len(losses)}: "
        + " ".join(f"{v:.4f}" for v in losses))
    if len(losses) != 2 * TRAIN_STEPS or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses {losses}")
    _log_rates("train", text, f"W48 two-scale 1024x2048 bf16, bs 1, remat "
               f"1-3, 3 scales and kernels on in validation, {card_info}")
    log(f"[train] whole CLI run {wall:.1f} s, peak device memory "
        f"{mem:.2f} GiB, on {card_info}")

    # the trained module: moved from its seeded init, and checkpointed
    runner = recorded[-1][0]
    model = runner.model
    trained = {k: v.detach().cpu() for k, v in
               model.state_dict().items()}
    init = get_model(eval_model_config(cfg),
                     seed=cfg.train.seed).state_dict()
    moved = {kind: [not torch.equal(trained[k], init[k])
                    for k in init if k.endswith(suffix)]
             for kind, suffix in (("parameters", ("weight", "bias")),
                                  ("BN running stats",
                                   ("running_mean", "running_var")))}
    log("[train] moved from the init: " + ", ".join(
        f"{sum(v)}/{len(v)} {k}" for k, v in moved.items()))
    if any(sum(v) < 0.99 * len(v) for v in moved.values()):
        raise AssertionError("training left the weights in place")
    ckpt = CheckpointManager(str(Path(logdir, cfg.train.checkpoint_dir)))
    step = ckpt.latest_step()
    saved = ckpt.restore()["model"]
    same = all(torch.equal(saved[k], v) for k, v in trained.items())
    log(f"[train] checkpoint step {step} restored, equal to the "
        f"trained module: {same}")
    if step != 2 * TRAIN_STEPS or not same:
        raise AssertionError(f"checkpoint step {step}, equal {same}")

    # the packed-weight cache after the optimizer steps: every block
    # the kernel was given vs a fresh fold + pack of that moment
    log(f"[train] packed bottleneck weights checked against a fresh "
        f"fold + pack at every launch of the validations: "
        f"{stale['launches']} launches, {stale['stale']} stale")
    if stale["stale"] or stale["launches"] != 9 * 2 * TRAIN_VAL_IMAGES:
        raise AssertionError(f"stale packed weights: {stale}")

    # held: each kernel vs its plain version at the inputs the trained
    # model gives it. Printed: the last validation's argmax (kernels
    # on) vs the same weights with kernels off. The steps leave a net of
    # so high a gain that the fused block's f32 folded-BN math and the
    # unfused block's bf16 conv -> BN passes flip some argmaxes; the
    # spread between runs is in PERF.md
    _, val_loader, _ = setup_data(cfg, eval_mode="val",
                                  seed=cfg.train.seed)
    batches = [b for _, b in zip(range(TRAIN_VAL_IMAGES), val_loader)]
    on = recorded[-TRAIN_VAL_IMAGES:]
    model.eval()
    _set_kernels(model, False)
    for batch in batches:
        runner.run_batch(batch, need_assets=False, acc=runner.init_acc())
    off = recorded[-TRAIN_VAL_IMAGES:]
    _kernels_at_trained_inputs(model, device_normalize(
        torch.from_numpy(batches[0]["image"]).cuda()))
    model.train()
    agree = float(torch.stack([(a[1] == b[1]).float().mean()
                               for a, b in zip(on, off)]).mean())
    std = float(torch.stack([b[2] for b in off]).mean())
    log(f"[train] the last validation (kernels on) vs the same weights "
        f"with kernels off: argmax agreement {agree:.5f} over "
        f"{TRAIN_VAL_IMAGES} images (not held; logit std {std:.1f})")

    # the validations launched both kernels on every image
    want = {"ocr_attention": 3 * 2 * TRAIN_VAL_IMAGES,
            "bottleneck_fused": 9 * 2 * TRAIN_VAL_IMAGES,
            "bottleneck_fused_any": 0, "dilated_conv": 0}
    log(f"[train] validation launches {launches} (want {want}: 3 attention "
        f"and 9 bottleneck calls an image, 2 validations)")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    return launches


def phase_train_remat(card_info: str) -> None:
    """W48 bf16 1024x2048, the recipe's step, REMAT_STEPS steps from one
    weight draw on one seeded scene with remat_stages [1, 2, 3] and then
    with remat off: the first step's loss and BN running statistics held,
    peak memory and s/step printed. The remat side's model then gives
    [train-profile] one more step."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.models import get_model

    image, _, tid = _fake_scene(7)
    label = tid.copy()
    label[:64] = 255
    batch = {"image": torch.from_numpy(image[None]).cuda(),
             "label": torch.from_numpy(label[None]).cuda()}
    base = get_model(load_config(TRAIN_RECIPE, [])).state_dict()
    sides = {}
    for name, sets in (("remat 1-3", []), ("no remat", ["model.remat=false"])):
        cfg = load_config(TRAIN_RECIPE, ["train.batch_size=1"] + sets)
        model = get_model(cfg)
        model.load_state_dict(base)
        model = model.cuda().to(memory_format=torch.channels_last).train()
        step, opt = _train_step_of(cfg, model)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(1)  # the same dropout masks on both sides
        times, first = [], None
        for i in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(model, opt, batch, i)["loss"])
            times.append(time.perf_counter() - t0)
            if first is None:
                first = (loss, _stats(model))
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        sides[name] = first
        log(f"[train-remat] {name}: step 1 loss {first[0]:.4f}, peak "
            f"device memory {mem:.2f} GiB, steps 2-{REMAT_STEPS} "
            f"{np.mean(times[1:]):.4f} s/step (step 1 {times[0]:.3f} s) "
            f"(W48 two-scale 1024x2048 bf16, bs 1, {card_info})")
        if name == "remat 1-3":
            _profile(lambda: step(model, opt, batch, REMAT_STEPS), card_info,
                     what="one train step (remat 1-3)",
                     out_name="train_profile_top.txt", tag="train-profile",
                     inference=False)
        del model, opt, step
    (l_on, s_on), (l_off, s_off) = sides.values()
    got = {"loss_rel": abs(l_on - l_off) / abs(l_off),
           "stats_l1": _tree_l1(s_on, s_off)}
    log("[train-remat] remat 1-3 vs no remat after step 1: " + ", ".join(
        f"{k} {v:.3e} (bound {REMAT_TOL[k]})" for k, v in got.items()))
    bad = [k for k, v in got.items() if not v <= REMAT_TOL[k]]
    if bad:
        raise AssertionError(f"[train-remat] out of bounds: {bad}")


# ------------------------------------------------- the ASPP-headed zoo

DEEPV3_RECIPE = "tpuseg_torch/cli/recipes/train_cityscapes_deepv3.yaml"
ZOO_HW = (128, 256)  # [zoo-parity]: card vs CPU, f32, TF32 off
ZOO_PARITY_TOL = 1e-4  # logits, L1-relative
ZOO_EVAL_CALLS = 2  # [zoo-eval]: forwards an arch; 2..N are timed
# factories that build the network of another ([zoo-parity] holds their
# weights equal): [zoo-eval] times that one
ZOO_SAME_NET = {"deepv3.DeepV3PlusW38I": "deepv3.DeepV3PlusW38",
                "deepv3.DeepWV3Plus": "deepv3.DeepV3PlusW38"}
RELAXED_TRAIN_IMAGES = 5  # [relaxed]: 5 steps an epoch at batch 1
RELAXED_TOL = 1e-5  # relaxed_soft_nll card vs CPU, value and gradient


def _zoo_archs(parity: bool = False) -> list:
    """The zoo: the ten DeepLabV3 / V3+ factories, HRNet_ASPP_OCR, and
    the attention-scale family's 25 factories (``parity``: one a class)."""
    from tpuseg_torch.models import PORTED

    family = FAMILY_PARITY if parity else [
        f"{m}.{f}" for m in FAMILY for f in PORTED[m]]
    return [f"deepv3.{f}" for f in PORTED["deepv3"]] + [
        "ocrnet.HRNet_ASPP_OCR", *family]


def _zoo_model(arch: str, evaluate: bool = False, **sets):
    """``arch`` at full width from get_model, with ``_condition``'s seeded
    weights, in eval mode: on the CPU, or for ``evaluate`` on the card
    (its generator is seconds faster for the wide nets) as the eval entry
    points build it (the mscale archs' n-scale fusion over
    eval.scales)."""
    from tpuseg_torch.config import eval_model_config, make_config
    from tpuseg_torch.models import get_model

    cfg = make_config({"model.arch": arch, **sets})
    model = get_model(eval_model_config(cfg) if evaluate else cfg)
    if evaluate:
        model = model.cuda()
    _condition(model, seed=0)
    return model.eval()


def phase_zoo_parity(card_info: str) -> None:
    """Every factory of the slice at full width, f32 with TF32 off, on one
    seeded image: the logits on the card vs on the CPU (L1-relative held,
    max|d| printed). cuDNN's dilated, grouped and depthwise convs against
    the CPU's. Factories that build the same network from the same seed
    (W38, W38I, DeepWV3Plus) share the CPU forward, their weights held
    equal."""
    x = torch.from_numpy(np.random.RandomState(5).randn(
        1, *ZOO_HW, 3).astype(np.float32))
    cpu = {}  # network -> (state dict, CPU logits)
    bad = []
    t_all = time.perf_counter()
    for arch in _zoo_archs(parity=True):
        model = _zoo_model(arch, **{"model.compute_dtype": "float32"})
        state = model.state_dict()
        net = (type(model).__name__, tuple(
            (k, tuple(v.shape)) for k, v in state.items()))
        t0 = time.perf_counter()
        if net in cpu and all(torch.equal(v, cpu[net][0][k])
                              for k, v in state.items()):
            want, how = cpu[net][1], "the same network's CPU forward"
        else:
            with torch.inference_mode():
                want = model(x)["pred"]
            cpu[net] = (state, want)
            how = f"CPU forward {time.perf_counter() - t0:.1f} s"
        model = model.cuda().to(memory_format=torch.channels_last)
        with torch.inference_mode():
            got = model(x.cuda())["pred"].cpu()
        max_abs, l1 = compare(got, want)
        ok = (got.shape == (1, *ZOO_HW, 19) and bool(torch.isfinite(got)
                                                     .all())
              and l1 <= ZOO_PARITY_TOL)
        log(f"[zoo-parity] {arch} f32 1x{ZOO_HW[0]}x{ZOO_HW[1]}, card vs "
            f"CPU ({how}): l1_rel {l1:.3e} (bound {ZOO_PARITY_TOL}), max|d| "
            f"{max_abs:.3e}, max|logit| {float(want.abs().max()):.3f}, on "
            f"{card_info}")
        if not ok:
            bad.append(arch)
        del model, got
        torch.cuda.empty_cache()
    log(f"[zoo-parity] {len(_zoo_archs(parity=True))} factories in "
        f"{time.perf_counter() - t_all:.1f} s")
    if bad:
        raise AssertionError(f"[zoo-parity] out of bounds: {bad}")


# bf16 3x3 convs of the zoo at their 1024x2048 shapes:
# (what, C_in, C_out, dilation, feature H x W)
ZOO_CONVS = (("HRNet_ASPP_OCR ASPP rate 12, 1.0x", 720, 256, 12, (256, 512)),
             ("ResNet-50 layer4 conv2, dilation 4", 512, 512, 4, (128, 256)))


def _conv_algorithms(card_info: str) -> None:
    """Each of ZOO_CONVS timed with CUDA events (median of 2 calls after a
    warm-up) under cuDNN's default algorithm choice and under
    ``cudnn.benchmark``, on channels_last and on contiguous NCHW input,
    and by the dilated conv kernel where it takes the conv (median of REPS
    calls after a warm-up)."""
    import torch.nn.functional as F

    from tpuseg_torch.kernels import dilated_conv as dc

    flag = torch.backends.cudnn.benchmark
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for what, cin, cout, d, (h, w) in ZOO_CONVS:
            x = torch.randn(1, cin, h, w, device="cuda", generator=gen,
                            dtype=torch.bfloat16)
            wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen,
                             dtype=torch.bfloat16) * cin ** -0.5
            row = []
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench
                for fmt in (torch.channels_last, torch.contiguous_format):
                    xf, wf = (x.contiguous(memory_format=fmt),
                              wt.contiguous(memory_format=fmt))
                    times = []
                    with torch.inference_mode():
                        for i in range(3):
                            start = torch.cuda.Event(enable_timing=True)
                            end = torch.cuda.Event(enable_timing=True)
                            start.record()
                            F.conv2d(xf, wf, padding=d, dilation=d)
                            end.record()
                            end.synchronize()
                            if i:
                                times.append(start.elapsed_time(end))
                    row.append(f"{'benchmark' if bench else 'default'} "
                               f"{'NHWC' if fmt is torch.channels_last else 'NCHW'}"
                               f" {np.median(times):.3f} ms")
            if dc.supports(x, wt, dilation=(d, d)):
                # the port's route for it since the dilated conv kernel
                xc = x.contiguous(memory_format=torch.channels_last)
                with torch.inference_mode():
                    ms = time_ms(lambda x: dc.dilated_conv3x3(
                        x, wt, (d, d), d), [(xc,)], inner=1)
                row.append(f"the dilated conv kernel {ms:.3f} ms")
            flops = 2.0 * h * w * cout * cin * 9
            log(f"[zoo-eval] conv {what}: {cin}->{cout} 3x3 at {h}x{w} "
                f"bf16 ({flops / BF16_FLOPS * 1e3:.3f} ms at the bf16 "
                f"peak): " + ", ".join(row) + f"; {card_info}")
    finally:
        torch.backends.cudnn.benchmark = flag


def phase_zoo_eval(card_info: str) -> None:
    """Every factory of the slice at full width, bf16, eval, on one seeded
    uint8 1024x2048 image normalized on the card (one of the factories
    that build one network, ZOO_SAME_NET): ms a forward over calls 2..N,
    peak device memory and parameter count printed; finite logits of the
    image's shape held."""
    from tpuseg_torch.ops import device_normalize

    _conv_algorithms(card_info)
    image, _, _ = _fake_scene(1001)
    x = device_normalize(torch.from_numpy(image[None]).cuda())
    bad = []
    for arch in _zoo_archs():
        if arch in ZOO_SAME_NET:
            log(f"[zoo-eval] {arch}: the network of {ZOO_SAME_NET[arch]}, "
                f"timed there")
            continue
        model = _zoo_model(arch, evaluate=True)
        n_params = sum(p.numel() for p in model.parameters())
        model = model.to(memory_format=torch.channels_last)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with torch.inference_mode():
            for _ in range(ZOO_EVAL_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred = model(x)["pred"]
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ok = pred.shape == (1, *SCENE_HW, 19) and bool(
            torch.isfinite(pred).all())
        log(f"[zoo-eval] {arch} bf16 1x1024x2048: "
            f"{np.mean(times[1:]) * 1e3:.2f} ms a forward (calls "
            f"2-{ZOO_EVAL_CALLS}; call 1 {times[0] * 1e3:.0f} ms), peak "
            f"device memory {mem:.2f} GiB, {n_params} parameters, logits "
            f"{tuple(pred.shape)} finite {ok}, on {card_info}")
        if not ok:
            bad.append(arch)
        del model, pred
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"[zoo-eval] bad logits: {bad}")


def _resize_nhwc(x, scale: float):
    from tpuseg_torch.ops import resize_x

    return resize_x(x.permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)


def phase_aspp_ocr(card_info: str, root: str) -> dict:
    """HRNet_ASPP_OCR at full width (W48 -> ASPP -> OCR, bf16) through
    EvalRunner at the outer scales {1.0, 0.5, 2.0} over the seeded val
    images with both kernels on, its BN statistics calibrated on one val
    scene. Held: 3 attention, 9 bottleneck and 9 dilated conv launches an
    image, each kernel vs its plain version at the model's own inputs,
    kernels on vs off (logit std and argmax agreement, as [on/off]).
    Printed: img/s.
    Returns the launches of the val images' run."""
    from tpuseg_torch.config import make_config
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.evaluation.inference import EvalRunner
    from tpuseg_torch.models import get_model
    from tpuseg_torch.ops import device_normalize

    cfg = make_config({"model.arch": "ocrnet.HRNet_ASPP_OCR",
                       "model.use_pallas": True, "model.fused_stage1": True,
                       "dataset.name": "cityscapes",
                       "dataset.cityscapes_dir": root})
    model = get_model(cfg, seed=cfg.train.seed)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    scene, _, _ = _fake_scene(1000)
    x = device_normalize(torch.from_numpy(scene[None]).cuda())

    def three_scales():
        return [model(_resize_nhwc(x, s)) for s in SCALES]

    _set_kernels(model, False)
    _calibrate_bn(model, x, run=three_scales)
    _set_kernels(model, True)

    _, loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    batches = [b for _, b in zip(range(VAL_IMAGES), loader)]
    runner = EvalRunner(model, 19, scales=(1.0, 0.5, 2.0), is_mscale=False,
                        device="cuda")
    acc = runner.init_acc()
    reset_launches()
    t0 = None
    for i, batch in enumerate(batches):
        _, acc = runner.run_batch(batch, need_assets=False, acc=acc)
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    hist = runner.drain(acc)[0]
    img_s = (len(batches) - 1) / (time.perf_counter() - t0)
    launches = launch_counts()
    # ASPP's 3 rates at each of the 3 scales an image
    _hold_launches("aspp-ocr", launches, len(batches), per=(3, 9, 0, 9))
    log(f"[aspp-ocr] HRNet_ASPP_OCR (W48 + ASPP + OCR) bf16, outer scales "
        f"(1.0, 0.5, 2.0), {len(batches)} 1024x2048 val images: "
        f"{img_s:.4f} img/s (images 2-{len(batches)}), {int(hist.sum())} "
        f"pixels scored, on {card_info}")

    _kernels_at_trained_inputs(model, x, forward=three_scales,
                               tag="aspp-ocr")

    # kernels on vs off, each against the same weights' f32 forward
    # (kernels off): the kernels compute the block's and the attention's
    # math with f32 accumulation, the unfused bf16 path rounds more, so the
    # side with the kernels must be no farther from f32 than the other
    image = torch.from_numpy(batches[0]["image"]).cuda()
    label = torch.from_numpy(batches[0]["label"]).cuda()
    ref = copy.deepcopy(model).float()
    ref.backbone.dtype = torch.float32
    _set_kernels(ref, False)
    ref_runner = EvalRunner(ref, 19, scales=(1.0, 0.5, 2.0), is_mscale=False,
                            device="cuda")
    with torch.inference_mode():
        f32 = ref_runner.forward(image, label, ref_runner.init_acc())[0]
        logits = {}
        for on in (True, False):
            _set_kernels(model, on)
            logits[on] = runner.forward(image, label, runner.init_acc())[0]
    _set_kernels(model, True)
    del ref, ref_runner

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    on, off = logits[True], logits[False]
    std = float(off.std())
    gap = {k: (agree(v, f32), compare(v, f32)[1]) for k, v in
           (("on", on), ("off", off))}
    log(f"[aspp-ocr] one val image, 3 scales, logit std {std:.4f} (bound "
        f"1e-2..1e2); vs the f32 forward: kernels on argmax agreement "
        f"{gap['on'][0]:.5f}, l1_rel {gap['on'][1]:.3e}; kernels off "
        f"{gap['off'][0]:.5f}, {gap['off'][1]:.3e} (held: on no farther "
        f"than off); on vs off argmax agreement {agree(on, off):.5f}, "
        f"l1_rel {compare(on, off)[1]:.3e} (printed), on {card_info}")
    if not (torch.isfinite(on).all() and torch.isfinite(off).all()):
        raise AssertionError("[aspp-ocr] non-finite logits")
    if not (1e-2 <= std <= 1e2 and gap["on"][1] <= gap["off"][1]
            and gap["on"][0] >= gap["off"][0] - 0.005):
        raise AssertionError(f"[aspp-ocr] on/off vs f32: std {std}, {gap}")
    del model, runner
    torch.cuda.empty_cache()
    return launches


def _spy_drains(sums: list):
    """Wrap EvalRunner.drain so that each drain leaves the number of pixels
    its confusion matrix counts; returns the undo."""
    from tpuseg_torch.evaluation import inference

    orig = inference.EvalRunner.drain

    def drain(self, acc):
        out = orig(self, acc)
        sums.append(int(out[0].sum()))
        return out

    inference.EvalRunner.drain = drain
    return lambda: setattr(inference.EvalRunner, "drain", orig)


def _run_train_cli(logdir: str, sets: list):
    """``python -m tpuseg_torch.cli train --config DEEPV3_RECIPE`` in this
    process, its output teed: -> (stdout text, wall seconds)."""
    from tpuseg_torch.cli.main import main as cli_main

    argv = ["train", "--config", DEEPV3_RECIPE, "--logdir", logdir]
    for item in sets:
        argv += ["--set", item]
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli_main(argv)
    if rc != 0:
        raise AssertionError(f"tpuseg_torch.cli train returned {rc}")
    return tee.buf.getvalue(), time.perf_counter() - t0


def _train_losses(logdir: str, steps: int) -> list:
    lines = [json.loads(x) for x in
             Path(logdir, "metrics.jsonl").read_text().splitlines()]
    losses = [x["loss"] for x in lines if x["phase"] == "train"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses {losses}")
    return losses


def _log_rates(tag: str, text: str, what: str) -> None:
    for m in re.finditer(r"epoch (\d+): (\d+) steps on \S+, steps "
                         r"2-\d+: ([\d.]+) s/step, ([\d.]+) img/s; host "
                         r"data wait ([\d.]+) ms/step( \(steps 2-\d+ "
                         r"[\d.]+ ms/step\))?", text):
        log(f"[{tag}] epoch {m.group(1)}: steps 2-{m.group(2)} "
            f"{m.group(3)} s/step, {m.group(4)} img/s, host data wait "
            f"{m.group(5)} ms/step{m.group(6) or ''} ({what})")
    for m in re.finditer(r"validate: (\d+) images on \S+ in ([\d.]+) "
                         r"s, ([\d.]+) s/image", text):
        log(f"[{tag}] validation: {m.group(1)} images, {m.group(3)} "
            f"s/image ({what})")


def phase_deepv3_train(card_info: str, root: str) -> dict:
    """``train_cityscapes_deepv3.yaml`` (DeepV3PlusW38 at full width, 800x800
    crops, bf16, plain CE, SGD + poly 2, the WRN38 blocks remat'd, the
    uint8 wire) through the CLI's code, bs 1, two epochs of TRAIN_STEPS
    steps over as many seeded Cityscapes train scenes, each validated over
    TRAIN_VAL_IMAGES images at 1024x2048.
    Held: finite losses, parameters and BN statistics moved, the checkpoint
    written, equal to the trained module and resumed by a second run, each
    validation's confusion matrix counting every labelled pixel, and the
    first run's launches: the dilated conv's 3 a forward (ASPP's rates, a
    train step or a val image), no other kernel's. Returns those
    launches."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.models import get_model
    from tpuseg_torch.train.checkpoint import CheckpointManager

    out_dir = Path("chiprun_out/deepv3_train")
    out_dir.mkdir(parents=True, exist_ok=True)
    logdir = str(Path(root, "deepv3_logs"))  # checkpoints stay out
    sub = _subset_tree(root, TRAIN_STEPS, TRAIN_VAL_IMAGES)
    sets = ["train.batch_size=1", "train.test_mode=true",
            "train.log_every=1", f"dataset.cityscapes_dir={sub}",
            f"dataset.centroid_root={Path(sub, 'centroids')}"]
    recorded, sums = [], []
    undo, undo_drain = _spy_validation(recorded), _spy_drains(sums)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        text, wall = _run_train_cli(logdir, sets)
    finally:
        undo()
        undo_drain()
    launches = launch_counts()
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("log.txt", "metrics.jsonl"):
        shutil.copy(Path(logdir, name), out_dir / name)
    cfg = load_config(DEEPV3_RECIPE, sets)
    steps = 2 * TRAIN_STEPS
    losses = _train_losses(logdir, steps)
    log(f"[deepv3-train] loss at steps 1..{steps}: "
        + " ".join(f"{v:.4f}" for v in losses))
    what = (f"DeepV3PlusW38 800x800 bf16, bs 1, WRN38 blocks remat'd, "
            f"{card_info}")
    _log_rates("deepv3-train", text, what)
    log(f"[deepv3-train] whole CLI run {wall:.1f} s, peak device memory "
        f"{mem:.2f} GiB, on {card_info}")

    # every labelled val pixel counted, once a validation
    _, val_loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    labelled = sum(int((np.asarray(b["label"]) != 255).sum())
                   for b in val_loader)
    log(f"[deepv3-train] validation confusion matrices count {sums} pixels "
        f"(want {labelled} labelled pixels each)")
    if sums != [labelled, labelled]:
        raise AssertionError(f"confusion matrices count {sums}")
    forwards = steps + len(recorded)
    want = {**dict.fromkeys(KERNELS, 0), "dilated_conv": 3 * forwards}
    log(f"[deepv3-train] launches {launches} (want {want}: 3 dilated conv "
        f"calls a forward, {steps} steps and {len(recorded)} val images)")
    if launches != want or len(recorded) != 2 * TRAIN_VAL_IMAGES:
        raise AssertionError(f"[deepv3-train] launch counts {launches} for "
                             f"{len(recorded)} val images")

    model = recorded[-1][0].model
    trained = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    init = get_model(eval_model_config(cfg),
                     seed=cfg.train.seed).state_dict()
    moved = {kind: [not torch.equal(trained[k], init[k])
                    for k in init if k.endswith(suffix)]
             for kind, suffix in (("parameters", ("weight", "bias")),
                                  ("BN running stats",
                                   ("running_mean", "running_var")))}
    log("[deepv3-train] moved from the init: " + ", ".join(
        f"{sum(v)}/{len(v)} {k}" for k, v in moved.items()))
    if any(sum(v) < 0.99 * len(v) for v in moved.values()):
        raise AssertionError("training left the weights in place")
    ckpt = CheckpointManager(str(Path(logdir, cfg.train.checkpoint_dir)))
    step = ckpt.latest_step()
    saved = ckpt.restore()["model"]
    same = all(torch.equal(saved[k], v) for k, v in trained.items())
    del saved
    del model, recorded
    torch.cuda.empty_cache()
    text, _ = _run_train_cli(logdir, sets)  # a restart of the same run
    resumed = "resumed at epoch 2" in text
    log(f"[deepv3-train] checkpoint step {step}, equal to the trained "
        f"module: {same}; a second run resumed from it: {resumed}")
    if step != steps or not same or not resumed:
        raise AssertionError(f"checkpoint step {step}, equal {same}, "
                             f"resumed {resumed}")
    torch.cuda.empty_cache()
    return launches


def _subset_tree(root: str, n_train: int, n_val: int = VAL_IMAGES) -> str:
    """A Cityscapes tree beside ``root`` with its first ``n_train`` train
    scenes and first ``n_val`` val scenes (symlinks), made once."""
    sub = Path(root, f"subset_{n_train}" + (
        f"_{n_val}" if n_val != VAL_IMAGES else ""))
    if sub.exists():
        return str(sub)
    for part in ("leftImg8bit_trainvaltest/leftImg8bit",
                 "gtFine_trainvaltest/gtFine"):
        for split, city, n in (("train", "aachen", n_train),
                               ("val", "lindau", n_val)):
            src = Path(root, part, split, city)
            dst = sub / part / split / city
            dst.mkdir(parents=True)
            for f in sorted(src.iterdir()):
                if int(f.name.split("_")[1]) < n:
                    (dst / f.name).symlink_to(f)
    return str(sub)


def phase_relaxed(card_info: str, root: str) -> None:
    """The DeepLabV3+ recipe with label relaxation (loss.loss_type=relaxed,
    dataset.jointwtborder, loss.reduce_border_epoch=0) through the CLI's
    code, bs 1, two epochs of 5 steps. Held: epoch 1 (past the border
    epoch) ran the inverted criterion on the reduce_border targets, every
    loss finite; relaxed_soft_nll on the card vs the CPU at a seeded
    (1, 512, 1024, 19) logit tensor, value and gradient. Printed: s/step,
    the host label transform's ms a step and the target's bytes."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.data.relaxed_labels import relaxed_onehot
    from tpuseg_torch.data.setup import relaxed_label_transform
    from tpuseg_torch.losses import relaxed_soft_nll

    # the loss, card vs CPU
    _, _, tid = _fake_scene(7)
    target = torch.from_numpy(relaxed_onehot(tid[:512, :1024], 19)[None])
    logits = torch.from_numpy(2 * np.random.RandomState(9).randn(
        1, 512, 1024, 19).astype(np.float32))
    for invert in (False, True):
        vals, grads = [], []
        for dev in ("cpu", "cuda"):
            x = logits.detach().to(dev).requires_grad_(True)
            loss = relaxed_soft_nll(x, target.to(dev), invert_border=invert)
            loss.backward()
            vals.append(loss.detach().double().cpu())
            grads.append(x.grad.cpu())
        v_rel = float((vals[1] - vals[0]).abs() / vals[0].abs())
        g_rel = compare(grads[1], grads[0])[1]
        log(f"[relaxed] relaxed_soft_nll (1, 512, 1024, 19) invert_border="
            f"{invert}, card vs CPU: value rel {v_rel:.3e}, gradient l1_rel "
            f"{g_rel:.3e} (bound {RELAXED_TOL}), on {card_info}")
        if not (v_rel <= RELAXED_TOL and g_rel <= RELAXED_TOL):
            raise AssertionError(f"[relaxed] card vs CPU: {v_rel}, {g_rel}")

    tree = _subset_tree(root, RELAXED_TRAIN_IMAGES, TRAIN_VAL_IMAGES)
    logdir = str(Path(root, "relaxed_logs"))
    sets = ["train.batch_size=1", "train.test_mode=true",
            "train.log_every=1", "loss.loss_type=relaxed",
            "dataset.jointwtborder=true", "loss.reduce_border_epoch=0",
            f"dataset.cityscapes_dir={tree}",
            f"dataset.centroid_root={Path(root, 'centroids_subset')}"]
    torch.cuda.reset_peak_memory_stats()
    text, wall = _run_train_cli(logdir, sets)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = _train_losses(logdir, 2 * RELAXED_TRAIN_IMAGES)
    log(f"[relaxed] loss at steps 1..{len(losses)}: "
        + " ".join(f"{v:.4f}" for v in losses))
    flips = re.findall(r"epoch (\d): relaxed loss invert_border=(\w+), "
                       r"label transform reduce_border=(\w+)", text)
    log(f"[relaxed] border schedule (epoch, invert_border, reduce_border): "
        f"{flips}")
    if flips != [("0", "False", "False"), ("1", "True", "True")]:
        raise AssertionError(f"[relaxed] border schedule {flips}")
    _log_rates("relaxed", text, f"DeepV3PlusW38 800x800 bf16, relaxed loss, "
               f"bs 1, {card_info}")

    cfg = load_config(DEEPV3_RECIPE, sets)
    crop = tid[:800, :800]
    for reduce in (False, True):
        fn = relaxed_label_transform(cfg, 255, reduce_border=reduce)
        fn(crop)
        t0 = time.perf_counter()
        for _ in range(5):
            out = fn(crop)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        log(f"[relaxed] host label transform reduce_border={reduce}: "
            f"{ms:.1f} ms a 800x800 label (one a step at bs 1), target "
            f"{out.shape} {out.dtype}, {out.nbytes / crop.size:.0f}x the "
            f"uint8 label's bytes")
    log(f"[relaxed] whole CLI run {wall:.1f} s, peak device memory "
        f"{mem:.2f} GiB, on {card_info}")


# ----------------------------------------- the attention-scale family

FAMILY = ("mscale", "mscale2", "attnscale", "basic", "deeper")
# [zoo-parity]: one factory a class of the family (the fused-ASPP,
# 2-channel V3Plus for MscaleV3Plus)
FAMILY_PARITY = ("mscale.DeepV3W38Fuse2", "mscale.DeeperX71",
                 "mscale.HRNet", "mscale.HRNet_ASP", "mscale2.DeepV3R50",
                 "mscale2.HRNet", "attnscale.DeepV3R50",
                 "attnscale.DeepV3R50BP", "basic.HRNet", "basic.HRNet_ASP",
                 "deeper.DeeperW38")
MAPILLARY_RECIPE = "tpuseg_torch/cli/recipes/eval_mapillary.yaml"
MAPILLARY_TRAIN_RECIPE = "tpuseg_torch/cli/recipes/train_mapillary.yaml"
# ragged Mapillary scenes, long side 2048-2304: pre_size 2177 resizes each
MAPILLARY_VAL_HW = ((1536, 2048), (1728, 2304), (1600, 2176))
MAPILLARY_TRAIN_HW = ((1536, 2048), (1728, 2304), (1632, 2176),
                      (1536, 2240), (1664, 2208))


def _mscale_forward(model, x, scales):
    """The single-scale passes of an attention-scale model at ``scales``
    (its ``_fwd`` over the resized NCHW image)."""
    from tpuseg_torch.ops import resize_x

    xc = x.permute(0, 3, 1, 2)
    return [model._fwd(resize_x(xc, s)) for s in scales]


def _on_off_vs_f32(tag: str, model, runner_kw: dict, image, label,
                   card_info: str, hold: bool = True) -> None:
    """Kernels on vs off, each against the same weights' f32 forward with
    the kernels off, through EvalRunner on one image (as [aspp-ocr]):
    held (unless ``hold`` is False: printed), the kernels' side no
    farther from f32 than the other."""
    from tpuseg_torch.evaluation.inference import EvalRunner

    ref = copy.deepcopy(model).float()
    ref.backbone.dtype = torch.float32
    _set_kernels(ref, False)
    runner = EvalRunner(model, device="cuda", **runner_kw)
    ref_runner = EvalRunner(ref, device="cuda", **runner_kw)
    with torch.inference_mode():
        f32 = ref_runner.forward(image, label, ref_runner.init_acc())[0]
        logits = {}
        for on in (True, False):
            _set_kernels(model, on)
            logits[on] = runner.forward(image, label, runner.init_acc())[0]
    _set_kernels(model, True)
    del ref, ref_runner

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    on, off = logits[True], logits[False]
    std = float(off.std())
    gap = {k: (agree(v, f32), compare(v, f32)[1]) for k, v in
           (("on", on), ("off", off))}
    log(f"[{tag}] one val image, logit std {std:.4f} (bound 1e-2..1e2); vs "
        f"the f32 forward: kernels on argmax agreement {gap['on'][0]:.5f}, "
        f"l1_rel {gap['on'][1]:.3e}; kernels off {gap['off'][0]:.5f}, "
        f"{gap['off'][1]:.3e} (held: on no farther than off); on vs off "
        f"argmax agreement {agree(on, off):.5f}, l1_rel "
        f"{compare(on, off)[1]:.3e} (printed), on {card_info}")
    if not (torch.isfinite(on).all() and torch.isfinite(off).all()):
        raise AssertionError(f"[{tag}] non-finite logits")
    if hold and not (1e-2 <= std <= 1e2 and gap["on"][1] <= gap["off"][1]
                     and gap["on"][0] >= gap["off"][0] - 0.005):
        raise AssertionError(f"[{tag}] on/off vs f32: std {std}, {gap}")


def phase_mscale_eval(card_info: str, root: str) -> dict:
    """``mscale.HRNet`` (MscaleBasic on the W48 trunk) at full width
    through EvalRunner: n-scale fusion at {0.5, 1.0, 2.0} in the model,
    bf16, ``model.fused_stage1`` on, its BN statistics calibrated on one
    val scene, over the seeded val scenes. Held: 9 bottleneck and 0
    attention launches an image, the kernel vs its plain version at the
    model's own inputs, kernels on vs off against the f32 forward.
    Printed: img/s and peak memory. Returns the launches."""
    from tpuseg_torch.config import eval_model_config, make_config
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.evaluation.inference import EvalRunner
    from tpuseg_torch.models import get_model
    from tpuseg_torch.ops import device_normalize

    cfg = eval_model_config(make_config({
        "model.arch": "mscale.HRNet", "model.fused_stage1": True,
        "dataset.name": "cityscapes", "dataset.cityscapes_dir": root}))
    model = get_model(cfg, seed=cfg.train.seed)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    scene, _, _ = _fake_scene(1000)
    x = device_normalize(torch.from_numpy(scene[None]).cuda())
    three = lambda: _mscale_forward(model, x, SCALES)  # noqa: E731

    _set_kernels(model, False)
    _calibrate_bn(model, x, run=three)
    _set_kernels(model, True)

    _, loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    batches = [b for _, b in zip(range(VAL_IMAGES), loader)]
    runner = EvalRunner(model, 19, is_mscale=True, device="cuda")
    acc = runner.init_acc()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = None
    for i, batch in enumerate(batches):
        _, acc = runner.run_batch(batch, need_assets=False, acc=acc)
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    hist = runner.drain(acc)[0]
    img_s = (len(batches) - 1) / (time.perf_counter() - t0)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = launch_counts()
    _hold_launches("mscale-eval", launches, len(batches), per=(0, 9, 0, 0))
    log(f"[mscale-eval] mscale.HRNet (W48 MscaleBasic) bf16, n-scale "
        f"{cfg.model.n_scales} in the model, {len(batches)} 1024x2048 val "
        f"images: {img_s:.4f} img/s (images 2-{len(batches)}), peak device "
        f"memory {mem:.2f} GiB, {int(hist.sum())} pixels scored, on "
        f"{card_info}")
    _profile(lambda: runner.run_batch(batches[1], need_assets=False,
                                      acc=acc), card_info, top=8,
             what="one mscale.HRNet image (3 scales)",
             out_name="mscale_profile_top.txt", tag="mscale-eval")
    _kernels_at_trained_inputs(model, x, forward=three, tag="mscale-eval",
                               calls=9)
    _on_off_vs_f32("mscale-eval", model, {"num_classes": 19},
                   torch.from_numpy(batches[0]["image"]).cuda(),
                   torch.from_numpy(batches[0]["label"]).cuda(), card_info)
    del model, runner
    torch.cuda.empty_cache()
    return launches


def phase_mscale_train(card_info: str, root: str) -> None:
    """``train_cityscapes_deepv3.yaml`` with ``model.arch=mscale.DeepV3W38``
    (MscaleV3Plus on WRN38: two-scale fwd+bwd at 800x800, bf16, the WRN38
    blocks remat'd) through the CLI's code, bs 1, two epochs of TRAIN_STEPS
    steps over as many seeded Cityscapes train scenes, the second
    validated over TRAIN_VAL_IMAGES images at 1024x2048 with n-scale
    fusion. Held: finite losses, every
    ``scale_attn`` parameter moved, the validation's matrix counting every
    labelled pixel. Printed: s/step, host data wait, peak memory."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.models import get_model

    out_dir = Path("chiprun_out/mscale_train")
    out_dir.mkdir(parents=True, exist_ok=True)
    logdir = str(Path(root, "mscale_logs"))  # checkpoints stay out
    sub = _subset_tree(root, TRAIN_STEPS, TRAIN_VAL_IMAGES)
    sets = ["model.arch=mscale.DeepV3W38", "train.batch_size=1",
            "train.test_mode=true", "train.log_every=1", "train.val_freq=2",
            f"dataset.cityscapes_dir={sub}",
            f"dataset.centroid_root={Path(sub, 'centroids')}"]
    recorded, sums = [], []
    undo, undo_drain = _spy_validation(recorded), _spy_drains(sums)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        text, wall = _run_train_cli(logdir, sets)
    finally:
        undo()
        undo_drain()
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("log.txt", "metrics.jsonl"):
        shutil.copy(Path(logdir, name), out_dir / name)
    cfg = load_config(DEEPV3_RECIPE, sets)
    losses = _train_losses(logdir, 2 * TRAIN_STEPS)
    log(f"[mscale-train] loss at steps 1..{2 * TRAIN_STEPS}: "
        + " ".join(f"{v:.4f}" for v in losses))
    _log_rates("mscale-train", text, f"mscale.DeepV3W38 two-scale 800x800 "
               f"bf16, bs 1, WRN38 blocks remat'd, {card_info}")
    log(f"[mscale-train] whole CLI run {wall:.1f} s, peak device memory "
        f"{mem:.2f} GiB, on {card_info}")
    _, val_loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    labelled = sum(int((np.asarray(b["label"]) != 255).sum())
                   for b in val_loader)
    log(f"[mscale-train] validation confusion matrix counts {sums} pixels "
        f"(want {labelled} labelled pixels, one validation)")
    if sums != [labelled]:
        raise AssertionError(f"confusion matrices count {sums}")
    model = recorded[-1][0].model
    trained = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    init = get_model(eval_model_config(cfg),
                     seed=cfg.train.seed).state_dict()
    attn = [k for k in init if k.startswith("scale_attn.")
            and k.endswith(("weight", "bias"))]
    moved = [k for k in attn if not torch.equal(trained[k], init[k])]
    log(f"[mscale-train] scale_attn parameters moved from the init: "
        f"{len(moved)}/{len(attn)}")
    if not attn or len(moved) != len(attn):
        raise AssertionError(f"scale_attn parameters left in place: "
                             f"{sorted(set(attn) - set(moved))}")
    del model, recorded
    torch.cuda.empty_cache()


def _write_fake_mapillary(root: str) -> None:
    """A Mapillary tree: ``config.json`` with 66 labels (65 classes and the
    ignore class), and seeded ragged training / validation scenes (JPEG
    images, trainId PNG labels) built as ``_fake_scene``'s."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.RandomState(66)
    labels = [{"color": [int(c) for c in rng.randint(0, 256, 3)],
               "readable": f"class {i}", "instances": False}
              for i in range(66)]
    Path(root).mkdir(parents=True, exist_ok=True)
    Path(root, "config.json").write_text(json.dumps({"labels": labels}))
    palette = np.array([lb["color"] for lb in labels], np.int16)
    jobs = [("training", i, hw) for i, hw in enumerate(MAPILLARY_TRAIN_HW)] \
        + [("validation", i, hw) for i, hw in enumerate(MAPILLARY_VAL_HW)]

    def write(job):
        split, i, (h, w) = job
        r = np.random.RandomState(6600 + 100 * (split == "validation") + i)
        ids = r.randint(0, 66, (-(-h // BLOCK), -(-w // BLOCK)))
        tid = np.repeat(np.repeat(ids, BLOCK, 0), BLOCK, 1)[:h, :w]
        noise = r.randint(-24, 25, (h, w, 3)).astype(np.int16)
        image = np.clip(palette[tid] + noise, 0, 255).astype(np.uint8)
        for sub in ("images", "labels"):
            Path(root, split, sub).mkdir(parents=True, exist_ok=True)
        Image.fromarray(image).save(Path(root, split, "images",
                                         f"scene{i}.jpg"), quality=90)
        Image.fromarray(tid.astype(np.uint8)).save(
            Path(root, split, "labels", f"scene{i}.png"), compress_level=1)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))


def phase_mapillary_eval(card_info: str, mroot: str) -> dict:
    """``eval_mapillary.yaml`` as shipped (W48 HRNet_Mscale, 65 classes,
    scales 0.25 / 0.5 / 1.0 / 2.0 in the model, flip, pre_size 2177,
    ``pad_multiple`` 64, bf16 fusion, the uint8 wire) through
    ``evaluate_only`` over the seeded Mapillary tree's ragged val scenes
    (MAPILLARY_VAL_HW),
    with seeded weights whose BN statistics are calibrated on one of them.
    Held: 8 attention and 24 bottleneck launches an image, each kernel vs
    its plain version at the model's own inputs (K = 65, up to the 2.0x
    shapes). Printed: img/s and peak memory. Returns the launches."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.evaluation.inference import make_eval_forward
    from tpuseg_torch.models import get_model
    from tpuseg_torch.ops import device_normalize
    from tpuseg_torch.train.loop import evaluate_only

    sets = [f"dataset.mapillary_dir={mroot}", "model.use_pallas=true",
            "model.fused_stage1=true"]
    cfg = load_config(MAPILLARY_RECIPE, sets)
    _, loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    first = next(iter(loader))
    model = get_model(eval_model_config(cfg), seed=cfg.train.seed)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    x = device_normalize(torch.from_numpy(np.asarray(first["image"])).cuda())
    _set_kernels(model, False)
    _calibrate_bn(model, x)  # at the recipe's four scales
    _set_kernels(model, True)
    ckpt = str(Path(mroot, "calibrated.pth"))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)

    logdir = str(Path(mroot, "eval_logs"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        metrics = evaluate_only(cfg, logdir=logdir, checkpoint=ckpt,
                                device="cuda")
    wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = launch_counts()
    n = len(MAPILLARY_VAL_HW)
    _hold_launches("mapillary-eval", launches, n, per=(8, 24, 0, 0))
    img_s, mpx_s = _rate(tee.buf.getvalue())
    shapes = sorted({tuple(np.asarray(b["image"]).shape[1:3])
                     for b in loader})
    log(f"[mapillary-eval] W48 HRNet_Mscale, 65 classes, scales "
        f"{cfg.model.n_scales} x flip, bf16 fusion, {n} ragged val scenes "
        f"{list(MAPILLARY_VAL_HW)} -> pre_size {cfg.dataset.pre_size} "
        f"{shapes}, pad_multiple {cfg.eval.pad_multiple}: {img_s} img/s, "
        f"{mpx_s} Mpx/s (images 2-{n}), mIoU {metrics.mean_iou:.4f}, "
        f"{int(metrics.hist.sum())} pixels scored, whole evaluate_only "
        f"{wall:.1f} s, peak device memory {mem:.2f} GiB, on {card_info}")
    labelled = sum(int((np.asarray(b["label"]) != 65).sum()) for b in loader)
    if int(metrics.hist.sum()) != labelled:
        raise AssertionError(f"[mapillary-eval] scored {metrics.hist.sum()}"
                             f" pixels, {labelled} labelled")

    # the same images again through EvalRunner: each padded shape's first
    # image pays cuDNN's and the allocator's first calls, so time a
    # second round
    from tpuseg_torch.evaluation.inference import EvalRunner

    runner = EvalRunner(model, 65, do_flip=True, ignore_label=65,
                        pad_multiple=cfg.eval.pad_multiple, device="cuda")
    batches = list(loader)
    acc = runner.init_acc()
    rounds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            _, acc = runner.run_batch(batch, need_assets=False, acc=acc)
        torch.cuda.synchronize()
        rounds.append(len(batches) / (time.perf_counter() - t0))
    log(f"[mapillary-eval] EvalRunner over the same {len(batches)} images "
        f"twice: {rounds[0]:.4f} img/s, then {rounds[1]:.4f} img/s with "
        f"every padded shape seen, on {card_info}")
    _profile(lambda: runner.run_batch(batches[0], need_assets=False,
                                      acc=acc), card_info, top=8,
             what="one Mapillary image (4 scales x flip, 65 classes)",
             out_name="mapillary_profile_top.txt", tag="mapillary-eval")

    # the kernels at the model's inputs: one padded val image, flip x the
    # four scales (24 bottleneck and 8 attention calls)
    forward = make_eval_forward(model, 65, do_flip=True)
    pad = cfg.eval.pad_multiple
    h, w = np.asarray(first["image"]).shape[1:3]
    image = np.pad(np.asarray(first["image"]),
                   ((0, 0), (0, -h % pad), (0, -w % pad), (0, 0)))
    label = np.pad(np.asarray(first["label"]),
                   ((0, 0), (0, -h % pad), (0, -w % pad)),
                   constant_values=65)
    image, label = (torch.from_numpy(a).cuda() for a in (image, label))
    acc = {"hist": torch.zeros((65, 65), dtype=torch.int64, device="cuda"),
           "scale_hists": {}}
    _kernels_at_trained_inputs(
        model, x, forward=lambda: forward(image, label, acc, (h, w)),
        tag="mapillary-eval", calls=32)
    del model
    torch.cuda.empty_cache()
    return launches


def phase_mapillary_train(card_info: str, mroot: str) -> None:
    """``train_mapillary.yaml`` as shipped (W48 HRNet_Mscale, 1024x1024
    crops after pre_size 2177, gblur, class-uniform sampling at 0.5, RMI at
    65 classes, SGD + poly, the uint8 wire) through the CLI's code, bs 1,
    ``train.test_mode``, two epochs of 5 steps over the seeded Mapillary
    tree and one validation, after the second (``train.val_freq=2``).
    Held: finite losses, the validation's matrix counting every labelled
    pixel. Printed: s/step, host data wait, peak memory."""
    from tpuseg_torch.cli.main import load_config, main as cli_main
    from tpuseg_torch.data.setup import setup_data

    out_dir = Path("chiprun_out/mapillary_train")
    out_dir.mkdir(parents=True, exist_ok=True)
    logdir = str(Path(mroot, "train_logs"))
    sets = [f"dataset.mapillary_dir={mroot}", "train.batch_size=1",
            "train.test_mode=true", "train.log_every=1",
            "train.val_freq=2",
            f"dataset.centroid_root={Path(mroot, 'centroids')}"]
    argv = ["train", "--config", MAPILLARY_TRAIN_RECIPE, "--logdir", logdir]
    for item in sets:
        argv += ["--set", item]
    sums = []
    undo = _spy_drains(sums)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            rc = cli_main(argv)
    finally:
        undo()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"tpuseg_torch.cli train returned {rc}")
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("log.txt", "metrics.jsonl"):
        shutil.copy(Path(logdir, name), out_dir / name)
    n = len(MAPILLARY_TRAIN_HW)
    losses = _train_losses(logdir, 2 * n)
    log(f"[mapillary-train] loss at steps 1..{2 * n}: "
        + " ".join(f"{v:.4f}" for v in losses))
    _log_rates("mapillary-train", tee.buf.getvalue(),
               f"W48 HRNet_Mscale two-scale 1024x1024 bf16, RMI at 65 "
               f"classes, gblur, bs 1, {card_info}")
    cfg = load_config(MAPILLARY_TRAIN_RECIPE, sets)
    _, val_loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    labelled = sum(int((np.asarray(b["label"]) != 65).sum())
                   for b in val_loader)
    log(f"[mapillary-train] validation confusion matrix counts {sums} "
        f"pixels (want {labelled}, one validation); whole CLI run "
        f"{wall:.1f} s, peak device memory {mem:.2f} GiB, on {card_info}")
    if sums != [labelled]:
        raise AssertionError(f"confusion matrices count {sums}")
    torch.cuda.empty_cache()


# ------------------------------------------------ data-parallel training

# [ddp-train]'s tree: 4 train scenes (2 steps an epoch a rank at batch 2)
# and 2 val scenes (1 a rank: the val sampler does not pad)
DDP_TRAIN_IMAGES, DDP_VAL_IMAGES = 4, 2
# [ddp-parity]: two ranks vs one process, tiny f32 CE step on the card,
# TF32 off; cuDNN picks other algorithms at batch 1 than at batch 2
DDP_PARITY_TOL = {"loss_rel": 1e-5, "params_l1": 1e-5, "stats_l1": 1e-5}
RANK_TIMEOUT = 600  # seconds a launch of ranks may take
REFERENCE_MODULES = ("tpuseg", "jax", "jaxlib", "flax", "optax", "orbax")


def _reference_modules() -> list:
    """Loaded modules of tpuseg or JAX (none may be)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in REFERENCE_MODULES)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _processes() -> dict:
    """pid -> (parent pid, process group) of every process that is not a
    zombie, from /proc."""
    found = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            state, ppid, pgid = (d / "stat").read_text().rsplit(
                ")", 1)[1].split()[:3]
        except (OSError, ValueError):  # it ended while being read
            continue
        if state != "Z":
            found[int(d.name)] = (int(ppid), int(pgid))
    return found


def _wait_gone(alive, what: str, timeout: float = 30.0) -> None:
    """Return once ``alive(_processes())`` is empty; raise after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while left := alive(_processes()):
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what} still running: {left}")
        time.sleep(0.05)


def _kill_group(p: subprocess.Popen) -> None:
    """SIGKILL the process group that ``p`` leads (it was started with
    ``start_new_session``), reap ``p`` and wait until no process of the
    group runs."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(p.pid, signal.SIGKILL)
    p.wait()
    _wait_gone(lambda procs: [pid for pid, (_, g) in procs.items()
                              if g == p.pid], f"process group {p.pid}")


def _descendants() -> list:
    """The running processes below this one."""
    procs = _processes()
    found, parents = [], [os.getpid()]
    while parents:
        kids = [pid for pid, (ppid, _) in procs.items()
                if ppid in parents]
        found += kids
        parents = kids
    return found


def stop_processes() -> None:
    """SIGKILL every process this run started that still runs (each phase
    stops its own: this catches what a failed phase left), and return
    once none does."""
    left = _descendants()
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    for pid in left:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)
    _wait_gone(lambda procs: [pid for pid in left if pid in procs] or
               _descendants(), "processes this run started")
    if left:
        log(f"[processes] stopped {len(left)} still running at the end")


def _run_ranks(cmd: list, log_path: Path, env=None) -> str:
    """Run ``cmd`` (a launcher of ranks, or one child) in its own process
    group, output to ``log_path``; raises unless it exits 0 within
    RANK_TIMEOUT. Every process it started is killed, and gone, on the way
    out."""
    with open(log_path, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                             env=env, start_new_session=True)
        try:
            rc = p.wait(timeout=RANK_TIMEOUT)
        finally:
            _kill_group(p)
    text = log_path.read_text()
    if rc != 0:
        raise AssertionError(f"{cmd[:6]} exited {rc}: {text[-3000:]}")
    return text


def _torchrun(nproc: int, args: list, log_path: Path, env=None) -> str:
    """``python -m torch.distributed.run --nproc-per-node N args``."""
    return _run_ranks([sys.executable, "-m", "torch.distributed.run",
                       "--nproc-per-node", str(nproc), "--master-addr",
                       "localhost", "--master-port", str(_free_port()),
                       *args], log_path, env)


def _batches_equal(a: list, b: list) -> bool:
    """Two epochs of batches, key for key and byte for byte."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            return False
        for k in x:
            u, v = np.asarray(x[k]), np.asarray(y[k])
            if (u.dtype, u.shape) != (v.dtype, v.shape) or \
                    u.tobytes() != v.tobytes():
                return False
    return True


def _child_loader(spec: dict) -> None:
    """[loader]'s two runs, in a process of its own so that the process
    loader's forkserver and workers end with it: one epoch of the
    ``train_cityscapes.yaml`` train set through each loader, then the
    DeepLabV3+ recipe through the process loader for one epoch over
    ``spec["cli_root"]`` (a
    termination request ends the run after it). Records the batches/s,
    whether the batches are equal and the CLI's output into
    ``spec["out"]``."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.data.setup import setup_data

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets
    torch.backends.cudnn.allow_tf32 = False
    root = spec["root"]
    sets = [f"dataset.cityscapes_dir={root}",
            f"dataset.centroid_root={Path(root, 'centroids')}"]
    epochs, rates = {}, {}
    for kind in ("threaded", "grain"):
        cfg = load_config(TRAIN_RECIPE, sets + [f"dataset.loader={kind}"])
        loader, _, train_set = setup_data(cfg, seed=cfg.train.seed)
        train_set.build_epoch(0)
        loader.set_epoch(0)
        for rep in range(2 if kind == "grain" else 1):
            t0 = time.perf_counter()
            batches = list(loader)
            rates[kind if rep == 0 else "grain, forkserver up"] = \
                len(batches) / (time.perf_counter() - t0)
        epochs[kind] = batches
    res = {"rates": rates, "n": len(epochs["grain"]),
           "equal": _batches_equal(epochs["threaded"], epochs["grain"]),
           "batch_size": cfg.train.batch_size,
           "workers": cfg.dataset.num_workers}
    del epochs

    stop = Path(root, "loader_stop")
    stop.touch()
    os.environ["TPUSEG_TERMINATE_FILE"] = str(stop)
    sub = spec["cli_root"]
    res["text"], res["wall"] = _run_train_cli(
        str(Path(root, "loader_logs")), [
            "train.batch_size=1", "train.test_mode=true",
            "train.log_every=1", "train.val_freq=2", "dataset.loader=grain",
            f"dataset.cityscapes_dir={sub}",
            f"dataset.centroid_root={Path(sub, 'centroids')}"])
    res["modules"] = _reference_modules()
    Path(spec["out"]).write_text(json.dumps(res))


def phase_loader(card_info: str, root: str) -> None:
    """The ``train_cityscapes.yaml`` train set (class-uniform 1024x2048
    crops, batch 8, the uint8 wire) over the seeded tree, one epoch through
    the threaded ``BatchLoader`` and through ``GrainLoader``'s worker
    processes, ``dataset.num_workers`` of each, no model. Held: the
    batches equal byte for byte. Printed: batches/s of each (the process
    loader's first epoch includes starting its forkserver; then a second
    pass). Then the DeepLabV3+ recipe with ``dataset.loader=grain`` through
    the CLI's code for one epoch of TRAIN_STEPS steps over [deepv3-train]'s
    scenes, its host data wait beside the threaded loader's there. Both run in a child process
    (:func:`_child_loader`), stopped with all it started."""
    out = Path("chiprun_out/loader")
    out.mkdir(parents=True, exist_ok=True)
    spec = {"root": root, "out": str(out / "loader.json"),
            "cli_root": _subset_tree(root, TRAIN_STEPS, TRAIN_VAL_IMAGES)}
    _run_ranks([sys.executable, __file__, "--child", "loader",
                json.dumps(spec)], out / "loader.log")
    res = json.loads(Path(spec["out"]).read_text())
    text = res["text"]
    log(f"[loader] train_cityscapes.yaml train set, {res['n']} batches of "
        f"{res['batch_size']} 1024x2048 crops, {res['workers']} "
        f"workers: " + ", ".join(f"{k} {v:.4f} batches/s"
                                 for k, v in res["rates"].items())
        + f"; batches equal byte for byte: {res['equal']} (host of "
        f"{card_info})")
    if not res["equal"] or res["n"] == 0:
        raise AssertionError("[loader] GrainLoader's batches differ from "
                             "BatchLoader's")
    _log_rates("loader", text, f"DeepV3PlusW38 800x800 bf16, bs 1, "
               f"dataset.loader=grain, {card_info}")
    wait = (r"epoch 0: .*host data wait ([\d.]+) ms/step( \(steps 2-\d+ "
            r"[\d.]+ ms/step\))?")
    threaded = Path("chiprun_out/deepv3_train/log.txt")
    m = threaded.exists() and re.search(wait, threaded.read_text())
    grain = re.search(wait, text)
    log(f"[loader] DeepV3PlusW38 host data wait, epoch 0: grain "
        + (f"{grain.group(1)} ms/step{grain.group(2) or ''}" if grain else
           "not measured")
        + ", threaded " + (f"{m.group(1)} ms/step{m.group(2) or ''}" if m
                           else "not measured in this run")
        + f" ([deepv3-train]); whole CLI run {res['wall']:.1f} s, on "
        f"{card_info}; the loader's process loaded {res['modules'] or 'no'}"
        f" tpuseg / JAX modules")
    if not grain or "termination requested" not in text or res["modules"]:
        raise AssertionError("[loader] the grain-loaded epoch did not run")


def _parity_inputs():
    """The tiny f32 step's config, seeded weights and a global batch of 2
    whose images have different numbers of ignore pixels."""
    from tpuseg_torch.config import make_config
    from tpuseg_torch.models import get_model

    sets = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
            "model.compute_dtype": "float32", "model.n_scales": (),
            "model.ocr.dropout": 0.0, "model.remat": False,
            "loss.loss_type": "ce", "loss.supervised_mscale_wt": 0.05,
            "optim.lr": 5e-4}
    base = get_model(make_config(sets))
    _condition(base)
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, (2, 64, 128, 3)).astype(np.uint8)
    label = rng.randint(0, 19, (2, 2, 4)).astype(np.uint8).repeat(
        32, 1).repeat(32, 2)
    label[0, :4] = 255
    label[1, :, :40] = 255
    return {"sets": sets, "state": base.state_dict(), "image": image,
            "label": label}


def _parity_step(inp, rows: slice, ddp: bool) -> dict:
    """One step of the tiny model on ``rows`` of the global batch on the
    card, in DDP when ``ddp``: the loss, parameters and BN statistics."""
    from tpuseg_torch.config import make_config
    from tpuseg_torch.models import get_model

    cfg = make_config(inp["sets"])
    model = get_model(cfg)
    model.load_state_dict(inp["state"])
    model = model.to("cuda", memory_format=torch.channels_last).train()
    net = model
    if ddp:
        net = torch.nn.parallel.DistributedDataParallel(
            model, broadcast_buffers=False,
            device_ids=[torch.cuda.current_device()])
    step, opt = _train_step_of(cfg, model)
    batch = {k: torch.from_numpy(inp[k][rows]).cuda()
             for k in ("image", "label")}
    loss = float(step(net, opt, batch, 0)["loss"])
    params = {n: p.detach().double().cpu()
              for n, p in model.named_parameters()}
    return {"loss": loss, "params": params, "stats": _stats(model)}


def phase_ddp_parity(card_info: str) -> None:
    """The tiny f32 train step (CE, dropout 0, TF32 off) as two gloo ranks
    on the one card at batch 1 a rank under DDP (BN statistics and the
    loss over the global batch), against one process at batch 2 on the
    same global batch, whose two images have different ignore counts.
    Held: the ranks' mean loss, each rank's parameters after SGD and its
    BN running statistics, within DDP_PARITY_TOL of the one process."""
    out = Path("chiprun_out/ddp_parity")
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        inp = _parity_inputs()
        torch.save(inp, Path(tmp, "inputs.pt"))
        port = str(_free_port())
        procs = []
        try:
            for rank in (0, 1):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE="2", MASTER_ADDR="localhost",
                           MASTER_PORT=port)
                log_f = open(out / f"rank{rank}.log", "w")
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--child", "ddp-parity", tmp],
                    stdout=log_f, stderr=subprocess.STDOUT, env=env,
                    start_new_session=True))
                log_f.close()
            flags = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                one = _parity_step(inp, slice(0, 2), ddp=False)
            finally:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = flags
            rcs = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                _kill_group(p)
        if rcs != [0, 0]:
            raise AssertionError(
                f"[ddp-parity] ranks exited {rcs}: "
                + (out / "rank0.log").read_text()[-3000:])
        ranks = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in (0, 1)]
    loss = (ranks[0]["loss"] + ranks[1]["loss"]) / 2
    gaps = {"loss_rel": abs(loss - one["loss"]) / abs(one["loss"]),
            "params_l1": max(_tree_l1(r["params"], one["params"])
                             for r in ranks),
            "stats_l1": max(_tree_l1(r["stats"], one["stats"])
                            for r in ranks)}
    same = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in one["params"])
    modules = sorted({m for r in ranks for m in r["modules"]})
    log(f"[ddp-parity] tiny HRNet_Mscale f32 CE, TF32 off, 2 gloo ranks on "
        f"one card at batch 1 vs one process at batch 2 (loss "
        f"{one['loss']:.6f}; ignore pixels {int((inp['label'][0] == 255).sum())}"
        f" and {int((inp['label'][1] == 255).sum())}): " + ", ".join(
            f"{k} {v:.3e} (bound {DDP_PARITY_TOL[k]})"
            for k, v in gaps.items())
        + f"; ranks' parameters identical: {same}; the ranks loaded "
        f"{modules or 'no'} tpuseg / JAX modules; on {card_info}")
    bad = [k for k, v in gaps.items() if not v <= DDP_PARITY_TOL[k]]
    if bad or not same or modules:
        raise AssertionError(f"[ddp-parity] out of bounds: {bad}, ranks "
                             f"identical {same}, modules {modules}")


def _child_ddp_parity(tmp: str) -> None:
    """A rank of [ddp-parity]: gloo on the card, its row of the batch."""
    from tpuseg_torch.parallel import init_distributed, process_index

    init_distributed("cuda", backend="gloo")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(Path(tmp, "inputs.pt"), weights_only=False)
    rank = process_index()
    res = _parity_step(inp, slice(rank, rank + 1), ddp=True)
    res["modules"] = _reference_modules()
    torch.save(res, Path(tmp, f"rank{rank}.pt"))


def _cfg_of(argv: list):
    """The config a ``tpuseg_torch.cli`` command line builds."""
    from tpuseg_torch.cli.main import load_config

    sets = [argv[i + 1] for i, a in enumerate(argv) if a == "--set"]
    return load_config(argv[argv.index("--config") + 1], sets)


def _child_cli(spec: dict) -> None:
    """A rank running the CLI's code (``tpuseg_torch.cli.main.main`` with
    ``spec["argv"]``) under torchrun: joins the process group first with
    ``spec["backend"]`` when given (the CLI's own ``--multi-host`` then
    finds it up), on ``spec["stop_rank"]`` alone points
    TPUSEG_TERMINATE_FILE at ``spec["stop"]``, and records the launch
    counts, validated images, each validation's metrics, peak memory and
    loaded modules into ``<spec["out"]>_rank<r>.json``. Rank 0 then holds
    each kernel against its plain version at its own first val image."""
    from tpuseg_torch.cli.main import main as cli_main
    from tpuseg_torch.data.setup import setup_data
    from tpuseg_torch.ops import device_normalize
    from tpuseg_torch.parallel import (init_distributed, process_count,
                                       process_index)
    from tpuseg_torch.train import loop

    if spec.get("backend"):
        init_distributed("cuda", backend=spec["backend"])
    rank = int(os.environ["RANK"])
    if spec.get("stop") and rank == spec["stop_rank"]:
        os.environ["TPUSEG_TERMINATE_FILE"] = spec["stop"]
    recorded, validations = [], []
    undo = _spy_validation(recorded)
    orig = loop.Trainer.validate

    def validate(self, epoch):
        metrics = orig(self, epoch)
        validations.append([epoch, metrics.mean_iou,
                            int(metrics.hist.sum())])
        return metrics

    loop.Trainer.validate = validate
    # the collectives this process issues from Python (batch norm, the
    # losses, the metrics; DDP's gradient buckets go through C++): count
    # and host seconds
    reduces = {"calls": 0, "s": 0.0}
    all_reduce = torch.distributed.all_reduce

    def counted(*a, **k):
        t0 = time.perf_counter()
        try:
            return all_reduce(*a, **k)
        finally:
            reduces["calls"] += 1
            reduces["s"] += time.perf_counter() - t0

    torch.distributed.all_reduce = counted
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        rc = cli_main(spec["argv"])
    finally:
        undo()
        loop.Trainer.validate = orig
        torch.distributed.all_reduce = all_reduce
    launches = launch_counts()
    res = {"rank": rank, "world": process_count(), "rc": rc,
           "launches": launches, "images": len(recorded),
           "validations": validations,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "all_reduce": reduces, "modules": _reference_modules()}
    if rank == 0 and spec.get("kernel_check") and recorded:
        cfg = _cfg_of(spec["argv"])
        _, val_loader, _ = setup_data(cfg, eval_mode="val",
                                      seed=cfg.train.seed,
                                      num_shards=process_count(),
                                      shard=process_index())
        first = next(iter(val_loader))
        model = recorded[-1][0].model
        model.eval()
        _kernels_at_trained_inputs(model, device_normalize(
            torch.from_numpy(first["image"]).cuda()),
            tag=spec.get("tag", "ddp-train"))
    Path(f"{spec['out']}_rank{rank}.json").write_text(json.dumps(res))


def _cli_ranks(nproc: int, spec: dict, tag: str, env=None) -> tuple:
    """``spec``'s CLI command as ``nproc`` ranks of this script's child
    under torchrun: -> (the launch's output, each rank's record)."""
    text = _torchrun(nproc, [__file__, "--child", "cli", json.dumps(spec)],
                     Path(f"{spec['out']}.log"), env)
    ranks = [json.loads(Path(f"{spec['out']}_rank{r}.json").read_text())
             for r in range(nproc)]
    for r in ranks:
        if r["rc"] != 0 or r["modules"]:
            raise AssertionError(f"[{tag}] rank {r['rank']}: rc {r['rc']}, "
                                 f"modules {r['modules']}")
    log(f"[{tag}] ranks' loaded tpuseg / JAX modules: "
        f"{[r['modules'] for r in ranks]}")
    return text, ranks


def _log_ddp_rates(tag: str, text: str, what: str) -> None:
    _log_rates(tag, text, what)
    for pattern in (r"epoch \d+: \d+ ranks, host data wait by rank [^\n]*",
                    r"validate: \d+ ranks, [^\n]*"):
        for m in re.finditer(pattern, text):
            log(f"[{tag}] {m.group(0)} ({what})")


def phase_ddp_train(card_info: str, root: str) -> dict:
    """``train_cityscapes.yaml`` at full width (W48 HRNet_Mscale, two-scale
    1024x2048 fwd+bwd in bf16, RMI + aux + mscale CE, remat of stages
    1-3, SGD + poly) through the CLI's code as two data-parallel ranks on
    the one card: ``torch.distributed.run --nproc-per-node 2`` and
    ``--multi-host``, gloo, batch 2 (1 a rank), ``dataset.loader=grain``,
    ``test_mode``, over a tree of DDP_TRAIN_IMAGES train scenes (2 steps
    an epoch) and DDP_VAL_IMAGES val scenes (1 a rank), both kernels in
    the validation. The first launch stops after epoch 0 on a termination
    request that only rank 1 sees, checkpointed without a validation
    (``train.val_freq=2``); a restart
    resumes from its checkpoint and runs and validates epoch 1. Held: both
    launches end on both ranks, a checkpoint each, the restart resumed,
    both ranks hold the same mIoU, the summed matrix counts every labelled
    val pixel once, each rank launches 3 attention and 9 bottleneck
    kernels a val image of its shard (none in the first launch), and rank
    0's kernels agree with their plain versions at its own inputs.
    Printed: global s/step and img/s, each rank's data wait, peak memory
    and validation s/image. Returns the launches over both ranks."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.data.setup import setup_data

    out = Path("chiprun_out/ddp_train")
    out.mkdir(parents=True, exist_ok=True)
    sub = _subset_tree(root, DDP_TRAIN_IMAGES, DDP_VAL_IMAGES)
    logdir = str(Path(sub, "logs"))  # checkpoints stay out
    sets = ["train.batch_size=2", "train.test_mode=true",
            "train.log_every=1", "train.val_freq=2", "model.use_pallas=true",
            "model.fused_stage1=true", "dataset.loader=grain",
            "dataset.num_workers=4", f"dataset.cityscapes_dir={sub}",
            f"dataset.centroid_root={Path(sub, 'centroids')}"]
    argv = ["train", "--multi-host", "--config", TRAIN_RECIPE, "--logdir",
            logdir]
    for item in sets:
        argv += ["--set", item]
    stop = Path(sub, "stop")
    stop.touch()
    what = f"W48 two-scale 1024x2048 bf16, remat 1-3, 2 gloo ranks, {card_info}"
    t0 = time.perf_counter()
    first, first_ranks = _cli_ranks(2, {
        "argv": argv, "backend": "gloo", "out": str(out / "first"),
        "stop": str(stop), "stop_rank": 1}, "ddp-train")
    ckpts = sorted(p.name for p in Path(logdir, "ckpt").glob("*.pt"))
    t1 = time.perf_counter()
    restart, restart_ranks = _cli_ranks(2, {
        "argv": argv, "backend": "gloo", "out": str(out / "restart"),
        "kernel_check": True}, "ddp-train")
    wall = (t1 - t0, time.perf_counter() - t1)
    ckpts_after = sorted(p.name for p in Path(logdir, "ckpt").glob("*.pt"))
    for name in ("log.txt", "metrics.jsonl"):
        shutil.copy(Path(logdir, name), out / name)
    _log_ddp_rates("ddp-train", first + restart, what)
    log(f"[ddp-train] launches {wall[0]:.1f} s (epoch 0, stopped) and "
        f"{wall[1]:.1f} s (resumed, epoch 1); peak device memory by rank "
        + ", ".join(f"{r['peak_gib']:.2f}"
                    for r in first_ranks + restart_ranks) + " GiB; "
        "all_reduce calls from Python (synced BN, losses, metrics) and "
        f"their host seconds by rank, over the first launch's "
        f"{DDP_TRAIN_IMAGES // 2} steps and the restart's steps and "
        f"validation: " + ", ".join(
            f"{r['all_reduce']['calls']} in {r['all_reduce']['s']:.2f} s"
            for r in first_ranks + restart_ranks))

    cfg = load_config(TRAIN_RECIPE, sets)
    _, val_loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    labelled = sum(int((np.asarray(b["label"]) != 255).sum())
                   for b in val_loader)
    # the first launch validates nothing (val_freq 2), the restart epoch 1
    want_vals = {"first": None, "restart": 1}
    total = dict.fromkeys(KERNELS, 0)
    bad = []
    for name, text, ranks in (("first", first, first_ranks),
                              ("restart", restart, restart_ranks)):
        vals = [r["validations"] for r in ranks]
        log(f"[ddp-train] {name}: validations (epoch, mIoU, pixels) by "
            f"rank {vals} (want epoch {want_vals[name]}, {labelled} "
            f"labelled pixels); images by rank "
            f"{[r['images'] for r in ranks]}; launches by rank "
            f"{[r['launches'] for r in ranks]}")
        if want_vals[name] is None:
            if vals != [[], []]:
                bad.append(f"{name} validations {vals}")
        elif vals[0] != vals[1] or len(vals[0]) != 1 or \
                vals[0][0][0] != want_vals[name] or \
                vals[0][0][2] != labelled:
            bad.append(f"{name} validations {vals}")
        images = 0 if want_vals[name] is None else DDP_VAL_IMAGES // 2
        for r in ranks:
            want = {"ocr_attention": 3 * r["images"],
                    "bottleneck_fused": 9 * r["images"],
                    "bottleneck_fused_any": 0, "dilated_conv": 0}
            if r["images"] != images or r["launches"] != want:
                bad.append(f"{name} rank {r['rank']} launches "
                           f"{r['launches']} for {r['images']} images")
            for k in total:
                total[k] += r["launches"][k]
    stopped = "termination requested" in first
    resumed = "resumed at epoch 1" in restart
    log(f"[ddp-train] checkpoints after the first launch {ckpts}, after "
        f"the restart {ckpts_after}; both ranks stopped on rank 1's "
        f"termination request: {stopped}; the restart resumed at epoch 1: "
        f"{resumed}")
    steps = DDP_TRAIN_IMAGES // 2
    if ckpts != [f"ckpt_{steps}.pt"] or \
            ckpts_after != sorted([f"ckpt_{steps}.pt", f"ckpt_{2 * steps}.pt"]):
        bad.append(f"checkpoints {ckpts} {ckpts_after}")
    if not (stopped and resumed):
        bad.append(f"stopped {stopped}, resumed {resumed}")
    if bad:
        raise AssertionError(f"[ddp-train] {bad}")
    return total


# [ddp-nccl]'s tree: 3 train scenes (3 steps) and 2 val scenes
NCCL_TRAIN, NCCL_VAL = 2, 1


def phase_ddp_nccl(card_info: str, root: str) -> None:
    """One rank with the production backend: ``torch.distributed.run
    --nproc-per-node 1`` of the CLI's code with ``--multi-host`` (NCCL on
    the card), ``train_cityscapes.yaml`` at W48 over a tree of NCCL_TRAIN
    train and NCCL_VAL val scenes: 2 steps, one validation of 1 image,
    then a termination request.
    Held: NCCL started and DDP wrapped the model, the epoch, the
    validation and its checkpoint. That more than one card trains
    correctly is not shown here (one card)."""
    out = Path("chiprun_out/ddp_nccl")
    out.mkdir(parents=True, exist_ok=True)
    sub = _subset_tree(root, NCCL_TRAIN, NCCL_VAL)
    logdir = str(Path(root, "nccl_logs"))
    stop = Path(root, "nccl_stop")
    stop.touch()
    argv = ["train", "--multi-host", "--config", TRAIN_RECIPE, "--logdir",
            logdir]
    for item in ["train.batch_size=1", "train.test_mode=true",
                 "train.log_every=1", "model.use_pallas=true",
                 "model.fused_stage1=true", f"dataset.cityscapes_dir={sub}",
                 f"dataset.centroid_root={Path(root, 'nccl_centroids')}"]:
        argv += ["--set", item]
    t0 = time.perf_counter()
    text, ranks = _cli_ranks(1, {"argv": argv, "out": str(out / "nccl"),
                                 "stop": str(stop), "stop_rank": 0},
                             "ddp-nccl")
    wall = time.perf_counter() - t0
    _log_rates("ddp-nccl", text, f"W48, 1 NCCL rank, {card_info}")
    wrapped = re.search(r"DistributedDataParallel: 1 ranks, backend nccl",
                        text)
    ckpts = sorted(p.name for p in Path(logdir, "ckpt").glob("*.pt"))
    r = ranks[0]
    log(f"[ddp-nccl] DDP over NCCL: {bool(wrapped)}; validations "
        f"{r['validations']}, launches {r['launches']} for {r['images']} "
        f"images; checkpoints {ckpts}; whole launch {wall:.1f} s, peak "
        f"{r['peak_gib']:.2f} GiB, on {card_info}")
    if not wrapped or f"epoch 0: {NCCL_TRAIN} steps on cuda:0" not in text \
            or len(r["validations"]) != 1 or r["images"] != NCCL_VAL or \
            ckpts != [f"ckpt_{NCCL_TRAIN}.pt"]:
        raise AssertionError("[ddp-nccl] the one-rank NCCL run did not "
                             "train, validate and checkpoint")


# ------------------------------------------------ dp x sp spatial sharding

# [sp-parity]: W48 at full width in f32, one image at SP_PARITY_HW (a
# quarter of the recipe's crop keeps the phase in its budget), two gloo
# ranks of one sp group on the card vs one process; TF32 off and cuDNN
# deterministic on both sides. The random W48 net amplifies f32 rounding
# in its gradients: the one process on a batch of the image twice (the
# same loss and gradient, other kernels and sums) sets the floor, and the
# CE gradient is held within SP_GRAD_FLOORS of it, or 1e-4
SP_PARITY_HW = (256, 1024)
SP_PARITY_TOL = {"loss_rel": 1e-5, "params_l1": 1e-5, "stats_l1": 1e-5,
                 "grad_l1": 1e-4}
SP_GRAD_FLOORS = 2.0
# [sp-train]'s tree: 2 train scenes (2 steps at batch 1, dp 1) and 2 val
# scenes (1 a rank)
SP_TRAIN_IMAGES, SP_VAL_IMAGES = 2, 2


def _sp_inputs(hw=SP_PARITY_HW) -> dict:
    """The W48 step's config (the recipe's model, f32, dropout 0, remat
    off), seeded weights and one seeded scene at ``hw`` whose top band
    holds every ignore pixel."""
    from tpuseg_torch.config import make_config
    from tpuseg_torch.models import get_model

    sets = {"model.arch": "ocrnet.HRNet_Mscale",
            "model.compute_dtype": "float32", "model.n_scales": (),
            "model.ocr.dropout": 0.0, "model.remat": False,
            "loss.supervised_mscale_wt": 0.05, "loss.ocr_alpha": 0.4,
            "optim.lr": 5e-4}
    base = get_model(make_config({**sets, "loss.loss_type": "ce"}))
    _condition(base)
    image, _, label = _fake_scene(2001, hw=hw)
    label = label.copy()
    label[:48] = 255
    return {"sets": sets, "state": base.state_dict(), "image": image[None],
            "label": label[None]}


def _sp_steps(inp, mesh=None, copies: int = 1) -> dict:
    """The CE step from the input weights on the card: on this rank's band
    under DDP when ``mesh`` is given, on a batch of ``copies`` of the
    image otherwise. -> ``{"ce": ...}``: the loss's value and gradients,
    the parameters and BN statistics after SGD, and the sp collectives a
    step. (The recipe's RMI step is not taken: its 9x9 solves amplify
    cuDNN's f32 differences past any floor, and the CPU tests hold RMI on
    bands exactly in f64.)"""
    from tpuseg_torch.config import make_config
    from tpuseg_torch.models import get_model
    from tpuseg_torch.parallel import shard_batch_spatial, spatial
    from tpuseg_torch.utils.profiling import reset_counters

    model = get_model(make_config({**inp["sets"], "loss.loss_type": "ce"}))
    model = model.to("cuda", memory_format=torch.channels_last).train()
    net = model
    if mesh is not None:
        net = torch.nn.parallel.DistributedDataParallel(
            model, broadcast_buffers=False,
            device_ids=[torch.cuda.current_device()])
    whole = {k: np.concatenate([inp[k]] * copies)
             for k in ("image", "label")}
    model.load_state_dict(inp["state"])
    cfg = make_config({**inp["sets"], "loss.loss_type": "ce"})
    step, opt = _train_step_of(cfg, model)
    reset_counters()
    with spatial.sharded(None if mesh is None else mesh.bands):
        # a band's rows enter the context's table of map heights
        batch = whole if mesh is None else shard_batch_spatial(mesh, whole)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                 for k, v in batch.items()}
        loss = float(step(net, opt, batch, 0)["loss"])
    return {"ce": {
        "loss": loss, **sp_collectives(),
        "grads": {n: p.grad.detach().cpu()
                  for n, p in model.named_parameters()},
        "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
        "stats": _stats(model)}}


def _deterministic() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _child_sp_parity(tmp: str) -> None:
    """A rank of [sp-parity]: gloo on the card, one sp group of 2, its band
    of the image. Rank 0 writes the gradients and parameters (DDP leaves
    them equal on both ranks: each rank writes their checksums)."""
    from tpuseg_torch.parallel import init_distributed, make_mesh

    init_distributed("cuda", backend="gloo")
    _deterministic()
    inp = torch.load(Path(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(2)
    torch.cuda.reset_peak_memory_stats()
    res = _sp_steps(inp, mesh)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["sums"] = {"ce": float(sum(g.double().abs().sum()
                                   for g in res["ce"]["grads"].values()))}
    res["sums"]["params"] = float(sum(
        p.double().abs().sum() for p in res["ce"]["params"].values()))
    if mesh.sp_index != 0:
        del res["ce"]["grads"]
        del res["ce"]["params"]
    res["modules"] = _reference_modules()
    torch.save(res, Path(tmp, f"rank{mesh.sp_index}.pt"))


def phase_sp_parity(card_info: str) -> None:
    """W48 ``HRNet_Mscale`` at full width in f32 (TF32 off, cuDNN
    deterministic), one SP_PARITY_HW image, as two gloo ranks of one sp
    group on the card (``mesh.model_parallelism = 2``, dp 1: each rank
    its band of rows, halo exchanges through every conv and resize, the
    OCR gather's sums over the group) under DDP, against one
    process on the whole image. Held for a CE step: the ranks' mean loss,
    the parameters after SGD and the BN running statistics within
    SP_PARITY_TOL, the gradients (L1-rel over every parameter) within 1e-4
    or SP_GRAD_FLOORS times the f32 floor (the one process on a batch of
    the image twice vs once), whichever is larger; both ranks' gradients
    and parameters equal."""
    out = Path("chiprun_out/sp_parity")
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        inp = _sp_inputs()
        torch.save(inp, Path(tmp, "inputs.pt"))
        port = str(_free_port())
        procs = []
        try:
            for rank in (0, 1):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE="2", MASTER_ADDR="localhost",
                           MASTER_PORT=port)
                log_f = open(out / f"rank{rank}.log", "w")
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--child", "sp-parity", tmp],
                    stdout=log_f, stderr=subprocess.STDOUT, env=env,
                    start_new_session=True))
                log_f.close()
            flags = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
            _deterministic()
            try:
                one = _sp_steps(inp)
                twice = _sp_steps(inp, copies=2)
            finally:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark) = flags
            rcs = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                _kill_group(p)
        if rcs != [0, 0]:
            raise AssertionError(
                f"[sp-parity] ranks exited {rcs}: "
                + (out / "rank0.log").read_text()[-3000:])
        ranks = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in (0, 1)]
    loss = (ranks[0]["ce"]["loss"] + ranks[1]["ce"]["loss"]) / 2
    gaps = {"ce": {
        "loss_rel": abs(loss - one["ce"]["loss"]) / abs(one["ce"]["loss"]),
        "grad_l1": _tree_l1(ranks[0]["ce"]["grads"], one["ce"]["grads"])}}
    floor = {"ce": {
        "loss_rel": abs(twice["ce"]["loss"] - one["ce"]["loss"]) / abs(
            one["ce"]["loss"]),
        "grad_l1": _tree_l1(twice["ce"]["grads"], one["ce"]["grads"])}}
    bounds = dict(SP_PARITY_TOL, grad_l1=max(
        SP_PARITY_TOL["grad_l1"], SP_GRAD_FLOORS * floor["ce"]["grad_l1"]))
    gaps["ce"]["params_l1"] = _tree_l1(ranks[0]["ce"]["params"],
                                       one["ce"]["params"])
    gaps["ce"]["stats_l1"] = max(_tree_l1(r["ce"]["stats"],
                                          one["ce"]["stats"]) for r in ranks)
    same = ranks[0]["sums"] == ranks[1]["sums"]
    modules = sorted({m for r in ranks for m in r["modules"]})
    c = ranks[0]["ce"]
    log(f"[sp-parity] W48 HRNet_Mscale f32 1x{SP_PARITY_HW[0]}x"
        f"{SP_PARITY_HW[1]}, TF32 off, cuDNN deterministic, 2 gloo ranks "
        f"of one sp group on one card vs one process; CE step (loss "
        f"{one['ce']['loss']:.6f}): " + ", ".join(
            f"{k} {v:.3e} (bound {bounds[k]:.3g})"
            for k, v in gaps["ce"].items())
        + f"; the one process on the image twice vs once (the f32 floor): "
        f"loss_rel {floor['ce']['loss_rel']:.3e}, grad_l1 "
        f"{floor['ce']['grad_l1']:.3e}; ranks' gradients and parameters "
        f"equal (checksums): {same}; a CE step's sp collectives on a rank: "
        + ", ".join(f"{c['counts'][k]} {k} in {c['seconds'][k]:.3f} s"
                    for k in c["counts"])
        + f"; peak device memory by rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; the ranks "
        f"loaded {modules or 'no'} tpuseg / JAX modules; on {card_info}")
    bad = [k for k, v in gaps["ce"].items() if not v <= bounds[k]]
    if bad or not same or modules or not c["counts"]["halo"]:
        raise AssertionError(f"[sp-parity] out of bounds: {bad}, ranks "
                             f"equal {same}, modules {modules}")


def phase_sp_train(card_info: str, root: str) -> dict:
    """``train_cityscapes.yaml`` as shipped (W48 HRNet_Mscale, two-scale
    1024x2048 fwd+bwd in bf16, RMI + aux + mscale CE, remat of stages
    1-3, SGD + poly) plus ``mesh.model_parallelism=2`` and
    ``train.batch_size=1`` through the CLI's code as two gloo ranks of one
    sp group on the card (``torch.distributed.run --nproc-per-node 2``,
    ``--multi-host``): each rank trains on its 512-row band of every crop.
    ``test_mode`` over SP_TRAIN_IMAGES train scenes (2 steps) and
    SP_VAL_IMAGES val scenes (1 a rank, whole images, both kernels), then
    a termination request. Held: both ranks end, one checkpoint, the same
    mIoU on both, every labelled val pixel counted once, 3 attention and
    9 bottleneck launches a val image a rank, and rank 0's kernels agree
    with their plain versions at its own inputs. Printed: s/step, img/s,
    peak memory a rank, the sp collectives a step with their host seconds
    and validation s/image. Returns the launches over both ranks."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.data.setup import setup_data

    out = Path("chiprun_out/sp_train")
    out.mkdir(parents=True, exist_ok=True)
    sub = _subset_tree(root, SP_TRAIN_IMAGES, SP_VAL_IMAGES)
    logdir = str(Path(sub, "logs"))  # checkpoints stay out
    sets = ["mesh.model_parallelism=2", "train.batch_size=1",
            "train.test_mode=true", "train.log_every=1",
            "model.use_pallas=true", "model.fused_stage1=true",
            f"dataset.cityscapes_dir={sub}",
            f"dataset.centroid_root={Path(sub, 'centroids')}"]
    argv = ["train", "--multi-host", "--config", TRAIN_RECIPE, "--logdir",
            logdir]
    for item in sets:
        argv += ["--set", item]
    stop = Path(sub, "stop")
    stop.touch()
    what = (f"W48 two-scale 1024x2048 bf16, remat 1-3, dp 1 x sp 2 gloo "
            f"ranks, {card_info}")
    t0 = time.perf_counter()
    text, ranks = _cli_ranks(2, {
        "argv": argv, "backend": "gloo", "out": str(out / "sp"),
        "stop": str(stop), "stop_rank": 1, "kernel_check": True,
        "tag": "sp-train"}, "sp-train")
    wall = time.perf_counter() - t0
    for name in ("log.txt", "metrics.jsonl"):
        shutil.copy(Path(logdir, name), out / name)
    _log_ddp_rates("sp-train", text, what)
    for m in re.finditer(r"epoch \d+: sp collectives a step [^\n]*", text):
        log(f"[sp-train] {m.group(0)} ({what})")
    ckpts = sorted(p.name for p in Path(logdir, "ckpt").glob("*.pt"))
    cfg = load_config(TRAIN_RECIPE, sets)
    _, val_loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    labelled = sum(int((np.asarray(b["label"]) != 255).sum())
                   for b in val_loader)
    vals = [r["validations"] for r in ranks]
    log(f"[sp-train] whole launch {wall:.1f} s; validations (epoch, mIoU, "
        f"pixels) by rank {vals} (want epoch 0, {labelled} labelled "
        f"pixels); images by rank {[r['images'] for r in ranks]}; launches "
        f"by rank {[r['launches'] for r in ranks]}; peak device memory by "
        f"rank " + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks)
        + " GiB; all_reduce calls from Python (halo exchanges, sp sums, "
        "synced BN, losses, metrics) and their host seconds by rank: "
        + ", ".join(f"{r['all_reduce']['calls']} in "
                    f"{r['all_reduce']['s']:.2f} s" for r in ranks)
        + f"; checkpoints {ckpts}")
    bad = []
    if vals[0] != vals[1] or len(vals[0]) != 1 or vals[0][0][0] != 0 or \
            vals[0][0][2] != labelled:
        bad.append(f"validations {vals}")
    total = dict.fromkeys(KERNELS, 0)
    for r in ranks:
        want = {"ocr_attention": 3 * r["images"],
                "bottleneck_fused": 9 * r["images"],
                "bottleneck_fused_any": 0, "dilated_conv": 0}
        if r["images"] != SP_VAL_IMAGES // 2 or r["launches"] != want:
            bad.append(f"rank {r['rank']} launches {r['launches']} for "
                       f"{r['images']} images")
        for k in total:
            total[k] += r["launches"][k]
    if ckpts != [f"ckpt_{SP_TRAIN_IMAGES}.pt"]:
        bad.append(f"checkpoints {ckpts}")
    if "dp 1 x sp 2" not in text or "termination requested" not in text:
        bad.append("no dp 1 x sp 2 run stopped on its request")
    if bad:
        raise AssertionError(f"[sp-train] {bad}")
    return total


# [sp-zoo-parity]: one factory a trunk or head family at full width, f32,
# TF32 off, cuDNN deterministic, one SP_ZOO_HW crop (every map splits into
# two bands: 32 rows at stride 8, 16 at the 0.5x pass, 8 at stride 32),
# dropout and drop path on with the default generator seeded alike in
# every process. Held as [sp-parity]; the gradient within SP_GRAD_FLOORS
# times the f32 floor (the image twice in a batch vs once, masks off) or
# 1e-4. The mscale2, basic and deeper families are held on the CPU
# (tests/test_torch_spatial_zoo.py), their classes on tiny trunks
SP_ZOO = ("deepv3.DeepV3PlusR50", "deepv3.DeepV3PlusSRNX50",
          "deepv3.DeepV3PlusX71", "deepv3.DeepV3PlusEffB4",
          "deepv3.DeepV3PlusW38", "ocrnet.HRNet_ASPP_OCR",
          "mscale.DeepV3W38")
SP_ZOO_HW = (256, 512)
SP_ZOO_SEED = 11
SP_ZOO_TOL = {"loss_rel": 1e-5, "params_l1": 2e-5, "stats_l1": 2e-5,
              "grad_l1": 1e-4}
# [sp-deepv3-train]: 3 train scenes (one epoch of 3 steps at batch 1, dp
# 1) and 2 val scenes (one a rank)
SP_DEEPV3_TRAIN, SP_DEEPV3_VAL = 3, 2
# [sp-uneven-train]: the same 3 train scenes and 3 val scenes, one a rank
SP_UNEVEN_VAL = 3


def _sp_zoo_inputs() -> dict:
    """Each factory's config (f32, remat off, n-scale off: the two-scale
    train forward of mscale) and one seeded SP_ZOO_HW scene whose top band
    holds every ignore pixel."""
    image, _, label = _fake_scene(2002, hw=SP_ZOO_HW)
    label = label.copy()
    label[:24] = 255
    base = {"model.compute_dtype": "float32", "model.remat": False,
            "model.n_scales": (), "loss.loss_type": "ce",
            "loss.ocr_alpha": 0.4, "loss.supervised_mscale_wt": 0.05,
            "optim.lr": 5e-4}
    return {"sets": {a: {**base, "model.arch": a} for a in SP_ZOO},
            "image": image[None], "label": label[None]}


def _masks(model, on: bool) -> None:
    """Dropout and drop path at their rates, or off."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout2d):
            m.p = m.__dict__.setdefault("rate", m.p) if on else 0.0
        elif hasattr(m, "drop_path"):
            m.drop_path = (m.__dict__.setdefault("rate", m.drop_path)
                           if on else 0.0)


def _sp_zoo_step(model, init: dict, cfg, batch: dict, mesh=None,
                 masks: bool = True) -> dict:
    """One CE step of ``model`` from ``init`` on the card, the default
    generator seeded with SP_ZOO_SEED: on this rank's band under DDP when
    ``mesh`` is given. -> loss, gradients, parameters after SGD, BN
    statistics (on the host) and the sp collectives with their host
    seconds."""
    from tpuseg_torch.parallel import shard_batch_spatial, spatial
    from tpuseg_torch.utils.profiling import reset_counters

    model.load_state_dict(init)
    _masks(model, masks)
    net = model
    if mesh is not None:
        # the ranks drew the same weights: no broadcast from rank 0
        net = torch.nn.parallel.DistributedDataParallel(
            model, broadcast_buffers=False, init_sync=False,
            device_ids=[torch.cuda.current_device()])
    step, opt = _train_step_of(cfg, model)
    # on a band: the modules whose 4-D output is not channels_last, in
    # call order (the ranks must run the same formats, so the same cuDNN
    # algorithms)
    nchw, hooks = [], []
    if mesh is not None:
        def record(name):
            def hook(module, args, out):
                if isinstance(out, torch.Tensor) and out.dim() == 4 and \
                        spatial.memory_format(out) != torch.channels_last:
                    nchw.append(name)
            return hook

        hooks = [m.register_forward_hook(record(n))
                 for n, m in model.named_modules()]
    reset_counters()
    torch.manual_seed(SP_ZOO_SEED)
    t0 = time.perf_counter()
    try:
        with spatial.sharded(None if mesh is None else mesh.bands):
            # a band's rows enter the context's table of map heights
            if mesh is not None:
                batch = shard_batch_spatial(mesh, batch)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                     for k, v in batch.items()}
            loss = float(step(net, opt, batch, 0)["loss"])
    finally:
        for h in hooks:
            h.remove()
    return {"loss": loss, "s": time.perf_counter() - t0, "nchw": nchw,
            **sp_collectives(),
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu()
                       for n, p in model.named_parameters()},
            "stats": _stats(model)}


def _sums(res: dict, keys) -> dict:
    """Checksums of a step's tensors, to hold the ranks' results equal."""
    return {k: float(sum(t.double().abs().sum() for t in res[k].values()))
            for k in keys}


def _child_sp_zoo(tmp: str) -> None:
    """A rank of [sp-zoo-parity]: gloo on the card, one sp group of 2. It
    takes each factory's step on its band; then the ranks leave the group
    and each runs one process for every other factory (DDP left both
    ranks' results equal): the step on the whole image, held against its
    band's, and the f32 floor."""
    import torch.distributed as dist

    from tpuseg_torch.config import make_config
    from tpuseg_torch.models import get_model
    from tpuseg_torch.parallel import init_distributed, make_mesh

    init_distributed("cuda", backend="gloo")
    _deterministic()
    inp = torch.load(Path(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(2)
    rank = mesh.sp_index
    batch = {k: inp[k] for k in ("image", "label")}
    torch.cuda.reset_peak_memory_stats()
    res, mine = {}, {}
    for i, (arch, sets) in enumerate(inp["sets"].items()):
        cfg = make_config(sets)
        model = get_model(cfg).to(
            "cuda", memory_format=torch.channels_last).train()
        _condition(model)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        band = _sp_zoo_step(model, init, cfg, batch, mesh)
        res[arch] = {k: band[k]
                     for k in ("loss", "s", "nchw", "counts", "seconds")}
        res[arch]["sums"] = _sums(band, ("grads", "params", "stats"))
        if i % 2 == rank:
            mine[arch] = model, init, cfg, band
        del model
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    dist.destroy_process_group()  # one process from here on
    for arch, (model, init, cfg, band) in mine.items():
        one = _sp_zoo_step(model, init, cfg, batch)
        # a doubled batch draws other masks: the floor runs without
        once = _sp_zoo_step(model, init, cfg, batch, masks=False)
        twice = _sp_zoo_step(model, init, cfg, {
            k: np.concatenate([v, v]) for k, v in batch.items()},
            masks=False)
        res[arch]["one"] = {
            "loss": one["loss"],
            "grad_l1": _tree_l1(band["grads"], one["grads"]),
            "params_l1": _tree_l1(band["params"], one["params"]),
            "stats_l1": _tree_l1(band["stats"], one["stats"]),
            "floor": _tree_l1(twice["grads"], once["grads"])}
    res["modules"] = _reference_modules()
    torch.save(res, Path(tmp, f"rank{rank}.pt"))


def start_sp_zoo_parity() -> dict:
    """Start [sp-zoo-parity]'s two ranks (``_child_sp_zoo``) in the
    background; ``phase_sp_zoo_parity`` waits for them and holds their
    results. -> what it needs."""
    out = Path("chiprun_out/sp_zoo_parity")
    out.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp()
    torch.save(_sp_zoo_inputs(), Path(tmp, "inputs.pt"))
    port = str(_free_port())
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port)
        with open(out / f"rank{rank}.log", "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--child", "sp-zoo", tmp],
                stdout=log_f, stderr=subprocess.STDOUT, env=env,
                start_new_session=True))
    return {"out": out, "tmp": tmp, "procs": procs,
            "t0": time.perf_counter()}


def phase_sp_zoo_parity(card_info: str, started: dict) -> None:
    """One factory a trunk or head family (SP_ZOO: the stem max pool of
    ResNet-50, SE-ResNeXt-50's Caffe-style ceil-mode pool and
    squeeze-excite, Xception-71, EfficientNet-B4's squeeze-excite and drop
    path, WRN38, HRNet-ASPP-OCR, mscale's two-scale DeepV3W38; ASPP's
    image pooling in each) at full width in f32 (TF32 off, cuDNN
    deterministic) on one SP_ZOO_HW image: one CE step as two gloo ranks
    of one sp group on the card (each its band of rows, under DDP)
    against one process on the whole image, dropout and drop path on in
    both (the bands draw the masks one process draws). The ranks run in
    the background from ``start_sp_zoo_parity`` on, beside [zoo-parity],
    [ddp-parity] and [sp-parity]. Held for each: the ranks' mean loss within
    SP_ZOO_TOL, the parameters after SGD and the BN statistics, the
    gradients within 1e-4 or SP_GRAD_FLOORS times the f32 floor (the one
    process on the image twice vs once, masks off); both ranks' results
    equal (checksums) and their modules' outputs in the same memory
    formats; halo exchanges and sp sums issued. Printed: the sp
    collectives of a step and each rank's band step seconds a factory."""
    out, tmp, procs = started["out"], started["tmp"], started["procs"]
    try:
        rcs = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
        if rcs != [0, 0]:
            raise AssertionError(
                f"[sp-zoo-parity] ranks exited {rcs}: "
                + "".join((out / f"rank{r}.log").read_text()[-2000:]
                          for r in (0, 1)))
        ranks = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in (0, 1)]
    finally:
        for p in procs:
            _kill_group(p)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[sp-zoo-parity] ranks ran {time.perf_counter() - started['t0']:.1f}"
        f" s from their start, beside [zoo-parity], [ddp-parity] and "
        f"[sp-parity]")
    bad = []
    for arch in SP_ZOO:
        got = [r[arch] for r in ranks]
        one, = [g["one"] for g in got if "one" in g]
        loss = (got[0]["loss"] + got[1]["loss"]) / 2
        gaps = {"loss_rel": abs(loss - one["loss"]) / abs(one["loss"]),
                **{k: one[k] for k in ("grad_l1", "params_l1",
                                       "stats_l1")}}
        bounds = dict(SP_ZOO_TOL, grad_l1=max(SP_ZOO_TOL["grad_l1"],
                                              SP_GRAD_FLOORS * one["floor"]))
        same = got[0]["sums"] == got[1]["sums"]
        formats = got[0]["nchw"] == got[1]["nchw"]
        c = got[0]
        log(f"[sp-zoo-parity] {arch} f32 1x{SP_ZOO_HW[0]}x{SP_ZOO_HW[1]}, "
            f"2 gloo ranks of one sp group vs one process, CE step (loss "
            f"{one['loss']:.6f}): " + ", ".join(
                f"{k} {v:.3e} (bound {bounds[k]:.3g})"
                for k, v in gaps.items())
            + f"; the f32 floor (the image twice vs once) "
            f"{one['floor']:.3e}; ranks equal: {same}; ranks' output "
            f"formats equal: {formats} ({len(c['nchw'])} module outputs "
            f"not channels_last a rank); a step's sp "
            f"collectives on a rank: " + ", ".join(
                f"{c['counts'][k]} {k} in {c['seconds'][k]:.3f} s"
                for k in c["counts"])
            + f"; band step by rank {got[0]['s']:.2f} {got[1]['s']:.2f} s;"
            f" on {card_info}")
        if [k for k, v in gaps.items() if not v <= bounds[k]] or not same \
                or not formats or not c["counts"]["halo"] or \
                not c["counts"]["sum"]:
            bad.append(arch)
    modules = sorted({m for r in ranks for m in r["modules"]})
    log(f"[sp-zoo-parity] peak device memory by rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; the ranks loaded "
        f"{modules or 'no'} tpuseg / JAX modules")
    if bad or modules:
        raise AssertionError(f"[sp-zoo-parity] out of bounds: {bad}, "
                             f"modules {modules}")


def _sp_deepv3_ranks(card_info: str, root: str, sp: int, n_val: int,
                     tag: str, out: Path) -> dict:
    """``train_cityscapes_deepv3.yaml`` as shipped plus
    ``mesh.model_parallelism=sp`` and ``train.batch_size=1`` through the
    CLI's code as ``sp`` gloo ranks of one sp group on the card
    (``torch.distributed.run --nproc-per-node sp``, ``--multi-host``): one
    epoch over SP_DEEPV3_TRAIN train scenes, then one whole-image
    validation of ``n_val`` val scenes, one a rank. Held: every
    rank ends, the checkpoint written, the same mIoU on every rank, every
    labelled val pixel counted once, the dilated conv's 3 launches a
    forward (ASPP's rates, on the band in a step) and no other kernel's
    (DeepLabV3+ has no OCR block and no HRNet stage 1). Printed: s/step
    and img/s over steps 2..N, the sp collectives a step with their host
    seconds, the ranks' all-reduces, peak memory a rank and validation
    s/image. Returns the launches over the ranks."""
    from tpuseg_torch.cli.main import load_config
    from tpuseg_torch.data.setup import setup_data

    out.mkdir(parents=True, exist_ok=True)
    sub = _subset_tree(root, SP_DEEPV3_TRAIN, n_val)
    # checkpoints stay out
    logdir = str(Path(sub, f"sp{sp}_deepv3_logs"))
    steps = SP_DEEPV3_TRAIN
    sets = [f"mesh.model_parallelism={sp}", "train.batch_size=1",
            "train.max_epoch=1", "train.log_every=1",
            f"dataset.cityscapes_dir={sub}",
            f"dataset.centroid_root={Path(sub, 'centroids')}"]
    argv = ["train", "--multi-host", "--config", DEEPV3_RECIPE, "--logdir",
            logdir]
    for item in sets:
        argv += ["--set", item]
    what = (f"DeepV3PlusW38 800x800 bf16, WRN38 blocks remat'd, dp 1 x sp "
            f"{sp} gloo ranks, {card_info}")
    t0 = time.perf_counter()
    text, ranks = _cli_ranks(sp, {
        "argv": argv, "backend": "gloo", "out": str(out / "sp")}, tag)
    wall = time.perf_counter() - t0
    for name in ("log.txt", "metrics.jsonl"):
        shutil.copy(Path(logdir, name), out / name)
    _log_ddp_rates(tag, text, what)
    for m in re.finditer(r"epoch \d+: sp collectives a step [^\n]*", text):
        log(f"[{tag}] {m.group(0)} ({what})")
    losses = _train_losses(logdir, steps)
    ckpts = sorted(p.name for p in Path(logdir, "ckpt").glob("*.pt"))
    cfg = load_config(DEEPV3_RECIPE, sets)
    _, val_loader, _ = setup_data(cfg, eval_mode="val", seed=cfg.train.seed)
    labelled = sum(int((np.asarray(b["label"]) != 255).sum())
                   for b in val_loader)
    vals = [r["validations"] for r in ranks]
    images = [r["images"] for r in ranks]
    log(f"[{tag}] loss at steps 1..{steps}: "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; whole launch {wall:.1f} s; validations (epoch, mIoU, pixels) "
        f"by rank {vals} (want epoch 0, {labelled} labelled pixels); "
        f"images by rank {images}; launches by rank "
        f"{[r['launches'] for r in ranks]}; peak device memory by rank "
        + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks)
        + " GiB; all_reduce calls from Python (halo exchanges, sp sums, "
        "synced BN, losses, metrics) and their host seconds by rank: "
        + ", ".join(f"{r['all_reduce']['calls']} in "
                    f"{r['all_reduce']['s']:.2f} s" for r in ranks)
        + f"; checkpoints {ckpts}")
    bad = []
    if any(v != vals[0] for v in vals) or len(vals[0]) != 1 or \
            vals[0][0][0] != 0 or vals[0][0][2] != labelled:
        bad.append(f"validations {vals}")
    if images != [len(range(r, n_val, sp)) for r in range(sp)]:
        bad.append(f"val images by rank {images}")
    total = dict.fromkeys(KERNELS, 0)
    for r in ranks:
        want = {**dict.fromkeys(KERNELS, 0),
                "dilated_conv": 3 * (steps + r["images"])}
        if r["launches"] != want:
            bad.append(f"rank {r['rank']} launches {r['launches']} for "
                       f"{steps} steps and {r['images']} images")
        for k in total:
            total[k] += r["launches"][k]
    if ckpts != [f"ckpt_{steps}.pt"]:
        bad.append(f"checkpoints {ckpts}")
    if f"dp 1 x sp {sp}" not in text:
        bad.append(f"no dp 1 x sp {sp} run")
    if bad:
        raise AssertionError(f"[{tag}] {bad}")
    return total


def phase_sp_deepv3_train(card_info: str, root: str) -> dict:
    """``train_cityscapes_deepv3.yaml`` as shipped (DeepV3PlusW38 at full
    width, 800x800 crops, bf16, plain CE, SGD + poly 2, the WRN38 blocks
    remat'd, the uint8 wire) as two spatial ranks (``_sp_deepv3_ranks``):
    each rank trains on its 400-row band of every crop, every map even.
    Returns the launches over both ranks."""
    return _sp_deepv3_ranks(card_info, root, 2, SP_DEEPV3_VAL,
                            "sp-deepv3-train",
                            Path("chiprun_out/sp_deepv3_train"))


def phase_sp_uneven_train(card_info: str, root: str) -> dict:
    """Uneven bands: ``train_cityscapes_deepv3.yaml`` as shipped
    with ``mesh.model_parallelism=3``, three spatial ranks
    (``_sp_deepv3_ranks``): the maps' 800, 400, 200 and 100 rows split
    into padded bands of 267, 134, 67 and 34 rows, none even; SP_UNEVEN_VAL
    val scenes, one a rank. Returns the launches over the ranks."""
    return _sp_deepv3_ranks(card_info, root, 3, SP_UNEVEN_VAL,
                            "sp-uneven-train",
                            Path("chiprun_out/sp_uneven_train"))


# [sp-uneven-parity]: three gloo ranks of one sp group vs one
# process, f32, TF32 off, cuDNN deterministic, at crops whose maps do not
# split evenly over 3 bands, each band padded to ceil(H / 3) rows: W48
# HRNet_Mscale (the 0.5x pass's 5 stride-32 rows held as 2 + 2 + 1),
# DeepV3PlusW38 (25 stride-8 rows: 9 + 9 + 7) and attnscale.DeepV3R50 with
# the plain head (its 34-row attention map at 1.0x: 12 + 12 + 10). Held
# as [sp-zoo-parity]
SP_UNEVEN = 3
SP_UNEVEN_W48_HW = (320, 640)
SP_UNEVEN_ZOO = {"deepv3.DeepV3PlusW38": (200, 400),
                 "attnscale.DeepV3R50": (256, 512)}


def _sp_uneven_inputs() -> dict:
    """The W48 step's inputs at SP_UNEVEN_W48_HW (``_sp_inputs``), and for
    each SP_UNEVEN_ZOO factory its config (f32, remat off, CE) and one
    seeded scene at its crop whose top rows hold every ignore pixel."""
    zoo = {}
    for i, (arch, hw) in enumerate(SP_UNEVEN_ZOO.items()):
        image, _, label = _fake_scene(2010 + i, hw=hw)
        label = label.copy()
        label[:24] = 255
        zoo[arch] = {"sets": {"model.arch": arch, "model.compute_dtype":
                              "float32", "model.remat": False,
                              "model.n_scales": (), "loss.loss_type": "ce",
                              "loss.ocr_alpha": 0.4, "optim.lr": 5e-4},
                     "image": image[None], "label": label[None]}
    return {"w48": _sp_inputs(SP_UNEVEN_W48_HW), "zoo": zoo}


def _child_sp_uneven(tmp: str) -> None:
    """A rank of [sp-uneven-parity]: gloo on the card, one sp group of
    SP_UNEVEN. It takes the W48 CE step and each SP_UNEVEN_ZOO factory's
    CE step on its padded band; then the ranks leave the group
    and each runs one process for one case (rank 0 the W48 step, rank i
    the i-th factory; DDP left every rank's results equal): the steps on
    the whole image, held against its band's, and the f32 floor (the image
    twice vs once)."""
    import torch.distributed as dist

    from tpuseg_torch.config import make_config
    from tpuseg_torch.models import get_model
    from tpuseg_torch.parallel import init_distributed, make_mesh

    init_distributed("cuda", backend="gloo")
    _deterministic()
    inp = torch.load(Path(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(SP_UNEVEN)
    rank = mesh.sp_index
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w48 = _sp_steps(inp["w48"], mesh)
    res = {"w48": {"ce": {k: w48["ce"][k]
                          for k in ("loss", "counts", "seconds")}}}
    res["w48"]["s"] = time.perf_counter() - t0
    res["w48"]["sums"] = {"ce": _sums(w48["ce"],
                                      ("grads", "params", "stats"))}
    mine = {}
    for i, (arch, case) in enumerate(inp["zoo"].items()):
        cfg = make_config(case["sets"])
        model = get_model(cfg).to(
            "cuda", memory_format=torch.channels_last).train()
        _condition(model)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        batch = {k: case[k] for k in ("image", "label")}
        band = _sp_zoo_step(model, init, cfg, batch, mesh)
        res[arch] = {k: band[k]
                     for k in ("loss", "s", "nchw", "counts", "seconds")}
        res[arch]["sums"] = _sums(band, ("grads", "params", "stats"))
        if i + 1 == rank:
            mine[arch] = model, init, cfg, batch, band
        del model
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    dist.destroy_process_group()  # one process from here on
    if rank == 0:
        one = _sp_steps(inp["w48"])
        twice = _sp_steps(inp["w48"], copies=2)
        res["w48"]["ce"]["one"] = {
            "loss": one["ce"]["loss"],
            "grad_l1": _tree_l1(w48["ce"]["grads"], one["ce"]["grads"]),
            "floor": _tree_l1(twice["ce"]["grads"], one["ce"]["grads"])}
        res["w48"]["ce"]["one"]["params_l1"] = _tree_l1(
            w48["ce"]["params"], one["ce"]["params"])
        res["w48"]["ce"]["one"]["stats_l1"] = _tree_l1(
            w48["ce"]["stats"], one["ce"]["stats"])
    for arch, (model, init, cfg, batch, band) in mine.items():
        one = _sp_zoo_step(model, init, cfg, batch)
        # a doubled batch draws other masks: the floor runs without
        once = _sp_zoo_step(model, init, cfg, batch, masks=False)
        twice = _sp_zoo_step(model, init, cfg, {
            k: np.concatenate([v, v]) for k, v in batch.items()},
            masks=False)
        res[arch]["one"] = {
            "loss": one["loss"],
            "grad_l1": _tree_l1(band["grads"], one["grads"]),
            "params_l1": _tree_l1(band["params"], one["params"]),
            "stats_l1": _tree_l1(band["stats"], one["stats"]),
            "floor": _tree_l1(twice["grads"], once["grads"])}
    res["modules"] = _reference_modules()
    torch.save(res, Path(tmp, f"rank{rank}.pt"))


def start_sp_uneven_parity() -> dict:
    """Start [sp-uneven-parity]'s SP_UNEVEN ranks (``_child_sp_uneven``) in
    the background; ``phase_sp_uneven_parity`` waits for them and holds
    their results. -> what it needs."""
    out = Path("chiprun_out/sp_uneven_parity")
    out.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp()
    torch.save(_sp_uneven_inputs(), Path(tmp, "inputs.pt"))
    port = str(_free_port())
    procs = []
    for rank in range(SP_UNEVEN):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(SP_UNEVEN), MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        with open(out / f"rank{rank}.log", "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--child", "sp-uneven", tmp],
                stdout=log_f, stderr=subprocess.STDOUT, env=env,
                start_new_session=True))
    return {"out": out, "tmp": tmp, "procs": procs,
            "t0": time.perf_counter()}


def phase_sp_uneven_parity(card_info: str, started: dict) -> None:
    """Uneven bands: SP_UNEVEN gloo ranks of one sp group on the
    card, each on its band of ceil(H / 3) rows, the rows past H padding,
    against one process on the whole image, in f32 (TF32 off, cuDNN
    deterministic): W48 ``HRNet_Mscale`` at SP_UNEVEN_W48_HW (a CE + aux +
    mscale CE step), DeepV3PlusW38 and
    attnscale.DeepV3R50's plain head at their SP_UNEVEN_ZOO crops (a CE
    step, dropout and drop path on, the masks seeded alike). The ranks run
    in the background from ``start_sp_uneven_parity`` on, beside the other
    parity phases. Held for each CE step, as [sp-zoo-parity]: the ranks'
    mean loss, the parameters after SGD and the BN statistics within
    SP_ZOO_TOL, the gradients within 1e-4 or SP_GRAD_FLOORS times the f32
    floor (the one process on the image twice vs once, masks off); every
    rank's results equal (checksums), the factories' module outputs in
    the same memory formats on every rank; halo exchanges and sp sums
    issued. Printed: each step's sp collectives with their host seconds,
    and each rank's band step seconds."""
    out, tmp, procs = started["out"], started["tmp"], started["procs"]
    try:
        rcs = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
        if rcs != [0] * SP_UNEVEN:
            raise AssertionError(
                f"[sp-uneven-parity] ranks exited {rcs}: "
                + "".join((out / f"rank{r}.log").read_text()[-2000:]
                          for r in range(SP_UNEVEN)))
        ranks = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(SP_UNEVEN)]
    finally:
        for p in procs:
            _kill_group(p)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[sp-uneven-parity] ranks ran "
        f"{time.perf_counter() - started['t0']:.1f} s from their start, "
        f"beside the other parity phases")

    def held(tag, got, one, same, formats=True):
        loss = sum(g["loss"] for g in got) / len(got)
        gaps = {"loss_rel": abs(loss - one["loss"]) / abs(one["loss"]),
                **{k: one[k] for k in ("grad_l1", "params_l1",
                                       "stats_l1")}}
        bounds = dict(SP_ZOO_TOL, grad_l1=max(SP_ZOO_TOL["grad_l1"],
                                              SP_GRAD_FLOORS * one["floor"]))
        c = got[0]
        log(f"[sp-uneven-parity] {tag}, {SP_UNEVEN} gloo ranks of one sp "
            f"group vs one process (loss {one['loss']:.6f}): " + ", ".join(
                f"{k} {v:.3e} (bound {bounds[k]:.3g})"
                for k, v in gaps.items())
            + f"; the f32 floor (the image twice vs once) {one['floor']:.3e}"
            f"; ranks equal: {same}; output formats equal: {formats}; a "
            f"step's sp collectives on a rank: " + ", ".join(
                f"{c['counts'][k]} {k} in {c['seconds'][k]:.3f} s"
                for k in c["counts"]) + f"; on {card_info}")
        return ([k for k, v in gaps.items() if not v <= bounds[k]]
                or not same or not formats or not c["counts"]["halo"])

    bad = []
    w = [r["w48"] for r in ranks]
    one = w[0]["ce"]["one"]
    if held(f"W48 HRNet_Mscale f32 1x{SP_UNEVEN_W48_HW[0]}x"
            f"{SP_UNEVEN_W48_HW[1]}, CE + aux + mscale CE step",
            [g["ce"] for g in w], one,
            all(g["sums"]["ce"] == w[0]["sums"]["ce"] for g in w)):
        bad.append("W48 CE")
    log(f"[sp-uneven-parity] W48 band step by rank "
        + " ".join(f"{g['s']:.2f}" for g in w) + " s")
    for arch, hw in SP_UNEVEN_ZOO.items():
        got = [r[arch] for r in ranks]
        one, = [g["one"] for g in got if "one" in g]
        if held(f"{arch} f32 1x{hw[0]}x{hw[1]}, CE step", got, one,
                all(g["sums"] == got[0]["sums"] for g in got),
                all(g["nchw"] == got[0]["nchw"] for g in got)) or \
                not got[0]["counts"]["sum"]:
            bad.append(arch)
        log(f"[sp-uneven-parity] {arch} band step by rank "
            + " ".join(f"{g['s']:.2f}" for g in got) + " s")
    modules = sorted({m for r in ranks for m in r["modules"]})
    log(f"[sp-uneven-parity] peak device memory by rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; the ranks loaded "
        f"{modules or 'no'} tpuseg / JAX modules")
    if bad or modules:
        raise AssertionError(f"[sp-uneven-parity] out of bounds: {bad}, "
                             f"modules {modules}")


def child_main(argv: list) -> int:
    """A process this script starts: ``--child ddp-parity <dir>``,
    ``--child sp-parity <dir>``, ``--child sp-zoo <dir>``, ``--child
    sp-uneven <dir>``, ``--child loader <json spec>`` or ``--child cli
    <json spec>``."""
    kind, arg = argv
    if kind == "ddp-parity":
        _child_ddp_parity(arg)
    elif kind == "sp-parity":
        _child_sp_parity(arg)
    elif kind == "sp-zoo":
        _child_sp_zoo(arg)
    elif kind == "sp-uneven":
        _child_sp_uneven(arg)
    elif kind == "loader":
        _child_loader(json.loads(arg))
    else:
        _child_cli(json.loads(arg))
    return 0


T_START = time.perf_counter()


def timed(fn, *args):
    """``fn(*args)``, its wall seconds logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {fn.__name__} {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    LOG_COPY.parent.mkdir(exist_ok=True)
    LOG_COPY.write_text("")
    try:
        return run()
    finally:
        stop_processes()


def run() -> int:
    name, card_info = phase_device()
    timed(phase_build)
    records = timed(phase_kernels, card_info)
    launches = timed(phase_main_path, card_info)
    timed(phase_on_off, card_info)
    s1w32_launches = timed(phase_s1w32_eval, card_info)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        _write_fake_cityscapes(root)
        log(f"[data] wrote {TRAIN_IMAGES} train + {VAL_IMAGES} val "
            f"1024x2048 scenes in {time.perf_counter() - t0:.1f} s")
        model, ckpt = _conditioned_model(root)
        dump_launches = timed(phase_dump, card_info, root, model, ckpt)
        serve_launches = timed(phase_serve, card_info, root, model, ckpt)
        del model
        torch.cuda.empty_cache()
        timed(phase_summary, card_info)
        timed(phase_train_parity)
        train_launches = timed(phase_train, card_info, root)
        timed(phase_train_remat, card_info)
        # the parity phases time nothing that is reported: the ranks of
        # [sp-zoo-parity] and [sp-uneven-parity] run beside the other three
        sp_zoo = start_sp_zoo_parity()
        sp_uneven = start_sp_uneven_parity()
        timed(phase_zoo_parity, card_info)
        timed(phase_ddp_parity, card_info)
        timed(phase_sp_parity, card_info)
        timed(phase_sp_zoo_parity, card_info, sp_zoo)
        timed(phase_sp_uneven_parity, card_info, sp_uneven)
        timed(phase_zoo_eval, card_info)
        aspp_ocr_launches = timed(phase_aspp_ocr, card_info, root)
        deepv3_launches = timed(phase_deepv3_train, card_info, root)
        timed(phase_relaxed, card_info, root)
        mscale_launches = timed(phase_mscale_eval, card_info, root)
        timed(phase_mscale_train, card_info, root)
        timed(phase_loader, card_info, root)
        ddp_launches = timed(phase_ddp_train, card_info, root)
        timed(phase_ddp_nccl, card_info, root)
        sp_launches = timed(phase_sp_train, card_info, root)
        sp_deepv3_launches = timed(phase_sp_deepv3_train, card_info, root)
        sp_uneven_launches = timed(phase_sp_uneven_train, card_info, root)
    with tempfile.TemporaryDirectory() as mroot:
        t0 = time.perf_counter()
        _write_fake_mapillary(mroot)
        log(f"[data] wrote a Mapillary tree of {len(MAPILLARY_TRAIN_HW)} "
            f"training + {len(MAPILLARY_VAL_HW)} validation scenes in "
            f"{time.perf_counter() - t0:.1f} s")
        mapillary_launches = timed(phase_mapillary_eval, card_info, mroot)
        timed(phase_mapillary_train, card_info, mroot)
    # each kernel's launches on its own slice's path: W48's eval recipe
    # for the two kernels it runs, [s1w32-eval] for the other widths,
    # DeepLabV3+'s train recipe for the dilated conv
    paths = {"bottleneck_fused_any": ("s1w32-eval", s1w32_launches),
             "dilated_conv": ("deepv3-train", deepv3_launches)}
    for r in records:
        r["path"], path_launches = paths.get(r["name"], ("main", launches))
        r["launches"] = path_launches[r["name"]]
        r["main_launches"] = launches[r["name"]]
        r["dump_launches"] = dump_launches[r["name"]]
        r["serve_launches"] = serve_launches[r["name"]]
        r["train_launches"] = train_launches[r["name"]]
        r["aspp_ocr_launches"] = aspp_ocr_launches[r["name"]]
        r["deepv3_launches"] = deepv3_launches[r["name"]]
        r["mscale_launches"] = mscale_launches[r["name"]]
        r["mapillary_launches"] = mapillary_launches[r["name"]]
        r["ddp_launches"] = ddp_launches[r["name"]]
        r["sp_launches"] = sp_launches[r["name"]]
        r["sp_deepv3_launches"] = sp_deepv3_launches[r["name"]]
        r["sp_uneven_launches"] = sp_uneven_launches[r["name"]]
        r["s1w32_launches"] = s1w32_launches[r["name"]]
    log(f"[total] chip_smoke.py ran {time.perf_counter() - T_START:.1f} s")
    ref_mods = _reference_modules()
    log(f"[imports] tpuseg / JAX modules loaded: {ref_mods}")
    if ref_mods:
        raise AssertionError(f"the port imported {ref_mods}")
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:  # a rank this script started
        sys.exit(child_main(sys.argv[2:]))
    sys.exit(main())
