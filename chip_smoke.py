"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks each against its plain PyTorch version at the main path's shapes of
the three eval scales (and at ragged and wider cases) and times it there
beside its bound (and beside F.scaled_dot_product_attention, or the
model's unfused cuDNN block), with inputs from device memory, drives
the W48 3-scale eval path through the CLI's code, compares kernels on vs
off, and profiles one image.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and this checkout; exits non-zero otherwise
and on any failed phase. The profile's whole table goes to
``chiprun_out/profile_top.txt``. The line before the last is a JSON record
of the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

RECIPE = "tpuseg_torch/cli/recipes/eval_cityscapes.yaml"
MAIN_IMAGES = 5  # train.test_mode stops the eval loop after 5 images
REPS = 20
ON_OFF_REPS = 3  # timed images a side in each half of phase 5


def log(msg: str) -> None:
    print(msg, flush=True)


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
    r = lambda *s: torch.randn(*s, generator=gen)
    x = r(b, h, w, c).to("cuda", torch.bfloat16)
    w1 = (r(c, m) * 0.1).to("cuda", torch.bfloat16)
    b1 = (r(m).abs() + 0.5).cuda()          # positive: pins the border
    w2 = (r(9, m, m) * 0.1).to("cuda", torch.bfloat16)
    b2 = (r(m) * 0.1).cuda()
    w3 = (r(m, c) * 0.1).to("cuda", torch.bfloat16)
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
        plain = time_ms(ak.object_attention_reference, copies)
        with torch.inference_mode():
            lib = time_ms(sdpa, copies)
        bnd, by = _attention_bound(*args)
        rows[s] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
        log(f"[kernel] ocr_attention {s}x (1,{ATTN_N[s]},256) K=19 bf16: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of the bound "
            f"(median of {REPS} x 10 calls over {len(copies)} input "
            f"copies, {card_info})")
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
        plain = time_ms(lambda x: bk.bottleneck_reference(x, *weights),
                        copies)
        with torch.inference_mode():
            unfused_ms = time_ms(unfused, copies)
        bnd, by = _bottleneck_bound(*args)
        rows[s] = {"ms": ms, "plain_ms": plain, "unfused_ms": unfused_ms,
                   "bound_ms": bnd, "bound_by": by, **err}
        log(f"[kernel] bottleneck {s}x x=(1,{BNECK_HW[s][0]},"
            f"{BNECK_HW[s][1]},256) bf16: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, unfused cuDNN block {unfused_ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of the bound "
            f"(median of {REPS} x 10 calls over {len(copies)} input "
            f"copies, {card_info})")
    return rows


def phase_kernels(card_info: str) -> list:
    """Each kernel vs its plain version on the card, then timed at the main
    path's shapes at the three scales. Returns the JSON records (launches
    filled in by the main path's run)."""
    from tpuseg_torch.kernels import bottleneck_fused as bk
    from tpuseg_torch.kernels import ocr_attention as ak

    gen = torch.Generator().manual_seed(0)
    records = []
    for name, mod, check, timed, replaces in (
            ("ocr_attention", ak, _check_attention, _time_attention,
             "tpuseg/kernels/ocr_attention.py:92"),
            ("bottleneck_fused", bk, _check_bottleneck, _time_bottleneck,
             "tpuseg/kernels/bottleneck_fused.py:118")):
        rows = timed(mod, gen, card_info)
        max_abs = max(check(mod, gen),
                      *(r["max_abs_err"] for r in rows.values()))
        main = rows[1.0]
        records.append({
            "name": name, "route": "cuda",
            "source": f"tpuseg_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": 0, "max_abs_err": max_abs, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
            **({"unfused_ms": main["unfused_ms"]} if "unfused_ms" in main
               else {}),
            "scales": {str(s): r for s, r in rows.items()}})
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


def phase_main_path(card_info: str) -> dict:
    """W48 HRNet_Mscale, 3 scales, 1024x2048, bf16, both kernels on, through
    the CLI's code path. Returns each kernel's launch count."""
    from tpuseg_torch.cli.main import main as cli_main
    from tpuseg_torch.kernels import bottleneck_fused as bk
    from tpuseg_torch.kernels import ocr_attention as ak

    argv = ["eval", "--config", RECIPE, "--logdir", "chiprun_out/logs",
            "--set", "dataset.name=synthetic",
            "--set", "eval.dump_assets=false",
            "--set", "train.test_mode=true",
            "--set", "model.use_pallas=true",
            "--set", "model.fused_stage1=true"]
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    ak.LAUNCHES = bk.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    launches = {"ocr_attention": ak.LAUNCHES,
                "bottleneck_fused": bk.LAUNCHES}
    if rc != 0:
        raise AssertionError(f"tpuseg_torch.cli eval returned {rc}")
    log_text = tee.buf.getvalue()
    if "mean mIoU:" not in log_text:
        raise AssertionError("the eval printed no mIoU")
    want = {"ocr_attention": 3 * MAIN_IMAGES,
            "bottleneck_fused": 9 * MAIN_IMAGES}
    log(f"[main] launches {launches} (want {want}: 3 attention and 9 "
        f"bottleneck calls per image)")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    m = re.search(r"after the first: ([\d.]+) img/s, ([\d.]+) Mpx/s",
                  log_text)
    if m is None:
        raise AssertionError("the eval printed no rate")
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[main] W48 HRNet_Mscale 3-scale 1024x2048 bf16, {MAIN_IMAGES} "
        f"images: {m.group(1)} img/s, {m.group(2)} Mpx/s (images 2-5), "
        f"whole CLI run {wall:.2f} s, peak device memory {mem:.2f} GiB, on "
        f"{card_info}")
    return launches


def _calibrate_bn(model, x) -> None:
    """Set every BN's running statistics to the average batch statistics of
    the image at the three eval scales, so that a random weight draw keeps
    activations O(1) through the W48 trunk. The BNs over the K class
    proxies (f_object, f_down) keep unit statistics: the proxies are
    averages over many pixels and nearly equal, so batch statistics over
    them would blow up any later deviation of their inputs. For the same
    reason each running variance is floored at a tenth of the channel's
    second moment: a channel nearly constant over the pixels is not scaled
    up more than ~3x its RMS."""
    from tpuseg_torch.ops import resize_x

    bns = [m for n, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)
           and ".f_object." not in n and ".f_down." not in n]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average over the calibration passes
        bn.train()
    with torch.no_grad():
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
    _profile(lambda: runner.forward(image, label, runner.init_acc()),
             card_info)


def _profile(fn, card_info: str, top: int = 12) -> None:
    """Device time by kernel name over one image with both kernels on, from
    torch.profiler: the top entries printed, the whole table written to
    chiprun_out/profile_top.txt."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()  # warm-up outside the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    def device_us(e):
        # device kernels only: a CPU op's entry repeats its kernels' time
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
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
        log("[profile] the profiler saw no device time: not measured")
        return
    lines = [f"device time {total / 1e3:.3f} ms over {wall * 1e3:.3f} ms of "
             f"wall time ({1 - total / 1e6 / wall:.1%} idle), one image, "
             f"{card_info}"]
    lines += [f"{us / 1e3:9.3f} ms {us / total:6.1%} x{n:<5d} {name[:90]}"
              for us, n, name in rows]
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_top.txt").write_text("\n".join(lines) + "\n")
    for line in lines[:top + 1]:
        log(f"[profile] {line}")


def main() -> int:
    name, card_info = phase_device()
    phase_build()
    records = phase_kernels(card_info)
    launches = phase_main_path(card_info)
    for r in records:
        r["launches"] = launches[r["name"]]
    phase_on_off(card_info)
    jax_mods = sorted({m.split(".")[0] for m in sys.modules}
                      & {"jax", "jaxlib", "flax", "optax", "orbax"})
    ref_mods = sorted(m for m in sys.modules if m.split(".")[0] == "tpuseg")
    log(f"[imports] JAX modules loaded: {jax_mods}; tpuseg modules loaded: "
        f"{ref_mods}")
    if jax_mods or ref_mods:
        raise AssertionError(f"the port imported {jax_mods + ref_mods}")
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
