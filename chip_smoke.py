"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks each against its plain PyTorch version, drives the W48 3-scale
eval path through the CLI's code, and compares kernels on vs off.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and this checkout; exits non-zero otherwise
and on any failed phase. Every phase prints one line. The line before the
last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

RECIPE = "tpuseg/cli/recipes/eval_cityscapes.yaml"
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


def time_ms(fn) -> float:
    """Median of REPS CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(got: torch.Tensor, want: torch.Tensor):
    g, w = got.double(), want.double()
    max_abs = float((g - w).abs().max())
    l1 = float((g - w).abs().sum() / w.abs().sum().clamp_min(1e-30))
    return max_abs, l1


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
            if "registers" in line or "spill" in line:
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


def phase_kernels() -> list:
    """Each kernel vs its plain version on the card; timings at the main
    path's 1.0x shapes. Returns the JSON records (launches filled later)."""
    from tpuseg_torch.kernels import bottleneck_fused as bk
    from tpuseg_torch.kernels import ocr_attention as ak

    gen = torch.Generator().manual_seed(0)
    records = []

    # object attention: the 1.0x main-path shape in bf16, ragged f32 cases
    cases = [("main", 1, 131072, 19, 256, torch.bfloat16, 5e-2),
             ("ragged", 2, 3001, 65, 128, torch.float32, 1e-4),
             ("k128", 1, 5001, 128, 128, torch.float32, 1e-4)]
    main = None
    for tag, b, n, k, d, dt, tol in cases:
        q, key, val = _attention_case(gen, b, n, k, d, dt)
        got = ak.fused_object_attention(q, key, val)
        want = ak.object_attention_reference(q, key, val)
        torch.cuda.synchronize()
        max_abs, l1 = compare(got, want)
        log(f"[kernel] ocr_attention {tag} B={b} N={n} K={k} d={d} {dt}: "
            f"max|d|={max_abs:.3e} l1_rel={l1:.3e} (bound max|d| < {tol})")
        if not max_abs < tol:
            raise AssertionError(f"ocr_attention {tag}: max|d| {max_abs}")
        if tag == "main":
            main = (q, key, val, max_abs)
    q, key, val, max_abs = main
    ms = time_ms(lambda: ak.fused_object_attention(q, key, val))
    plain_ms = time_ms(lambda: ak.object_attention_reference(q, key, val))
    log(f"[kernel] ocr_attention N=131072 K=19 d=256 bf16: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of {REPS})")
    records.append({"name": "ocr_attention", "route": "cuda",
                    "source": "tpuseg_torch/csrc/ocr_attention.cu",
                    "replaces": "tpuseg/kernels/ocr_attention.py:92",
                    "launches": 0, "max_abs_err": max_abs, "ms": ms,
                    "plain_ms": plain_ms})

    # fused bottleneck: the 1.0x main-path shape and a ragged batch of 2
    main = None
    for tag, shape in (("main", (1, 256, 512)), ("ragged", (2, 37, 75))):
        args = _bottleneck_case(gen, *shape)
        got = bk.fused_bottleneck(*args)
        want = bk.bottleneck_reference(*args)
        torch.cuda.synchronize()
        max_abs, l1 = compare(got, want)
        border = torch.ones(got.shape[1:3], dtype=torch.bool, device="cuda")
        border[1:-1, 1:-1] = False
        bmax, bl1 = compare(got[:, border], want[:, border])
        log(f"[kernel] bottleneck {tag} x={tuple(got.shape)} bf16, b1>0: "
            f"max|d|={max_abs:.3e} l1_rel={l1:.3e}; border max|d|="
            f"{bmax:.3e} l1_rel={bl1:.3e} (bound l1_rel < 2e-2 overall "
            f"and at the border)")
        if not (l1 < 2e-2 and bl1 < 2e-2):
            raise AssertionError(f"bottleneck {tag}: l1 {l1}, border {bl1}")
        if tag == "main":
            main = (args, max_abs)
    args, max_abs = main
    ms = time_ms(lambda: bk.fused_bottleneck(*args))
    plain_ms = time_ms(lambda: bk.bottleneck_reference(*args))
    log(f"[kernel] bottleneck x=(1,256,512,256) bf16: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (median of {REPS})")
    # what the model runs with the kernel off: the unfused eval block, cuDNN
    # bf16 convs with separate BN, ReLU and residual passes
    from tpuseg_torch.models.hrnet import Bottleneck
    from tpuseg_torch.models.layers import init_weights

    block = Bottleneck(256, 64)
    init_weights(block, torch.Generator().manual_seed(0))
    block = block.to("cuda", memory_format=torch.channels_last).eval()
    xc = args[0].permute(0, 3, 1, 2)  # NCHW view of the NHWC input
    with torch.inference_mode():
        unfused_ms = time_ms(lambda: block(xc))
    log(f"[kernel] bottleneck x=(1,256,512,256) bf16: the model's unfused "
        f"block (cuDNN) {unfused_ms:.4f} ms (median of {REPS})")
    records.append({"name": "bottleneck_fused", "route": "cuda",
                    "source": "tpuseg_torch/csrc/bottleneck_fused.cu",
                    "replaces": "tpuseg/kernels/bottleneck_fused.py:118",
                    "launches": 0, "max_abs_err": max_abs, "ms": ms,
                    "plain_ms": plain_ms})
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


def main() -> int:
    name, card_info = phase_device()
    phase_build()
    records = phase_kernels()
    launches = phase_main_path(card_info)
    for r in records:
        r["launches"] = launches[r["name"]]
    phase_on_off(card_info)
    jax_mods = sorted({m.split(".")[0] for m in sys.modules}
                      & {"jax", "jaxlib", "flax", "optax", "orbax"})
    log(f"[imports] JAX modules loaded: {jax_mods}")
    if jax_mods:
        raise AssertionError(f"the port imported {jax_mods}")
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
