"""The port's spans and counters (``tpuseg_torch/utils/profiling.py``) and
the benchmark's reading of them (``portbench/spans.py``), on the CPU: the
spans an eval batch and a remat'd train step open under ``torch.profiler``
and how they nest, the counters that replaced the module globals, and the
span table and its metrics on fabricated profiler events."""
import ast
import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuseg_torch.config import make_config
from tpuseg_torch.evaluation.inference import EvalRunner
from tpuseg_torch.kernels import _build
from tpuseg_torch.losses import get_loss
from tpuseg_torch.models import get_model
from tpuseg_torch.parallel import spatial
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step
from tpuseg_torch.utils import profiling
from tpuseg_torch.utils.profiling import SPANS, span, spanned

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench import spans as pspans  # noqa: E402

torch.set_num_threads(1)

EVAL_SETS = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
             "model.compute_dtype": "float32", "model.remat": False,
             "model.n_scales": (0.5, 1.0, 2.0), "model.use_pallas": True,
             "dataset.num_classes": 19}
TRAIN_SETS = {"model.arch": "deepv3.DeepV3PlusW38Tiny",
              "model.compute_dtype": "float32", "model.remat": True,
              "dataset.num_classes": 19, "loss.loss_type": "ce"}
MODEL_SPANS = ("model.trunk", "model.ocr", "model.head", "model.fusion")


LAYERS = {n.split(".")[0] for n in SPANS}


def _recorded(prof) -> list:
    """(name, thread, start, end) of every host event recorded whose name
    starts as a span's does (``model.``, ``op.``, ...)."""
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.split(".")[0] in LAYERS]


def _program(spans: list) -> list:
    """The program's spans among ``spans``."""
    return [s for s in spans if s[0] in SPANS]


def _ancestors(spans: list) -> list:
    """The names above each span, innermost first."""
    parent, _ = pspans.tree(spans)
    out = []
    for i in range(len(spans)):
        names, j = [], parent[i]
        while j >= 0:
            names.append(spans[j][0])
            j = parent[j]
        out.append(names)
    return out


def _batch(rng, b, h, w):
    return {"image": rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8),
            "label": rng.randint(0, 19, (b, h, w)).astype(np.uint8)}


@pytest.fixture(scope="module")
def eval_trace():
    """One 3-scale batch of the tiny HRNet-OCR through ``EvalRunner``
    under a CPU profiler, the accumulator drained inside it; then two more
    batches, one at a new shape, outside it."""
    torch.manual_seed(0)
    cfg = make_config(EVAL_SETS)
    model = get_model(cfg).eval()
    runner = EvalRunner(model, 19, device="cpu")
    rng = np.random.RandomState(0)
    profiling.reset_counters()
    acc = runner.init_acc()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run_batch(_batch(rng, 1, 32, 64), need_assets=False, acc=acc)
        runner.drain(acc)
    runner.run_batch(_batch(rng, 1, 32, 64), need_assets=False, acc=acc)
    runner.run_batch(_batch(rng, 2, 32, 64), need_assets=False, acc=acc)
    return _recorded(prof), profiling.counters()


@pytest.fixture(scope="module")
def train_trace():
    """One train step of the tiny DeepLabV3+ on WRN38 with every block
    remat'd, under a CPU profiler."""
    torch.manual_seed(0)
    cfg = make_config(TRAIN_SETS)
    model = get_model(cfg).train()
    criterion, _ = get_loss(cfg)
    opt, schedule = make_optimizer(cfg, model.parameters(), 1)
    step = make_train_step(criterion, schedule)
    rng = np.random.RandomState(1)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(rng, 2, 32, 32).items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, opt, batch, 0)
    return _recorded(prof)


def test_span_is_a_shared_no_op_without_a_profiler():
    """No profiler: every span is the one no-op object, and a block run
    under one records nothing in a profiler started later."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("eval.forward") is span("model.trunk")
    assert span("op.bn") is profiling._NO_SPAN

    @spanned("op.resize")
    def twice(x):
        return 2 * x

    with span("eval.forward"):
        assert twice(3) == 6
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2) + 1
    assert not _recorded(prof)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert twice(torch.ones(2)).sum() == 4
    assert [s[0] for s in _recorded(prof)] == ["op.resize"]


def test_eval_batch_spans_nest_as_declared(eval_trace):
    """Every eval and model span, the model spans inside ``eval.forward``
    and none inside another; the eval spans at the top and apart."""
    spans = _program(eval_trace[0])
    names = {s[0] for s in spans}
    want = {"eval.upload", "eval.forward", "eval.score", "eval.drain",
            *MODEL_SPANS, "op.resize", "op.bn"}
    assert want <= names, want - names
    above = _ancestors(spans)
    for (name, *_), up in zip(spans, above):
        if name.startswith("eval."):
            assert not up, (name, up)
        if name in MODEL_SPANS:
            assert "eval.forward" in up, (name, up)
            assert not set(up) & set(MODEL_SPANS), (name, up)
        if name.startswith("op."):
            assert up and up[-1].startswith("eval."), (name, up)
    top = sorted((s[2], s[3]) for s in spans if s[0].startswith("eval."))
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    # the 3 scales: one trunk, OCR and head a scale
    assert sum(s[0] == "model.trunk" for s in spans) == 3
    assert sum(s[0] == "model.ocr" for s in spans) == 3


def test_eval_runner_counts_new_shapes(eval_trace):
    """(1, 32, 64) twice, then (2, 32, 64): two shapes first seen."""
    assert eval_trace[1].get("eval.new_shapes") == 2


def test_remat_block_in_forward_and_again_in_backward(train_trace):
    """``remat.block`` under ``model.trunk`` in ``train.forward``, and as
    often again under ``train.backward`` where the checkpoint recomputes
    it; the step's three top spans."""
    spans = _program(train_trace)
    above = _ancestors(spans)
    fwd = [up for (n, *_), up in zip(spans, above)
           if n == "remat.block" and "train.forward" in up]
    bwd = [up for (n, *_), up in zip(spans, above)
           if n == "remat.block" and "train.backward" in up]
    assert fwd and all("model.trunk" in up for up in fwd)
    assert len(bwd) == len(fwd)
    tops = {n for (n, *_), up in zip(spans, above) if not up}
    assert tops == {"train.forward", "train.backward", "train.optimizer"}
    assert {"model.head", "op.bn", "op.resize"} <= {s[0] for s in spans}


def _program_span_names() -> dict:
    """{name: files} of every literal name passed to ``span`` or
    ``spanned`` in the port's sources."""
    found: dict = {}
    for path in (ROOT / "tpuseg_torch").rglob("*.py"):
        if path.name == "profiling.py":  # where they are defined
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) in ("span", "spanned"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), (path, ast.dump(arg))
                found.setdefault(arg.value, set()).add(path.name)
    return found


def test_no_span_name_outside_spans(eval_trace, train_trace):
    """The sources open only names of ``SPANS`` and open each of them; the
    profiles record no other dotted name of the program's layers."""
    used = _program_span_names()
    assert set(used) <= set(SPANS), set(used) - set(SPANS)
    assert set(used) == set(SPANS), set(SPANS) - set(used)
    assert len(SPANS) == len(set(SPANS))
    recorded = {name for name, *_ in eval_trace[0] + train_trace}
    assert recorded and recorded <= set(SPANS), recorded - set(SPANS)


EFFB4_SETS = {"model.arch": "deepv3.DeepV3PlusEffB4",
              "model.compute_dtype": "float32", "model.remat": True,
              "dataset.num_classes": 19}


@pytest.fixture(scope="module")
def effb4():
    """DeepLabV3+ on the full-width EfficientNet-B4 trunk (32 MBConv
    blocks, 25 of them residual with a drop path) and a 2 x 32 x 32 input."""
    torch.manual_seed(0)
    model = get_model(make_config(EFFB4_SETS))
    return model, torch.randn(2, 32, 32, 3)


def test_effb4_forward_spans_each_depthwise_conv_and_se(effb4):
    """One eval forward under a CPU profiler: an ``op.dwconv`` and a
    ``model.se`` span for each of the 32 blocks, inside ``model.trunk``."""
    model, x = effb4
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model.eval()(x)
    spans = _program(_recorded(prof))
    names = [s[0] for s in spans]
    assert names.count("op.dwconv") == names.count("model.se") == 32
    for (name, *_), up in zip(spans, _ancestors(spans)):
        if name in ("op.dwconv", "model.se"):
            assert up == ["model.trunk"], (name, up)


def test_effb4_drop_path_draws_count(effb4):
    """25 draws a training forward, as many again where the backward
    recomputes the remat'd blocks; none in eval."""
    model, x = effb4
    profiling.reset_counters()
    with torch.no_grad():
        model.eval()(x)
    assert profiling.counters().get("drop_path.draws", 0) == 0
    out = model.train()(x)["pred"]
    assert profiling.counters()["drop_path.draws"] == 25
    out.sum().backward()
    assert profiling.counters()["drop_path.draws"] == 50


def test_effb4_makes_no_span_object_without_a_profiler(effb4, monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "_RECORD",
                        lambda name: made.append(name) or profiling._NO_SPAN)
    model, x = effb4
    with torch.no_grad():
        model.eval()(x)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model(x[:1])
    assert made.count("op.dwconv") == 32


def test_counters_add_copy_and_reset():
    profiling.reset_counters()
    profiling.count("a")
    profiling.count("a", 2)
    profiling.count("b.host_s", 0.25)
    got = profiling.counters()
    assert got == {"a": 3, "b.host_s": 0.25}
    got["a"] = 0
    assert profiling.counters()["a"] == 3
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_sp_collectives_count_by_kind(monkeypatch):
    """Each collective of the sp groups counts once under its kind, with
    its host seconds, where ``spatial.COUNTS`` / ``SECONDS`` counted."""
    issued = []
    monkeypatch.setattr(spatial.dist, "all_reduce",
                        lambda t, op=None, group=None: issued.append(op))
    profiling.reset_counters()
    x = torch.ones(3)
    for kind in ("halo", "halo", "sum", "max"):
        spatial._all_reduce(x, None, kind)
    got = profiling.counters()
    assert len(issued) == 4
    assert {k: got.get(f"sp.{k}") for k in spatial.KINDS} == {
        "halo": 2, "sum": 1, "max": 1}
    assert all(got[f"sp.{k}.host_s"] >= 0 for k in spatial.KINDS)


def test_kernel_build_counts_once_a_build(monkeypatch, tmp_path):
    """An ``nvcc`` build (here a stand-in that writes its ``-o`` file)
    counts in ``kernel.builds`` and ``kernel.build_s``; a library of the
    same sources is loaded as it is and counts nothing."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
                    "done\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    profiling.reset_counters()
    so = _build.build()
    assert so.exists() and profiling.counters()["kernel.builds"] == 1
    assert profiling.counters()["kernel.build_s"] >= 0
    assert _build.build() == so
    assert profiling.counters()["kernel.builds"] == 1
    assert os.listdir(tmp_path / "build") != []


# fabricated profiles: (name, thread, start, end) spans in microseconds on
# the main thread 1 and the autograd thread 2, and (name, start, end,
# (launch thread, start, end)) device ops
SPANS_T = [("train.forward", 1, 0, 100), ("model.trunk", 1, 5, 90),
           ("remat.block", 1, 10, 40), ("op.bn", 1, 20, 30),
           ("train.backward", 1, 100, 200), ("remat.block", 2, 120, 150),
           ("op.bn", 2, 130, 140), ("train.optimizer", 1, 200, 210)]
OPS_T = [
    ("k_bn", 22, 26, (1, 21, 22)),        # op.bn in the forward
    ("k_blk", 32, 38, (1, 31, 32)),       # remat.block in the forward
    ("k_trunk", 45, 55, (1, 44, 45)),     # the trunk outside a block
    ("k_grad", 105, 115, (2, 102, 103)),  # autograd thread, no span there
    ("k_rbn", 135, 139, (2, 131, 132)),   # recomputed op.bn
    ("k_rblk", 140, 148, (2, 141, 142)),  # recomputed block
    ("k_sgd", 202, 204, (1, 201, 202)),   # the optimizer
    ("Memcpy HtoD", 300, 310, None),      # unlinked: (none)
    ("k_late", 310, 320, (1, 250, 251)),  # launched under no span
]


@pytest.mark.parametrize("name,path", [
    ("k_bn", "train.forward/model.trunk/remat.block/op.bn"),
    ("k_blk", "train.forward/model.trunk/remat.block"),
    ("k_trunk", "train.forward/model.trunk"),
    ("k_grad", "train.backward"),
    ("k_rbn", "train.backward/remat.block/op.bn"),
    ("k_rblk", "train.backward/remat.block"),
    ("k_sgd", "train.optimizer"),
    ("Memcpy HtoD", pspans.NONE),
    ("k_late", pspans.NONE)])
def test_span_table_attributes_each_op(name, path):
    """Innermost span on the launching thread; the main thread's innermost
    open span at the launch where that thread has none; ``(none)`` for an
    op with no link or no span."""
    op = next(o for o in OPS_T if o[0] == name)
    tab = pspans.table(SPANS_T, [op])
    assert list(tab["paths"]) == [path]
    row = tab["paths"][path]
    assert row["device_s"] == pytest.approx((op[2] - op[1]) / 1e6)
    assert row["launches"] == (0 if name.startswith("Memcpy") else 1)


def test_span_table_idle_gaps_and_totals():
    """Each gap between busy runs goes to the main thread's innermost span
    at its middle: 26-32 (mid 29, op.bn), 38-45 (41.5, model.trunk), 55-105
    (80, model.trunk), 115-135 (125, train.backward: the main thread's),
    139-140 and 148-202 (train.backward), 204-300 (252, none)."""
    tab = pspans.table(SPANS_T, OPS_T)
    idle = {p: r["idle_s"] * 1e6 for p, r in tab["paths"].items()
            if r["idle_s"]}
    assert idle == pytest.approx({
        "train.forward/model.trunk/remat.block/op.bn": 6.0,
        "train.forward/model.trunk": 7.0 + 50.0,
        "train.backward": 20.0 + 1.0 + 54.0,
        pspans.NONE: 96.0})
    assert tab["busy_s"] * 1e6 == pytest.approx(4 + 6 + 10 + 10 + 4 + 8 + 2
                                                 + 20)
    assert tab["calls"] == {"train.forward": 1, "model.trunk": 1,
                            "remat.block": 2, "op.bn": 2,
                            "train.backward": 1, "train.optimizer": 1}
    names = pspans.by_name(tab)
    assert names["train.backward"]["device_s"] * 1e6 == pytest.approx(22)
    assert names["remat.block"]["device_s"] * 1e6 == pytest.approx(22)
    assert names[pspans.NONE]["launches"] == 1


def test_span_table_without_spans_reads_nothing():
    """A program without spans (the parent of the spans): every op under
    ``(none)``, every metric None."""
    tab = pspans.table([], OPS_T)
    assert list(tab["paths"]) == [pspans.NONE]
    assert all(pspans.metric(tab, m, 8) is None for m in pspans.METRICS)


# a fabricated table: device and idle microseconds by path, 2 images
TAB = {"paths": {
    "eval.upload": {"device_s": 1e-6, "launches": 0, "idle_s": 0.0},
    "eval.forward/model.fusion/op.resize": {
        "device_s": 3e-6, "launches": 1, "idle_s": 1e-6},
    "eval.forward/model.trunk": {"device_s": 40e-6, "launches": 9,
                                 "idle_s": 4e-6},
    "eval.forward/model.trunk/op.bn": {"device_s": 8e-6, "launches": 4,
                                       "idle_s": 2e-6},
    "eval.forward/model.ocr": {"device_s": 6e-6, "launches": 3,
                               "idle_s": 0.0},
    "eval.forward/model.head/op.resize": {"device_s": 5e-6, "launches": 1,
                                          "idle_s": 1e-6},
    "eval.forward": {"device_s": 0.5e-6, "launches": 1, "idle_s": 3e-6},
    "eval.score": {"device_s": 2e-6, "launches": 5, "idle_s": 0.0},
    "train.forward/op.bn": {"device_s": 7e-6, "launches": 2, "idle_s": 0},
    "train.forward/model.trunk/remat.block": {
        "device_s": 10e-6, "launches": 3, "idle_s": 0.0},
    "train.backward": {"device_s": 20e-6, "launches": 6, "idle_s": 0.0},
    "train.backward/remat.block/op.bn": {"device_s": 4e-6, "launches": 2,
                                         "idle_s": 0.0},
    "train.backward/remat.block": {"device_s": 6e-6, "launches": 2,
                                   "idle_s": 0.0},
    "train.optimizer": {"device_s": 1e-6, "launches": 1, "idle_s": 0.0}},
    "calls": {n: 1 for n in SPANS}, "busy_s": 1.0, "idle_s": 0.0}


@pytest.mark.parametrize("metric,us", [
    ("trunk_ms_per_img.eval", 40 + 8 + 10),
    ("ocr_ms_per_img.eval", 6),
    ("fusion_ms_per_img.eval", 3 + 5),
    ("score_ms_per_img.eval", 2),
    ("model_idle_ms_per_img.eval", 1 + 4 + 2 + 1),
    ("resize_op_ms_per_img.eval", 3 + 5),
    ("fwd_ms_per_img.train", 17),
    ("bwd_ms_per_img.train", 30),
    ("recompute_ms_per_img.train", 10),
    ("optim_ms_per_img.train", 1),
    ("bn_op_ms_per_img.train", 8 + 7 + 4)])
def test_span_metric_arithmetic(metric, us):
    """Each metric's device (or idle) milliseconds an image, its spans read
    inclusively, over 2 images."""
    assert pspans.metric(TAB, metric, 2) == pytest.approx(1e-3 * us / 2)


class _Event:
    """A Kineto event as ``prof.profiler.kineto_results.events()`` gives
    it: times in ns."""

    def __init__(self, name, device, thread, start, end, corr, link=0,
                 note=False):
        self._v = (name, device, thread, start, end, corr, link, note)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_thread_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4] - self._v[3]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def test_from_profile_launch_is_the_runtime_call():
    """A kernel launched by ctypes inside ``kernel.ocr_attention`` links to
    the registered op around it; its runtime call (same correlation id)
    places it in the span. Without a runtime call the op's whole interval
    is the launch. Device annotation ranges and other annotations drop."""
    from types import SimpleNamespace

    ev = [_Event("model.ocr", 0, 1, 0, 100_000, 1, note=True),
          _Event("tpuseg_torch::ocr_attention", 0, 1, 10_000, 50_000, 7),
          _Event("kernel.ocr_attention", 0, 1, 20_000, 30_000, 8,
                 note=True),
          _Event("Optimizer.step#SGD.step", 0, 1, 60_000, 70_000, 9,
                 note=True),
          _Event("cudaLaunchKernel", 0, 4242, 22_000, 24_000, 900, link=7),
          _Event("attention_tc_kernel", 1, 0, 40_000, 60_000, 900, link=7),
          _Event("other_kernel", 1, 0, 60_000, 70_000, 901, link=7),
          _Event("kernel.ocr_attention", 1, 0, 40_000, 60_000, 902,
                 note=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    spans, ops = pspans.from_profile(prof)
    assert [s[0] for s in spans] == ["model.ocr", "kernel.ocr_attention"]
    assert [o[0] for o in ops] == ["attention_tc_kernel", "other_kernel"]
    assert ops[0][3] == (1, 22.0, 24.0) and ops[1][3] == (1, 10.0, 50.0)
    paths = pspans.attribute(spans, ops)[0]
    assert paths == ["model.ocr/kernel.ocr_attention", "model.ocr"]
