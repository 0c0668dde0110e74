"""torch.export bundles of the port (tpuseg_torch/serving.py) held against
the eager forward and tpuseg's ``model.apply`` on the same weights, the
bundle semantics of tests/test_serving.py, the HTTP server, the ``export``
CLI, the two kernels as registered ops in the exported graph, and
``summary``."""
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import flax_shapes, load_into, max_abs, random_variables
from _torch_port import set_threads
from tpuseg.config import eval_model_config as jax_eval_config
from tpuseg.config import make_config as jax_config
from tpuseg.models import get_model as jax_model
from tpuseg_torch.cli.main import main as cli_main
from tpuseg_torch.config import eval_model_config, make_config
from tpuseg_torch.kernels import bottleneck_fused as bk
from tpuseg_torch.models import get_model
from tpuseg_torch.models.hrnet import Bottleneck
from tpuseg_torch.serving import export_model, load_exported, \
    make_http_server
from tpuseg_torch.utils.profiling import model_summary

set_threads()

SETS = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
        "model.compute_dtype": "float32", "model.remat": False,
        "model.n_scales": (1.0,), "model.use_pallas": True,
        "dataset.num_classes": 19}
HW = (32, 64)


def _ops(program) -> list:
    return [str(n.target) for n in program.graph.nodes
            if str(n.target).startswith("tpuseg_torch.")]


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The tiny model (one scale, to keep the export short) with seeded
    random weights, exported by the
    ``export`` CLI from a reference-format .pth on the CPU in f32."""
    tmp = tmp_path_factory.mktemp("serve")
    jm = jax_model(jax_eval_config(jax_config(SETS)))
    variables = random_variables(jm, np.random.RandomState(0),
                                 jnp.zeros((1, *HW, 3)))
    port = load_into(get_model(eval_model_config(make_config(SETS))),
                     variables)
    ckpt = str(tmp / "weights.pth")
    torch.save(port.state_dict(), ckpt)
    path = str(tmp / "bundle")
    argv = ["export", "--device", "cpu", "--checkpoint", ckpt,
            "--export-out", path, "--export-size", "x".join(map(str, HW))]
    for k, v in SETS.items():
        argv += ["--set", f"{k}={v}"]
    assert cli_main(argv) == 0
    return path, jm, variables, port, load_exported(path)


def test_exported_matches_eager_and_tpuseg(bundle):
    path, jm, variables, port, serve = bundle
    (entry,) = serve.manifest["entries"]
    assert entry["input"] == {"shape": [1, *HW, 3], "dtype": "float32"}
    assert entry["device"] == "cpu"
    x = np.random.RandomState(1).randn(1, *HW, 3).astype(np.float32)
    got = serve(x)
    assert got.dtype == torch.float32 and got.shape == (1, *HW, 19)
    with torch.inference_mode():
        eager = port(torch.from_numpy(x))["pred"]
    assert max_abs(got, eager) < 1e-5
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False)["pred"])(
        variables, jnp.asarray(x))
    assert max_abs(got, np.asarray(want)) < 1e-4
    assert float(got.std()) > 1e-2  # not a trivial comparison
    # the attention op in the saved graph
    program = torch.export.load(os.path.join(path, entry["file"]))
    assert _ops(program) == ["tpuseg_torch.ocr_attention.default"]
    with pytest.raises(ValueError, match="no entry"):
        serve(np.zeros((1, 64, 64, 3), np.float32))


def _widen(x):
    """(B, H, W, 3) -> (B, H, W, 256) by repeating the channels."""
    return x.repeat(1, 1, 1, 86)[..., :256]


class _FusedBlock(torch.nn.Module):
    """A fused stage-1 Bottleneck as a model: an NHWC image widened to its
    256 channels in, {"pred": ...} out."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x):
        y = self.block(_widen(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        return {"pred": y.permute(0, 2, 3, 1)}


def test_exported_fused_bottleneck_holds_the_op(tmp_path):
    """C = 256, M = 64 (the CUDA kernel's width), 16x16, bf16 on the CPU:
    the block's folded weights are frozen into the program, the graph
    holds the bottleneck op, and the result is the plain version's; the
    block is left as it was."""
    gen = torch.Generator().manual_seed(2)
    block = Bottleneck(256, 64, fused_kernel=True).eval()
    with torch.no_grad():
        for name, t in block.state_dict().items():
            if name.endswith("weight") and t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=gen)
                        / t[0].numel() ** 0.5)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    before = {k: v.clone() for k, v in block.state_dict().items()}
    entry = export_model(_FusedBlock(block), (16, 16), str(tmp_path),
                         input_dtype="bfloat16", device="cpu")
    program = torch.export.load(str(tmp_path / entry["file"]))
    assert _ops(program) == ["tpuseg_torch.bottleneck_fused.default"]
    assert not any(n.startswith("folded_") for n, _ in block.named_buffers())
    assert all(torch.equal(before[k], v)
               for k, v in block.state_dict().items())
    x = torch.randn(1, 16, 16, 3, generator=gen).bfloat16()
    got = load_exported(str(tmp_path))(x)
    want = bk.bottleneck_reference(_widen(x), *block._folded().weights)
    assert got.shape == (1, 16, 16, 256)
    assert torch.equal(got, want.float())


class _Toy(torch.nn.Module):
    """A 1x1 conv to 19 classes: enough for the bundle's bookkeeping."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 19, 1)

    def forward(self, x):
        return {"pred": self.conv(x.float().permute(0, 3, 1, 2))
                .permute(0, 2, 3, 1)}


def test_export_multi_entry_bundle(tmp_path):
    """Several sizes accumulate into one bundle; re-export replaces an
    entry; serve() dispatches on the input shape (tests/test_serving.py)."""
    path = str(tmp_path / "bundle")
    model = _Toy()
    manifest = export_model(model, [(8, 8), (8, 16)], path,
                            input_dtype="float32", device="cpu")
    assert len(manifest["entries"]) == 2
    export_model(model, (16, 16), path, input_dtype="float32", device="cpu")
    export_model(model, (8, 8), path, input_dtype="float32", device="cpu")
    serve = load_exported(path)
    assert len(serve.manifest["entries"]) == 3
    for hw in [(8, 8), (8, 16), (16, 16)]:
        x = torch.randn(1, *hw, 3)
        assert torch.equal(serve(x), model(x)["pred"].detach())
    with pytest.raises(ValueError, match="no entry"):
        serve(np.zeros((1, 4, 4, 3), np.float32))


def test_export_two_dtypes_same_size(tmp_path):
    """Entries are keyed by (shape, dtype): two dtypes at one size coexist
    and serve() dispatches on the input dtype."""
    path = str(tmp_path / "dt")
    for dtype in ("float32", "bfloat16"):
        export_model(_Toy(), (8, 8), path, input_dtype=dtype, device="cpu")
    serve = load_exported(path)
    assert len(serve.manifest["entries"]) == 2
    assert serve(np.zeros((1, 8, 8, 3), np.float32)).shape == (1, 8, 8, 19)
    assert serve(torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16)).shape == \
        (1, 8, 8, 19)
    with pytest.raises(ValueError, match="dtype"):
        serve(np.zeros((1, 8, 8, 3), np.int32))


@pytest.mark.parametrize("fmt", ["tpuseg-export-v2", "something-else"])
def test_foreign_bundle_is_refused(tmp_path, fmt):
    """A tpuseg StableHLO bundle (or any other format) is refused, never
    clobbered."""
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    manifest = {"format": fmt, "entries": []}
    (foreign / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="refusing"):
        export_model(_Toy(), (8, 8), str(foreign), input_dtype="float32",
                     device="cpu")
    with pytest.raises(ValueError, match="refusing"):
        load_exported(str(foreign))
    assert json.loads((foreign / "manifest.json").read_text()) == manifest
    assert os.listdir(foreign) == ["manifest.json"]


def test_http_server_roundtrip(bundle):
    """/healthz returns the manifest; /predict answers an .npy batch with
    the bytes of the in-process call; a shape mismatch gets a 400."""
    path = bundle[0]
    srv = make_http_server(path, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        health = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=30).read())
        assert health == srv.artifact_manifest
        assert health["format"] == "tpuseg_torch-export-v1"

        x = np.random.RandomState(3).randn(1, *HW, 3).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(),
                                     method="POST")
        body = urllib.request.urlopen(req, timeout=60).read()
        want = io.BytesIO()
        np.save(want, bundle[4](x).numpy(), allow_pickle=False)
        assert body == want.getvalue()
        assert np.load(io.BytesIO(body)).shape == (1, *HW, 19)

        bad = io.BytesIO()
        np.save(bad, np.zeros((1, 8, 8, 3), np.float32))
        req = urllib.request.Request(f"{base}/predict", data=bad.getvalue(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_summary_params_match_tpuseg(capsys):
    """`summary`: the port's parameter count equals tpuseg's (the sum over
    its params tree that tpuseg's model_summary takes), and the counted
    FLOPs include both kernels' formulas."""
    sets = {**SETS, "model.fused_stage1": True}
    x = jnp.zeros((1, *HW, 3))
    shapes = flax_shapes(jax_model(jax_eval_config(jax_config(sets))), x,
                         train=False)
    want = sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes["params"]))
    model = get_model(eval_model_config(make_config(sets)))
    info = model_summary(model, (1, *HW, 3), torch.float32, device="cpu")
    assert info["params"] == want
    assert info["flops"] > 0 and info["peak_bytes"] is None
    with torch.inference_mode():
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
        with counter:
            model(torch.zeros(1, *HW, 3))
    ops = {str(k) for k in counter.get_flop_counts()["Global"]}
    assert "tpuseg_torch.ocr_attention" in ops

    argv = ["summary", "--device", "cpu"]
    for k, v in {**sets, "dataset.crop_size": HW}.items():
        argv += ["--set", f"{k}={v}"]
    assert cli_main(argv) == 0
    assert f"({want})" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    from tpuseg_torch.utils.profiling import trace

    with trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads((tmp_path / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
