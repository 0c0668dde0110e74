"""The dp x sp band primitives of the port (``tpuseg_torch/parallel/
spatial.py`` and the ops that read it) on a real two-rank gloo sp group on
the CPU, against the whole tensors in one process.

One module-scoped fixture draws seeded whole tensors, writes them for two
child processes (tests/_torch_spatial_child.py ``ops``, torchrun's
environment set by hand, one sp group of 2) and, while they run, computes
each case on the whole tensors here. Each rank runs the case on its band
of rows (``shard_batch_spatial``'s layout) under ``spatial.sharded`` and
backpropagates its band of the same upstream gradient. The cases: convs
(kernel 1 and 3, stride 1 and 2, dilation 2, groups, padding 0 to 2),
bilinear resizes (x0.5, x2, x4, x8 and ``scale_as``, both corner
conventions), pools on the global grid, RMI's pooled bands (a 40-row map
pools to 11 rows, and the window of pooled row 5 straddles the band
boundary at row 20),
the OCR block's class gather, and the CE, image-weighted, relaxed and RMI
losses.

Tolerance: f32 max |diff| <= 1e-5 of the whole tensor's result's scale
(its max |value|, at least 1), forward and backward (``TOL``): a weight
gradient sums hundreds of O(1) products, and the bands sum them in
another order. The RMI loss's gradient is the exception: its 9x9 solves
amplify the order of the f32 sums that make the covariances (1.3e-5
L1-rel here), so it is held in L1-rel at ``RMI_GRAD_L1``; its value and
its pooled bands at ``TOL``.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import set_threads
from tpuseg_torch.config import make_config
from tpuseg_torch.data.relaxed_labels import relaxed_onehot
from tpuseg_torch.losses import get_loss
from tpuseg_torch.losses import rmi as rmi_mod
from tpuseg_torch.models.layers import Conv2d
from tpuseg_torch.models.ocr import spatial_gather
from tpuseg_torch.ops import avg_pool2d, max_pool2d, resize_x, scale_as

set_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_spatial_child.py")
TOL = 1e-5
RMI_GRAD_L1 = 1e-4
C = 5
# (cin, cout, kernel) and keywords: stride, dilation, groups, padding
CONVS = {
    "k1": ((4, 6, 1), {}),
    "k1_s2": ((4, 6, 1), dict(stride=2)),
    "k3": ((4, 6, 3), dict(padding=1)),
    "k3_s2": ((4, 6, 3), dict(stride=2, padding=1)),
    "k3_d2": ((4, 6, 3), dict(dilation=2, padding=2)),
    "k3_groups": ((4, 6, 3), dict(groups=2, padding=1)),
    "k3_pad0": ((4, 6, 3), dict(padding=0)),
    "k5_s2_d2": ((4, 6, 5), dict(stride=2, dilation=2, padding=4)),
}
RESIZES = {f"x{s:g}_{'ac' if ac else 'hp'}": (s, ac)
           for s in (0.5, 2, 4, 8) for ac in (False, True)}
RESIZES.update({f"scale_as_{'ac' if ac else 'hp'}": (None, ac)
                for ac in (False, True)})
POOLS = {"avg_3_2_1": ("avg", (3, 2, 1)), "max_3_2_1": ("max", (3, 2, 1)),
         "avg_2_2_0": ("avg", (2, 2, 0)), "max_5_2_2": ("max", (5, 2, 2))}
RMI_POOLS = {f"{way}_{h}": (way, h) for way in ("avg", "max")
             for h in (32, 40)}
LOSSES = {"ce": {"loss.loss_type": "ce"},
          "rmi": {"loss.loss_type": "rmi"},
          "img_wt": {"loss.loss_type": "img_wt"},
          "relaxed": {"loss.loss_type": "relaxed"}}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _cases(rng) -> dict:
    cases = {"conv": {}, "resize": {}, "pool": {}, "rmi_pool": {},
             "loss": {}}
    x = _t(rng.randn(2, 4, 16, 12))
    for name, (args, kw) in CONVS.items():
        conv = Conv2d(*args, **kw)
        with torch.no_grad():
            for p in conv.parameters():
                p.copy_(_t(rng.randn(*p.shape)) / 4)
        y_shape = F.conv2d(x, conv.weight, None, conv.stride, conv.padding,
                           conv.dilation, conv.groups).shape
        cases["conv"][name] = {"args": args, "kw": kw,
                               "state": conv.state_dict(), "x": x,
                               "dy": _t(rng.randn(*y_shape))}
    for name, (scale, ac) in RESIZES.items():
        x = _t(rng.randn(2, 3, 16, 8))
        case = {"x": x, "align_corners": ac}
        if scale is None:  # 16x8 -> the 32x12 of another tensor
            case["like"] = _t(rng.randn(2, 1, 32, 12))
            out = (32, 12)
        else:
            case["scale"] = scale
            out = (int(16 * scale), int(8 * scale))
        case["dy"] = _t(rng.randn(2, 3, *out))
        cases["resize"][name] = case
    for name, (kind, args) in POOLS.items():
        x = _t(rng.randn(2, 3, 16, 8))
        k, s, p = args
        h_out = (16 + 2 * p - k) // s + 1
        w_out = (8 + 2 * p - k) // s + 1
        cases["pool"][name] = {"kind": kind, "args": args, "x": x,
                               "dy": _t(rng.randn(2, 3, h_out, w_out))}
    for name, (way, h) in RMI_POOLS.items():
        cases["rmi_pool"][name] = {
            "way": way, "onehot": _t(rng.rand(2, C, h, 12) > 0.7),
            "probs": _t(rng.rand(2, C, h, 12))}
    cases["gather"] = {"feats": _t(rng.randn(2, 6, 16, 8)),
                       "probs": _t(3 * rng.randn(2, C, 16, 8)),
                       "dctx": _t(rng.randn(2, C, 6))}
    logits = _t(2 * rng.randn(2, 40, 12, C))
    labels = rng.randint(0, C, (2, 40, 12)).astype(np.int64)
    labels[0, :3] = 255           # band 0 only
    labels[1, 22:, 5:] = 255      # band 1 only
    for name, sets in LOSSES.items():
        target = labels
        if sets["loss.loss_type"] == "relaxed":
            target = np.stack([relaxed_onehot(lab, C) for lab in labels])
        cases["loss"][name] = {
            "sets": {"dataset.num_classes": C, **sets}, "logits": logits,
            "target": torch.from_numpy(np.ascontiguousarray(target))}
    return cases


def _whole_grad(fn, xs, dy):
    xs = [x.clone().requires_grad_() for x in xs]
    y = fn(*xs)
    (y * dy).sum().backward()
    return {"y": y.detach(), "grads": [x.grad for x in xs]}


def _whole(cases) -> dict:
    """Every case on the whole tensors, in this process."""
    want = {"conv": {}, "resize": {}, "pool": {}, "rmi_pool": {},
            "loss": {}}
    for name, case in cases["conv"].items():
        conv = Conv2d(*case["args"], **case["kw"])
        conv.load_state_dict(case["state"])
        out = _whole_grad(conv, [case["x"]], case["dy"])
        out["dw"] = conv.weight.grad
        want["conv"][name] = out
    for name, case in cases["resize"].items():
        ac = case["align_corners"]
        if "scale" in case:
            want["resize"][name] = _whole_grad(
                lambda x: resize_x(x, case["scale"], ac), [case["x"]],
                case["dy"])
        else:
            want["resize"][name] = _whole_grad(
                lambda x, y: scale_as(x, y, ac), [case["x"], case["like"]],
                case["dy"])
    for name, case in cases["pool"].items():
        pool = avg_pool2d if case["kind"] == "avg" else max_pool2d
        want["pool"][name] = _whole_grad(
            lambda x: pool(x, *case["args"]), [case["x"]], case["dy"])
    for name, case in cases["rmi_pool"].items():
        oh, pr, n_rows = rmi_mod._pooled(case["onehot"], case["probs"], 4,
                                         case["way"], 3)
        want["rmi_pool"][name] = {"onehot": oh, "probs": pr,
                                  "n_rows": n_rows}
    g = cases["gather"]
    want["gather"] = _whole_grad(spatial_gather, [g["feats"], g["probs"]],
                                 g["dctx"])
    for name, case in cases["loss"].items():
        criterion, _ = get_loss(make_config(case["sets"]))
        logits = case["logits"].clone().requires_grad_()
        # one process: the criterion's global-batch loss is the loss
        loss = criterion(logits, case["target"])
        loss.backward()
        want["loss"][name] = {"loss": loss.detach(), "grad": logits.grad}
    return want


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial_ops")
    cases = _cases(np.random.RandomState(0))
    torch.save(cases, out / "inputs.pt")
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, "ops", str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    try:
        want = _whole(cases)
        texts = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
    ranks = [torch.load(out / f"ops_rank{r}.pt", weights_only=False)
             for r in (0, 1)]
    return ranks, want, cases


def _cat(parts, dim=2):
    return torch.cat(parts, dim=dim)


def _max_diff(a, b) -> float:
    """max |a - b| over the scale of ``b``: its max |value|, at least 1."""
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(b.double().abs().max()))
    return float((a.double() - b.double()).abs().max()) / scale


def _assert_bands(ranks, want, kind, name, dim=2):
    got = [r[kind][name] for r in ranks]
    want = want[kind][name]
    assert _max_diff(_cat([g["y"] for g in got], dim), want["y"]) <= TOL
    for i, w in enumerate(want["grads"]):
        if w is None:  # scale_as reads only the other tensor's size
            assert all(r["grads"][i] is None for r in got)
            continue
        g = _cat([r["grads"][i] for r in got], dim)
        assert _max_diff(g, w) <= TOL, (name, i)


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_on_bands(cluster, name):
    """Each band's output rows and input gradient are its rows of the whole
    conv's (halo rows fetched, their gradients sent back); the bands'
    weight gradients sum to the whole one."""
    ranks, want, _ = cluster
    _assert_bands(ranks, want, "conv", name)
    dw = ranks[0]["conv"][name]["dw"] + ranks[1]["conv"][name]["dw"]
    assert _max_diff(dw, want["conv"][name]["dw"]) <= TOL


@pytest.mark.parametrize("name", list(RESIZES))
def test_bilinear_resize_on_bands(cluster, name):
    """Resizes to global sizes from global source rows: the rows next to
    the band boundary equal the whole resize's, with both corner
    conventions; ``scale_as`` reads the other tensor's global height."""
    ranks, want, _ = cluster
    _assert_bands(ranks, want, "resize", name)


@pytest.mark.parametrize("name", list(POOLS))
def test_pool_on_bands(cluster, name):
    """Pool windows on the global grid, the image's padding (zeros for the
    average, -inf for the max) only at the image's edges."""
    ranks, want, _ = cluster
    _assert_bands(ranks, want, "pool", name)


def _owned_rows(h: int, bands: int = 2, pool: int = 4, pad: int = 2,
                radius: int = 3):
    """RMI's ownership, derived here from the rule: pooled row i belongs
    to the band holding row max(4 i - 2, 0); each band's vector rows are
    the pooled rows it owns."""
    h_p = (h + 2 * pad - pool) // pool + 1
    n_rows = h_p - radius + 1
    own = [[j for j in range(n_rows)
            if min(max(pool * j - pad, 0), h - 1) // (h // bands) == b]
           for b in range(bands)]
    return own, n_rows


@pytest.mark.parametrize("name", list(RMI_POOLS))
def test_rmi_pooled_bands(cluster, name):
    """RMI's pool (4, 4, pad 2) on bands: the vector rows do not split
    evenly (6 and 3 of 9 at 40 rows, 5 and 2 of 7 at 32), and each band's
    pooled map is the whole map's rows of its own vectors plus the
    radius - 1 rows below them, computed from the same pixels; together
    the bands' vector rows are every vector row of the image once."""
    ranks, want, cases = cluster
    h = cases["rmi_pool"][name]["onehot"].shape[2]
    own, n_rows = _owned_rows(h)
    assert sorted(sum(own, [])) == list(range(n_rows))
    assert len(own[0]) != len(own[1])
    w = want["rmi_pool"][name]
    for r, rows in zip(ranks, own):
        got = r["rmi_pool"][name]
        assert got["n_rows"] == w["n_rows"] == n_rows
        lo, hi = rows[0], rows[-1] + 3
        for key in ("onehot", "probs"):
            assert _max_diff(got[key], w[key][:, :, lo:hi]) <= TOL, key


def test_class_gather_on_bands(cluster):
    """The OCR class gather's softmax over every pixel of the image: the
    class context is whole on both ranks; each band's input gradients,
    over the 2 ranks (each rank's copy of the context feeds its own
    loss), are its rows of the whole gather's."""
    ranks, want, _ = cluster
    w = want["gather"]
    for r in ranks:
        assert _max_diff(r["gather"]["y"], w["y"]) <= TOL
    for i, gw in enumerate(w["grads"]):
        g = _cat([r["gather"]["grads"][i] / 2 for r in ranks])
        assert _max_diff(g, gw) <= TOL, i


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_on_bands(cluster, name):
    """The ranks' mean loss is the whole batch's loss, and each band's
    logits gradient over the 2 ranks (DDP's mean) is its rows of the
    whole loss's gradient; the ignore pixels are in one band each."""
    ranks, want, _ = cluster
    w = want["loss"][name]
    loss = float(sum(r["loss"][name]["loss"] for r in ranks)) / 2
    grad = _cat([r["loss"][name]["grad"] / 2 for r in ranks], dim=1)
    rel = abs(loss - float(w["loss"])) / abs(float(w["loss"]))
    assert rel <= TOL, rel
    if name == "rmi":
        l1 = float((grad - w["grad"]).abs().sum() / w["grad"].abs().sum())
        assert l1 <= RMI_GRAD_L1, l1
    else:
        assert _max_diff(grad, w["grad"]) <= TOL


def test_children_import_no_jax(cluster):
    ranks, _, _ = cluster
    assert ranks[0]["modules"] == ranks[1]["modules"] == []
