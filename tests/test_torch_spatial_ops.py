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
conventions), pools on the global grid (and the trunks' stem pools as
modules: torchvision's padding 1, and the Caffe-style padding 0 with
``ceil_mode``), the global average pool, ASPP (its image pooling's 1x1
conv and BN replicated over the group) and DPC in train mode, RMI's
pooled bands (a 40-row map pools to 11 rows, and the window of pooled
row 5 straddles the band boundary at row 20),
the OCR block's class gather, the CE, image-weighted, relaxed and RMI
losses, and batch norm's global statistics and backward. Four more ranks
form one sp group of 4 (``halo``) for ASPP's rate-36 conv on 24-row
bands: its halo spans the whole neighbouring band and part of the next,
each of its rows written by its one owner.

Every case runs again on uneven bands (the ``@sp2`` and ``@sp3`` cases):
its tensors drawn at heights that split over neither 2 nor 3 bands
(``UNEVEN``), on an sp group of 2 and one of 3, each band padded to
``ceil(H / sp)`` rows (``spatial.band``), and a stride-2 conv whose 4
output rows leave the third of 3 bands with padding only; and the halo
conv on 90 rows over 4 bands. There the bands' outputs, cut to the
image's true rows, equal the whole tensor's, and the inputs' gradients
are zero on every padding row. All the clusters run at once.

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
from tpuseg_torch.models.heads import ASPP, DPC
from tpuseg_torch.models.layers import Conv2d, Norm
from tpuseg_torch.models.ocr import spatial_gather
from tpuseg_torch.ops import (
    MaxPool2d,
    avg_pool2d,
    global_avg_pool,
    max_pool2d,
    resize_x,
    scale_as,
)
from tpuseg_torch.parallel import spatial
from tpuseg_torch.parallel.spatial import Bands, window_needs

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
# the stems' pool modules: ResNet's, and SE-ResNeXt's Caffe style
STEM_POOLS = {"stem_3_2_1": (3, 2, 1), "stem_3_2_0_ceil": (3, 2, 0, True)}
# ASPP and DPC (cin, reduction_dim, output_stride) at output stride 16:
# their row dilations (6 to 18) reach into and past the other band
HEADS = {"aspp": ("aspp", (4, 3, 16)), "dpc": ("dpc", (4, 3, 16))}
# the 4-band group's convs: ASPP's rate-36 conv over 24-row bands
HALO_CONVS = {"k3_d36": ((4, 6, 3), dict(dilation=36, padding=36))}
# the heights of the cases' maps: every one splits into 2 bands in the
# even set, none into 2 or into 3 in the uneven one
EVEN = {"map": 16, "like": 32, "loss": 40, "rmi": (32, 40)}
UNEVEN = {"map": 13, "like": 29, "loss": 37, "rmi": (31, 41)}
# the uneven sp groups: the suffix of their cases' names -> ranks
UNEVEN_SP = {"@sp2": 2, "@sp3": 3}
# uneven only: a stride-2 conv of 7 rows to 4, over 3 bands 2 + 2 + 0
SMALL_CONVS = {"k3_s2_7rows": ((4, 6, 3), dict(stride=2, padding=1))}
# the halo group's uneven conv: 90 rows over 4 bands, 23 + 23 + 23 + 21
HALO_ROWS = {"k3_d36": 96, "k3_d36_90rows": 90}


def _rmi_pools(heights) -> dict:
    return {f"{way}_{h}": (way, h) for way in ("avg", "max")
            for h in heights["rmi"]}


RMI_POOLS = _rmi_pools(EVEN)
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


def _conv_case(rng, x, args, kw) -> dict:
    conv = Conv2d(*args, **kw)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(_t(rng.randn(*p.shape)) / 4)
    y_shape = F.conv2d(x, conv.weight, None, conv.stride, conv.padding,
                       conv.dilation, conv.groups).shape
    return {"args": args, "kw": kw, "state": conv.state_dict(), "x": x,
            "dy": _t(rng.randn(*y_shape))}


def _head(case) -> torch.nn.Module:
    return {"aspp": ASPP, "dpc": DPC, "norm": Norm}[case["kind"]](
        *case["args"])


def _cases(rng, heights=EVEN) -> dict:
    h, like, h_loss = heights["map"], heights["like"], heights["loss"]
    cases = {"conv": {}, "resize": {}, "pool": {}, "rmi_pool": {},
             "loss": {}, "head": {}}
    x = _t(rng.randn(2, 4, h, 12))
    for name, (args, kw) in CONVS.items():
        cases["conv"][name] = _conv_case(rng, x, args, kw)
    for name, (scale, ac) in RESIZES.items():
        x = _t(rng.randn(2, 3, h, 8))
        case = {"x": x, "align_corners": ac}
        if scale is None:  # h x 8 -> the like x 12 of another tensor
            case["like"] = _t(rng.randn(2, 1, like, 12))
            out = (like, 12)
        else:
            case["scale"] = scale
            out = (int(h * scale), int(8 * scale))
        case["dy"] = _t(rng.randn(2, 3, *out))
        cases["resize"][name] = case
    for name, (kind, args) in POOLS.items():
        x = _t(rng.randn(2, 3, h, 8))
        k, s, p = args
        h_out = (h + 2 * p - k) // s + 1
        w_out = (8 + 2 * p - k) // s + 1
        cases["pool"][name] = {"kind": kind, "args": args, "x": x,
                               "dy": _t(rng.randn(2, 3, h_out, w_out))}
    for name, (way, hr) in _rmi_pools(heights).items():
        cases["rmi_pool"][name] = {
            "way": way, "onehot": _t(rng.rand(2, C, hr, 12) > 0.7),
            "probs": _t(rng.rand(2, C, hr, 12))}
    cases["gather"] = {"feats": _t(rng.randn(2, 6, h, 8)),
                       "probs": _t(3 * rng.randn(2, C, h, 8)),
                       "dctx": _t(rng.randn(2, C, 6))}
    logits = _t(2 * rng.randn(2, h_loss, 12, C))
    labels = rng.randint(0, C, (2, h_loss, 12)).astype(np.int64)
    labels[0, :3] = 255           # band 0 only
    labels[1, 22:, 5:] = 255      # band 1 only (at sp 2)
    for name, sets in LOSSES.items():
        target = labels
        if sets["loss.loss_type"] == "relaxed":
            target = np.stack([relaxed_onehot(lab, C) for lab in labels])
        cases["loss"][name] = {
            "sets": {"dataset.num_classes": C, **sets}, "logits": logits,
            "target": torch.from_numpy(np.ascontiguousarray(target))}
    return cases


def _pool_and_head_cases(rng, cases, heights=EVEN) -> None:
    """The stem pools, the global average pool, ASPP, DPC and batch norm,
    into ``cases`` (drawn from a generator of their own); with the uneven
    heights, the small conv too."""
    h = heights["map"]
    for name, args in STEM_POOLS.items():
        # channels_last, as the trunks run
        x = _t(rng.randn(2, 3, h, 8)).contiguous(
            memory_format=torch.channels_last)
        y = MaxPool2d(*args)(x)
        cases["pool"][name] = {"kind": "module", "args": args, "x": x,
                               "dy": _t(rng.randn(*y.shape))}
    cases["global_pool"] = {"x": _t(rng.randn(2, 5, h, 6)),
                            "dy": _t(rng.randn(2, 5, 1, 1))}
    for name, (kind, args) in HEADS.items():
        case = {"kind": kind, "args": args}
        head = _head(case)
        with torch.no_grad():
            for p in head.parameters():
                p.copy_(_t(rng.randn(*p.shape)) / 2)
        case["state"] = head.state_dict()
        case["x"] = _t(rng.randn(2, 4, h, 12))
        case["dy"] = _t(rng.randn(2, 5 * args[1], h, 12))
        cases["head"][name] = case
    # batch norm alone: random affine parameters, an input off zero mean
    case = {"kind": "norm", "args": (4,)}
    norm = _head(case)
    with torch.no_grad():
        for p in norm.parameters():
            p.copy_(1 + _t(rng.randn(*p.shape)) / 2)
    case["state"] = norm.state_dict()
    case["x"] = 2 + _t(rng.randn(2, 4, h, 12))
    case["dy"] = _t(rng.randn(2, 4, h, 12))
    cases["norm"] = case
    if heights is not EVEN:
        x = _t(rng.randn(2, 4, 7, 12))
        for name, (args, kw) in SMALL_CONVS.items():
            cases["conv"][name] = _conv_case(rng, x, args, kw)


def _halo_cases(rng) -> dict:
    """The 4-band group's convs, each on one image of its HALO_ROWS rows
    (96: 24 rows a band; 90: 23 rows a band, the last with 2 padding
    rows)."""
    cases = {"conv": {}}
    for name, rows in HALO_ROWS.items():
        args, kw = HALO_CONVS["k3_d36"]
        x = _t(rng.randn(1, 4, rows, 8))
        cases["conv"][name] = _conv_case(rng, x, args, kw)
    return cases


def _whole_grad(fn, xs, dy):
    xs = [x.clone().requires_grad_() for x in xs]
    y = fn(*xs)
    (y * dy).sum().backward()
    return {"y": y.detach(), "grads": [x.grad for x in xs]}


def _whole_conv(case) -> dict:
    conv = Conv2d(*case["args"], **case["kw"])
    conv.load_state_dict(case["state"])
    out = _whole_grad(conv, [case["x"]], case["dy"])
    out["dw"] = conv.weight.grad
    return out


def _whole_head(case) -> dict:
    head = _head(case)
    head.load_state_dict(case["state"])
    head.train()
    out = _whole_grad(head, [case["x"]], case["dy"])
    out["params"] = {n: p.grad for n, p in head.named_parameters()}
    out["stats"] = {k: v for k, v in head.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))}
    return out


def _whole(cases) -> dict:
    """Every case on the whole tensors, in this process."""
    want = {"conv": {}, "resize": {}, "pool": {}, "rmi_pool": {},
            "loss": {}, "head": {}}
    for name, case in cases["conv"].items():
        want["conv"][name] = _whole_conv(case)
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
        pool = {"avg": avg_pool2d, "max": max_pool2d,
                "module": lambda x, *a: MaxPool2d(*a)(x)}[case["kind"]]
        want["pool"][name] = _whole_grad(
            lambda x: pool(x, *case["args"]), [case["x"]], case["dy"])
    g = cases["global_pool"]
    want["global_pool"] = _whole_grad(global_avg_pool, [g["x"]], g["dy"])
    for name, case in cases["head"].items():
        want["head"][name] = _whole_head(case)
    want["norm"] = _whole_head(cases["norm"])
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
def clusters(tmp_path_factory):
    """Every cluster at once: the even cases on an sp group of 2 (key
    ""), the uneven ones on groups of 2 and 3 (the UNEVEN_SP suffixes),
    the halo convs on a group of 4 (``halo``); meanwhile every case on
    the whole tensors here. -> key -> (each rank's result, the whole
    results, the cases)."""
    even = _cases(np.random.RandomState(0))
    _pool_and_head_cases(np.random.RandomState(1), even)
    uneven = _cases(np.random.RandomState(4), UNEVEN)
    _pool_and_head_cases(np.random.RandomState(5), uneven, UNEVEN)
    halo = _halo_cases(np.random.RandomState(2))
    runs = {"": (even, "ops", 2), "halo": (halo, "halo", 4),
            **{k: (uneven, "ops", w) for k, w in UNEVEN_SP.items()}}
    started = {}
    try:
        for key, (cases, mode, world) in runs.items():
            out = tmp_path_factory.mktemp("spatial_ops")
            torch.save(cases, out / ("halo_inputs.pt" if mode == "halo"
                                     else "inputs.pt"))
            started[key] = out, _launch(out, mode, world)
        whole = {id(even): _whole(even), id(uneven): _whole(uneven),
                 id(halo): {"conv": {name: _whole_conv(case) for name, case
                                     in halo["conv"].items()}}}
        ranks = {key: _collect(out, runs[key][1], procs)
                 for key, (out, procs) in started.items()}
    finally:
        for _, procs in started.values():
            for p in procs:
                p.kill()
    return {key: (ranks[key], whole[id(cases)], cases)
            for key, (cases, _, _) in runs.items()}


@pytest.fixture(scope="module")
def cluster(clusters):
    return clusters[""]


def _pick(clusters, name: str) -> tuple:
    """-> (ranks, whole results, cases, the case's name) of a parametrised
    case: ``name`` with an UNEVEN_SP suffix is an uneven case."""
    for key in UNEVEN_SP:
        if name.endswith(key):
            return clusters[key] + (name[:-len(key)],)
    return clusters[""] + (name,)


def _uneven(names) -> list:
    """``names`` as the uneven layouts' cases."""
    return [f"{n}{key}" for key in UNEVEN_SP for n in names]


def _launch(out, mode: str, world: int) -> list:
    """``world`` ranks of the child in ``mode`` (one sp group)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, mode, str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    return procs


def _collect(out, mode: str, procs) -> list:
    """Each rank's result, once every rank has ended well."""
    texts = [p.communicate(timeout=300)[0] for p in procs]
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
    return [torch.load(out / f"{mode}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _cat(parts, rows: int, dim=2, padding_zero: bool = False):
    """The bands ``parts`` put together, cut to the image's ``rows`` true
    rows; with ``padding_zero``, the padding rows cut off must be zeros
    (an input gradient's)."""
    whole = torch.cat(parts, dim=dim)
    if padding_zero:
        rest = whole.narrow(dim, rows, whole.shape[dim] - rows)
        assert not rest.any(), "a gradient on padding rows"
    return whole.narrow(dim, 0, rows)


def _max_diff(a, b) -> float:
    """max |a - b| over the scale of ``b``: its max |value|, at least 1."""
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(b.double().abs().max()))
    return float((a.double() - b.double()).abs().max()) / scale


def _assert_bands(ranks, want, kind, name, dim=2):
    got = [r[kind][name] if name else r[kind] for r in ranks]
    want = want[kind][name] if name else want[kind]
    y = _cat([g["y"] for g in got], want["y"].shape[dim], dim)
    assert _max_diff(y, want["y"]) <= TOL
    for i, w in enumerate(want["grads"]):
        if w is None:  # scale_as reads only the other tensor's size
            assert all(r["grads"][i] is None for r in got)
            continue
        g = _cat([r["grads"][i] for r in got], w.shape[dim], dim,
                 padding_zero=True)
        assert _max_diff(g, w) <= TOL, (name, i)


@pytest.mark.parametrize("name", list(CONVS)
                         + _uneven(list(CONVS) + list(SMALL_CONVS)))
def test_conv_on_bands(clusters, name):
    """Each band's output rows and input gradient are its rows of the whole
    conv's (halo rows fetched, their gradients sent back); the bands'
    weight gradients sum to the whole one. On uneven bands the output's
    padding rows read zeros past the input's true rows, and the stride-2
    conv of 7 rows to 4 leaves the last of 3 bands no true row."""
    ranks, want, _, name = _pick(clusters, name)
    _assert_bands(ranks, want, "conv", name)
    dw = sum(r["conv"][name]["dw"] for r in ranks)
    assert _max_diff(dw, want["conv"][name]["dw"]) <= TOL


@pytest.mark.parametrize("name", list(RESIZES) + _uneven(RESIZES))
def test_bilinear_resize_on_bands(clusters, name):
    """Resizes to global sizes from global source rows: the rows next to
    the band boundary equal the whole resize's, with both corner
    conventions; ``scale_as`` reads the other tensor's global height. On
    uneven bands the source rows clamp at the input's true bottom row."""
    ranks, want, _, name = _pick(clusters, name)
    _assert_bands(ranks, want, "resize", name)


@pytest.mark.parametrize("name", list(POOLS) + _uneven(POOLS))
def test_pool_on_bands(clusters, name):
    """Pool windows on the global grid, the image's padding (zeros for the
    average, -inf for the max) only at the image's true edges."""
    ranks, want, _, name = _pick(clusters, name)
    _assert_bands(ranks, want, "pool", name)


@pytest.mark.parametrize("name", list(STEM_POOLS) + _uneven(STEM_POOLS))
def test_stem_pool_module_on_bands(clusters, name):
    """The trunks' stem pools (``ops.MaxPool2d``): ResNet's padding 1 and
    SE-ResNeXt's Caffe-style padding 0 with ``ceil_mode``, whose last
    window reads past the image's bottom edge (-inf there). Every band,
    the edge bands too, keeps the input's channels_last format."""
    ranks, want, _, name = _pick(clusters, name)
    _assert_bands(ranks, want, "pool", name)
    assert [r["pool"][name]["channels_last"] for r in ranks] == [True] * len(
        ranks)


def _assert_global_pool(ranks, want):
    w = want["global_pool"]
    for r in ranks:
        assert _max_diff(r["global_pool"]["y"], w["y"]) <= TOL
    g = _cat([r["global_pool"]["grads"][0] / len(ranks) for r in ranks],
             w["grads"][0].shape[2], padding_zero=True)
    assert _max_diff(g, w["grads"][0]) <= TOL


def test_global_avg_pool_on_bands(cluster):
    """The image's mean over both bands, whole on both ranks; each band's
    input gradient, over the 2 ranks (each rank's copy of the mean feeds
    its own loss), is its rows of the whole pool's."""
    ranks, want, _ = cluster
    _assert_global_pool(ranks, want)


@pytest.mark.parametrize("layout", list(UNEVEN_SP))
def test_global_avg_pool_on_uneven_bands(clusters, layout):
    """The mean over every band's true rows, over the image's true pixel
    count, whole on every rank; the bands' input gradients as on even
    bands, zero on their padding rows."""
    ranks, want, _ = clusters[layout]
    _assert_global_pool(ranks, want)


def _assert_head(ranks, want, kind, name):
    """Output rows and input gradient are the bands' rows of the whole
    module's, the parameters' gradients over the bands sum to the whole
    ones and the BN running statistics equal the whole ones on each
    rank."""
    _assert_bands(ranks, want, kind, name)
    got = [r[kind][name] if name else r[kind] for r in ranks]
    w = want[kind][name] if name else want[kind]
    for n, gw in w["params"].items():
        g = sum(r["params"][n] for r in got)
        assert _max_diff(g, gw) <= TOL, n
    for r in got:
        for k, v in w["stats"].items():
            assert _max_diff(r["stats"][k], v) <= TOL, k


@pytest.mark.parametrize("name", list(HEADS) + _uneven(HEADS))
def test_context_head_on_bands(clusters, name):
    """ASPP and DPC in train mode on bands: output rows and input gradient
    are the bands' rows of the whole module's, the parameters' gradients
    over both bands sum to the whole ones and the BN running statistics
    equal the whole ones on each rank. ASPP's image pooling branch (1x1
    conv and BN on the pooled image) runs replicated: its batch norm
    counts the pooled value once, and its output is broadcast to the
    band's rows."""
    ranks, want, _, name = _pick(clusters, name)
    _assert_head(ranks, want, "head", name)


@pytest.mark.parametrize("layout", [pytest.param("", id="even"),
                                    *UNEVEN_SP])
def test_batch_norm_on_bands(clusters, layout):
    """``BatchNorm2d`` in train mode on bands: the global statistics over
    every true pixel once (the mean, the biased variance for the output
    and Bessel's factor of the true count for the running variance), the
    backward's sums over true rows only, the input gradient zero on a
    band's padding rows."""
    ranks, want, _ = clusters[layout]
    _assert_head(ranks, want, "norm", None)


@pytest.mark.parametrize("name", list(HALO_ROWS))
def test_dilated_conv_halo_wider_than_a_band(clusters, name):
    """ASPP's rate-36 conv on an sp group of 4 (24-row bands of 96 rows,
    and 23-row bands of 90, the last holding 21 true rows): a band's halo
    reaches 36 rows past each edge, the whole neighbouring band and 12
    (13) rows of the next, and the image's zeros beyond; the exchange's
    slots have one writer a row, so every band's output and input
    gradient are its rows of the whole conv's, and the weight gradients
    sum to the whole one."""
    ranks, want, _ = clusters["halo"]
    assert [r["world"] for r in ranks] == [4] * 4
    rows = HALO_ROWS[name]
    h = -(-rows // 4)
    needs = window_needs(h, Bands(None, 0, 4), 3, 1, 36, 36, rows)
    lo, hi = needs[1]  # band 1: past the image's top edge
    assert lo < 0 and hi > 3 * h  # and past band 2 into band 3
    _assert_bands(ranks, want, "conv", name)
    dw = sum(r["conv"][name]["dw"] for r in ranks)
    assert _max_diff(dw, want["conv"][name]["dw"]) <= TOL


def _owned_rows(h: int, bands: int = 2, pool: int = 4, pad: int = 2,
                radius: int = 3):
    """RMI's ownership, derived here from the rule: pooled row i belongs
    to the band holding row max(4 i - 2, 0) of the h true rows, each band
    holding ceil(h / bands) rows; each band's vector rows are the pooled
    rows it owns."""
    h_p = (h + 2 * pad - pool) // pool + 1
    n_rows = h_p - radius + 1
    own = [[j for j in range(n_rows)
            if min(max(pool * j - pad, 0), h - 1) // -(-h // bands) == b]
           for b in range(bands)]
    return own, n_rows


@pytest.mark.parametrize("name", list(RMI_POOLS)
                         + _uneven(_rmi_pools(UNEVEN)))
def test_rmi_pooled_bands(clusters, name):
    """RMI's pool (4, 4, pad 2) on bands: the vector rows do not split
    evenly (6 and 3 of 9 at 40 rows, 5 and 2 of 7 at 32), and each band's
    pooled map is the whole map's rows of its own vectors plus the
    radius - 1 rows below them, computed from the same pixels; together
    the bands' vector rows are every vector row of the image once. On
    uneven bands the ownership counts the true rows, a band's padding
    rows pool as the image's bottom padding, and at 31 rows over 3 bands
    the last band owns no vector."""
    ranks, want, cases, name = _pick(clusters, name)
    h = cases["rmi_pool"][name]["onehot"].shape[2]
    own, n_rows = _owned_rows(h, len(ranks))
    assert sorted(sum(own, [])) == list(range(n_rows))
    assert len(own[0]) != len(own[-1])
    w = want["rmi_pool"][name]
    for r, rows in zip(ranks, own):
        got = r["rmi_pool"][name]
        assert got["n_rows"] == w["n_rows"] == n_rows
        if not rows:  # a band that owns no vector: radius - 1 rows, none
            assert got["onehot"].shape[2] == 2
            continue
        lo, hi = rows[0], rows[-1] + 3
        for key in ("onehot", "probs"):
            assert _max_diff(got[key], w[key][:, :, lo:hi]) <= TOL, key


def _assert_gather(ranks, want):
    w = want["gather"]
    for r in ranks:
        assert _max_diff(r["gather"]["y"], w["y"]) <= TOL
    for i, gw in enumerate(w["grads"]):
        g = _cat([r["gather"]["grads"][i] / len(ranks) for r in ranks],
                 gw.shape[2], padding_zero=True)
        assert _max_diff(g, gw) <= TOL, i


def test_class_gather_on_bands(cluster):
    """The OCR class gather's softmax over every pixel of the image: the
    class context is whole on both ranks; each band's input gradients,
    over the 2 ranks (each rank's copy of the context feeds its own
    loss), are its rows of the whole gather's."""
    ranks, want, _ = cluster
    _assert_gather(ranks, want)


@pytest.mark.parametrize("layout", list(UNEVEN_SP))
def test_class_gather_on_uneven_bands(clusters, layout):
    """A band's padding pixels are not among the image's pixels: no weight
    in the softmax over them, no gradient; the rest as on even bands."""
    ranks, want, _ = clusters[layout]
    _assert_gather(ranks, want)


@pytest.mark.parametrize("name", list(LOSSES) + _uneven(LOSSES))
def test_loss_on_bands(clusters, name):
    """The ranks' mean loss is the whole batch's loss, and each band's
    logits gradient over the ranks (DDP's mean) is its rows of the whole
    loss's gradient; the ignore pixels are in one band each (at sp 2). On
    uneven bands the labels' padding rows are ignored (a relaxed target's
    have no class), and the logits there get no gradient."""
    ranks, want, _, name = _pick(clusters, name)
    w = want["loss"][name]
    n = len(ranks)
    loss = float(sum(r["loss"][name]["loss"] for r in ranks)) / n
    grad = _cat([r["loss"][name]["grad"] / n for r in ranks],
                w["grad"].shape[1], dim=1, padding_zero=True)
    rel = abs(loss - float(w["loss"])) / abs(float(w["loss"]))
    assert rel <= TOL, rel
    if name == "rmi":
        l1 = float((grad - w["grad"]).abs().sum() / w["grad"].abs().sum())
        assert l1 <= RMI_GRAD_L1, l1
    else:
        assert _max_diff(grad, w["grad"]) <= TOL


@pytest.mark.parametrize("key", ["", *UNEVEN_SP])
def test_collectives_count_in_the_program_counters(clusters, key):
    """Every sp collective a rank issued over its op cases counts once
    under its kind (``sp.halo``, ``sp.sum``, ``sp.max``) in the program's
    counters, as ``spatial.COUNTS`` counted it, and its host seconds in
    ``sp.<kind>.host_s``."""
    for rank in clusters[key][0]:
        tally, counts = rank["collectives"]
        assert all(n > 0 for n in tally.values()), tally
        assert {k: counts.get(f"sp.{k}", 0) for k in spatial.KINDS} == tally
        assert all(counts[f"sp.{k}.host_s"] > 0 for k in spatial.KINDS)


def test_padded_layout():
    """The layout's table of heights, without a process group: a map of H
    rows is held as bands of ceil(H / sp) rows, its true rows a prefix of
    each band; a second true height that would share a band height takes
    the next free one (a 100-row map and its 102-row attention map at sp
    3: 34 and 35 rows), so each band height reads back one true height; a
    band height no op entered is a map of whole bands; ``band`` pads the
    image with zeros and the label with its fill."""
    with spatial.sharded(Bands(None, 2, 3)):
        assert [spatial.split_rows(h) for h in (100, 102, 100, 101)] == [
            34, 35, 34, 36]
        x = torch.zeros(1, 1, 35, 4)
        assert spatial.global_size(x) == (102, 4)
        assert spatial.valid_rows(x) == 102 - 70
        assert spatial.global_height(torch.zeros(1, 1, 7, 4)) == 21
        assert spatial.valid_rows(torch.zeros(1, 1, 34, 4)) == 100 - 68
        # a map of 4 rows: 2 + 2 + 0 (this is band 2 of 3)
        label = np.arange(4 * 3).reshape(1, 4, 3).astype(np.uint8)
        got = spatial.band(label, 1, 255)
        assert got.shape == (1, 2, 3) and (got == 255).all()
        assert spatial.valid_rows(torch.zeros(1, 1, 2, 3)) == 0
        needs = window_needs(2, Bands(None, 2, 3), 3, 2, 1, total=4)
        assert needs == [(-1, 4), (3, 8), (7, 7)]
    with spatial.sharded(Bands(None, 1, 3)):
        image = torch.arange(5.0).view(1, 5, 1, 1)
        got = spatial.band(image, 1)
        assert got.flatten().tolist() == [2.0, 3.0]
    assert spatial.active() is None


def test_children_import_no_jax(clusters):
    assert all(r["modules"] == [] for ranks, _, _ in clusters.values()
               for r in ranks)
