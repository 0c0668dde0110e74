"""The port's eval surfaces held against tpuseg's on the CPU: the image
dumper in every mode, the results page, the top-N failure gallery, the
boundary F-score, and ``evaluate_only`` with dumps on a synthetic
Cityscapes tree through the tiny model with the same weights."""
import os

import numpy as np
import pytest
from PIL import Image

import tpuseg.evaluation.inference as jax_inference
import tpuseg.train.loop as jax_loop
from _torch_port import load_into, set_threads
from tpuseg.config import make_config as jax_config
from tpuseg.evaluation import f_boundary as jfb
from tpuseg.evaluation import topn as jtopn
from tpuseg.evaluation.dumper import ImageDumper as JaxDumper
from tpuseg_torch.cli.main import main as cli_main
from tpuseg_torch.config import make_config
from tpuseg_torch.data.cityscapes import Cityscapes
from tpuseg_torch.data.cityscapes_labels import PALETTE, TRAINID_TO_ID
from tpuseg_torch.evaluation import f_boundary as pfb
from tpuseg_torch.evaluation import inference as port_inference
from tpuseg_torch.evaluation import topn as ptopn
from tpuseg_torch.evaluation.dumper import ImageDumper
from tpuseg_torch.models import get_model
from tpuseg_torch.train.loop import evaluate_only

set_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 128
GAP = 1e-4  # predictions may differ where JAX's top-2 logit gap is below
MODES = {
    "composites": {"dump_all_images": True},
    "assets": {"dump_all_images": True, "dump_assets": True},
    "every_nth": {"dump_assets": True},
    "auto_labelling": {"dump_for_auto_labelling": True},
    "submission": {"dump_for_submission": True},
}


def _dump_dict(rng, name, image):
    b = image.shape[0]
    pred = rng.randint(0, 19, (b, H, W))
    gt = rng.randint(0, 19, (b, H, W))
    gt[:, :4] = 255
    return {
        "input_images": image, "gt_images": gt,
        "img_names": [f"{name}_{i}" for i in range(b)],
        "assets": {
            "predictions": pred,
            "prob_mask": rng.rand(b, H, W).astype(np.float32),
            "pred_0.5x": rng.randint(0, 19, (b, H // 2, W // 2)),
            "pred_1.0x": pred,
            "attn_0.5x": rng.rand(b, H // 2, W // 2, 1).astype(np.float32),
            "attn_1.0x": 1.2 * rng.rand(b, H, W, 1).astype(np.float32) - .1,
            "err_mask": port_inference.calc_err_mask_all(pred, gt, 19),
            "scale_hists": {1.0: np.eye(19)}}}


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _run_dumpers(tmp_path, kw, images):
    """The same dump calls through both dumpers; -> (tpuseg's files,
    the port's files, the two dumpers)."""
    dumpers = []
    for cls, sub in ((JaxDumper, "jax"), (ImageDumper, "port")):
        rng = np.random.RandomState(0)
        # val_len 6, dump_num 2: every third image unless all are dumped
        d = cls(val_len=6, dump_dir=str(tmp_path / sub),
                palette=PALETTE, trainid_to_id=TRAINID_TO_ID, dump_num=2,
                **kw)
        for idx, image in enumerate(images):
            d.dump(_dump_dict(rng, f"im{idx}", image), idx)
        d.write_webpage()
        dumpers.append(d)
    return (_files(tmp_path / "jax"), _files(tmp_path / "port"), *dumpers)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dumper_matches_tpuseg(tmp_path, mode):
    """Every mode writes the same files, byte for byte (index.html
    included), from a uint8 batch of two and an f32 normalized image."""
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8),
              rng.randn(1, H, W, 3).astype(np.float32),
              rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8)]
    jax_files, port_files, jd, pd = _run_dumpers(tmp_path, MODES[mode],
                                                 images)
    assert port_files and set(port_files) == set(jax_files)
    for name, data in jax_files.items():
        assert port_files[name] == data, name
    assert ("index.html" in port_files) == (mode not in (
        "auto_labelling", "submission"))
    assert len(pd.imgs_to_tensorboard) == len(jd.imgs_to_tensorboard)
    for a, b in zip(pd.imgs_to_tensorboard, jd.imgs_to_tensorboard):
        np.testing.assert_array_equal(a, b)


def test_dumper_clips_wide_integer_images(tmp_path):
    """The one place the port's dumper departs from tpuseg's: an integer
    image wider than uint8 saturates at 0..255 where tpuseg wraps it
    modulo 256 (ROADMAP Queue 3). Only the files made from the input
    image differ."""
    rng = np.random.RandomState(2)
    wide = rng.randint(-300, 600, (1, H, W, 3)).astype(np.int32)
    jax_files, port_files, _, _ = _run_dumpers(tmp_path, MODES["assets"],
                                               [wide])
    assert set(port_files) == set(jax_files)
    differ = {n for n in jax_files if port_files[n] != jax_files[n]}
    assert differ == {"im0_0_input.png", "im0_0_composited.png"}
    got = np.asarray(Image.open(tmp_path / "port" / "im0_0_input.png"))
    np.testing.assert_array_equal(got, np.clip(wide[0], 0, 255))
    wrapped = np.asarray(Image.open(tmp_path / "jax" / "im0_0_input.png"))
    np.testing.assert_array_equal(wrapped, wide[0].astype(np.uint8))


def test_err_masks_match_tpuseg():
    rng = np.random.RandomState(3)
    pred = rng.randint(0, 19, (2, H, W))
    gt = rng.randint(0, 19, (2, H, W))
    gt[:, :5] = 255
    np.testing.assert_array_equal(
        port_inference.calc_err_mask_all(pred, gt, 19),
        jax_inference.calc_err_mask_all(pred, gt, 19))
    for c in (0, 7, 18):
        np.testing.assert_array_equal(
            port_inference.calc_err_mask(pred, gt, c),
            jax_inference.calc_err_mask(pred, gt, c))


def _masks(seed):
    rng = np.random.RandomState(seed)
    blob = np.zeros((40, 60), bool)
    blob[10:25, 15:40] = True
    noisy = blob ^ (rng.rand(40, 60) < 0.05)
    empty = np.zeros((40, 60), bool)
    return [(blob, noisy), (noisy, blob), (rng.rand(40, 60) < 0.5, blob),
            (empty, blob), (blob, empty), (empty, empty)]


@pytest.mark.parametrize("bound_th", [0.008, 0.05, 3])
def test_boundary_fscore_matches_tpuseg(bound_th):
    """Including the empty and one-sided cases (f_boundary.py:65-70)."""
    for pred, gt in _masks(4):
        want = jfb.db_eval_boundary(pred, gt, bound_th)
        assert abs(pfb.db_eval_boundary(pred, gt, bound_th) - want) < 1e-12
    rng = np.random.RandomState(5)
    pred = rng.randint(0, 6, (2, 40, 60))
    gt = np.repeat(np.repeat(rng.randint(0, 6, (2, 4, 6)), 10, 1), 10, 2)
    pred[1] = 5  # a class present on one side only
    got = pfb.eval_mask_boundary(pred, gt, 8, bound_th, num_proc=2)
    want = jfb.eval_mask_boundary(pred, gt, 8, bound_th, num_proc=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


class _FakeRunner:
    """Seeded per-image confusion matrices and assets, for tpuseg's
    signature (variables first) and the port's."""

    def __init__(self, n):
        self.n = n

    def run_batch(self, *args, **kw):
        batch = args[-1]
        rng = np.random.RandomState(int(batch["name"][0][3:]))
        hist = rng.randint(0, 50, (self.n, self.n)).astype(np.float64)
        assets = {"predictions": rng.randint(0, self.n, (1, 16, 24)),
                  "prob_mask": rng.rand(1, 16, 24)}
        return assets, hist, None


def test_topn_selection_matches_tpuseg(tmp_path):
    """metrics_per_image, the worst-N selection per class, the dumped
    (image, class) set and the failure gallery agree exactly."""
    rng = np.random.RandomState(6)
    hist = rng.randint(0, 100, (19, 19))
    for p, j in zip(ptopn.metrics_per_image(hist),
                    jtopn.metrics_per_image(hist)):
        np.testing.assert_array_equal(p, j)

    n = 6
    batches = [{"name": [f"img{i}"],
                "image": rng.randint(0, 256, (1, 16, 24, 3)).astype(np.uint8),
                "label": rng.randint(0, n, (1, 16, 24))} for i in range(7)]
    names = {i: f"c{i}" for i in range(n)}
    out = {}
    for mod, sub, args in ((jtopn, "jax", (None,)), (ptopn, "port", ())):
        m = mod.validate_topn(batches, _FakeRunner(n), *args, n,
                              result_dir=str(tmp_path / sub),
                              trainid_to_name=names, dump_topn=2,
                              palette=PALETTE[:n], log=lambda *_: None)
        out[sub] = (m, _files(tmp_path / sub))
    (jm, jf), (pm, pf) = out["jax"], out["port"]
    np.testing.assert_array_equal(pm.hist, jm.hist)
    assert set(pf) == set(jf) and "best_images/topn_failures.html" in pf
    for name, data in jf.items():
        assert pf[name] == data, name


# ---------------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def cs_tree(tmp_path_factory):
    """A Cityscapes tree of seeded 64x128 scenes: 2 train and 3 val images,
    and 2 coarse-extra images for the auto-labelling loop."""
    root = tmp_path_factory.mktemp("cs")
    rng = np.random.RandomState(7)
    lv = "leftImg8bit_trainvaltest/leftImg8bit"
    for split, city, n in (("train", "aachen", 2), ("val", "lindau", 3)):
        img_dir = root / lv / split / city
        msk_dir = root / "gtFine_trainvaltest/gtFine" / split / city
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            tid = np.repeat(np.repeat(rng.randint(0, 19, (4, 8)), 16, 0),
                            16, 1)
            image = np.clip(PALETTE[tid].astype(int)
                            + rng.randint(-30, 31, (H, W, 3)), 0, 255)
            Image.fromarray(image.astype(np.uint8)).save(
                img_dir / f"{base}_leftImg8bit.png")
            Image.fromarray(TRAINID_TO_ID[tid]).save(
                msk_dir / f"{base}_gtFine_labelIds.png")
    extra = root / "leftImg8bit_trainextra/leftImg8bit/train_extra/aug"
    extra.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (H, W, 3)).astype(np.uint8)).save(
            extra / f"aug_{i:06d}_000019_leftImg8bit.png")
    return str(root)


def _sets(root, tmp):
    return {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
            "model.compute_dtype": "float32", "model.use_pallas": True,
            "model.remat": False, "dataset.name": "cityscapes",
            "dataset.cityscapes_dir": root, "dataset.cv": 0,
            "dataset.transfer_uint8": True, "dataset.num_workers": 2,
            "dataset.centroid_root": os.path.join(tmp, "centroids"),
            "eval.scales": (1.0,), "eval.dump_assets": True,
            "eval.dump_all_images": True}


class _JaxSpy(jax_loop.EvalRunner):
    """tpuseg's EvalRunner, recording its fused logits (no extra
    compile)."""
    logits: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        forward = self.forward

        def spy(*args):
            out = forward(*args)
            _JaxSpy.logits.append(np.asarray(out[0]))
            return out

        self.forward = spy


@pytest.fixture(scope="module")
def end_to_end(cs_tree, tmp_path_factory):
    """Seeded random weights (activations O(1), so predictions vary) as a
    tpuseg snapshot and as a reference .pth; tpuseg's evaluate_only with
    dump_assets and dump_all_images on them, then the port's."""
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    import torch

    from tpuseg.config import eval_model_config as jax_eval_config
    from tpuseg.models import get_model as jax_model
    from tpuseg_torch.config import eval_model_config
    from _torch_port import random_variables

    tmp = tmp_path_factory.mktemp("e2e")
    sets = _sets(cs_tree, str(tmp))
    jm = jax_model(jax_eval_config(jax_config(sets)))
    variables = random_variables(jm, np.random.RandomState(8),
                                 jnp.zeros((1, H, W, 3)))
    snapshot = str(tmp / "snapshot")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(snapshot, variables)
    ckptr.wait_until_finished()
    cfg = make_config(sets)
    ckpt = str(tmp / "weights.pth")
    torch.save(load_into(get_model(eval_model_config(cfg)),
                         variables).state_dict(), ckpt)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_loop, "EvalRunner", _JaxSpy)
    _JaxSpy.logits = []
    try:
        jmetrics = jax_loop.evaluate_only(
            jax_config(sets), logdir=str(tmp / "jax"), checkpoint=snapshot)
    finally:
        mp.undo()
    pmetrics = evaluate_only(cfg, logdir=str(tmp / "port"), checkpoint=ckpt,
                             device="cpu")
    return jmetrics, pmetrics, _JaxSpy.logits, tmp, sets, ckpt


def test_evaluate_only_dumps_match_tpuseg(end_to_end):
    jm, pm, logits, tmp, _, _ = end_to_end
    jdir, pdir = tmp / "jax" / "eval_images", tmp / "port" / "eval_images"
    jf, pf = _files(jdir), _files(pdir)
    # input, gt, prediction, composited, pred_1.0x, attn_1.0x and
    # err_mask for each of the 3 val images, and the page
    assert set(pf) == set(jf) and len(pf) == 3 * 7 + 1
    near_ties = 0
    for i, name in enumerate(sorted(n for n in pf
                                    if n.endswith("_prediction.png"))):
        top2 = np.sort(logits[i][0], axis=-1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) < GAP
        got = np.asarray(Image.open(pdir / name))
        want = np.asarray(Image.open(jdir / name))
        assert not ((got != want).any(-1) & ~tie).any(), name
        near_ties += int(tie.sum())
    for name in jf:  # made from the loader's uint8 batch alone
        if name.endswith(("_input.png", "_gt.png")):
            assert pf[name] == jf[name], name
    assert np.abs(pm.hist - jm.hist).sum() <= 2 * near_ties
    assert pm.hist.sum() == jm.hist.sum() > 0


def test_dump_topn_without_labels_raises(end_to_end):
    _, _, _, tmp, sets, ckpt = end_to_end
    for extra in ({"eval.dump_for_submission": True},
                  {"eval.dump_for_auto_labelling": True}):
        cfg = make_config({**sets, "eval.dump_topn": 2, **extra})
        with pytest.raises(ValueError, match="labels"):
            evaluate_only(cfg, logdir=str(tmp / "l"), device="cpu")


def test_dump_topn_gallery(end_to_end):
    """eval.dump_topn routes evaluate_only through the two-pass top-N:
    every dumped prediction is the image's own argmax."""
    _, pm, _, tmp, sets, ckpt = end_to_end
    cfg = make_config({**sets, "eval.dump_topn": 1})
    m = evaluate_only(cfg, logdir=str(tmp / "topn"), checkpoint=ckpt,
                      device="cpu")
    np.testing.assert_array_equal(m.hist, pm.hist)
    out = tmp / "topn" / "eval_images" / "best_images"
    files = set(os.listdir(out))
    assert "topn_failures.html" in files
    errs = [f for f in files if f.endswith("_err_mask.png")]
    assert len(errs) == 19  # one (image, class) pair a class
    for f in errs:
        base = f[:-len("_err_mask.png")]
        img = base.rsplit("_", 1)[0]
        assert np.array_equal(
            np.asarray(Image.open(out / f"{base}_prediction.png")),
            np.asarray(Image.open(tmp / "port" / "eval_images"
                                  / f"{img}_prediction.png")))


def test_folder_mode_dumps_every_image(cs_tree, tmp_path):
    """`dump --eval-mode folder` over a bare folder: no labels, no metrics,
    every image written, through the CLI."""
    folder = os.path.join(cs_tree, "leftImg8bit_trainextra/leftImg8bit/"
                                   "train_extra/aug")
    argv = ["dump", "--device", "cpu", "--eval-mode", "folder",
            "--logdir", str(tmp_path),
            "--config", os.path.join(REPO, "tpuseg_torch", "cli", "recipes",
                                     "dump_folder.yaml")]
    for k, v in {**_sets(cs_tree, str(tmp_path)),
                 "dataset.eval_folder": folder}.items():
        argv += ["--set", f"{k}={v}"]
    assert cli_main(argv) == 0
    files = os.listdir(tmp_path / "eval_images")
    assert sum(f.endswith("_prediction.png") for f in files) == 2
    assert not any(f.endswith("_err_mask.png") for f in files)
    assert "index.html" in files


def test_auto_labelling_round_trip(cs_tree, end_to_end, tmp_path,
                                   monkeypatch):
    """`dump --set eval.dump_for_auto_labelling=true` over the coarse
    extras, read back by the custom-coarse loader (what the SOTA recipe
    trains on): the labels are the dumped predictions as trainIds, with
    pixels under dataset.custom_coarse_prob ignored. The threshold is set
    inside the random model's confidences, so both sides of it occur."""
    cc = tmp_path / "autolabelled"
    folder = os.path.join(cs_tree, "leftImg8bit_trainextra/leftImg8bit/"
                                   "train_extra/aug")
    dumped = {}
    real = ImageDumper.dump

    def spy(self, dump_dict, val_idx, testing=False):
        for i, name in enumerate(dump_dict["img_names"]):
            dumped[name] = (dump_dict["assets"]["predictions"][i],
                            dump_dict["assets"]["prob_mask"][i])
        return real(self, dump_dict, val_idx, testing)

    monkeypatch.setattr(ImageDumper, "dump", spy)
    sets = {**_sets(cs_tree, str(tmp_path)), "dataset.eval_folder": folder,
            "eval.dump_for_auto_labelling": True,
            "eval.result_dir": str(cc / "train_extra" / "aug")}
    assert evaluate_only(make_config(sets), logdir=str(tmp_path / "l"),
                         eval_mode="folder", checkpoint=end_to_end[-1],
                         device="cpu") is None
    assert len(dumped) == 2

    # a threshold inside the dumped confidences, as the PNG stores them
    probs = np.concatenate([(p * 255).astype(np.uint8).ravel() / 255.0
                            for _, p in dumped.values()])
    thr = float(np.median(probs)) + 0.5 / 255
    cfg = make_config({"dataset.cityscapes_dir": cs_tree,
                       "dataset.cityscapes_customcoarse": str(cc),
                       "dataset.custom_coarse_prob": thr,
                       "dataset.class_uniform_pct": 0.0,
                       "dataset.coarse_boost_classes": (13,),
                       "dataset.transfer_uint8": True})
    ds = Cityscapes(cfg.dataset, mode="train")
    coarse = [i for i, rec in enumerate(ds.imgs) if str(cc) in rec[1]]
    assert len(coarse) == 2
    for i in coarse:
        sample = ds[i]
        pred, prob = dumped[sample["name"]]
        keep = (prob * 255).astype(np.uint8) / 255.0 >= thr
        assert keep.any() and not keep.all()
        want = np.where(keep, pred, 255)
        np.testing.assert_array_equal(sample["label"], want)


def _orbax_to_pth():
    """``scripts/orbax_to_pth.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "orbax_to_pth", os.path.join(REPO, "scripts", "orbax_to_pth.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_orbax_snapshot_converts_to_reference_pth(end_to_end):
    """The fixture's tpuseg snapshot through ``scripts/orbax_to_pth.py``:
    the same state dict, tensor for tensor, as the .pth made from the same
    weights, loaded strictly by the port's ``--checkpoint`` path."""
    import torch

    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.convert import load_reference_checkpoint

    _, _, _, tmp, sets, ckpt = end_to_end
    out = str(tmp / "converted.pth")
    skipped = []
    _orbax_to_pth().convert(str(tmp / "snapshot"), out, sets["model.arch"],
                            log=skipped.append)
    assert skipped == []
    got = torch.load(out, weights_only=True)
    want = torch.load(ckpt, weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    load_reference_checkpoint(
        get_model(eval_model_config(make_config(sets))), out)


def test_orbax_snapshot_of_another_class_count(tmp_path):
    """A 65-class snapshot (Mapillary's head) converted for 19 classes:
    tpuseg's forgiving merge skips, and logs, exactly the leaves whose
    shape depends on the class count, which keep the fresh model's
    values; every other tensor is the snapshot's."""
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    import torch

    from _torch_port import flax_shapes, random_variables
    from tpuseg.models import get_model as jax_model
    from tpuseg_torch.convert import state_dict_from_flax

    arch = "ocrnet.HRNet_Mscale_Tiny"
    example = jnp.zeros((1, 64, 64, 3))

    def shapes(n):
        return flax_shapes(jax_model(jax_config(
            {"model.arch": arch, "dataset.num_classes": n})), example,
            train=False)

    m65 = jax_model(jax_config({"model.arch": arch,
                                "dataset.num_classes": 65}))
    variables = random_variables(m65, np.random.RandomState(3), example,
                                 train=False)
    snapshot = str(tmp_path / "snapshot65")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(snapshot, variables)
    ckptr.wait_until_finished()
    skipped = []
    got = _orbax_to_pth().convert(snapshot, str(tmp_path / "out.pth"), arch,
                                  num_classes=19, log=skipped.append)

    def flat(tree, prefix=""):
        if hasattr(tree, "items"):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}{k}/")
        else:
            yield prefix[:-1], tuple(tree.shape)

    s65, s19 = shapes(65), shapes(19)
    changed = {k for coll in ("params", "batch_stats")
               for (k, a), (_, b) in zip(flat(s65[coll]), flat(s19[coll]))
               if a != b}
    assert changed and sorted(skipped) == sorted(
        f"Skipped loading parameter {k}" for k in changed)
    want = state_dict_from_flax(variables["params"],
                                variables["batch_stats"], arch=arch)
    assert list(got) == list(want)
    differ = [k for k in want if want[k].shape != got[k].shape]
    assert differ and all(("cls_head" in k or "aux_head" in k)
                          for k in differ)
    for k in want:
        if k not in differ:
            assert torch.equal(got[k], want[k]), k
