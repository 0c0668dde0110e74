"""The Mapillary and SOTA recipes and EvalRunner's flip and outer-scale
path of the port against tpuseg, on the CPU:

- ``eval_mapillary.yaml`` as shipped (65 classes, ignore 65, scales 0.25 /
  0.5 / 1.0 / 2.0 in the model, flip, ``pad_multiple`` 64, palette and
  names from the tree's ``config.json``) through both packages'
  ``evaluate_only`` on ``ocrnet.HRNet_Mscale_Tiny`` with the same weights,
  over a seeded Mapillary tree whose ragged images share one pad bucket:
  equal confusion matrices with f32 fusion, and the port's argmax with
  the recipe's bf16 fusion held against tpuseg's f32 one;
- the tiny MscaleOCR of tests/test_torch_eval_slice.py (one inner scale)
  through EvalRunner with ``do_flip`` and outer scales (1.0, 0.5, 1.5),
  padded and not: equal confusion matrices and predictions;
- train batches of ``train_mapillary.yaml`` (pre_size, gblur,
  class-uniform 0.5) and ``train_cityscapes_sota.yaml`` (coarse boost over
  an auto-labelled tree) equal to tpuseg's from the same seed.

tpuseg's jitted programs compile with XLA's backend optimisations off
(``quick_xla``).
"""
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from PIL import Image

import tpuseg.train.loop as jax_loop
import tpuseg_torch.train.loop as port_loop
from _torch_port import load_into, quick_xla, random_variables, set_threads
from test_torch_eval_slice import MODEL, SPEC
from tpuseg.cli.main import load_config as jax_load_config
from tpuseg.config import make_config as jax_make_config
from tpuseg.data.setup import setup_data as jax_setup_data
from tpuseg.evaluation.inference import EvalRunner as JaxRunner
from tpuseg.losses.ce import cross_entropy as jax_ce
from tpuseg.models import get_model as jax_get_model
from tpuseg.models.hrnet import HRNetSpec as JaxSpec
from tpuseg.models.ocrnet import MscaleOCR as JaxMscale
from tpuseg_torch.cli.main import load_config
from tpuseg_torch.config import eval_model_config
from tpuseg_torch.data.cityscapes_labels import PALETTE, TRAINID_TO_ID
from tpuseg_torch.data.setup import setup_data
from tpuseg_torch.evaluation.inference import EvalRunner
from tpuseg_torch.losses import cross_entropy
from tpuseg_torch.models import get_model
from tpuseg_torch.models.hrnet import HRNetSpec
from tpuseg_torch.models.ocrnet import MscaleOCR
from tpuseg_torch.train.loop import evaluate_only

set_threads()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_RECIPES = os.path.join(REPO, "tpuseg_torch", "cli", "recipes")
JAX_RECIPES = os.path.join(REPO, "tpuseg", "cli", "recipes")
# ragged val images: pre_size 64 scales each one's long side to 64, so all
# pad to one 64x64 bucket (one compiled graph on tpuseg's side)
VAL_SIZES = [(48, 67), (52, 80), (40, 90)]
TRAIN_SIZES = [(96, 120), (110, 100), (90, 128), (100, 100)]


@pytest.fixture(scope="module")
def fake_mapillary(tmp_path_factory):
    """training/ and validation/ trees of seeded scenes and a config.json
    with 66 labels (65 classes and the ignore class), as
    tests/test_mapillary_eval.py writes."""
    root = tmp_path_factory.mktemp("mapillary")
    rng = np.random.RandomState(0)
    labels = [{"color": [int(c) for c in rng.randint(0, 255, 3)],
               "readable": f"class {i}", "instances": False}
              for i in range(66)]
    (root / "config.json").write_text(json.dumps({"labels": labels}))
    for split, sizes in (("validation", VAL_SIZES),
                         ("training", TRAIN_SIZES)):
        (root / split / "images").mkdir(parents=True)
        (root / split / "labels").mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            # blocks of one class, so class-uniform sampling has tiles
            mask = np.repeat(np.repeat(rng.randint(0, 66, (4, 4)), -(-h // 4),
                                       0), -(-w // 4), 1)[:h, :w]
            image = np.clip(mask[..., None] * 3 + rng.randint(
                0, 60, (h, w, 3)), 0, 255)
            Image.fromarray(image.astype(np.uint8)).save(
                root / split / "images" / f"img{i}.jpg")
            Image.fromarray(mask.astype(np.uint8)).save(
                root / split / "labels" / f"img{i}.png")
    return str(root)


def _mapillary_sets(root, tmp, fusion):
    return [f"dataset.mapillary_dir={root}", "dataset.pre_size=64",
            "dataset.num_workers=2", f"dataset.centroid_root={tmp}",
            "model.arch=ocrnet.HRNet_Mscale_Tiny",
            "model.compute_dtype=float32", "model.remat=false",
            f"model.eval_fusion_dtype={fusion}", "train.test_mode=false"]


def _recording(runner_cls, predictions: list):
    """``runner_cls`` whose forward also records each batch's predictions
    (the padded batch's, no extra compile)."""

    class Recording(runner_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            forward = self.forward

            def record(*args):
                out = forward(*args)
                predictions.append(np.array(out[1]))
                return out

            self.forward = record

    return Recording


def _port_evaluate_only(root, tmp, fusion, ckpt):
    """The port's evaluate_only of eval_mapillary.yaml from a reference
    .pth: -> (its config, metrics, predictions)."""
    sets = _mapillary_sets(root, str(tmp), fusion)
    cfg = load_config(os.path.join(PORT_RECIPES, "eval_mapillary.yaml"),
                      sets)
    predictions = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_loop, "EvalRunner",
                   _recording(port_loop.EvalRunner, predictions))
        metrics = evaluate_only(cfg, logdir=str(tmp / f"port_{fusion}"),
                                checkpoint=ckpt, device="cpu")
    return cfg, metrics, predictions


@pytest.fixture(scope="module")
def mapillary_f32(fake_mapillary, tmp_path_factory):
    """tpuseg's and the port's evaluate_only of eval_mapillary.yaml with f32
    fusion from one set of seeded weights (a tpuseg snapshot, a reference
    .pth): -> (the port's config, tpuseg's metrics, the port's, each side's
    predictions, the .pth)."""
    tmp = tmp_path_factory.mktemp("f32")
    sets = _mapillary_sets(fake_mapillary, str(tmp), "float32")
    jcfg = jax_load_config(os.path.join(JAX_RECIPES, "eval_mapillary.yaml"),
                           sets)
    # the variables do not depend on the scales: trace one for their shapes
    jm = jax_get_model(jax_make_config({"model.arch": jcfg.model.arch,
                                        "dataset.num_classes": 65,
                                        "model.n_scales": (1.0,)}))
    variables = random_variables(jm, np.random.RandomState(8),
                                 jnp.zeros((1, 64, 64, 3)))
    # no classifier bias: with 65 classes a random bias outweighs the tiny
    # net's logit spread and one class would win every pixel
    cls = variables["params"]["ocr"]["cls"]
    cls["bias"] = np.zeros_like(cls["bias"])
    snapshot, ckpt = str(tmp / "snapshot"), str(tmp / "weights.pth")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(snapshot, variables)
    ckptr.wait_until_finished()
    cfg = load_config(os.path.join(PORT_RECIPES, "eval_mapillary.yaml"),
                      sets)
    torch.save(load_into(get_model(eval_model_config(cfg)),
                         variables).state_dict(), ckpt)
    jpred = []
    with quick_xla(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "EvalRunner",
                   _recording(jax_loop.EvalRunner, jpred))
        jmetrics = jax_loop.evaluate_only(jcfg, logdir=str(tmp / "jax"),
                                          checkpoint=snapshot)
    cfg, pmetrics, ppred = _port_evaluate_only(fake_mapillary, tmp,
                                               "float32", ckpt)
    return cfg, jmetrics, pmetrics, jpred, ppred, ckpt


def test_mapillary_eval_miniature_f32_matches_tpuseg(mapillary_f32):
    cfg, jm, pm, jpred, ppred, _ = mapillary_f32
    assert cfg.model.n_scales == (0.25, 0.5, 1.0, 2.0)
    assert cfg.eval.do_flip and cfg.eval.pad_multiple == 64
    assert pm.hist.shape == (65, 65)
    np.testing.assert_array_equal(pm.hist, jm.hist)
    # the matrix is load-bearing: the predictions spread over classes
    assert (pm.hist.sum(0) > 0).sum() >= 3
    # every labelled pixel of the ragged images, none of the padding
    _, val_loader, _ = setup_data(cfg, eval_mode="val")
    sizes, labelled = set(), 0
    for batch in val_loader:
        label = np.asarray(batch["label"])
        sizes.add(tuple(-(-d // 64) * 64 for d in label.shape[1:]))
        labelled += int((label != 65).sum())
    assert sizes == {(64, 64)} and pm.hist.sum() == labelled
    assert len(jpred) == len(ppred) == len(VAL_SIZES)
    ds = val_loader.dataset
    assert len(ds.trainid_to_name) == 66 and ds.palette is not None


# The recipe's bf16 fusion (model.eval_fusion_dtype) held against tpuseg's
# f32 predictions by argmax agreement. The per-scale logits are the f32
# ones (< 1e-5 from tpuseg's); the fusion chain then rounds to bf16 (2^-8
# of each value) after every op, so a pixel's argmax can change only where
# its top-2 gap is within a few bf16 ulps of its logits, a small share of a
# random net's pixels even at 65 classes.
BF16_AGREE = 0.98


def test_mapillary_eval_miniature_bf16_fusion(fake_mapillary, mapillary_f32,
                                              tmp_path):
    _, jm, _, jpred, _, ckpt = mapillary_f32
    cfg, pm, ppred = _port_evaluate_only(fake_mapillary, tmp_path,
                                         "bfloat16", ckpt)
    assert cfg.model.eval_fusion_dtype == "bfloat16"
    assert pm.hist.sum() == jm.hist.sum() > 0
    assert len(ppred) == len(jpred) == len(VAL_SIZES)
    agree = np.mean(np.concatenate([(p == j).ravel()
                                    for p, j in zip(ppred, jpred)]))
    assert agree >= BF16_AGREE, agree


# ------------------------------------------------- flip and outer scales


def test_eval_runner_flip_and_outer_scales_match_tpuseg():
    """do_flip with outer scales (1.0, 0.5, 1.5) around the tiny MscaleOCR:
    a ragged 50x100 batch padded to 64x128 (pad_multiple 32)
    and an aligned 64x128 batch unpadded. tpuseg's runner pads both (for
    the aligned batch a no-op: its pad mask multiplies by 1.0), so one
    compiled program serves the two."""
    # one inner scale: the outer loop is under test (six passes to trace)
    model = {**MODEL, "n_scales": (1.0,)}
    jm = JaxMscale(spec=JaxSpec(**SPEC), dtype=jnp.float32, **model)
    v = random_variables(jm, np.random.RandomState(0),
                         jnp.zeros((1, 64, 128, 3), jnp.float32))
    port = load_into(MscaleOCR(spec=HRNetSpec(**SPEC), dtype=torch.float32,
                               **model), v)
    kw = dict(scales=(1.0, 0.5, 1.5), do_flip=True)
    rng = np.random.RandomState(1)
    with quick_xla():
        jr = JaxRunner(jm, 19, pad_multiple=32, donate_acc=False,
                       criterion=functools.partial(jax_ce, ignore_label=255),
                       **kw)
        for hw, pad in (((50, 100), 32), ((64, 128), None)):
            batch = {"image": rng.randint(0, 256, (1, *hw, 3)).astype(
                np.uint8), "label": rng.randint(0, 19, (1, *hw)).astype(
                np.uint8)}
            batch["label"][:, :4] = 255
            pr = EvalRunner(port, 19, pad_multiple=pad, device="cpu",
                            criterion=functools.partial(cross_entropy,
                                                        ignore_label=255),
                            **kw)
            jout, jhist, jloss = jr.run_batch(v, batch)
            pout, phist, ploss = pr.run_batch(batch)
            assert set(pout["scale_hists"]) == {1.0, 0.5, 1.5}
            np.testing.assert_array_equal(phist, jhist)
            for s, h in jout["scale_hists"].items():
                np.testing.assert_array_equal(pout["scale_hists"][s], h)
            np.testing.assert_array_equal(pout["predictions"],
                                          jout["predictions"])
            np.testing.assert_allclose(pout["prob_mask"], jout["prob_mask"],
                                       atol=1e-5)
            assert phist.sum() == (batch["label"] != 255).sum()
            assert abs(ploss - jloss) < 1e-5


# ------------------------------------------------------------ train batches


def _train_batches(setup, load, recipe, sets, epochs=2):
    """Seeded train batches of ``epochs`` epochs, each epoch re-mixed as
    the Trainer re-mixes it."""
    cfg = load(recipe, sets)
    loader, _, train_set = setup(cfg, seed=cfg.train.seed)
    out = []
    for epoch in range(epochs):
        train_set.build_epoch(epoch)
        loader.set_epoch(epoch)
        out += list(loader)
    return out


def _assert_same_batches(got, want, n):
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


def test_mapillary_train_batches_match_tpuseg(fake_mapillary, tmp_path):
    """train_mapillary.yaml: pre_size, gblur, class-uniform sampling at 0.5,
    the uint8 wire."""
    sets = [f"dataset.mapillary_dir={fake_mapillary}",
            "dataset.pre_size=128", "dataset.crop_size=[64,64]",
            "dataset.class_uniform_tile=32", "train.batch_size=1",
            "dataset.num_workers=2"]
    recipe = "train_mapillary.yaml"
    got = _train_batches(setup_data, load_config,
                         os.path.join(PORT_RECIPES, recipe), sets + [
                             f"dataset.centroid_root={tmp_path / 'port'}"])
    want = _train_batches(jax_setup_data, jax_load_config,
                          os.path.join(JAX_RECIPES, recipe), sets + [
                              f"dataset.centroid_root={tmp_path / 'jax'}"])
    cfg = load_config(os.path.join(PORT_RECIPES, recipe), sets)
    assert cfg.dataset.gblur and cfg.dataset.class_uniform_pct == 0.5
    assert got[0]["image"].dtype == np.uint8
    _assert_same_batches(got, want, 2 * len(TRAIN_SIZES))


@pytest.fixture(scope="module")
def sota_tree(tmp_path_factory):
    """A Cityscapes tree (2 fine train, 1 val scene), 2 coarse-extra scenes
    with their gtCoarse labels, and an auto-labelled tree of those extras
    as the dumper writes it (trainId-as-labelId PNG + confidence PNG)."""
    root = tmp_path_factory.mktemp("cs_sota")
    rng = np.random.RandomState(7)
    h, w = 64, 128

    def scene():
        tid = np.repeat(np.repeat(rng.randint(0, 19, (4, 8)), 16, 0), 16, 1)
        image = np.clip(PALETTE[tid].astype(int)
                        + rng.randint(-30, 31, (h, w, 3)), 0, 255)
        return image.astype(np.uint8), tid

    lv = "leftImg8bit_trainvaltest/leftImg8bit"
    for split, city, n in (("train", "aachen", 2), ("val", "lindau", 1)):
        (root / lv / split / city).mkdir(parents=True)
        (root / "gtFine_trainvaltest/gtFine" / split / city).mkdir(
            parents=True)
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            image, tid = scene()
            Image.fromarray(image).save(
                root / lv / split / city / f"{base}_leftImg8bit.png")
            Image.fromarray(TRAINID_TO_ID[tid]).save(
                root / "gtFine_trainvaltest/gtFine" / split / city
                / f"{base}_gtFine_labelIds.png")
    extra = root / "leftImg8bit_trainextra/leftImg8bit/train_extra/aug"
    coarse = root / "gtCoarse/gtCoarse/train_extra/aug"
    auto = root / "autolabelled/train_extra/aug"
    for d in (extra, coarse, auto):
        d.mkdir(parents=True)
    for i in range(2):
        base = f"aug_{i:06d}_000019"
        image, tid = scene()
        Image.fromarray(image).save(extra / f"{base}_leftImg8bit.png")
        Image.fromarray(TRAINID_TO_ID[tid]).save(
            coarse / f"{base}_gtCoarse_labelIds.png")
        pred = np.repeat(np.repeat(rng.randint(0, 19, (4, 8)), 16, 0), 16, 1)
        Image.fromarray(TRAINID_TO_ID[pred]).save(
            auto / f"{base}_leftImg8bit.png")
        Image.fromarray(rng.randint(0, 256, (h, w)).astype(np.uint8)).save(
            auto / f"{base}_leftImg8bit_prob.png")
    return str(root)


def test_sota_train_batches_match_tpuseg(sota_tree, tmp_path):
    """train_cityscapes_sota.yaml: the coarse boost over the auto-labelled
    extras (custom-coarse threshold, dropout classes merged from gtCoarse,
    the fine labels masked out), class-uniform sampling at 0.5."""
    sets = [f"dataset.cityscapes_dir={sota_tree}",
            "dataset.cityscapes_customcoarse="
            f"{os.path.join(sota_tree, 'autolabelled')}",
            "dataset.custom_coarse_prob=0.5", "dataset.crop_size=[64,128]",
            "dataset.class_uniform_tile=64", "train.batch_size=1",
            "dataset.num_workers=2"]
    recipe = "train_cityscapes_sota.yaml"
    got = _train_batches(setup_data, load_config,
                         os.path.join(PORT_RECIPES, recipe), sets + [
                             f"dataset.centroid_root={tmp_path / 'port'}"])
    want = _train_batches(jax_setup_data, jax_load_config,
                          os.path.join(JAX_RECIPES, recipe), sets + [
                              f"dataset.centroid_root={tmp_path / 'jax'}"])
    cfg = load_config(os.path.join(PORT_RECIPES, recipe), sets)
    assert cfg.dataset.coarse_boost_classes and cfg.dataset.mask_out_cityscapes
    _assert_same_batches(got, want, 4)
