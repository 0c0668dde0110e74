"""The port's own copy of the host code (config, recipes, CLI overrides,
data pipeline, label helpers) against tpuseg's: the same recipe and
overrides give the same config, and the same config gives the same val
batches."""
import dataclasses
import filecmp
import os

import numpy as np
import pytest
from PIL import Image

import tpuseg.native as jax_native
import tpuseg_torch.native as port_native
from tpuseg.cli.main import load_config as jax_load_config
from tpuseg.data.setup import setup_data as jax_setup_data
from tpuseg_torch.cli.main import load_config
from tpuseg_torch.data.setup import setup_data
from tpuseg_torch.utils.logging import Logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECIPES = os.path.join(REPO, "tpuseg", "cli", "recipes")
PORT_RECIPES = os.path.join(REPO, "tpuseg_torch", "cli", "recipes")
RECIPES = sorted(f for f in os.listdir(JAX_RECIPES) if f.endswith(".yaml"))
# a bool, a bracketed list, null, the bare comma form and a float
SETS = ["eval.do_flip=false", "dataset.crop_size=[64,128]",
        "model.n_scales=null", "eval.scales=0.5,1.0,2.0", "optim.lr=1e-3"]
H, W = 128, 256


def test_recipes_shipped_with_the_port():
    assert len(RECIPES) == 8
    assert sorted(os.listdir(PORT_RECIPES)) == RECIPES
    for name in RECIPES:
        assert filecmp.cmp(os.path.join(JAX_RECIPES, name),
                           os.path.join(PORT_RECIPES, name), shallow=False)


@pytest.mark.parametrize("sets", [[], SETS], ids=["recipe", "recipe+sets"])
@pytest.mark.parametrize("recipe", RECIPES)
def test_load_config_matches_tpuseg(recipe, sets):
    got = load_config(os.path.join(PORT_RECIPES, recipe), sets)
    want = jax_load_config(os.path.join(JAX_RECIPES, recipe), sets)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if sets:
        assert got.eval.do_flip is False
        assert tuple(got.dataset.crop_size) == (64, 128)
        assert got.model.n_scales is None
        assert tuple(got.eval.scales) == (0.5, 1.0, 2.0)


@pytest.fixture(scope="module")
def fake_cityscapes(tmp_path_factory):
    """leftImg8bit/gtFine tree: 1 train city x 3 images, 1 val city x 3."""
    root = tmp_path_factory.mktemp("cs")
    rng = np.random.RandomState(0)
    for split, city, n in [("train", "aachen", 3), ("val", "lindau", 3)]:
        img_dir = root / "leftImg8bit_trainvaltest/leftImg8bit" / split / city
        msk_dir = root / "gtFine_trainvaltest/gtFine" / split / city
        img_dir.mkdir(parents=True, exist_ok=True)
        msk_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            img = rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
            Image.fromarray(img).save(img_dir / f"{base}_leftImg8bit.png")
            # raw label ids: road(7), car(26), sky(23), void(0)
            mask = np.zeros((H, W), np.uint8)
            mask[H // 2:, :] = 7
            mask[:H // 4, :] = 23
            mask[60:90, 100 + 10 * i:180] = 26
            Image.fromarray(mask).save(msk_dir / f"{base}_gtFine_labelIds.png")
    return str(root)


def _batches(setup, load, sets):
    cfg = load(None, sets)
    _, loader, _ = setup(cfg, eval_mode="val", seed=cfg.train.seed)
    return list(loader)


@pytest.mark.parametrize("bs", [1, 2])
@pytest.mark.parametrize("dataset", ["synthetic", "cityscapes"])
def test_val_batches_match_tpuseg(dataset, bs, fake_cityscapes, tmp_path):
    sets = [f"dataset.name={dataset}", f"eval.batch_size={bs}",
            "dataset.num_workers=2"]
    if dataset == "synthetic":
        sets.append("dataset.crop_size=[32,48]")
    else:
        sets += [f"dataset.cityscapes_dir={fake_cityscapes}",
                 f"dataset.centroid_root={tmp_path}"]
    got = _batches(setup_data, load_config, sets)
    want = _batches(jax_setup_data, jax_load_config, sets)
    assert len(got) == len(want) == -(-(16 if dataset == "synthetic"
                                        else 3) // bs)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


def _train_batches(setup, load, sets, epochs=2):
    """Seeded train batches of ``epochs`` epochs, each epoch re-mixed as
    the Trainer re-mixes it."""
    cfg = load(None, sets)
    loader, _, train_set = setup(cfg, seed=cfg.train.seed)
    out = []
    for epoch in range(epochs):
        train_set.build_epoch(epoch)
        loader.set_epoch(epoch)
        out += list(loader)
    return out


@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float32"])
def test_train_batches_match_tpuseg(uint8, fake_cityscapes, tmp_path):
    """Scale, crop, flip, colour jitter and class-uniform sampling at 0.5
    from the same seed give the same train batches."""
    sets = ["dataset.name=cityscapes",
            f"dataset.cityscapes_dir={fake_cityscapes}",
            "dataset.crop_size=[64,128]", "dataset.class_uniform_tile=64",
            "dataset.class_uniform_pct=0.5", "train.batch_size=1",
            "dataset.num_workers=2", f"dataset.transfer_uint8={uint8}"]
    got = _train_batches(setup_data, load_config, sets + [
        f"dataset.centroid_root={tmp_path / 'port'}"])
    want = _train_batches(jax_setup_data, jax_load_config, sets + [
        f"dataset.centroid_root={tmp_path / 'jax'}"])
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["image"].dtype == (np.uint8 if uint8 else np.float32)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


def test_label_helpers_match_tpuseg():
    rng = np.random.RandomState(3)
    mask = rng.randint(0, 40, (70, 130)).astype(np.uint8)
    table = rng.randint(0, 256, 256).astype(np.uint8)
    np.testing.assert_array_equal(port_native.remap(mask, table),
                                  jax_native.remap(mask, table))
    got = port_native.tile_class_centroids(mask, 32, 19)
    want = jax_native.tile_class_centroids(mask, 32, 19)
    assert {c: sorted(p) for c, p in got.items()} == \
        {c: sorted(p) for c, p in want.items()}


def test_unported_host_options_raise(tmp_path):
    # dataset.loader=grain is ported (tests/test_torch_grain_loader.py)
    with pytest.raises(NotImplementedError, match="TensorBoard"):
        Logger(str(tmp_path), tensorboard=True)
