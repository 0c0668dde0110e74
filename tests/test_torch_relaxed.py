"""Label relaxation in the port vs tpuseg: the relaxed soft NLL's value and
gradient over multi-hot border targets (every norm / batch-weighting /
border-inversion case, with ignore pixels, batch 2), the loss factory's
relaxed criterion, the Trainer's border schedule (the inverted criterion
and the reduce_border label transform past loss.reduce_border_epoch, its
batches equal to tpuseg's), and the DeepLabV3+ recipe through the CLI on
the CPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import set_threads
from tpuseg.cli.main import load_config as jax_load_config
from tpuseg.data.setup import relaxed_label_transform as jax_transform
from tpuseg.data.setup import setup_data as jax_setup_data
from tpuseg.losses.relaxed import relaxed_soft_nll as jax_relaxed
from tpuseg_torch.cli.main import load_config
from tpuseg_torch.config import make_config
from tpuseg_torch.data.relaxed_labels import relaxed_onehot
from tpuseg_torch.losses import get_loss, relaxed_soft_nll
from tpuseg_torch.train.checkpoint import CheckpointManager
from tpuseg_torch.train.loop import Trainer

set_threads()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "tpuseg_torch", "cli", "recipes",
                      "train_cityscapes_deepv3.yaml")
C = 19


def _targets(reduce_border=False):
    """Seeded logits (2, 24, 32, 19) and multi-hot targets from the port's
    relaxed_onehot over blocky label maps with an ignore region."""
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 6, (2, 3, 4)).repeat(8, 1).repeat(8, 2)
    labels[0, :4] = 255
    labels[1, :, -5:] = 255
    target = np.stack([relaxed_onehot(lab, C, border=1,
                                      reduce_border=reduce_border)
                       for lab in labels]).astype(np.float32)
    logits = (2 * rng.randn(2, 24, 32, C)).astype(np.float32)
    return logits, target


@pytest.mark.parametrize("norm", [False, True], ids=["1-hist", "norm"])
@pytest.mark.parametrize("batch_weighting", [False, True],
                         ids=["per-image", "batch"])
@pytest.mark.parametrize("invert_border", [False, True],
                         ids=["relaxed", "inverted"])
def test_relaxed_soft_nll_matches_tpuseg(norm, batch_weighting,
                                         invert_border):
    """Value and gradient w.r.t. the logits, rel < 1e-5."""
    logits, target = _targets(reduce_border=invert_border)
    assert target.max() == (2 if invert_border else 1)
    assert (target[..., C] > 0).any() and (target[..., :C].sum(-1) > 1).any()
    kw = dict(upper_bound=1.0, norm=norm, batch_weighting=batch_weighting,
              invert_border=invert_border)
    want, want_g = jax.value_and_grad(
        lambda x: jax_relaxed(x, jnp.asarray(target), **kw))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = relaxed_soft_nll(x, torch.from_numpy(target), **kw)
    got.backward()
    assert abs(got.item() - float(want)) / abs(float(want)) < 1e-5
    g, w = x.grad.double().numpy(), np.asarray(want_g, np.float64)
    assert np.abs(g - w).sum() / np.abs(w).sum() < 1e-5


def test_factory_relaxed_criterion():
    """get_loss's relaxed criterion: the config's bound and weighting, the
    border flip passed through; the val criterion stays CE."""
    cfg = make_config({"loss.loss_type": "relaxed", "loss.img_wt_bound": 2.0,
                       "loss.batch_weighting": True})
    criterion, val = get_loss(cfg)
    logits, target = _targets()
    x, t = torch.from_numpy(logits), torch.from_numpy(target)
    for invert in (False, True):
        want = relaxed_soft_nll(x, t, upper_bound=2.0, batch_weighting=True,
                                invert_border=invert)
        assert torch.equal(criterion(x, t, do_rmi=True,
                                     invert_border=invert), want)
    assert val.func.__name__ == "cross_entropy"


# ------------------------------------------------------- border schedule


@pytest.fixture(scope="module")
def fake_cityscapes(tmp_path_factory):
    """leftImg8bit/gtFine tree: 3 train and 2 val 64x64 images of blocky
    classes."""
    root = tmp_path_factory.mktemp("cs")
    rng = np.random.RandomState(0)
    ids = np.array([7, 8, 11, 21, 23, 24, 26])  # labelIds of train classes
    for split, city, n in [("train", "aachen", 3), ("val", "lindau", 2)]:
        img_dir = root / "leftImg8bit_trainvaltest/leftImg8bit" / split / city
        msk_dir = root / "gtFine_trainvaltest/gtFine" / split / city
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)
                            ).save(img_dir / f"{base}_leftImg8bit.png")
            mask = ids[rng.randint(0, len(ids), (4, 4))].repeat(
                16, 0).repeat(16, 1).astype(np.uint8)
            Image.fromarray(mask).save(
                msk_dir / f"{base}_gtFine_labelIds.png")
    return str(root)


def _relaxed_sets(root, tmp):
    return ["model.arch=deepv3.DeepV3PlusW38Tiny",
            "model.compute_dtype=float32", "model.remat=false",
            "loss.loss_type=relaxed", "dataset.jointwtborder=true",
            "loss.reduce_border_epoch=0", "loss.border_window=2",
            f"dataset.cityscapes_dir={root}",
            f"dataset.centroid_root={os.path.join(tmp, 'centroids')}",
            "dataset.crop_size=[32,32]", "dataset.class_uniform_tile=32",
            "dataset.num_workers=2", "dataset.color_aug=0.0",
            "train.batch_size=1", "train.test_mode=true",
            "train.log_every=1", "optim.lr=1e-3"]


def test_trainer_border_schedule(fake_cityscapes, tmp_path):
    """Epoch 0 runs the plain relaxed criterion on the relaxed targets,
    epoch 1 (past reduce_border_epoch=0) invert_border=True on the
    reduce_border targets: the batches the criterion sees equal tpuseg's
    loader's with its transform swapped the same way. Validation keeps
    int labels and CE."""
    sets = _relaxed_sets(fake_cityscapes, str(tmp_path / "port"))
    trainer = Trainer(load_config(RECIPE, sets), str(tmp_path / "logs"),
                      device="cpu")
    seen, val_seen = [], []
    crit, val_forward = trainer.criterion, trainer.eval_runner.forward

    def spy(logits, target, do_rmi=None, invert_border=False):
        seen.append((invert_border, target.clone()))
        return crit(logits, target, do_rmi, invert_border)

    def val_spy(image, label, acc, valid_hw=None):
        val_seen.append(label.dtype)
        return val_forward(image, label, acc, valid_hw)

    trainer.criterion = spy
    trainer.train_step = trainer._make_train_step(invert_border=False)
    trainer.eval_runner.forward = val_spy
    trainer.fit()
    assert [inv for inv, _ in seen] == [False] * 3 + [True] * 3
    assert val_seen and all(not d.is_floating_point for d in val_seen)

    cfg = jax_load_config(RECIPE, _relaxed_sets(fake_cityscapes,
                                                str(tmp_path / "jax")))
    loader, _, train_set = jax_setup_data(cfg, seed=cfg.train.seed)
    want = []
    for epoch in range(2):
        if epoch > 0:
            train_set.label_transform = jax_transform(cfg, 255,
                                                      reduce_border=True)
        train_set.build_epoch(epoch)
        loader.set_epoch(epoch)
        want += [np.asarray(b["label"]) for b in loader]
    assert len(want) == len(seen)
    for (inv, got), w in zip(seen, want):
        assert w.shape == (1, 32, 32, C + 1)
        assert w.max() == (2 if inv else 1)
        np.testing.assert_array_equal(got.numpy(), w)


def test_cli_train_deepv3_recipe_on_cpu(tmp_path):
    """The DeepLabV3+ recipe through the CLI, tiny, on the synthetic set:
    two epochs, validated and checkpointed."""
    args = ["train", "--device", "cpu", "--config", RECIPE,
            "--logdir", str(tmp_path),
            "--set", "model.arch=deepv3.DeepV3PlusW38Tiny",
            "--set", "dataset.name=synthetic",
            "--set", "dataset.crop_size=[32,32]",
            "--set", "train.test_mode=true",
            "--set", "train.batch_size=1",
            "--set", "dataset.num_workers=2"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "tpuseg_torch.cli", *args],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 20
    assert "epoch 1: 10 steps on cpu" in (tmp_path / "log.txt").read_text()
