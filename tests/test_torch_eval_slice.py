"""The eval slice end to end: the port's EvalRunner vs tpuseg's on seeded
uint8 images and labels through a tiny 3-scale MscaleOCR with the same
weights, and the port's CLI in a subprocess."""
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, max_abs, random_variables, set_threads
from tpuseg.evaluation.inference import EvalRunner as JaxRunner
from tpuseg.losses.ce import cross_entropy as jax_ce
from tpuseg.models.hrnet import HRNetSpec as JaxSpec
from tpuseg.models.ocrnet import MscaleOCR as JaxMscale
from tpuseg_torch.cli.main import main as cli_main
from tpuseg_torch.evaluation.inference import EvalRunner
from tpuseg_torch.losses import cross_entropy
from tpuseg_torch.models.hrnet import HRNetSpec
from tpuseg_torch.models.ocrnet import MscaleOCR

set_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "tpuseg_torch", "cli", "recipes",
                      "eval_cityscapes.yaml")
SPEC = dict(stage1_blocks=2, stage1_channels=8,
            stage2_modules=1, stage2_channels=(8, 16), stage2_blocks=1,
            stage3_modules=1, stage3_channels=(8, 16, 32), stage3_blocks=1,
            stage4_modules=1, stage4_channels=(8, 16, 32, 64),
            stage4_blocks=1)
MODEL = dict(num_classes=19, mid_channels=32, key_channels=16,
             n_scales=(0.5, 1.0, 2.0), attn_bot_ch=16, use_pallas=True,
             fused_stage1=False)
GAP = 1e-4  # predictions may differ where JAX's top-2 logit gap is below


@pytest.fixture(scope="module")
def models():
    jm = JaxMscale(spec=JaxSpec(**SPEC), dtype=jnp.float32, **MODEL)
    x = jnp.zeros((1, 64, 128, 3), jnp.float32)
    v = random_variables(jm, np.random.RandomState(0), x)
    port = load_into(MscaleOCR(spec=HRNetSpec(**SPEC), dtype=torch.float32,
                               **MODEL), v)
    return jm, v, port


@pytest.mark.parametrize("hw,pad", [((64, 128), None), ((50, 100), 32)])
def test_eval_runner_matches_tpuseg(models, hw, pad):
    jm, v, port = models
    rng = np.random.RandomState(1)
    batch = {"image": rng.randint(0, 256, (1, *hw, 3)).astype(np.uint8),
             "label": rng.randint(0, 19, (1, *hw)).astype(np.uint8)}
    batch["label"][:, :4] = 255
    jr = JaxRunner(jm, 19, criterion=functools.partial(jax_ce,
                                                       ignore_label=255),
                   pad_multiple=pad, donate_acc=False)
    pr = EvalRunner(port, 19, criterion=functools.partial(cross_entropy,
                                                          ignore_label=255),
                    pad_multiple=pad, device="cpu")
    jout, jhist, jloss = jr.run_batch(v, batch)
    pout, phist, ploss = pr.run_batch(batch)

    # logits of the (padded) forward
    image, label, valid = (pr._pad(batch["image"], batch["label"]) if pad
                           else (batch["image"], batch["label"], None))
    jlog = np.asarray(jr.forward(
        v, jnp.asarray(image), jnp.asarray(label), jr.init_acc(),
        *([jnp.asarray(valid, jnp.int32)] if valid else []))[0])
    with torch.inference_mode():
        plog = pr.forward(torch.from_numpy(image), torch.from_numpy(label),
                          pr.init_acc(), valid)[0]
    assert max_abs(plog, jlog) < 1e-4

    # predictions equal except at near-ties of JAX's logits
    h, w = hw
    top2 = np.sort(jlog[:, :h, :w], axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) < GAP
    diff = pout["predictions"] != jout["predictions"]
    assert not (diff & ~near_tie).any()
    # confusion matrices differ by those pixels only
    assert np.abs(phist - jhist).sum() <= 2 * int(diff.sum())
    assert phist.sum() == jhist.sum() == (batch["label"] != 255).sum()
    assert abs(ploss - jloss) < 1e-5
    np.testing.assert_allclose(pout["prob_mask"], jout["prob_mask"],
                               atol=1e-5)


def test_cli_eval_subprocess_imports_no_jax(tmp_path):
    code = (
        "import atexit, runpy, sys\n"
        "atexit.register(lambda: print('JAX_MODULES', sorted({m.split('.')[0]"
        " for m in sys.modules} & {'jax', 'flax', 'optax', 'orbax'})))\n"
        "atexit.register(lambda: print('TPUSEG_MODULES', sorted("
        "m for m in sys.modules if m.split('.')[0] == 'tpuseg')))\n"
        "sys.argv = ['tpuseg_torch.cli'] + sys.argv[1:]\n"
        "runpy.run_module('tpuseg_torch.cli', run_name='__main__')\n")
    args = ["eval", "--device", "cpu", "--config", RECIPE,
            "--logdir", str(tmp_path),
            "--set", "model.arch=ocrnet.HRNet_Mscale_Tiny",
            "--set", "dataset.name=synthetic",
            "--set", "dataset.crop_size=[64,128]",
            "--set", "train.test_mode=true",
            "--set", "model.use_pallas=true"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "mean mIoU:" in res.stdout
    # the recipe as shipped dumps its assets (eval.dump_assets: true)
    dumped = os.listdir(tmp_path / "eval_images")
    assert "index.html" in dumped
    assert any(f.endswith("_attn_1.0x.png") for f in dumped)
    assert "JAX_MODULES []" in res.stdout, res.stdout[-500:]
    assert "TPUSEG_MODULES []" in res.stdout, res.stdout[-500:]


def test_cuda_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["eval", "--config", RECIPE, "--logdir", str(tmp_path),
                  "--set", "model.arch=ocrnet.HRNet_Mscale_Tiny",
                  "--set", "dataset.name=synthetic"])
