"""The attention-scale classes of the port's models/mscale.py vs tpuseg's,
f32 on the CPU, on the tiny WRN38 trunk from the same converted weights
(checks in tests/_torch_family.py): the eval forward (n-scale, and
fuse_aspp's recursive low -> high eval) and the train forward (two-scale,
fuse_aspp through two_scale_fuse's fwd_hi), every output < 1e-4, the
train-mode BN statistics by L1-relative; and one train step of the
fused-ASPP, 2-channel-attention MscaleV3Plus through the port's
train/step.py with the supervised mscale loss (loss, gradient tree, BN
statistics and the parameters after SGD)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpuseg.models.wider_resnet as jwrn
from _torch_family import (NC, TRUNK, check_eval, check_train, image,
                           no_dropout, run_case, tree_l1)
from _torch_port import LinenWithoutDropout, load_into, max_abs
from _torch_port import quick_jit, random_variables, set_threads
from tpuseg.config import make_config as jax_make_config
from tpuseg.losses.factory import get_loss as jax_get_loss
from tpuseg.models import mscale as jmscale
from tpuseg.train.optim import make_optimizer as jax_make_optimizer
from tpuseg.train.step import make_loss_fn as jax_make_loss_fn
from tpuseg_torch.config import make_config
from tpuseg_torch.convert import state_dict_from_flax
from tpuseg_torch.keymap import HEADS, seg_key_fn
from tpuseg_torch.losses import get_loss
from tpuseg_torch.models import mscale, mscale_core
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step

set_threads()
# case -> (tpuseg class, port class, arguments both take)
CASES = {
    # fuse_aspp's recursive eval over three scales and its two-scale
    # training (fwd_hi); attn_2b with the old arch's unpadded 2x2 final conv
    "MscaleV3Plus-fuse-2b-old": (
        jmscale.MscaleV3Plus, mscale.MscaleV3Plus,
        dict(fuse_aspp=True, attn_2b=True, attn_old_arch=True, bot_ch=16,
             n_scales=(0.5, 1.0, 2.0))),
    "MscaleDeeper": (jmscale.MscaleDeeper, mscale.MscaleDeeper,
                     dict(bot_ch=16, n_scales=(0.5, 1.0))),
    "MscaleBasic": (jmscale.MscaleBasic, mscale.MscaleBasic,
                    dict(bot_ch=16, n_scales=(0.5, 1.0))),
    "MscaleASPP": (jmscale.MscaleASPP, mscale.MscaleASPP,
                   dict(aspp_bot_ch=16, bot_ch=16, n_scales=(0.5, 1.0))),
}


@pytest.mark.parametrize("case", CASES)
def test_eval_forward_matches_tpuseg(case):
    check_eval(case, *CASES[case])


@pytest.mark.parametrize("case", CASES)
def test_train_forward_matches_tpuseg(case):
    check_train(case, *CASES[case])


def test_fuse_aspp_training_needs_the_high_scale_hook(monkeypatch):
    """Without two_scale_fuse's fwd_hi, fuse_aspp's high-scale pass would
    ignore the low scale's ASPP features and train on another output."""
    case = "MscaleV3Plus-fuse-2b-old"
    _, ptr, _, _, jtr, _, state, _, _ = run_case(case, *CASES[case])
    _, pcls, kw = CASES[case]
    fuse = mscale_core.two_scale_fuse
    monkeypatch.setattr(mscale, "two_scale_fuse",
                        lambda *a, fwd_hi=None, **k: fuse(*a, **k))
    port = pcls(NC, trunk=TRUNK, dtype=torch.float32, **kw)
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = no_dropout(port).train()(torch.from_numpy(image()))
    assert max_abs(ptr["pred"], jtr["pred"]) < 1e-4
    assert max_abs(out["pred"], jtr["pred"]) > 1e-3


# ------------------------------------------------------------ train step

SETS = {"model.arch": "mscale.DeepV3W38Tiny", "model.compute_dtype":
        "float32", "model.remat": False, "loss.loss_type": "ce",
        "loss.supervised_mscale_wt": 0.05, "optim.lr": 5e-4,
        "optim.weight_decay": 1e-3}
STEP_KW = dict(fuse_aspp=True, attn_2b=True, bot_ch=16)


def _batch():
    """Continuous f32 pixels (the f32 wire; integer pixels put the two f32
    backward passes ~5e-4 apart, tests/test_torch_deepv3.py), and two
    scenes of different brightness: ASPP's image-pool BN normalises two
    values a channel at batch 2, and two scenes of the same mean make that
    division ill-conditioned (the gradient tree of the port's f32 step then
    lies 8.8e-5 from its f64 step, tpuseg's 1.3e-4; with these scenes
    6.8e-6 and 4.4e-5)."""
    rng = np.random.RandomState(4)
    image = (128 + 40 * rng.randn(2, 64, 64, 3)).astype(np.float32)
    image[1] = 0.5 * image[1] + 20  # a darker, flatter second scene
    label = rng.randint(0, NC, (2, 4, 4)).astype(np.uint8).repeat(
        16, 1).repeat(16, 2)
    label[1, :, :12] = 255
    return image, label


@pytest.fixture(scope="module")
def stepped():
    return train_step_pair()


def train_step_pair(port_dtype=torch.float32):
    """One SGD step of tpuseg (dropout off) and of the port (Dropout2d at
    p = 0) from the same weights and batch: -> ((loss, BN stats, grads,
    params after the step) of the port, the same of tpuseg)."""
    image, label = _batch()
    cfg = {**SETS, "dataset.num_classes": NC}
    key_fn = seg_key_fn(TRUNK, HEADS["MscaleV3Plus"])
    jm = jmscale.MscaleV3Plus(num_classes=NC, trunk=TRUNK,
                              dtype=jnp.float32, **STEP_KW)
    v = random_variables(jm, np.random.RandomState(5),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    criterion, _ = jax_get_loss(jax_make_config(cfg))
    loss_fn = jax_make_loss_fn(jm, criterion, supervised_mscale_wt=0.05)
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrn, "nn", LinenWithoutDropout())
        (loss, mutated), grads = quick_jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"], v["batch_stats"], batch,
                                    jax.random.PRNGKey(0))
    tx, _ = jax_make_optimizer(jax_make_config(cfg), 1)
    updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    params = optax.apply_updates(v["params"], updates)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    want = (float(loss),
            state_dict_from_flax({}, to_np(mutated["batch_stats"]),
                                 key_fn=key_fn),
            state_dict_from_flax(to_np(grads), {}, key_fn=key_fn),
            state_dict_from_flax(to_np(params), {}, key_fn=key_fn))

    model = no_dropout(load_into(
        mscale.MscaleV3Plus(NC, trunk=TRUNK, dtype=torch.float32, **STEP_KW),
        v, key_fn=key_fn)).train()
    model.backbone.dtype = port_dtype
    model.to(port_dtype)
    pcfg = make_config(cfg)
    opt, schedule = make_optimizer(pcfg, model.parameters(), 1)
    step = make_train_step(get_loss(pcfg)[0], schedule,
                           supervised_mscale_wt=0.05)
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in model.named_parameters()]
    out = step(model, opt, {"image": torch.from_numpy(image),
                            "label": torch.from_numpy(label)}, 0)
    for h in hooks:
        h.remove()
    state = model.state_dict()
    got = (float(out["loss"]),
           {k: t for k, t in state.items()
            if k.endswith(("running_mean", "running_var"))},
           grads,
           {n: p.detach() for n, p in model.named_parameters()})
    return got, want


def test_train_step_loss_matches_tpuseg(stepped):
    (got, *_), (want, *_) = stepped
    assert abs(got - want) / abs(want) < 1e-5, (got, want)


def test_train_step_bn_stats_and_gradients_match_tpuseg(stepped):
    (_, stats, grads, _), (_, jstats, jgrads, _) = stepped
    assert tree_l1(stats, {k: jstats[k] for k in stats}) < 1e-5
    assert tree_l1(grads, jgrads) < 1e-4
    # the whole model trains, the attention head's two channels included
    assert all(float(g.abs().sum()) > 0 for g in grads.values())


def test_train_step_params_after_sgd_match_tpuseg(stepped):
    (*_, params), (*_, jparams) = stepped
    assert tree_l1(params, jparams) < 1e-5
