"""tpuseg's spatially sharded train step, for tests/test_torch_spatial_train.py,
in a process of its own (tracing and compiling it takes most of that
file's time, so each loss's step runs beside the port's ranks).

``python _torch_spatial_jax.py <dir> <loss>`` reads ``<dir>/jax_inputs.pkl``
(the variables, batch and config overrides the parent drew), runs one step
of ``tpuseg.train.step.make_train_step`` on two virtual CPU devices as
``make_mesh(devices[:2], model_parallelism=2)`` with the batch placed by
``shard_batch_spatial`` (tests/test_spatial_sharding.py:113-163), and
writes the loss and the parameters and BN statistics after the step, in
the port's names (the key map of the step's ``model.arch``), to
``<dir>/jax_<loss>.pt``. The WRN38 trunk's dropout is off (its masks come
from one key over the global batch, which no band of the port's can
draw; the port's side sets its ``Dropout2d`` to p = 0).
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import tpuseg.models.wider_resnet as jwrn  # noqa: E402
from _torch_port import LinenWithoutDropout, quick_jit  # noqa: E402
from tpuseg.config import make_config  # noqa: E402
from tpuseg.losses.factory import get_loss  # noqa: E402
from tpuseg.models import get_model  # noqa: E402
from tpuseg.parallel import (  # noqa: E402
    make_mesh,
    replicate,
    shard_batch_spatial,
)
from tpuseg.train.optim import make_optimizer  # noqa: E402
from tpuseg.train.state import TrainState  # noqa: E402
from tpuseg.train.step import make_train_step  # noqa: E402
from tpuseg_torch.convert import state_dict_from_flax  # noqa: E402


def main():
    out_dir, name = sys.argv[1], sys.argv[2]
    with open(os.path.join(out_dir, "jax_inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = make_config(inp["step_sets"][name])
    jwrn.nn = LinenWithoutDropout()
    model = get_model(cfg)
    criterion, _ = get_loss(cfg)
    tx, _ = make_optimizer(cfg, 1)
    params = jax.tree.map(jnp.asarray, inp["variables"]["params"])
    stats = jax.tree.map(jnp.asarray, inp["variables"]["batch_stats"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx)
    lc = cfg.loss
    step = quick_jit(make_train_step(
        model, criterion, ocr_alpha=lc.ocr_alpha,
        supervised_mscale_wt=lc.supervised_mscale_wt))
    mesh = make_mesh(jax.devices()[:2], model_parallelism=2)
    assert dict(mesh.shape) == {"data": 1, "model": 2}
    batch = shard_batch_spatial(mesh, {"image": inp["image"],
                                       "label": inp["label"]})
    new, metrics = step(replicate(mesh, state), batch,
                        jax.random.PRNGKey(1))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    torch.save({"loss": float(metrics["loss"]),
                "state": state_dict_from_flax(to_np(new.params),
                                              to_np(new.batch_stats),
                                              arch=cfg.model.arch)},
               os.path.join(out_dir, f"jax_{name}.pt"))


if __name__ == "__main__":
    main()
