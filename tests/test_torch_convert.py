"""The JAX -> port weight map covers every parameter and buffer of the
port's models, in both directions (tpuseg_torch/convert.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import set_threads
from tpuseg.config import make_config
from tpuseg_torch.config import make_config as port_config
from tpuseg.models import get_model as get_flax_model
from tpuseg_torch.convert import state_dict_from_flax
from tpuseg_torch.models import get_model

set_threads()


def _flax_shapes(cfg):
    """tpuseg's variable tree as zero arrays of the right shapes
    (jax.eval_shape traces the init; nothing is computed)."""
    model = get_flax_model(cfg)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    return jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)


@pytest.mark.parametrize("arch", ["ocrnet.HRNet_Mscale_Tiny",
                                  "ocrnet.HRNet_Mscale"])
def test_converter_covers_every_key(arch):
    cfg = make_config({"model.arch": arch})
    variables = _flax_shapes(cfg)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    port_cfg = port_config({"model.arch": arch})
    if arch.endswith("Tiny"):
        port = get_model(port_cfg).state_dict()
    else:
        with torch.device("meta"):
            port = get_model(port_cfg).state_dict()
    assert set(sd) == set(port), (sorted(set(sd) - set(port))[:10],
                                  sorted(set(port) - set(sd))[:10])
    for k, v in port.items():
        assert tuple(sd[k].shape) == tuple(v.shape), (k, sd[k].shape, v.shape)
    n_bn = sum(k.endswith("num_batches_tracked") for k in port)
    assert n_bn > 0
    if arch.endswith("Tiny"):
        return
    # names are the reference's torch state-dict names
    for key in ("backbone.layer1.1.conv2.weight",
                "ocr.ocr_distri_head.object_context_block.f_pixel.1.0"
                ".running_var", "scale_attn.bn0.weight",
                "backbone.transition1.1.0.0.weight",
                "backbone.stage2.0.fuse_layers.0.1.1.running_mean",
                "backbone.stage3.0.fuse_layers.2.0.1.0.weight",
                "ocr.aux_head.2.bias", "ocr.cls_head.bias"):
        assert key in port, key


def test_converter_loads_strict_and_transposes():
    """A loaded model carries the tpuseg values: conv kernels HWIO -> OIHW,
    BN scale/bias/mean/var in place."""
    cfg = make_config({"model.arch": "ocrnet.HRNet_Mscale_Tiny"})
    rng = np.random.RandomState(0)
    variables = _flax_shapes(cfg)
    variables = jax.tree.map(
        lambda a: rng.randn(*a.shape).astype(np.float32), variables)
    model = get_model(port_config({"model.arch": "ocrnet.HRNet_Mscale_Tiny"}))
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]),
                          strict=True)
    k = variables["params"]["backbone"]["stage2_m0"]["fuse0_1_conv"]["kernel"]
    np.testing.assert_array_equal(
        model.backbone.stage2[0].fuse_layers[0][1][0].weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))
    bn = model.ocr.ocr_distri_head.object_context_block.f_up[1][0]
    st = variables["batch_stats"]["ocr"]["ocr_distri"]["object_context"][
        "f_up"]["norm"]["bn"]
    np.testing.assert_array_equal(bn.running_var.numpy(), st["var"])
    np.testing.assert_array_equal(bn.running_mean.numpy(), st["mean"])
