"""tpuseg_torch — the PyTorch/CUDA port of ``tpuseg`` for one NVIDIA H100.

The JAX package ``tpuseg`` is the reference this package is held against
(tests/test_torch_*.py load the same weights into both and compare). The
module tree mirrors ``tpuseg``'s: ``tpuseg/models/hrnet.py`` ↔
``tpuseg_torch/models/hrnet.py``. The host code the eval path runs is a
copy kept in this package under the same module names (``config``,
``data``, ``native``, ``utils.logging``, ``cli.main.load_config``, the YAML
recipes in ``cli/recipes/``).

This package imports ``torch`` and never ``tpuseg``, ``jax``, ``flax``,
``optax`` or ``orbax``.

Layout: NHWC at the public edges (model input/outputs, the kernels' public
functions, the eval forward), as in ``tpuseg``. Inside the model, convs run
on NCHW-logical tensors in ``torch.channels_last`` memory format, so
``x.permute(0, 2, 3, 1)`` is a free contiguous NHWC view.

The two Pallas kernels of ``tpuseg`` are hand-written CUDA C++ here
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/_build.py``).
"""

__version__ = "0.1.0"
