"""The (dp, sp) process grid (port of ``tpuseg/parallel/mesh.py``).

``tpuseg`` runs one process a host over a named-axis device mesh: GSPMD
inserts the gradient all-reduce, the global batch-norm statistics and the
loss reductions. Here each rank is one process on one device under
``torch.nn.parallel.DistributedDataParallel`` (the reference's own
engine, train.py:290-300):

- the process group comes from torchrun's ``env://`` variables
  (:func:`init_distributed`);
- each rank loads its shard of the global batch (``setup_data``'s
  ``num_shards`` / ``shard``) and DDP averages the gradients;
- batch norm reduces its statistics across ranks itself
  (``models/layers.py::BatchNorm2d``), and the losses divide by the global
  batch's denominators (:func:`global_sum`);
- host-side metrics are summed by :func:`multihost_sum`.

``tpuseg``'s ``batch_sharding``, ``shard_batch`` and ``replicate`` have no
counterpart under DDP: the module is replicated by DDP and every rank
places its own shard on its own device.

dp x sp (``mesh.model_parallelism = sp > 1``): :func:`make_mesh` arranges
the ``world = dp * sp`` ranks as ``tpuseg``'s mesh reshapes its devices,
``(world // sp, sp)``, so an sp group is ``sp`` consecutive ranks with a
process group of its own. The ranks of an sp group load the same images,
and :func:`shard_batch_spatial` keeps this rank's band of rows (the
counterpart of ``tpuseg``'s ``spatial_sharding`` layout, padded where the
rows do not split evenly, as GSPMD pads); the ops then run on bands under
``spatial.sharded(mesh.bands)`` (``parallel/spatial.py``).
DDP and batch norm still reduce over the world group: every pixel of the
global batch once.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpuseg_torch.parallel import spatial
from tpuseg_torch.parallel.spatial import Bands


def init_distributed(device: str = "cuda", backend: str | None = None
                     ) -> torch.device:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), unless this
    process has joined one already, and return the rank's device: on CUDA
    ``cuda:LOCAL_RANK`` modulo the visible device count, made current.
    The backend is ``nccl`` on CUDA and ``gloo`` on the CPU unless
    ``backend`` names one (gloo also runs ``all_reduce`` and ``broadcast``
    on CUDA tensors, so two ranks can share one card, which NCCL
    refuses). A failed ``init_process_group`` raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False; pass --device cpu to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        # NCCL binds its communicator to the rank's card up front
        dist.init_process_group(
            backend, init_method="env://",
            device_id=dev if backend == "nccl" else None)
    return dev


def process_index() -> int:
    """This process's rank; 0 when no process group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks; 1 when no process group is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where the backend reduces: NCCL on the current card, gloo on the
    CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def multihost_sum(x: np.ndarray) -> np.ndarray:
    """Sum a host array across ranks, in f64, by one ``all_reduce`` (the
    reference's IoU-hist / loss all-reduce, utils/misc.py:110-114,
    train.py:495-497). The array itself in one process."""
    if process_count() == 1:
        return x
    # a copy: the reduction runs in place
    t = torch.tensor(np.asarray(x, np.float64), device=_collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed across ranks, on ``t``'s device, outside autograd (the
    losses' global-batch denominators and histograms); ``t`` itself in one
    process."""
    if process_count() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank: a decision every rank takes
    together (one rank leaving alone would leave the others waiting in
    their next collective)."""
    if process_count() == 1:
        return flag
    return bool(multihost_sum(np.asarray([float(flag)]))[0] > 0)


def per_rank(value: float) -> list:
    """``value`` of every rank, in rank order (for the primary's log)."""
    if process_count() == 1:
        return [value]
    one = np.zeros(process_count())
    one[process_index()] = value
    return multihost_sum(one).tolist()


def sync_hosts() -> None:
    """Barrier across ranks (the reference's centroid-build barrier,
    datasets/uniform.py:265)."""
    if process_count() > 1:
        dist.barrier()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dp, sp) grid: data-parallel group
    ``dp_index`` of ``dp``, and its band layout (None when sp is 1)."""

    dp: int
    dp_index: int
    bands: Optional[Bands] = None

    @property
    def sp(self) -> int:
        return self.bands.size if self.bands is not None else 1

    @property
    def sp_index(self) -> int:
        return self.bands.index if self.bands is not None else 0


def make_mesh(model_parallelism: int = 1) -> Mesh:
    """The (dp, sp) grid over every rank, ``sp = model_parallelism``
    consecutive ranks an sp group (``tpuseg``'s ``make_mesh``). With sp >
    1 every rank creates every sp group's process group, in the same order
    (``dist.new_group`` is collective). Raises unless the ranks split into
    whole sp groups."""
    sp, world = int(model_parallelism), process_count()
    if sp < 1 or world % sp:
        raise ValueError(
            f"mesh.model_parallelism={sp} must divide the number of ranks "
            f"({world}): each sp group is model_parallelism ranks")
    rank = process_index()
    if sp == 1:
        return Mesh(dp=world, dp_index=rank)
    bands = None
    for d in range(world // sp):
        ranks = list(range(d * sp, (d + 1) * sp))
        group = dist.new_group(ranks)
        if rank in ranks:
            bands = Bands(group=group, index=rank - d * sp, size=sp)
    return Mesh(dp=world // sp, dp_index=rank // sp, bands=bands)


def shard_batch_spatial(mesh: Mesh, batch: dict,
                        ignore_label: int = 255) -> dict:
    """This rank's band of a host batch (``tpuseg``'s
    ``shard_batch_spatial``): of the NHWC image and the NHW label (or NHWC
    multi-hot relaxed targets), rows ``[i * h, (i + 1) * h)`` with ``h =
    ceil(H / sp)``, the rows past the crop's H padded as GSPMD pads an
    uneven shard: zeros in the image, ``ignore_label`` in the label, and
    no class (and no ignore flag: the pixel is not in the image's
    histogram) in relaxed targets. Runs inside
    ``spatial.sharded(mesh.bands)``, whose table of map heights takes the
    crop's H. The batch itself when sp is 1."""
    if mesh.bands is None:
        return batch
    if spatial.active() is not mesh.bands:
        raise RuntimeError("shard_batch_spatial runs inside "
                           "spatial.sharded(mesh.bands): the crop's height "
                           "enters that context's table of map heights")
    out = dict(batch)
    out["image"] = spatial.band(batch["image"])
    label = batch["label"]
    out["label"] = spatial.band(label, fill=0 if label.ndim == 4
                                else ignore_label)
    return out
