"""The data-parallel process group (port of ``tpuseg/parallel/mesh.py``).

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

``tpuseg``'s ``make_mesh``, ``batch_sharding``, ``shard_batch`` and
``replicate`` have no counterpart under DDP: the module is replicated by
DDP and every rank places its own shard on its own device.
``spatial_sharding`` and ``shard_batch_spatial`` (dp x sp) are not ported
(ROADMAP Queue 1 item 5); ``Trainer`` refuses ``mesh.model_parallelism >
1``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


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
