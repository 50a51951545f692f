"""Training in several processes: the port's counterpart of
``simpledepthestimation_tpu/parallel/mesh.py``.

The JAX package runs ONE program over the global batch, on a mesh of devices
that spans its processes (one process per host); GSPMD inserts the
collectives. The port runs one process per card (or per CPU), joined by
``torch.distributed`` (NCCL between cards, gloo on the CPU). Each rank holds
its own rows of the global batch and a full copy of the state: parameters,
running statistics, optimizer moments and the noise generator, all equal on
every rank. The global batch is the rank-major concatenation of the per-rank
batches, as ``jax.make_array_from_process_local_data`` forms it. So
``build_mesh``, ``data_sharding``, ``replicated``, ``shard_batch``,
``place_replicated`` and ``host_local_tree`` have no counterpart: nothing is
placed or sharded, the loader of each rank yields its own rows
(:func:`local_batch_size`).

World N computes what world 1 computes on the global batch. The rule that
gives this:

- every batch-level reduction of the forward is a :func:`global_sum` of
  per-rank partial sums (the means, masked means and standard deviations
  below, BatchNorm's statistics in ``models.norm_layers``), so every rank
  computes the same global loss;
- :func:`global_sum` is an all-reduce whose backward is an all-reduce too (its
  adjoint), and each rank seeds the backward of its copy of the loss with
  ``1/world`` (:func:`backward`): the N ranks together differentiate the mean
  of N equal copies, which is the loss, and each rank's gradient is its own
  rows' share of world 1's gradient;
- the step sums the parameter gradients over ranks
  (:func:`sum_gradients`).

A backward that passes the gradient through unchanged would be right only
for reductions whose result feeds nothing per-rank: a global mean that flows
back into per-rank operations (``variance_loss``'s ``depth / mean``, the
photometric clip's cap, MotionLearning's ``depth_mean``) gets a gradient part
from every rank, and those parts have to be summed.

The global path is taken once ``torch.distributed`` is initialised, at world
1 too, and outside :func:`per_rank`. Without a process group every function
here is the plain single-process expression, to the bit. Every rank must
issue the same collectives in the same order: a branch on a rank's data may
change a value, never whether a collective runs.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import comm

_local = threading.local()

# gradient all-reduces are coalesced into flat buffers of at most this many bytes
BUCKET_BYTES = 32 << 20

# collectives issued by this module, by kind (read and reset by callers that count them)
collective_counts = {"forward": 0, "backward": 0, "gradients": 0}


def reset_collective_counts() -> None:
    for k in collective_counts:
        collective_counts[k] = 0


def local_batch_size(global_batch: int, world: Optional[int] = None) -> int:
    """Each rank's share of ``global_batch`` (``SOLVER.IMS_PER_BATCH``)."""
    world = comm.get_world_size() if world is None else int(world)
    if global_batch % world:
        raise ValueError(f"IMS_PER_BATCH={global_batch} must divide evenly among {world} processes")
    return global_batch // world


def is_multiprocess() -> bool:
    """More than one process (the counterpart of ``is_multiprocess_mesh``)."""
    return comm.get_world_size() > 1


def is_global() -> bool:
    """Whether batch-level reductions go over every rank: a process group is
    initialised (at any world size) and no :func:`per_rank` is in force."""
    return comm.is_initialized() and not getattr(_local, "per_rank", 0)


@contextlib.contextmanager
def per_rank() -> Iterator[None]:
    """Within this context (this thread) every reduction is the rank's own and
    no collective is issued: PreciseBN's recalibration forwards, which the
    JAX package runs on each process's batches alone."""
    depth = getattr(_local, "per_rank", 0)
    _local.per_rank = depth + 1
    try:
        yield
    finally:
        _local.per_rank = depth


@contextlib.contextmanager
def stacked(blocks: int) -> Iterator[None]:
    """The batch that the nets see within this context is ``blocks`` per-rank
    batches stacked (MotionLearning's depth net runs both frames of a pair as
    one ``[2B]`` batch): its global counterpart is the ``blocks`` global
    batches stacked, and :func:`rank_rows` picks the rank's rows of each."""
    before = getattr(_local, "blocks", 1)
    _local.blocks = int(blocks)
    try:
        yield
    finally:
        _local.blocks = before


def current_blocks() -> int:
    return getattr(_local, "blocks", 1)


def global_rows(local_rows: int) -> int:
    """Rows of the global counterpart of a per-rank tensor of ``local_rows``
    (the same on the single-process path)."""
    return local_rows * comm.get_world_size() if is_global() else local_rows


def rank_rows(x: torch.Tensor, blocks: Optional[int] = None) -> torch.Tensor:
    """This rank's rows of a global tensor ``x`` whose leading dim is
    ``blocks`` stacked global batches, each the rank-major concatenation of
    the per-rank batches; ``x`` itself on the single-process path."""
    if not is_global():
        return x
    world, rank = comm.get_world_size(), comm.get_rank()
    blocks = current_blocks() if blocks is None else blocks
    per = x.shape[0] // (blocks * world)
    return x.reshape(blocks, world, per, *x.shape[1:])[:, rank].reshape(blocks * per, *x.shape[1:])


def all_reduce_sum(t: torch.Tensor, kind: str = "forward") -> torch.Tensor:
    """Sum ``t`` over ranks in place and return it, counted under ``kind``
    (a key of :data:`collective_counts`). Not differentiable."""
    torch.distributed.all_reduce(t)
    collective_counts[kind] += 1
    return t


class _GlobalSum(torch.autograd.Function):
    """Sum over ranks; backward: the sum over ranks of the incoming gradient."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x.detach().clone().contiguous(), "forward")

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.detach().clone().contiguous(), "backward")


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of the per-rank partial sums ``x`` (any shape, equal
    on every rank), differentiable under the module's rule; ``x`` itself on the
    single-process path."""
    return _GlobalSum.apply(x) if is_global() else x


def global_means(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of each tensor over the global batch, in one collective. Each
    tensor's shape must be the same on every rank (equal per-rank batches).
    Single-process: ``[x.mean() for x in xs]``."""
    if not is_global():
        return [x.mean() for x in xs]
    world = comm.get_world_size()
    sums = global_sum(torch.stack([x.sum() for x in xs]))
    return [sums[i] / (x.numel() * world) for i, x in enumerate(xs)]


def global_mean(x: torch.Tensor) -> torch.Tensor:
    return global_means([x])[0]


def global_masked_means(xs: Sequence[torch.Tensor], mask: torch.Tensor) -> List[torch.Tensor]:
    """Mean of each tensor over the positions of the global batch where
    ``mask`` holds (0 where it holds nowhere), in one collective."""
    mask = mask.to(xs[0].dtype)
    parts = [(x * mask).sum() for x in xs] + [mask.sum()]
    if is_global():
        parts = list(global_sum(torch.stack(parts)).unbind())
    count = parts[-1].clamp_min(1.0)
    return [total / count for total in parts[:-1]]


def global_mean_std(x: torch.Tensor, dim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and unbiased standard deviation over the global batch: of all of
    ``x`` (``dim=None``), or of each row of ``x`` [G, n] (``dim=1``: each rank
    holds n of each of the G groups' values); the deviations are taken from
    the global mean (two collectives). Single-process: ``x.mean(dim)`` and
    ``x.std(dim)``."""
    if not is_global():
        return (x.mean(), x.std()) if dim is None else (x.mean(dim=dim), x.std(dim=dim))
    assert dim in (None, 1)
    rows = x.reshape(1, -1) if dim is None else x
    n = rows.shape[1] * comm.get_world_size()
    mean = global_sum(rows.sum(dim=1)) / n
    m2 = global_sum(((rows - mean[:, None]) ** 2).sum(dim=1))
    std = torch.sqrt(m2 / (n - 1))
    return (mean[0], std[0]) if dim is None else (mean, std)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked in rank order, ``[world, ...]``,
    through one all-reduce of a zero buffer with each rank's slot filled (an
    exact gather: every other term of each sum is zero). Not differentiable."""
    world, rank = comm.get_world_size(), comm.get_rank()
    buf = x.new_zeros((world, *x.shape))
    buf[rank] = x
    return all_reduce_sum(buf, "forward")


def backward(total: torch.Tensor) -> None:
    """``total.backward()``, seeded with ``1/world`` on the global path."""
    if not is_global():
        total.backward()
        return
    total.backward(torch.full_like(total, 1.0 / comm.get_world_size()))


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def sum_gradients(grads: Sequence[torch.Tensor]) -> None:
    """Sum ``grads`` over ranks in place, a flat buffer of at most
    :data:`BUCKET_BYTES` per all-reduce. Every rank passes the gradients of the
    same parameters in the same order."""
    if not is_global():
        return
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        all_reduce_sum(flat, "gradients")
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def state_digest(module: torch.nn.Module) -> str:
    """SHA-256 of every tensor of ``module.state_dict()``, names and bytes."""
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode() + b"\0")
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def check_replicas_agree(module: torch.nn.Module, what: str = "the model") -> None:
    """Raise unless ``module``'s parameters and buffers are equal to the bit on
    every rank: one digest per rank, all gathered. Nothing on one process."""
    if not is_multiprocess():
        return
    digests = comm.all_gather(state_digest(module))
    if len(set(digests)) != 1:
        raise RuntimeError(f"{what} differs across ranks (state digests by rank: {digests})")
