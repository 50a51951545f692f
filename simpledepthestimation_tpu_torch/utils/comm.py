"""Process bookkeeping and the host-side collectives.

Counterpart of ``simpledepthestimation_tpu/utils/comm.py``. The JAX package
runs one process per host; the port runs one process per card (or per CPU),
joined by ``torch.distributed`` (:func:`init_process_group`: NCCL between
cards, gloo on the CPU). Every function degrades to the single-process answer
where no process group is initialised. The collectives of the train step
itself (global losses, BatchNorm statistics, gradient sums) are in
``parallel/mesh.py``.

Every collective carries the process group's timeout (:data:`TIMEOUT`, or
the one given to :func:`init_process_group`): a rank that is lost makes the
others fail after it, not hang.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


def init_process_group(init_method: str, world_size: int, rank: int, backend: str,
                       timeout: Optional[datetime.timedelta] = None) -> None:
    """``torch.distributed.init_process_group`` with a timeout on every
    collective. A CUDA caller sets its device first (NCCL's object gathers
    run on the current device)."""
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timeout or TIMEOUT)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank_of(process_id: int) -> int:
    """The card of process ``process_id`` on its host: the processes of one
    host take consecutive ids, one card each, so the id modulo the host's card
    count; 0 without a card (CPU processes share the host)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return process_id % cards if cards else 0


def get_local_rank() -> int:
    """This process's card on its host (:func:`local_rank_of`). The JAX
    package runs one process per host and always returns 0."""
    return local_rank_of(get_rank())


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier across all processes (nothing to wait for in a world of 1)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """Every process's picklable ``data``, in rank order."""
    if get_world_size() == 1:
        return [data]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every process's ``data`` on rank ``dst``; ``[]`` elsewhere."""
    if get_world_size() == 1:
        return [data]
    out = [None] * get_world_size() if get_rank() == dst else None
    dist.gather_object(data, out, dst=dst)
    return out if get_rank() == dst else []


def shared_random_seed() -> int:
    """A random seed agreed upon by all processes: rank 0's draw."""
    seed = int(np.random.randint(2**31))
    return int(all_gather(seed)[0])


def reduce_dict(input_dict: Dict[str, Any], average: bool = True) -> Dict[str, float]:
    """Mean (or sum) over processes of a dict of scalars, on every process."""
    if get_world_size() == 1:
        return dict(input_dict)
    keys = sorted(input_dict.keys())
    values = np.array([float(input_dict[k]) for k in keys], dtype=np.float64)
    rows = np.stack(all_gather(values))
    reduced = rows.mean(0) if average else rows.sum(0)
    return {k: float(v) for k, v in zip(keys, reduced)}
