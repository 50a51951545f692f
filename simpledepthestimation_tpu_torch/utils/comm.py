"""Process bookkeeping for one process on one GPU.

Counterpart of ``simpledepthestimation_tpu/utils/comm.py`` as far as one
process goes: rank 0 of a world of 1, unless ``torch.distributed`` has been
initialised by the caller, in which case its rank, world size, barrier and
object gathers are used. Launching several processes (DDP over NCCL) is not
part of this package yet.
"""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


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
