"""``engine.h2d_ms.train``: ms of the side-stream copy of a batch, mean over
the window's steps, from the CUDA events that ``engine.runtime.device_prefetch``
records around each batch's copy and yields with it."""

import statistics


def read(run):
    return statistics.fmean(run.h2d_ms) if run.h2d_ms else None
