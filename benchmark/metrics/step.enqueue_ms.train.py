"""``step.enqueue_ms.train``: host ms for ``step(batch)`` of
``parallel.make_train_step`` to return, mean over the window's steps (host
clock; the step waits for nothing, so this is the host's work to enqueue it,
and any wait for room in the launch queue)."""

import statistics


def read(run):
    return statistics.fmean(run.enqueue_ms) if run.enqueue_ms else None
