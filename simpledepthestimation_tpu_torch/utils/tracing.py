"""Named spans of the port's own code, for ``torch.profiler``.

``with span("meta_arch.loss"): ...`` is a ``torch.profiler.record_function``
range while a profiler is recording, and a shared ``nullcontext`` otherwise:
``record_function`` costs a dispatcher call even with no profiler running, and
a step untraced pays none. Recorded, a span shows as a CPU range and, around
the kernels launched in it from the entering thread, as a GPU-side annotation
(``is_user_annotation``), in every profile the port makes: the benchmark's
stretch traced with the host, the ``TorchProfiler`` hook's Chrome traces
(``TPU.PROFILE_ITERS``) and ``tools/trace_step_torch.py``. On the card each
kernel is annotated by the innermost span open at its launch only, so a span's
GPU range leaves out what spans nested in it launched at its ends. A span
changes no number.

The spans and what reads them (``benchmark/metrics/<metric>.py``):

| span | where | read by |
| --- | --- | --- |
| ``train_step.forward`` | the model's forward and the total loss | ``step.backward_ms.train`` (the backward's start) |
| ``train_step.backward`` | the backward and the gradients' sum over ranks | the host's idle gaps (autograd's own thread launches the backward's kernels) |
| ``train_step.grad_norm`` | the gradients' norm and clip | ``step.backward_ms.train`` (the backward's end) |
| ``meta_arch.depth_net`` | ``MonoDepth2Model``'s depth net | ``nets.depth_fwd_ms.train`` |
| ``meta_arch.pose_net`` | its pose input and pose net | ``nets.pose_fwd_ms.train`` |
| ``meta_arch.loss`` | its loss pass, the poses to the output dict | ``loss.fwd_ms.train``, ``loss.launches.train`` |
| ``norm.batch_norm``, ``norm.group_norm`` | ``BatchNorm2d``, ``GroupNorm`` | ``nets.norm_fwd_ms.train`` |

No name starts with ``cu``: the benchmark takes such host ranges for CUDA
runtime calls.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
