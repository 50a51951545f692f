"""``step.backward_ms.train``: device ms per step of the train step's backward,
over the stretch traced with the host (``core.spans``): in each step, the
device operations (host-to-device copies left out) that start after its
forward's GPU ranges end (the port's span ``train_step.forward`` and the
``meta_arch.*`` spans nested in it) and before its ``train_step.grad_norm``
range starts. Autograd launches the backward's kernels from a thread of its
own, outside any span; on the one compute stream they are what runs between
the two."""

from core.spans import between_ms

FORWARD = ("train_step.forward", "meta_arch.depth_net", "meta_arch.pose_net", "meta_arch.loss")


def read(run):
    return between_ms(run, FORWARD, "train_step.grad_norm")
