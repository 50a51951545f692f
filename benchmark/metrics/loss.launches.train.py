"""``loss.launches.train``: device operations per step (kernels and fills;
host-to-device copies left out) that start inside the GPU ranges of the
port's span ``meta_arch.loss``, the loss pass's forward, over the stretch
traced with the host (``core.spans``): the work count of the launch-bound
part of the step."""

from core.spans import launches


def read(run):
    return launches(run, ("meta_arch.loss",))
