"""``nets.pose_fwd_ms.train``: device ms per step of the pose net's forward
(the concatenation of its input, its convolutions and norms, the poses),
inside the GPU ranges of the port's span ``meta_arch.pose_net``, over the
stretch traced with the host (``core.spans``)."""

from core.spans import device_ms


def read(run):
    return device_ms(run, ("meta_arch.pose_net",))
