"""``nets.depth_fwd_ms.train``: device ms per step of the depth net's forward
(its convolutions, norms, pads and activations, the decoder's disparities),
inside the GPU ranges of the port's span ``meta_arch.depth_net``, over the
stretch traced with the host (``core.spans``)."""

from core.spans import device_ms


def read(run):
    return device_ms(run, ("meta_arch.depth_net",))
