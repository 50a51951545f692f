"""``loss.fwd_ms.train``: device ms per step of ``MonoDepth2Model``'s loss
pass in the forward (the poses' concatenation, view synthesis with K1, the
photometric maps with K2, the automask's minimum, smoothness and the
reductions), inside the GPU ranges of the port's span ``meta_arch.loss``, over
the stretch traced with the host (``core.spans``)."""

from core.spans import device_ms


def read(run):
    return device_ms(run, ("meta_arch.loss",))
