"""``nets.norm_fwd_ms.train``: device ms per step of the nets' norm layers in
the forward (``BatchNorm2d``: the float32 cast, the statistics and the
running statistics' update; ``GroupNorm``: the cast and the normalisation),
inside the GPU ranges of the port's spans ``norm.batch_norm`` and
``norm.group_norm``, over the stretch traced with the host (``core.spans``)."""

from core.spans import device_ms


def read(run):
    return device_ms(run, ("norm.batch_norm", "norm.group_norm"))
