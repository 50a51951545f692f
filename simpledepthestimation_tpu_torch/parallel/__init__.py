"""Train and eval steps (``train_step``) and training in several processes
(``mesh``). The names of ``train_step`` are loaded at their first use: the
models import ``mesh``, and ``train_step`` imports the models."""

from . import mesh  # noqa: F401

_TRAIN_STEP = ("TrainState", "compute_precise_bn_stats", "create_train_state", "make_eval_step", "make_train_step")


def __getattr__(name):
    if name in _TRAIN_STEP:
        from . import train_step

        return getattr(train_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_TRAIN_STEP) + ["mesh"]
