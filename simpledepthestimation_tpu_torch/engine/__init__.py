from .checkpoint import Checkpointer, PeriodicCheckpointer, load_weights
from .defaults import assemble_cfg, default_argument_parser, default_setup, default_writers, simple_main
from .runtime import do_test, do_train, restore_inference_state

__all__ = [
    "default_argument_parser",
    "default_setup",
    "default_writers",
    "assemble_cfg",
    "simple_main",
    "Checkpointer",
    "PeriodicCheckpointer",
    "load_weights",
    "do_train",
    "do_test",
    "restore_inference_state",
]
