from .checkpoint import Checkpointer, PeriodicCheckpointer, load_weights
from .defaults import (
    assemble_cfg, default_argument_parser, default_setup, default_writers, maybe_init_distributed, simple_main,
)
from .export import build_inference_fn, export_inference, load_exported
from .runtime import do_test, do_train, restore_inference_state
from .train_loop import HookBase, SimpleTrainer, TrainerBase
from .trainer import DefaultPredictor, DefaultTrainer

__all__ = [
    "default_argument_parser",
    "default_setup",
    "default_writers",
    "assemble_cfg",
    "maybe_init_distributed",
    "simple_main",
    "Checkpointer",
    "PeriodicCheckpointer",
    "load_weights",
    "do_train",
    "do_test",
    "restore_inference_state",
    "HookBase",
    "TrainerBase",
    "SimpleTrainer",
    "DefaultTrainer",
    "DefaultPredictor",
    "build_inference_fn",
    "export_inference",
    "load_exported",
]
