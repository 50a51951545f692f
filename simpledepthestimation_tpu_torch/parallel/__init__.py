from .train_step import TrainState, compute_precise_bn_stats, create_train_state, make_eval_step, make_train_step

__all__ = ["TrainState", "compute_precise_bn_stats", "create_train_state", "make_eval_step", "make_train_step"]
