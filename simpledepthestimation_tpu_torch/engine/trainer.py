"""``DefaultTrainer``: the config-driven, hook-based training assembly, and
``DefaultPredictor``, single-image inference.

The port's counterpart of ``simpledepthestimation_tpu/engine/trainer.py``:
the model, optimizer and loaders from the config, the default hooks in the
JAX package's order (timer, rate log, PreciseBN, checkpointer, evaluation,
profiler, writers), ``auto_scale_workers`` (the linear scaling rule) and the
loop of ``SimpleTrainer``. ``engine.runtime.do_train`` is the other, plain
path; this one is what ``tools/train_net_torch.py`` drives.

As in the JAX package, and unlike ``do_train``: no ImageNet warm start of the
encoder (``create_train_state(..., warm_start=False)``), and no per-step
schedule in the batch, so a MotionLearning config trains with the model's
defaults, noise 0 and motion weight 1 from the first step. The train step,
its noise generator and the batches are ``do_train``'s, so the two paths give
the same trajectory. Everything runs on the CUDA device unless the caller
names another (``device="cpu"``); without one it raises. In several processes
``auto_scale_workers`` takes the world size, the writers are rank 0's, each
rank runs every other hook (PreciseBN averages over ranks, the checkpoint is
rank 0's file behind a barrier, the evaluation gathers to rank 0).
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ..config import CfgNode
from ..data import build_train_loader
from ..data.preprocess import build_preprocess
from ..models.build import resolve_device
from ..parallel import mesh
from ..parallel.train_step import create_train_state, make_eval_step, make_train_step
from ..utils import comm
from . import hooks as hooks_lib
from .checkpoint import Checkpointer, PeriodicCheckpointer
from .defaults import default_writers
from .runtime import Device, check_supported, device_prefetch, do_test, restore_inference_state
from .train_loop import SimpleTrainer

logger = logging.getLogger(__name__)


class DefaultTrainer(SimpleTrainer):
    def __init__(self, cfg: CfgNode, device: Device = None):
        cfg = DefaultTrainer.auto_scale_workers(cfg, comm.get_world_size())
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

        seed = cfg.SEED if cfg.SEED >= 0 else 0
        self.loader = build_train_loader(cfg, seed=seed, pin_memory=self.device.type == "cuda")
        self.steps_per_epoch = len(self.loader)
        self._max_iter = self.steps_per_epoch * int(cfg.SOLVER.MAX_EPOCHS)

        state = create_train_state(cfg, device=self.device, steps_per_epoch=self.steps_per_epoch, warm_start=False)
        mesh.check_replicas_agree(state.model, "the initial model")
        self.model = state.model
        self.lr_schedule = state.scheduler.schedules[0]
        step_fn = make_train_step(state, grad_clip=float(cfg.SOLVER.get("GRAD_CLIP", 0.0)),
                                  remat=bool(cfg.TPU.get("REMAT", False)))

        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR)
        state, self.start_epoch = self.checkpointer.resume_or_load(str(cfg.MODEL.WEIGHTS), state, resume=False)

        def epoch_iter():
            # started at the first step, so it reads start_epoch after resume_or_load; the
            # copies to the card run ahead within an epoch only, so that PreciseBN, at an
            # epoch's end, finds the loader still on that epoch
            epoch = self.start_epoch
            while True:
                self.loader.set_epoch(epoch)
                for batch, _ in device_prefetch(iter(self.loader), self.device):
                    yield batch
                epoch += 1

        self._eval_step = None  # built at the first evaluation, reused by the later ones
        super().__init__(lambda batch, it: step_fn(batch), epoch_iter(), state)
        self.register_hooks(self.build_hooks())

    def resume_or_load(self, resume: bool = True) -> None:
        self.state, self.start_epoch = self.checkpointer.resume_or_load(
            str(self.cfg.MODEL.WEIGHTS), self.state, resume=resume)
        mesh.check_replicas_agree(self.state.model, "the restored model")

    def build_hooks(self):
        cfg = self.cfg
        ret = [hooks_lib.IterationTimer(), hooks_lib.LRSchedulerHook(self.lr_schedule)]
        # PreciseBN before the checkpointer, so that an epoch's checkpoint carries the
        # statistics its evaluation uses
        precise_bn = cfg.TEST.get("PRECISE_BN", {})
        if bool(precise_bn.get("ENABLED", False)) and int(cfg.TEST.EVAL_PERIOD) > 0:
            ret.append(hooks_lib.PreciseBN(int(cfg.TEST.EVAL_PERIOD), self.steps_per_epoch, self.loader,
                                           int(precise_bn.get("NUM_ITER", 200)), self.device))
        # on every rank: rank 0 writes, and every rank waits for the file (Checkpointer.save)
        pc = PeriodicCheckpointer(self.checkpointer, int(cfg.SOLVER.CHECKPOINT_PERIOD), int(cfg.SOLVER.MAX_EPOCHS))
        ret.append(hooks_lib.PeriodicCheckpointerHook(pc, self.steps_per_epoch))
        if int(cfg.TEST.EVAL_PERIOD) > 0:
            ret.append(hooks_lib.EvalHook(int(cfg.TEST.EVAL_PERIOD), self.steps_per_epoch, self._eval))
        profile_iters = set(int(i) for i in cfg.TPU.get("PROFILE_ITERS", ()))
        if profile_iters and comm.is_main_process():  # one trace file: rank 0's
            ret.append(hooks_lib.TorchProfiler(lambda trainer: trainer.iter in profile_iters, cfg.OUTPUT_DIR,
                                               self.device))
        if comm.is_main_process():
            ret.append(hooks_lib.PeriodicWriter(default_writers(cfg.OUTPUT_DIR, self._max_iter),
                                                period=int(cfg.LOG_PERIOD)))
        return ret

    def _eval(self) -> Dict:
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.state)
        return self.test(self.cfg, self.state, eval_step=self._eval_step)

    def train(self):
        super().train(self.start_epoch * self.steps_per_epoch, self._max_iter)

    @classmethod
    def test(cls, cfg, state, eval_step=None) -> Dict:
        """``{evaluator tag: {metric: value}}`` of ``state`` on the test loader."""
        return do_test(cfg, state=state, eval_step=eval_step)

    @staticmethod
    def auto_scale_workers(cfg: CfgNode, num_workers: int) -> CfgNode:
        """The linear scaling rule: where the world size differs from
        ``SOLVER.REFERENCE_WORLD_SIZE`` (0: off), scale the batch and the rates
        by their ratio, so that the batch of one worker stays the same."""
        old_world = int(cfg.SOLVER.get("REFERENCE_WORLD_SIZE", 0))
        if old_world == 0 or old_world == num_workers:
            return cfg
        cfg = cfg.clone()
        was_frozen = cfg.is_frozen()
        cfg.defrost()

        assert cfg.SOLVER.IMS_PER_BATCH % old_world == 0
        scale = num_workers / old_world
        cfg.SOLVER.IMS_PER_BATCH = int(round(cfg.SOLVER.IMS_PER_BATCH * scale))
        cfg.SOLVER.DEPTH_LR = cfg.SOLVER.DEPTH_LR * scale
        if "POSE_LR" in cfg.SOLVER:
            cfg.SOLVER.POSE_LR = cfg.SOLVER.POSE_LR * scale
        cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
        logger.info(f"auto_scale_workers: {old_world} → {num_workers} workers; "
                    f"IMS_PER_BATCH={cfg.SOLVER.IMS_PER_BATCH}, DEPTH_LR={cfg.SOLVER.DEPTH_LR}")
        if was_frozen:
            cfg.freeze()
        return cfg


class DefaultPredictor:
    """Single-image inference: the config's test preprocess (without its
    loading ops), the checkpoint of ``MODEL.WEIGHTS`` or ``OUTPUT_DIR``
    (:func:`.runtime.restore_inference_state`, loaded at the first call), and
    the preprocess undone on the prediction. Call it with an HWC uint8 RGB
    frame; it returns the depth map ``[H, W]`` float32 in that frame."""

    def __init__(self, cfg: CfgNode, device: Device = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.preprocesses = [
            build_preprocess(p) for p in cfg.DATASETS.TEST.get("PREPROCESS", [])
            if p["NAME"] not in ("LoadImg", "LoadDepth", "LoadMask", "LoadLidar")
        ]
        self.state = None
        self._eval_step = None

    def __call__(self, image: np.ndarray) -> np.ndarray:
        data = {"metadata": {}, "img": image}
        for op in self.preprocesses:
            data = op.forward(data, np.random.default_rng(0))
        img = data["img"].astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        batch = {"img": torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)[None])).to(self.device)}
        if self.state is None:
            self.state, _ = restore_inference_state(self.cfg, self.device)
            self._eval_step = make_eval_step(self.state)
        data["depth_pred"] = self._eval_step(batch)[0, 0].float().cpu().numpy()
        for op in self.preprocesses[::-1]:
            data = op.backward(data)
        return data["depth_pred"]
