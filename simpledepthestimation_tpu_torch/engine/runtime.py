"""The training and evaluation loops behind the project entry points.

The port's counterpart of ``simpledepthestimation_tpu/engine/runtime.py`` for
one process on one GPU: an epoch loop over the train loader, a checkpoint
every ``SOLVER.CHECKPOINT_PERIOD`` epochs, the KITTI evaluation every
``TEST.EVAL_PERIOD`` epochs, ``--resume`` and evaluation alone.

Everything runs on the CUDA device unless the caller names another one
(``device="cpu"``, as the tests do); without a CUDA device the entry points
raise, they never fall back to the CPU. Host batches come from the loader in
page-locked memory and are copied to the card on a side stream two batches
ahead of the step (:func:`device_prefetch`). The step returns 0-d device
tensors; the loop reads them at most 8 steps late and at each ``LOG_PERIOD``
(every step with ``PARITY.STRICT``), and raises there on a non-finite loss.

``VIS_PERIOD``: every that many steps the trained model's depth of the
batch's first frame goes to the storage as a magma panel
(``train/depth_pred``) beside the frame (``train/image``, HWC uint8).
``TEST.ASYNC``: each epoch-end evaluation runs on one worker thread, on a copy
of the model taken after the epoch's checkpoint, while the next epoch trains;
at most one is in flight, and its row is logged from the loop's thread.

Not in this package yet, and refused with ``NotImplementedError`` where a
config asks for it: training in several processes (``ROADMAP.md`` A17).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import itertools
import logging
import math
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..data import build_test_loader, build_train_loader
from ..evaluation import DatasetEvaluators, build_evaluator, inference_on_dataset
from ..models.build import build_model, resolve_device
from ..parallel.train_step import TrainState, create_train_state, make_eval_step, make_train_step
from ..solver.build import build_optimizer
from ..utils import comm
from ..utils.events import EventStorage, write_all
from .checkpoint import Checkpointer, PeriodicCheckpointer, load_weights
from .defaults import default_writers

logger = logging.getLogger(__name__)

Device = Optional[Union[str, torch.device]]
Copy = Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]


def check_supported(cfg) -> None:
    """Raise for what a config may ask of the JAX package's runtime that this
    one does not do yet, rather than ignore it."""
    if comm.get_world_size() > 1:
        raise NotImplementedError("training in several processes is not ported yet: ROADMAP.md A17")


def _tensors(batch: Dict) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}


def _inference_state(cfg, device: Device) -> TrainState:
    """A state for evaluation: the model as ``build_model`` makes it (no
    ImageNet warm start: a checkpoint is loaded over it), with an optimizer so
    that a full checkpoint restores into it."""
    model = build_model(cfg, device=device)
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch=1)
    noise = torch.Generator(device=next(model.parameters()).device).manual_seed(0)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler, noise_generator=noise)


def restore_inference_state(cfg, device: Device = None) -> Tuple[TrainState, bool]:
    """The inference state of a trained run: weights from ``MODEL.WEIGHTS`` (a
    checkpoint directory, a checkpoint file or a ``state_dict``), else from the
    newest checkpoint in ``OUTPUT_DIR``, loaded non-strictly. Returns
    ``(state, had_checkpoint)``; callers decide whether a missing checkpoint
    is an error."""
    state = _inference_state(cfg, device)
    weights = str(cfg.MODEL.WEIGHTS)
    if weights:
        load_weights(weights, state)
        return state, True
    ckpt = Checkpointer(cfg.OUTPUT_DIR)
    had_checkpoint = ckpt.has_checkpoint()
    ckpt.resume_or_load("", state, resume=True)
    return state, had_checkpoint


def device_prefetch(iterator, device: torch.device, depth: int = 2) -> Iterator[Tuple[Dict[str, torch.Tensor], Copy]]:
    """Yield ``(batch on the device, copy)`` for each host batch, ``depth``
    batches ahead of the consumer.

    On a CUDA device each batch's tensors (page-locked by the loader, pinned
    here otherwise) are copied with ``non_blocking=True`` on a side stream,
    between two timing events (``copy``: the side stream's time from the first
    copy's start to the last one's end, host delays between the enqueues
    included); the consumer's stream waits on the
    second event before the batch is yielded, and each device tensor is
    recorded on that stream so that its memory is not reused before the step
    that reads it has run. Elsewhere the tensors are moved as they are and
    ``copy`` is None. Non-tensor entries (``metadata``) are dropped."""
    if device.type != "cuda":
        for batch in iterator:
            yield {k: v.to(device) for k, v in _tensors(batch).items()}, None
        return

    side = torch.cuda.Stream(device=device)

    def place(batch):
        host = {k: v if v.is_pinned() else v.pin_memory() for k, v in _tensors(batch).items()}
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            on_device = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            done.record(side)
        return on_device, (start, done)

    def hand_over(item):
        on_device, copy = item
        compute = torch.cuda.current_stream(device)
        compute.wait_event(copy[1])
        for v in on_device.values():
            v.record_stream(compute)
        return on_device, copy

    queue = collections.deque()
    for batch in iterator:
        queue.append(place(batch))
        if len(queue) > depth:
            yield hand_over(queue.popleft())
    while queue:
        yield hand_over(queue.popleft())


def do_test(cfg, state: Optional[TrainState] = None, eval_step=None, device: Device = None) -> Dict:
    """Evaluate ``state`` (or, with none, the newest checkpoint in
    ``OUTPUT_DIR``, else ``MODEL.WEIGHTS``) on the test loader with
    ``cfg.EVALUATORS``; returns ``{evaluator tag: {metric: value}}``."""
    check_supported(cfg)
    loader = build_test_loader(cfg)
    if loader is None:
        logger.info("No test dataset configured; skipping eval")
        return {}
    if state is None:
        state = _inference_state(cfg, device)
        Checkpointer(cfg.OUTPUT_DIR).resume_or_load(str(cfg.MODEL.WEIGHTS), state, resume=True)
    if eval_step is None:
        eval_step = make_eval_step(state)
    model_device = next(state.model.parameters()).device

    def eval_fn(inputs):
        return eval_step({k: v.to(model_device) for k, v in _tensors(inputs).items()})

    evaluators = DatasetEvaluators(build_evaluator(cfg, cfg.OUTPUT_DIR))
    return inference_on_dataset(eval_fn, loader, evaluators)


def _snapshot(state: TrainState) -> Tuple[TrainState, Optional[torch.cuda.Event]]:
    """A copy of ``state`` with its own model (parameters and buffers copied on
    the current stream) for an evaluation that runs while training goes on,
    and on the card an event recorded after the copy."""
    snapshot = dataclasses.replace(state, model=copy.deepcopy(state.model))
    device = next(state.model.parameters()).device
    if device.type != "cuda":
        return snapshot, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return snapshot, ready


def _evaluate_snapshot(cfg, snapshot: TrainState, ready: Optional[torch.cuda.Event]) -> Dict:
    """``do_test`` of a :func:`_snapshot`, for a worker thread: on the card on a
    stream of its own, which first waits for the copy. The snapshot's tensors
    were allocated on the training stream, so each is recorded on this one:
    their memory goes back to the training stream only after the work queued
    here has run. Returns the results; the storage is the loop's alone."""
    if ready is None:
        return do_test(cfg, state=snapshot)
    stream = torch.cuda.Stream(device=next(snapshot.model.parameters()).device)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        for t in itertools.chain(snapshot.model.parameters(), snapshot.model.buffers()):
            t.record_stream(stream)
        return do_test(cfg, state=snapshot)


def do_train(
    cfg,
    resume: bool = False,
    schedule_fn: Optional[Callable[[int], Dict[str, float]]] = None,
    model: Optional[torch.nn.Module] = None,
    batch_tap: Optional[Callable[[Dict], None]] = None,
    metrics_tap: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device: Device = None,
) -> TrainState:
    """Run the training loop of ``cfg`` and return the trained state.

    ``schedule_fn(step)`` gives per-step scalars for the batch (MotionLearning:
    ``models.make_schedule_fn(cfg)``), of the restored ``TrainState.step`` on a
    resumed run. ``model``: a model built by the caller, used in place of a
    fresh one. ``batch_tap`` sees every host batch in the order the steps
    consume them, before it goes to the device; ``metrics_tap(step, floats)``
    every step's metrics as they are read back."""
    check_supported(cfg)
    device = resolve_device(device)
    seed = cfg.SEED if cfg.SEED >= 0 else 0
    loader = build_train_loader(cfg, seed=seed, pin_memory=device.type == "cuda")
    steps_per_epoch = len(loader)
    max_epochs = int(cfg.SOLVER.MAX_EPOCHS)
    max_iter = steps_per_epoch * max_epochs

    state = create_train_state(cfg, device=device, steps_per_epoch=steps_per_epoch, model=model)
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info(f"Model has {n_params / 1e6:.2f}M parameters")
    train_step = make_train_step(state, grad_clip=float(cfg.SOLVER.get("GRAD_CLIP", 0.0)), schedule_fn=schedule_fn,
                                 remat=bool(cfg.TPU.get("REMAT", False)))

    checkpointer = Checkpointer(cfg.OUTPUT_DIR)
    state, start_epoch = checkpointer.resume_or_load(str(cfg.MODEL.WEIGHTS), state, resume=resume)
    periodic_ckpt = PeriodicCheckpointer(checkpointer, int(cfg.SOLVER.CHECKPOINT_PERIOD), max_epochs)

    writers = default_writers(cfg.OUTPUT_DIR, max_iter) if comm.is_main_process() else []
    log_period = int(cfg.LOG_PERIOD)
    eval_period = int(cfg.TEST.EVAL_PERIOD)
    vis_period = int(cfg.get("VIS_PERIOD", 0))
    eval_step = make_eval_step(state)  # the evaluations' and the panels'
    # one process only (check_supported): two threads issuing collectives could interleave
    async_eval = bool(cfg.TEST.get("ASYNC", False)) and eval_period > 0
    eval_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="async-eval") if async_eval else None
    pending_eval: Optional[Tuple[int, Future]] = None  # (step at submission, future)
    eval_log_iter = -1  # the last iteration an asynchronous evaluation row was logged at
    lr_schedule = state.scheduler.schedules[0]
    # PARITY.STRICT: read and check every step's loss at once, as the reference does
    strict_parity = bool(cfg.get("PARITY", {}).get("STRICT", False))

    def log_eval_results(storage, results, at_iter):
        flat = {f"{task}/{k}": float(v) for task, ms in results.items() if isinstance(ms, dict) for k, v in ms.items()}
        if flat and comm.is_main_process():
            cur = storage.iter
            storage.iter = at_iter
            storage.put_scalars(**flat, smoothing_hint=False)
            storage.iter = cur

    def join_pending_eval(storage):
        """Wait for the evaluation in flight and log its row at an iteration
        above every one written so far (the JSON writer skips an iteration at
        or below its last), then write at once, so that a later evaluation
        cannot overwrite the row before it is written."""
        nonlocal pending_eval, eval_log_iter
        if pending_eval is None:
            return
        at_iter, future = pending_eval
        pending_eval = None
        eval_log_iter = max(at_iter, storage.iter + 1, eval_log_iter + 1)
        log_eval_results(storage, future.result(), eval_log_iter)
        write_all(writers)

    logger.info(f"Starting training from epoch {start_epoch}")
    with EventStorage(start_epoch * steps_per_epoch) as storage, eval_pool or contextlib.nullcontext():
        storage.max_epoch = max_epochs
        storage.max_iter_per_epoch = steps_per_epoch
        step = start_epoch * steps_per_epoch
        pending = []  # steps whose metrics are still on the device

        def drain(all_: bool = False):
            limit = 0 if all_ else 8
            while len(pending) > limit:
                it, data_time, iter_time, copy, metrics = pending.pop(0)
                values = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))  # one read
                total = values.get("total_loss", 0.0)
                if not math.isfinite(total):
                    raise FloatingPointError(f"Loss is {total} at iteration {it}: {values}")
                storage.iter = it
                storage.put_scalar("data_time", data_time)
                storage.put_scalar("time", iter_time)
                if copy is not None:
                    storage.put_scalar("h2d_time", copy[0].elapsed_time(copy[1]) / 1e3)
                for k, v in values.items():
                    storage.put_scalar(k, v)
                storage.put_scalar("lr", float(lr_schedule(it)), smoothing_hint=False)
                if metrics_tap is not None:
                    metrics_tap(it, values)

        for epoch in range(start_epoch, max_epochs):
            storage.epoch = epoch
            loader.set_epoch(epoch)
            epoch_iter = iter(loader)
            if batch_tap is not None:
                def _tapped(src):
                    for b in src:
                        batch_tap({k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in b.items()})
                        yield b

                epoch_iter = _tapped(epoch_iter)
            t_data = t_prev = time.perf_counter()
            for batch, copy in device_prefetch(epoch_iter, device):
                t_batch = time.perf_counter()
                metrics = train_step(batch)
                # data_time: the wait for this batch; time: since the previous step began
                pending.append((step, t_batch - t_data, t_batch - t_prev, copy, metrics))
                drain(all_=strict_parity)

                step += 1
                storage.iter = step
                if vis_period > 0 and step % vis_period == 0 and comm.is_main_process():
                    depth = eval_step({"img": batch["img"][:1]})[0, 0].float().cpu().numpy()
                    storage.put_image_with_cmap("train/depth_pred", depth, cmap="magma")
                    frame = batch["img"][0].permute(1, 2, 0).cpu().numpy()  # CHW -> HWC
                    storage.put_image("train/image", (frame * 255).astype(np.uint8))
                if step % log_period == 0:
                    drain(all_=True)
                    write_all(writers)
                t_data, t_prev = time.perf_counter(), t_batch

            drain(all_=True)
            periodic_ckpt.step(epoch, state)
            if eval_period > 0 and (epoch + 1) % eval_period == 0:
                if async_eval:
                    join_pending_eval(storage)  # at most one in flight
                    pending_eval = (step, eval_pool.submit(_evaluate_snapshot, cfg, *_snapshot(state)))
                else:
                    log_eval_results(storage, do_test(cfg, state=state, eval_step=eval_step), step)
            comm.synchronize()

        join_pending_eval(storage)
        write_all(writers)
        for writer in writers:
            writer.close()

    logger.info("Training complete")
    return state
