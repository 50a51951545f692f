"""The port's hook-driven trainer (``engine.trainer.DefaultTrainer``, its hooks,
PreciseBN) and the runtime's ``TEST.ASYNC`` and ``VIS_PERIOD``, on the CPU.

(a) Against the JAX package's ``DefaultTrainer``: ``SupDepthModel`` with
    DepthResNet-18 in float32 (``projects/Supervised/configs/synthetic_quick.yaml``
    at 64x128), B=4, 2 steps an epoch for 2 epochs, an evaluation each epoch,
    PreciseBN on (2 batches), both sides from the same weights (the port's
    seeded init, perturbed, carried to the JAX tree by ``convert_meta_arch``;
    the JAX trainer's ``create_train_state`` is handed that tree, since its
    eager Flax ``init`` takes 40 s on the CPU and loading ``MODEL.WEIGHTS`` would
    replace its values anyway). Held: every step's loss and ``grad_norm``, the
    parameters at the end, the evaluation rows and the iterations that carry
    them (1 and 4). The limits of ``test_torch_supervised.py`` (1e-5, 1e-4,
    1e-5) do not hold on these frames: on the first batch the JAX package's
    gradient of ``layer2.0.conv1.weight`` lies 7.0 % off the port's float32
    gradient and off the port run in float64, which agree to 4.4e-6 on every
    tensor (the port's is stable to 5e-6 under a 1e-7 perturbation of its
    weights): the kind of kink ``test_torch_supervised.py`` steps around by
    running at 64x128 on its own batches (``ROADMAP.md`` § C). Adam's first
    steps, about the rate whatever a gradient's size, carry it on. Measured on
    an 8-core Intel Xeon CPU, limits about three times that: losses 1.0e-4
    (3e-4), ``grad_norm`` 7.0e-5 (2e-4), parameters 7.4e-4 relative L2 (2e-3),
    evaluation 6.1e-5 (2e-4).
    PreciseBN itself is held on equal weights: the JAX package's
    ``compute_precise_bn_stats`` (with the function the JAX trainer's hook
    compiled) and the port's on the trained port model's weights and on the
    two first batches of epoch 1 of each package's loader: every running mean
    and variance within 3e-5 of its tensor's largest value (measured 1.3e-5,
    median 1.7e-6: the JAX package averages ``z_i/(1−m)`` from forwards
    started at zero, with the momentum recovered as ``m = o − z`` from two
    more forwards, which loses about ``B·6e-8/(1−m)`` relative to a batch
    variance ``B``; the port keeps a running mean with momentum ``1/(i+1)``;
    both take the batches' biased variance).
(b) The hook path against the port's ``do_train`` on the same config: the
    same losses, ``grad_norm`` and parameters to the bit (PreciseBN changes the
    running statistics only, which the train-mode steps do not read).
(c) ``TEST.ASYNC`` with ``VIS_PERIOD 2`` against (b)'s synchronous
    ``do_train``: the steps equal to the bit, the evaluation rows equal, at the
    JAX package's stamps ``max(at_iter, storage.iter + 1, last + 1)`` (4 and 5,
    where the synchronous rows sit at 2 and 4); panels after steps 2 and 4,
    magma uint8 [H, W, 3] and the frame HWC uint8, none left in the storage.
(d) ``compute_precise_bn_stats`` alone: the batch average, a BatchNorm that
    does not update left to the bit, momenta, counters and the training noise
    generator as they were.
(e) ``SimpleTrainer`` raises ``FloatingPointError`` on a NaN loss once the
    pending steps are written; ``auto_scale_workers`` equals the JAX package's.
"""
import copy
import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from simpledepthestimation_tpu.engine import trainer as jax_trainer_module
from simpledepthestimation_tpu.engine.hooks import PreciseBN as JaxPreciseBN
from simpledepthestimation_tpu.engine.trainer import DefaultTrainer as JaxDefaultTrainer
from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
from simpledepthestimation_tpu.parallel.mesh import build_mesh
from simpledepthestimation_tpu.parallel.train_step import TrainState as JTrainState
from simpledepthestimation_tpu.parallel.train_step import compute_precise_bn_stats as jax_compute_precise_bn_stats
from simpledepthestimation_tpu.parallel.train_step import place_replicated
from simpledepthestimation_tpu_torch.engine import DefaultTrainer, do_train, runtime
from simpledepthestimation_tpu_torch.engine.train_loop import SimpleTrainer
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.flax_import import load_flax_variables
from simpledepthestimation_tpu_torch.models.norm_layers import BatchNorm2d
from simpledepthestimation_tpu_torch.parallel import TrainState, compute_precise_bn_stats
from simpledepthestimation_tpu_torch.utils.events import EventStorage

from torch_port_helpers import shared_variables, supervised_cfgs, to_numpy_tree

OPTS = [
    "TPU.COMPUTE_DTYPE", "float32", "TPU.MESH_SHAPE", "(1,)",
    "DATASETS.TRAIN.IMG_HEIGHT", 64, "DATASETS.TRAIN.IMG_WIDTH", 128, "DATASETS.TRAIN.LENGTH", 8,
    "DATASETS.TEST.IMG_HEIGHT", 64, "DATASETS.TEST.IMG_WIDTH", 128, "DATASETS.TEST.LENGTH", 2,
    "SOLVER.IMS_PER_BATCH", 4, "SOLVER.MAX_EPOCHS", 2, "SOLVER.CHECKPOINT_PERIOD", 2, "TEST.EVAL_PERIOD", 1,
    "TEST.PRECISE_BN.ENABLED", True, "TEST.PRECISE_BN.NUM_ITER", 2, "LOG_PERIOD", 1, "DATALOADER.NUM_WORKERS", 2,
]
LOSS_RTOL, NORM_RTOL, PARAM_REL_L2 = 3e-4, 2e-4, 2e-3  # measured: module docstring
PRECISE_BN_RTOL = 3e-5
EVAL_RTOL = 2e-4
EVAL_KEYS = ("abs_rel", "sq_rel", "rms", "log_rms", "d1", "d2", "d3")


def _rows(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f]


def _eval_rows(out_dir):
    return [r for r in _rows(out_dir) if "kitti evaluator/abs_rel" in r]


def _per_step(storage, keys):
    """{key: [(iteration, value), ...]} of the unsmoothed step metrics."""
    return {k: [(int(it), v) for v, it in storage.history(k).values()] for k in keys}


def _flat(sd, keys):
    return np.concatenate([np.asarray(sd[k], np.float64).ravel() for k in keys])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's DefaultTrainer, the port's, and the port's do_train,
    on one config and one set of weights."""
    root = tmp_path_factory.mktemp("trainer")
    cfg_j, cfg_t = supervised_cfgs("synthetic_quick.yaml", OPTS)
    port = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    variables = shared_variables(port, cfg_j)
    torch.save(port.state_dict(), root / "weights.pth")

    def shared_state(model, optimizer, sample_batch, rng, train=True):
        # placed on the trainer's mesh as the step places its outputs, so that the first step
        # compiles the executable every later step runs (an unplaced state compiles it twice)
        return place_replicated(JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                            batch_stats=variables["batch_stats"],
                                            opt_state=optimizer.init(variables["params"])), build_mesh(shape=(1,)))

    cfg_j.OUTPUT_DIR = str(root / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "create_train_state", shared_state)
        jax_trainer = JaxDefaultTrainer(cfg_j)
    jax_trainer.train()

    cfg_t.MODEL.WEIGHTS, cfg_t.OUTPUT_DIR = str(root / "weights.pth"), str(root / "hook")
    trainer = DefaultTrainer(cfg_t, device="cpu")
    trainer.train()

    plain_cfg = cfg_t.clone()
    plain_cfg.OUTPUT_DIR = str(root / "plain")
    plain_seen = []
    plain = do_train(plain_cfg, device="cpu", metrics_tap=lambda it, m: plain_seen.append((it, m)))
    yield dict(root=root, cfg_j=cfg_j, cfg_t=cfg_t, jax=jax_trainer, hook=trainer, plain=plain,
               plain_seen=plain_seen, plain_cfg=plain_cfg)
    shutil.rmtree(root, ignore_errors=True)  # checkpoints of ~170 MB each


def test_default_trainer_matches_the_jax_default_trainer(runs):
    jax_trainer, trainer = runs["jax"], runs["hook"]
    assert trainer.iter == jax_trainer.iter == 4
    keys = ("total_loss", "silog_loss", "grad_norm")
    got, want = _per_step(trainer.storage, keys), _per_step(jax_trainer.storage, keys)
    for k in keys:
        assert [it for it, _ in got[k]] == [it for it, _ in want[k]] == [0, 1, 2, 3], k
        np.testing.assert_allclose([v for _, v in got[k]], [v for _, v in want[k]],
                                   rtol=NORM_RTOL if k == "grad_norm" else LOSS_RTOL, err_msg=k)

    want_model = build_model(runs["cfg_t"], device="cpu")
    load_flax_variables(want_model, to_numpy_tree(jax_trainer.state.params),
                        to_numpy_tree(jax_trainer.state.batch_stats))
    params = [k for k, _ in trainer.model.named_parameters()]
    va, vb = _flat(trainer.model.state_dict(), params), _flat(want_model.state_dict(), params)
    assert np.linalg.norm(va - vb) / np.linalg.norm(vb) <= PARAM_REL_L2

    got_rows, want_rows = _eval_rows(runs["cfg_t"].OUTPUT_DIR), _eval_rows(runs["cfg_j"].OUTPUT_DIR)
    assert [r["iteration"] for r in got_rows] == [r["iteration"] for r in want_rows] == [1, 4]
    for g, w in zip(got_rows, want_rows):
        for k in EVAL_KEYS:
            np.testing.assert_allclose(g[f"kitti evaluator/{k}"], w[f"kitti evaluator/{k}"], rtol=EVAL_RTOL, err_msg=k)


def test_precise_bn_matches_the_jax_package_on_equal_weights(runs):
    jax_trainer, trainer = runs["jax"], runs["hook"]
    (hook,) = [h for h in jax_trainer._hooks if isinstance(h, JaxPreciseBN)]
    model = copy.deepcopy(trainer.model)
    sd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    params, stats = convert_meta_arch(sd, runs["cfg_j"])
    # placed as the hook's state is, so that the hook's compiled update is reused, not compiled again
    jstate = place_replicated(JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                          opt_state=None), jax_trainer.mesh)

    jax_trainer.loader.set_epoch(1)
    trainer.loader.set_epoch(1)
    jbatches = list(itertools.islice(iter(jax_trainer.loader), 2))
    tbatches = list(itertools.islice(iter(trainer.loader), 2))
    for jb, tb in zip(jbatches, tbatches):
        np.testing.assert_array_equal(tb["img"].numpy().transpose(0, 2, 3, 1), jb["img"])
    want = jax_compute_precise_bn_stats(jax_trainer.model, jstate, iter(jbatches), stats_after=hook._stats_after)
    state = TrainState(model=model, optimizer=None, scheduler=None, noise_generator=None)
    tensors = ({k: v for k, v in b.items() if isinstance(v, torch.Tensor)} for b in tbatches)
    assert compute_precise_bn_stats(state, tensors) == 2

    want_model = build_model(runs["cfg_t"], device="cpu")
    load_flax_variables(want_model, to_numpy_tree(params), to_numpy_tree(want))
    a, b = model.state_dict(), want_model.state_dict()
    names = [k for k in a if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * sum(isinstance(m, BatchNorm2d) for m in model.modules()) > 0
    errs = {k: np.abs(a[k].numpy() - b[k].numpy()).max() / np.abs(b[k].numpy()).max() for k in names}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= PRECISE_BN_RTOL, (worst, errs[worst], np.median(list(errs.values())))
    # the trainer's last recomputation replaced the running averages, and its last checkpoint
    # (epoch 1, taken after that recomputation) carries them
    trained, ema = trainer.model.state_dict(), runs["plain"].model.state_dict()
    assert not any(torch.equal(trained[k], ema[k]) for k in names)
    saved = torch.load(os.path.join(runs["cfg_t"].OUTPUT_DIR, "model_0001.pth"), weights_only=True)["model"]
    assert all(torch.equal(saved[k], trained[k]) for k in names)


def test_hook_path_equals_do_train_to_the_bit(runs):
    trainer, plain, seen = runs["hook"], runs["plain"], runs["plain_seen"]
    keys = sorted(seen[0][1])
    assert keys == ["grad_norm", "silog_loss", "total_loss"]
    hook = _per_step(trainer.storage, keys)
    for k in keys:
        assert hook[k] == [(it, m[k]) for it, m in seen], k
    assert plain.step == trainer.state.step == 4
    for k, p in trainer.model.named_parameters():
        assert torch.equal(p, dict(plain.model.named_parameters())[k]), k


class _RecordingStorage(EventStorage):
    """The runtime's storage, recording each image put and itself."""

    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.images = []
        _RecordingStorage.made.append(self)

    def put_image(self, img_name, img):
        self.images.append((img_name, self.iter, np.asarray(img).shape, np.asarray(img).dtype))
        super().put_image(img_name, img)


def test_async_eval_and_vis_period(runs, monkeypatch):
    cfg = runs["plain_cfg"].clone()
    cfg.OUTPUT_DIR = str(runs["root"] / "async")
    cfg.TEST.ASYNC, cfg.VIS_PERIOD = True, 2
    runtime.check_supported(cfg)  # neither is refused any longer
    monkeypatch.setattr(runtime, "EventStorage", _RecordingStorage)
    _RecordingStorage.made.clear()
    seen = []
    do_train(cfg, device="cpu", metrics_tap=lambda it, m: seen.append((it, m)))
    assert seen == runs["plain_seen"]  # the evaluation thread and the panels leave training alone

    sync_rows, async_rows = _eval_rows(runs["plain_cfg"].OUTPUT_DIR), _eval_rows(cfg.OUTPUT_DIR)
    assert [r["iteration"] for r in sync_rows] == [2, 4]
    assert [r["iteration"] for r in async_rows] == [4, 5]
    for s, a in zip(sync_rows, async_rows):
        assert {k: v for k, v in s.items() if k.startswith("kitti")} == {k: v for k, v in a.items() if k.startswith("kitti")}

    (storage,) = _RecordingStorage.made
    assert storage.images == [
        ("train/depth_pred", 2, (64, 128, 3), np.uint8), ("train/image", 2, (64, 128, 3), np.uint8),
        ("train/depth_pred", 4, (64, 128, 3), np.uint8), ("train/image", 4, (64, 128, 3), np.uint8),
    ]
    assert storage._vis_data == [] and storage._histograms == []


class _TwoNorms(nn.Module):
    """A model with a BatchNorm that updates and one that never does (as
    ``BN_NO_TRACK`` runs its norms), drawing noise from the generator it is given."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))
        self.tracked, self.fixed = BatchNorm2d(3, momentum=0.1), BatchNorm2d(3, momentum=0.1)
        for bn in (self.tracked, self.fixed):
            bn.running_mean.uniform_(-1, 1)
            bn.running_var.uniform_(0.5, 1.5)
            bn.num_batches_tracked.fill_(7)

    def forward(self, batch, train=False, generator=None):
        x = batch["img"] * self.scale + 1e-3 * torch.randn(batch["img"].shape, generator=generator)
        return {"loss": (self.tracked(x, train) + self.fixed(x, False)).mean()}


def test_precise_bn_stats_are_the_batch_average():
    model = _TwoNorms()
    noise = torch.Generator().manual_seed(5)
    state = TrainState(model=model, optimizer=None, scheduler=None, noise_generator=noise)
    noise_before, fixed_before = noise.get_state(), {k: v.clone() for k, v in model.fixed.state_dict().items()}
    rng = np.random.RandomState(0)
    batches = [{"img": torch.from_numpy(rng.randn(4, 3, 5, 6).astype(np.float32) * (i + 1) + i)} for i in range(3)]
    assert compute_precise_bn_stats(state, iter(batches)) == 3

    replay = torch.Generator().manual_seed(0)  # the noise of the forwards, drawn again
    xs = [b["img"] + 1e-3 * torch.randn(b["img"].shape, generator=replay) for b in batches]
    means = torch.stack([x.mean(dim=(0, 2, 3)) for x in xs])
    variances = torch.stack([x.var(dim=(0, 2, 3), unbiased=False) for x in xs])
    torch.testing.assert_close(model.tracked.running_mean, means.mean(0), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(model.tracked.running_var, variances.mean(0), rtol=1e-5, atol=1e-6)
    for k, v in model.fixed.state_dict().items():
        assert torch.equal(v, fixed_before[k]), k
    assert model.tracked.momentum == model.fixed.momentum == 0.1
    assert int(model.tracked.num_batches_tracked) == int(model.fixed.num_batches_tracked) == 7
    assert torch.equal(noise.get_state(), noise_before)
    # a model without BatchNorm: nothing to do, and the caller's batches are not read
    bare = TrainState(model=nn.Linear(2, 2), optimizer=None, scheduler=None, noise_generator=noise)
    assert compute_precise_bn_stats(bare, iter(batches)) == 0


def test_simple_trainer_raises_on_a_nan_loss():
    losses = [1.0, 2.0, float("nan"), 4.0, 5.0]
    trainer = SimpleTrainer(lambda batch, it: {"total_loss": torch.tensor(losses[it])}, iter(range(5)), state=None)
    with pytest.raises(FloatingPointError, match="iteration=2"):
        trainer.train(0, 5)
    written = [(it, v) for v, it in trainer.storage.history("total_loss").values()]
    assert written == [(0, 1.0), (1, 2.0), (3, 4.0), (4, 5.0)]  # the pending steps, read before the error


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_auto_scale_workers_equals_the_jax_function(runs, world):
    cfg_j, cfg_t = runs["cfg_j"].clone(), runs["cfg_t"].clone()
    for cfg in (cfg_j, cfg_t):
        cfg.SOLVER.REFERENCE_WORLD_SIZE, cfg.SOLVER.IMS_PER_BATCH = 4, 16
        cfg.SOLVER.POSE_LR = 2e-4
        cfg.freeze()
    want = JaxDefaultTrainer.auto_scale_workers(cfg_j, world)
    got = DefaultTrainer.auto_scale_workers(cfg_t, world)
    assert got.is_frozen() == want.is_frozen()
    assert {k: got.SOLVER[k] for k in ("IMS_PER_BATCH", "DEPTH_LR", "POSE_LR", "REFERENCE_WORLD_SIZE")} == {
        k: want.SOLVER[k] for k in ("IMS_PER_BATCH", "DEPTH_LR", "POSE_LR", "REFERENCE_WORLD_SIZE")}
    assert (got is cfg_t) == (want is cfg_j) == (world == 4)


def test_default_trainer_refuses_several_processes(runs, monkeypatch):
    """Above one process ``DefaultTrainer`` refuses a global batch (after
    ``auto_scale_workers``) that does not split evenly among the processes,
    before it builds anything (the runs in several processes:
    ``tests/test_torch_parallel.py``)."""
    from simpledepthestimation_tpu_torch.utils import comm

    assert int(runs["cfg_t"].SOLVER.IMS_PER_BATCH) % 3 and not int(runs["cfg_t"].SOLVER.REFERENCE_WORLD_SIZE)
    monkeypatch.setattr(comm, "get_world_size", lambda: 3)
    with pytest.raises(ValueError, match="must divide evenly among 3 processes"):
        DefaultTrainer(runs["cfg_t"], device="cpu")
