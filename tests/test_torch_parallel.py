"""The port in several processes: world 2 over gloo on the CPU against world 1
on the same global batch, and against the JAX package's global program.

One pair of processes (``tests/torch_parallel_worker.py``) runs every case on
its rows of the global batches while this process computes world 1 (the port
with no process group, which the other ``test_torch_*`` files hold against the
JAX package) and the JAX references:

(a) the comm primitives and the evaluator's metric gather, as
    ``tests/test_multihost.py:62-89`` holds them for the JAX package; a lost
    rank fails at the group's timeout;
(b) ``BatchNorm2d`` in train mode: output and running statistics against the
    JAX package's ``get_norm("SyncBN", True)`` on the 8-device virtual mesh
    (``tests/test_parallel.py:136-183``, same limits), and against float64 on
    activations around 30 (where flax's E[x²] − E[x]² cancels in float32),
    input and affine gradients against world 1;
(c) ``silog_loss``, ``variance_loss``, ``MonoDepth2Model._clip`` and the
    ``SCALE_NORMALIZE`` depth mean against the JAX functions on the global
    batch, their gradients against world 1;
(d) one train step of SupDepthModel, MonoDepth2-R18 (clip and variance loss on)
    and MotionLearning-R18 (RandLayerNorm noise 0.5, under ``TPU.REMAT`` at world 2)
    against world 1: the limits of ``tests/test_parallel.py:72-81``, and the
    state equal to the bit on both ranks;
(e) PreciseBN: the mean over ranks of each rank's statistics;
(f) ``projects/Supervised/train_torch.py --coordinator … --num-processes 2``:
    one epoch with evaluation and checkpoint, then ``--resume`` for a second,
    against the same run in one process.

Every spawned process has a timeout, and so has every collective in it.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from torch_port_helpers import REPO

WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD = 2
PROC_TIMEOUT = 300

# tests/test_parallel.py:72-81 and :175-180, the JAX package's own limits for its mesh against one device
LOSS_RTOL, GRAD_NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 5e-4
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
# gradients of one function at world 2 and world 1: the same terms summed in another order
GRAD_RTOL = 1e-5
# MonoDepth2-R18's first-step grad_norm: tests/test_torch_train_step.py's first-step limit. Its pose net's
# gradient (most of the norm) is a sum over pixels that cancels: in ONE process, step_case("monodepth2", ...) on
# one thread against two moves grad_norm by 4.1e-4 with the loss equal to the bit, so the JAX package's 1e-4
# sits inside float32's noise here
MONODEPTH2_GRAD_NORM_RTOL = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "tests"))
    return subprocess.Popen([sys.executable, WORKER, *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-4000:]}"
    return outs


def _joined(parts, blocks=1):
    """The global array of per-rank arrays of ``blocks`` stacked batches each."""
    split = [np.split(np.asarray(p), blocks) for p in parts]
    return np.concatenate([split[r][j] for j in range(blocks) for r in range(len(parts))])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results; world 1 is computed here while the ranks run."""
    out = tmp_path_factory.mktemp("world2")
    address = f"127.0.0.1:{_free_port()}"
    procs = [_spawn([str(r), str(WORLD), address, str(out)]) for r in range(WORLD)]
    try:
        world1 = {"bn": W.bn_case(*W.bn_inputs()), "losses": W.loss_case(W.loss_inputs())}
        for family in ("supervised", "monodepth2", "motion"):
            world1[family] = W.step_case(family, W.step_batch(family))
        world1["precise_bn_ranks"] = [W.precise_bn_case(W.precise_bn_batches(r)) for r in range(WORLD)]
    finally:
        _wait(procs)
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    shutil.rmtree(out)  # rank 0's states: a few hundred MB
    return results, world1


def test_comm_primitives_and_metric_gather(ranks):
    results, _ = ranks
    for rank, res in enumerate(results):
        c = res["comm"]
        assert (c["world"], c["rank"], c["local_rank"]) == (WORLD, rank, 0)
        assert [g["rank"] for g in c["gathered"]] == [0, 1] and len(c["gathered"][1]["blob"]) == 110
        assert c["gather"] == ([0, 10] if rank == 0 else [])
        assert c["reduced"] == {"loss": 1.5} and c["summed"] == {"loss": 3.0}
        assert c["is_global"] and c["multiprocess"] and c["local_batch"] == 4
        assert "must divide evenly among 2 processes" in c["split_error"]
    assert results[0]["comm"]["seed"] == results[1]["comm"]["seed"]
    # rank 0 sees both fabricated metric rows, 0 and 1: their mean in every column
    assert results[0]["comm"]["evaluated"] == {"kitti evaluator": dict.fromkeys(
        ("abs_rel", "sq_rel", "rms", "log_rms", "d1", "d2", "d3"), 0.5)}
    assert results[1]["comm"]["evaluated"] == {}


def test_lost_rank_fails_at_the_timeout(ranks):
    lost = ranks[0][0]["lost_rank"]
    assert lost["raised"] == "RuntimeError" and lost["seconds"] < 30


def test_batchnorm_global_statistics_against_sync_bn(ranks):
    """The rank's output rows and the running statistics against the JAX
    package's SyncBN on the global batch, sharded over the virtual mesh."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze

    from simpledepthestimation_tpu.models.norm_layers import get_norm
    from simpledepthestimation_tpu.parallel import build_mesh, data_sharding, replicated

    x, weight, bias, _ = W.bn_inputs(offset=0.0)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))

    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=True):
            return get_norm("SyncBN", train)("bn")(x)

    model = Tiny()
    variables = unfreeze(model.init(jax.random.PRNGKey(0), x_nhwc, train=True))
    variables["params"]["bn"] = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    mesh = build_mesh(("data",), (8,))

    @jax.jit
    def step(variables, x):
        out, mut = model.apply(variables, x, train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    out, stats = step(jax.device_put(variables, replicated(mesh)), jax.device_put(x_nhwc, data_sharding(mesh)))
    results, _ = ranks
    got = _joined([r["bn_sync"]["out"] for r in results])
    np.testing.assert_allclose(got, np.asarray(out).transpose(0, 3, 1, 2), rtol=OUT_RTOL, atol=OUT_ATOL)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        assert np.array_equal(results[0]["bn_sync"][name], results[1]["bn_sync"][name])
        np.testing.assert_allclose(results[0]["bn_sync"][name], np.asarray(stats["bn"][key]), rtol=STATS_RTOL,
                                   atol=STATS_ATOL)


def test_batchnorm_global_statistics_do_not_cancel(ranks):
    """Activations around 30: output and running statistics against float64."""
    x, weight, bias, _ = W.bn_inputs()
    x64 = x.astype(np.float64)
    mean, var = x64.mean(axis=(0, 2, 3)), x64.var(axis=(0, 2, 3))
    want = (x64 - mean[None, :, None, None]) / np.sqrt(var + 1e-5)[None, :, None, None] * weight[None, :, None, None] \
        + bias[None, :, None, None]
    results, _ = ranks
    np.testing.assert_allclose(_joined([r["bn"]["out"] for r in results]), want, rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(results[0]["bn"]["running_mean"], 0.1 * mean, rtol=STATS_RTOL, atol=STATS_ATOL)
    np.testing.assert_allclose(results[0]["bn"]["running_var"], 0.9 + 0.1 * var, rtol=STATS_RTOL, atol=STATS_ATOL)


def test_batchnorm_gradients_equal_world_1(ranks):
    results, world1 = ranks
    ref = world1["bn"]
    np.testing.assert_allclose(_joined([r["bn"]["x_grad"] for r in results]), ref["x_grad"], rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(ref["x_grad"]).max())
    for key in ("weight_grad", "bias_grad"):
        assert np.array_equal(results[0]["bn"][key], results[1]["bn"][key])
        np.testing.assert_allclose(results[0]["bn"][key], ref[key], rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref[key]).max())


def _jax_losses():
    """The JAX package's functions on the global inputs of ``loss_inputs``."""
    import jax.numpy as jnp

    from simpledepthestimation_tpu.models import losses as LJ
    from simpledepthestimation_tpu.models.meta_arch import MonoDepth2Model as JaxMonoDepth2

    inp = W.loss_inputs()
    model = JaxMonoDepth2(depth_net=None, pose_net=None, ssim_weight=0.0, clip_loss=0.5, pallas_photometric=False)
    nhwc = {k: jnp.asarray(inp[k].transpose(0, 2, 3, 1)) for k in ("frame", "sampled")}
    clipped = model.apply({}, nhwc["frame"], nhwc["sampled"], 2, method=JaxMonoDepth2._photometric)
    return {
        "silog": float(LJ.silog_loss(jnp.asarray(inp["est"]), jnp.asarray(inp["gt"]))),
        "variance": float(LJ.variance_loss(jnp.asarray(inp["est"]))),
        "clip": np.asarray(clipped).transpose(0, 3, 1, 2),
        "depth_mean": float(jnp.mean(jnp.concatenate([jnp.asarray(inp["est"]), jnp.asarray(inp["est2"])]))),
    }


@pytest.fixture(scope="module")
def jax_losses():
    return _jax_losses()


@pytest.mark.parametrize("name,blocks", [("silog", 1), ("variance", 1), ("clip", 2), ("depth_mean", 2)])
def test_losses_global_against_jax(ranks, jax_losses, name, blocks):
    """The value at world 2 against the JAX function on the global batch; its
    gradient against world 1 (a global mean that flows back into per-rank
    operations, as in ``variance_loss``, ``_clip`` and ``depth_mean``, needs the
    summed backward of ``mesh.global_sum``)."""
    results, world1 = ranks
    per_rank = [r["losses"][name] for r in results]
    if name == "clip":
        np.testing.assert_allclose(_joined(per_rank, 2), jax_losses[name], rtol=1e-6, atol=1e-6)
    else:
        assert per_rank[0] == per_rank[1]
        np.testing.assert_allclose(per_rank[0], jax_losses[name], rtol=1e-5)
    grad_key = {"depth_mean": "depth_mean_grads"}.get(name, name + "_grad")
    got = _joined([r["losses"][grad_key] for r in results], blocks)
    want = world1["losses"][grad_key]
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(want).max())


@pytest.mark.parametrize("family", ["supervised", "monodepth2", "motion"])
def test_train_step_world_2_equals_world_1(ranks, family, record_property):
    """Metrics and the state after the step against world 1 (MotionLearning's
    world 2 under ``TPU.REMAT``, world 1 without); the state equal to the bit
    on both ranks. The errors go into the junit file's properties."""
    results, world1 = ranks
    ref = world1[family]
    m0, m1 = results[0][family]["metrics"], results[1][family]["metrics"]
    assert m0 == m1 and set(m0) == set(ref["metrics"])
    rel = {k: abs(m0[k] - v) / abs(v) for k, v in ref["metrics"].items()}
    record_property("loss_rel_err", max(e for k, e in rel.items() if k != "grad_norm"))
    record_property("grad_norm_rel_err", rel["grad_norm"])
    record_property("collectives", results[0][family]["collectives"])
    norm_rtol = MONODEPTH2_GRAD_NORM_RTOL if family == "monodepth2" else GRAD_NORM_RTOL
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(m0[k], v, rtol=norm_rtol if k == "grad_norm" else LOSS_RTOL, err_msg=k)
    assert results[0][family]["digest"] == results[1][family]["digest"]
    state = results[0][family]["state"]
    assert set(state) == set(ref["state"])
    record_property("param_max_apart", max((state[k].double() - v.double()).abs().max().item()
                                           for k, v in ref["state"].items()
                                           if v.is_floating_point() and not k.endswith(("running_mean", "running_var"))))
    for k, v in ref["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)
    counts = [r[family]["collectives"] for r in results]
    assert counts[0] == counts[1] and counts[0]["forward"] > 0 and counts[0]["gradients"] > 0


def test_precise_bn_is_the_mean_over_ranks(ranks):
    """Each rank's statistics come from its own batches (no collective in the
    forwards), then their mean over ranks, equal to the bit on both."""
    results, world1 = ranks
    per_rank = world1["precise_bn_ranks"]
    assert per_rank[0].keys() == results[0]["precise_bn"].keys() and per_rank[0]
    for k in per_rank[0]:
        assert np.array_equal(results[0]["precise_bn"][k], results[1]["precise_bn"][k]), k
        np.testing.assert_allclose(results[0]["precise_bn"][k], (per_rank[0][k] + per_rank[1][k]) / 2,
                                   rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=k)


def _entry_argv(out_dir, extra=()):
    return ["--device", "cpu", "--cfg", os.path.join(REPO, "projects", "Supervised", "configs", "synthetic_quick.yaml"),
            *extra, "TPU.COMPUTE_DTYPE", "float32", "DATASETS.TRAIN.LENGTH", "8", "DATASETS.TEST.LENGTH", "5",
            "DATASETS.TRAIN.IMG_HEIGHT", "64", "DATASETS.TRAIN.IMG_WIDTH", "96", "DATASETS.TEST.IMG_HEIGHT", "64",
            "DATASETS.TEST.IMG_WIDTH", "96", "SOLVER.IMS_PER_BATCH", "4", "TEST.EVAL_PERIOD", "1",
            "DATALOADER.NUM_WORKERS", "1", "LOG_PERIOD", "1", "OUTPUT_DIR", str(out_dir)]


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    steps = [(r["iteration"], r["silog_loss"], r["total_loss"], r["grad_norm"]) for r in rows if "silog_loss" in r]
    evals = [{k: v for k, v in r.items() if k.startswith("kitti evaluator/")} for r in rows
             if "kitti evaluator/abs_rel" in r]
    return steps, evals


def test_supervised_entry_point_in_two_processes(tmp_path, monkeypatch):
    """Two processes of ``projects/Supervised/train_torch.py`` against one: the
    first epoch with its evaluation (5 test frames: shards of 3 and 2) and
    checkpoint, then ``--resume`` for a second (``adamw_poly``'s rate follows
    ``SOLVER.MAX_EPOCHS``, so the run in one process is cut the same way);
    rank 0 writes the metrics and the checkpoints."""
    import importlib.util

    from simpledepthestimation_tpu_torch.engine import default_argument_parser, defaults, simple_main

    script = os.path.join(REPO, "projects", "Supervised", "train_torch.py")
    spec = importlib.util.spec_from_file_location("train_torch_supervised_parallel", script)
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    monkeypatch.setattr(defaults, "tensorboard_writer_or_none", lambda *a, **k: None)
    two, one = tmp_path / "two", tmp_path / "one"

    def run(extra):
        """Both runs side by side: two processes, and one in this process."""
        address = f"127.0.0.1:{_free_port()}"
        procs = [_spawn(["entry", script, *_entry_argv(two, ["--coordinator", address, "--num-processes", "2",
                                                              "--process-id", str(r), *extra])])
                 for r in range(WORLD)]
        try:
            simple_main(default_argument_parser().parse_args(_entry_argv(one, extra)), entry.train, entry.test)
        finally:
            _wait(procs)

    try:
        run(["SOLVER.MAX_EPOCHS", "1"])
        run(["--resume", "SOLVER.MAX_EPOCHS", "2"])
        _compare_entry_point_runs(two / "Supervised_synthetic_quick", one / "Supervised_synthetic_quick")
    finally:  # four checkpoints of ~90 MB
        shutil.rmtree(two, ignore_errors=True)
        shutil.rmtree(one, ignore_errors=True)


def _compare_entry_point_runs(run_two_dir, run_one_dir):
    """The two-process run's files, step rows, evaluations and last checkpoint against the single one's."""
    assert sorted(os.listdir(run_two_dir)) == sorted(
        ["config.yaml", "last_checkpoint", "log.txt", "log.txt.rank1", "metrics.json", "model_0000.pth",
         "model_0001.pth"])
    steps2, evals2 = _rows(run_two_dir)
    steps1, evals1 = _rows(run_one_dir)
    assert [s[0] for s in steps2] == [s[0] for s in steps1] == [0, 1, 2, 3]
    steps2, steps1 = np.array(steps2)[:, 1:], np.array(steps1)[:, 1:]
    np.testing.assert_allclose(steps2[:, :2], steps1[:, :2], rtol=LOSS_RTOL)
    np.testing.assert_allclose(steps2[:, 2], steps1[:, 2], rtol=GRAD_NORM_RTOL)
    assert len(evals2) == len(evals1) == 2
    for e2, e1 in zip(evals2, evals1):
        assert e2.keys() == e1.keys() and e1
        np.testing.assert_allclose([e2[k] for k in e1], [e1[k] for k in e1], rtol=1e-4)
    final2 = torch.load(run_two_dir / "model_0001.pth", weights_only=True)
    final1 = torch.load(run_one_dir / "model_0001.pth", weights_only=True)
    assert final2["step"] == final1["step"] == 4
    for k, v in final1["model"].items():
        np.testing.assert_allclose(final2["model"][k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)


def test_single_process_path_is_the_plain_expression():
    """Without a process group the global reductions are the plain ones to the
    bit and issue nothing."""
    from simpledepthestimation_tpu_torch.parallel import mesh

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 1, 6, 7).astype(np.float32))
    mask = x > 0.3
    grouped = x.reshape(2, -1)
    mesh.reset_collective_counts()
    assert not mesh.is_global() and not mesh.is_multiprocess() and mesh.local_batch_size(8) == 8
    assert torch.equal(mesh.global_mean(x), x.mean())
    assert torch.equal(mesh.global_masked_means([x], mask)[0], (x * mask).sum() / mask.float().sum())
    assert all(torch.equal(a, b) for a, b in zip(mesh.global_mean_std(grouped, dim=1),
                                                 (grouped.mean(dim=1), grouped.std(dim=1))))
    assert torch.equal(mesh.rank_rows(x, blocks=2), x) and mesh.global_rows(4) == 4
    assert mesh.collective_counts == {"forward": 0, "backward": 0, "gradients": 0}


@pytest.mark.parametrize("rank", [0, 1])
def test_loaders_at_world_2_equal_the_jax_package(rank, monkeypatch):
    """Each rank's train loader (``IMS_PER_BATCH`` split in two, the rank-strided
    ``EpochSampler`` and ``TrainingSampler``) and test loader (``InferenceSampler``'s
    unequal shards, 5 frames: 3 and 2) against the JAX package's, with the rank and
    the world size of both packages' ``comm`` set to those of a world of 2."""
    from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
    from simpledepthestimation_tpu.data import build_test_loader as jax_test_loader
    from simpledepthestimation_tpu.data import build_train_loader as jax_train_loader
    from simpledepthestimation_tpu.utils import comm as jax_comm
    from simpledepthestimation_tpu_torch.config import get_cfg
    from simpledepthestimation_tpu_torch.data import build_test_loader, build_train_loader
    from simpledepthestimation_tpu_torch.utils import comm

    for module in (comm, jax_comm):
        monkeypatch.setattr(module, "get_world_size", lambda: WORLD)
        monkeypatch.setattr(module, "get_rank", lambda: rank)
    cfgs = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(os.path.join(REPO, "projects", "MonoDepth2", "configs", "synthetic_quick.yaml"))
        cfg.merge_from_list(["DATASETS.TRAIN.IMG_HEIGHT", 32, "DATASETS.TRAIN.IMG_WIDTH", 64, "DATASETS.TRAIN.LENGTH", 11,
                             "DATASETS.TEST.IMG_HEIGHT", 32, "DATASETS.TEST.IMG_WIDTH", 64, "DATASETS.TEST.LENGTH", 5,
                             "SOLVER.IMS_PER_BATCH", 4, "DATALOADER.NUM_WORKERS", 1])
        cfgs.append(cfg)
    for sampler in ("DDPSampler", "TrainingSampler"):
        for cfg in cfgs:
            cfg.DATALOADER.SAMPLER_TRAIN = sampler
        jl, tl = jax_train_loader(cfgs[0], seed=2), build_train_loader(cfgs[1], seed=2)
        assert tl.batch_size == jl.batch_size == 2
        if sampler == "DDPSampler":  # 11 frames padded to 12, 6 a rank: 3 batches an epoch
            for epoch in (0, 1):
                jl.set_epoch(epoch)
                tl.set_epoch(epoch)
                assert list(tl.sampler) == list(jl.sampler) and len(tl) == len(jl) == 3
                jb, tb = next(iter(jl)), next(iter(tl))
                np.testing.assert_array_equal(tb["img"].numpy().transpose(0, 2, 3, 1), jb["img"])
        else:
            take = lambda s: [i for _, i in zip(range(30), iter(s))]  # noqa: E731
            assert take(tl.sampler) == take(jl.sampler)
    jt, tt = jax_test_loader(cfgs[0]), build_test_loader(cfgs[1])
    assert list(tt.sampler) == list(jt.sampler) == ([0, 1, 2] if rank == 0 else [3, 4])
