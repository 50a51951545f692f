"""One rank of the port's multi-process checks (``tests/test_torch_parallel.py``).

    python tests/torch_parallel_worker.py <rank> <world> <host:port> <out_dir>
    python tests/torch_parallel_worker.py entry <script> <arguments>

joins a gloo group on the CPU (every collective with a timeout), runs the
cases below on its rows of each global batch and writes what it computed to
``<out_dir>/rank<rank>.pt``. The inputs are made here from seeds with numpy,
so that the test process builds the same global batches for world 1 and the
JAX package. The case functions take the rank's rows; the test process calls
them with the whole global batch and no process group (world 1). The second
form runs an entry point (``projects/*/train_torch.py``) as ``__main__``.
Nothing here imports JAX.
"""

import datetime
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port_helpers import REPO, batch_to_torch, make_batch, make_sup_batch, smooth_field  # noqa: E402

TIMEOUT_S = 120
GLOBAL_B = 4  # the train steps' global batch: 2 rows a rank at world 2


def rows(x, rank, world, blocks=1):
    """Rank ``rank``'s rows of global ``x`` (``blocks`` stacked global batches)."""
    per = x.shape[0] // (blocks * world)
    parts = [x[j * per * world + rank * per: j * per * world + (rank + 1) * per] for j in range(blocks)]
    return parts[0] if blocks == 1 else (torch.cat(parts) if isinstance(x, torch.Tensor) else np.concatenate(parts))


def batch_rows(batch, rank, world):
    return {k: rows(v, rank, world) if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}


# -- (b) BatchNorm ----------------------------------------------------------

def bn_inputs(seed=0, offset=30.0):
    """Post-ReLU-like activations (NCHW [8,6,5,7]) around ``offset`` (far from
    zero, where E[x²] − E[x]² cancels in float32), the affine parameters and a
    cotangent."""
    rng = np.random.RandomState(seed)
    x = (np.maximum(rng.randn(8, 6, 5, 7), 0.0) * 2.0 + offset + rng.rand(1, 6, 1, 1) * 5).astype(np.float32)
    weight = (1.0 + 0.3 * rng.randn(6)).astype(np.float32)
    bias = (0.2 * rng.randn(6)).astype(np.float32)
    cot = rng.randn(8, 6, 5, 7).astype(np.float32)
    return x, weight, bias, cot


def bn_case(x, weight, bias, cot):
    """A train-mode ``BatchNorm2d`` on rows ``x``: output, running statistics,
    and the gradients of Σ out·cot over the global batch (affine: summed over
    ranks)."""
    from simpledepthestimation_tpu_torch.models.norm_layers import BatchNorm2d
    from simpledepthestimation_tpu_torch.parallel import mesh

    bn = BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    out = bn(xt, train=True)
    mesh.backward(mesh.global_sum((out * torch.from_numpy(cot)).sum()))
    mesh.sum_gradients([bn.weight.grad, bn.bias.grad])
    return {"out": out.detach().numpy(), "running_mean": bn.running_mean.numpy().copy(),
            "running_var": bn.running_var.numpy().copy(), "x_grad": xt.grad.numpy(),
            "weight_grad": bn.weight.grad.numpy(), "bias_grad": bn.bias.grad.numpy()}


# -- (c) eager loss functions -----------------------------------------------

def loss_inputs(seed=1):
    """Global inputs of the loss checks: depth [4,1,16,24] (and a second
    frame's), ground truth with a third at or below 1, a photometric map of two
    groups [2·4,1,16,24] from two frames, cotangents."""
    rng = np.random.RandomState(seed)
    est = (1.0 + 30.0 * smooth_field(rng, 4, 16, 24, 1)).transpose(0, 3, 1, 2).astype(np.float32)
    est2 = (2.0 + 20.0 * smooth_field(rng, 4, 16, 24, 1)).transpose(0, 3, 1, 2).astype(np.float32)
    gt = (1.5 + 38.0 * rng.rand(4, 1, 16, 24)).astype(np.float32)
    gt[rng.rand(4, 1, 16, 24) < 1 / 3] = 0.5
    frame = rng.rand(8, 3, 16, 24).astype(np.float32)
    sampled = rng.rand(8, 3, 16, 24).astype(np.float32)
    cot = rng.randn(8, 1, 16, 24).astype(np.float32)
    return {"est": est, "est2": est2, "gt": gt, "frame": frame, "sampled": sampled, "cot": cot}


def loss_case(inp, rank=0, world=1):
    """``silog_loss``, ``variance_loss``, ``MonoDepth2Model._clip`` (two groups,
    λ 0.5, after the L1 map) and MotionLearning's ``SCALE_NORMALIZE`` depth mean
    on the rank's rows, each with the gradient of a global function of it."""
    from simpledepthestimation_tpu_torch.models import losses as L
    from simpledepthestimation_tpu_torch.models.meta_arch import MonoDepth2Model
    from simpledepthestimation_tpu_torch.parallel import mesh

    def t(name, blocks=1):
        return rows(torch.from_numpy(inp[name]), rank, world, blocks).clone().requires_grad_()

    out = {}
    est, gt = t("est"), rows(torch.from_numpy(inp["gt"]), rank, world)
    value = L.silog_loss(est, gt)
    mesh.backward(value)
    out["silog"], out["silog_grad"] = value.item(), est.grad.numpy()

    est = t("est")
    value = L.variance_loss(est)
    mesh.backward(value)
    out["variance"], out["variance_grad"] = value.item(), est.grad.numpy()

    model = MonoDepth2Model(torch.nn.Identity(), torch.nn.Identity(), ssim_weight=0.0, clip_loss=0.5)
    frame, sampled = t("frame", 2), t("sampled", 2)
    clipped = model._clip(model._photometric_map(frame, sampled), n_groups=2)
    mesh.backward(mesh.global_sum((clipped * rows(torch.from_numpy(inp["cot"]), rank, world, 2)).sum()))
    out["clip"], out["clip_grad"] = clipped.detach().numpy(), sampled.grad.numpy()

    rd1, rd2 = t("est"), t("est2")
    depth_mean = mesh.global_mean(torch.cat([rd1, rd2], dim=0))
    normalized = mesh.global_mean((rd1 / depth_mean) ** 2) + mesh.global_mean((rd2 / depth_mean) ** 3)
    mesh.backward(normalized)
    out["depth_mean"], out["depth_mean_grads"] = depth_mean.item(), np.concatenate([rd1.grad, rd2.grad])
    return out


# -- (d) train steps ----------------------------------------------------------

def step_cfg(family):
    """The step's config (float32, random-init encoder): SupDepthModel
    DepthResNet-18, MonoDepth2-R18 with the photometric clip and the variance
    loss on, MotionLearning-R18 with RandLayerNorm noise 0.5 from the first step
    and ``SCALE_NORMALIZE``."""
    from simpledepthestimation_tpu_torch.config import get_cfg

    yaml, opts = {
        "supervised": ("Supervised/configs/synthetic_quick.yaml", []),
        "monodepth2": ("MonoDepth2/configs/resnet18.yaml",
                       ["MODEL.DEPTH_NET.ENCODER_NAME", "18", "LOSS.CLIP", 0.5, "LOSS.VAR_LOSS_WEIGHT", 0.01]),
        "motion": ("MotionLearning/configs/resnet18.yaml",
                   ["MODEL.DEPTH_NET.ENCODER_NAME", "18", "MODEL.DEPTH_NET.RAMPUP_ITERS", 1,
                    "MODEL.POSE_NET.BURN_IN_ITERS", 0, "LOSS.SCALE_NORMALIZE", True]),
    }[family]
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "projects", yaml))
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", *opts])
    return cfg


def step_batch(family):
    """The global batch of ``family``'s step (torch, NCHW)."""
    if family == "supervised":
        return batch_to_torch(make_sup_batch(seed=5, B=GLOBAL_B, H=64, W=96, flip=[False, True, True, False]))
    if family == "monodepth2":
        return batch_to_torch(make_batch(seed=6, B=GLOBAL_B, H=64, W=128, smooth=True, flip=[False, True, False, True]))
    rng = np.random.RandomState(7)
    H, W = 64, 96
    img = smooth_field(rng, GLOBAL_B, H, W, 3)
    ctx = (np.roll(img, 2, axis=2)[:, None] + 0.01 * rng.rand(GLOBAL_B, 1, H, W, 3)).astype(np.float32)
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (GLOBAL_B, 1, 1))
    return batch_to_torch({"img": img, "ctx_img": ctx, "intrinsics": K, "flip": np.array([False, True, True, False])})


def step_case(family, batch, remat=False, keep_state=True):
    """One train step of ``family`` on ``batch`` (the rank's rows): metrics, the
    digest of the state after it (and with ``keep_state`` the state itself:
    parameters and running statistics), and the collectives it issued."""
    from simpledepthestimation_tpu_torch.models import make_schedule_fn
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step, mesh

    cfg = step_cfg(family)
    state = create_train_state(cfg, device="cpu", steps_per_epoch=1, warm_start=False)
    mesh.check_replicas_agree(state.model)
    schedule = make_schedule_fn(cfg) if family == "motion" else None
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.get("GRAD_CLIP", 0.0)), schedule_fn=schedule,
                           remat=remat)
    mesh.reset_collective_counts()
    t0 = time.perf_counter()
    metrics = step(batch)
    seconds = time.perf_counter() - t0
    out = {"metrics": {k: v.item() for k, v in metrics.items()}, "digest": mesh.state_digest(state.model),
           "collectives": dict(mesh.collective_counts), "seconds": seconds}
    if keep_state:
        out["state"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return out


# -- (e) PreciseBN ------------------------------------------------------------

def precise_bn_batches(rank):
    """Two batches of rank ``rank``'s own loader shard (SupDepthModel, B=2)."""
    return [batch_to_torch(make_sup_batch(seed=20 + 2 * rank + i, B=2, H=64, W=96)) for i in range(2)]


def precise_bn_case(batches):
    """The PreciseBN hook's update (``compute_precise_bn_stats``, then the mean
    over ranks) of the supervised step's fresh state: its running statistics."""
    from simpledepthestimation_tpu_torch.engine.hooks import average_over_ranks
    from simpledepthestimation_tpu_torch.parallel import compute_precise_bn_stats, create_train_state

    state = create_train_state(step_cfg("supervised"), device="cpu", steps_per_epoch=1, warm_start=False)
    compute_precise_bn_stats(state, batches)
    average_over_ranks(state.model)
    return {k: v.numpy().copy() for k, v in state.model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


# -- (a) comm -------------------------------------------------------------------

def comm_case(rank, world):
    from simpledepthestimation_tpu_torch.config import get_cfg
    from simpledepthestimation_tpu_torch.evaluation.depth_evaluation import kitti_evaluator
    from simpledepthestimation_tpu_torch.parallel import mesh
    from simpledepthestimation_tpu_torch.utils import comm

    gathered = comm.all_gather({"rank": rank, "blob": "x" * (10 + rank * 100)})
    evaluator = kitti_evaluator(get_cfg(), output_folder=None)
    evaluator.reset()
    evaluator.metrics = [tuple(np.full(9, float(rank)))]  # a fabricated metric row encoding the rank
    try:
        mesh.local_batch_size(3)
        split_error = None
    except ValueError as e:
        split_error = str(e)
    out = {
        "world": comm.get_world_size(), "rank": comm.get_rank(), "local_rank": comm.get_local_rank(),
        "gathered": gathered, "gather": comm.gather(rank * 10), "reduced": comm.reduce_dict({"loss": float(rank + 1)}),
        "summed": comm.reduce_dict({"loss": float(rank + 1)}, average=False), "seed": comm.shared_random_seed(),
        "evaluated": evaluator.evaluate(), "is_global": mesh.is_global(), "multiprocess": mesh.is_multiprocess(),
        "local_batch": mesh.local_batch_size(8), "split_error": split_error,
    }
    comm.synchronize()
    return out


def run_entry_point(script, argv):
    """``script`` (an entry point) run as ``__main__`` with ``argv``, without a
    tensorboard writer (importing it takes seconds here; ``metrics.json`` is
    what the checks read)."""
    import runpy

    from simpledepthestimation_tpu_torch.engine import defaults

    defaults.tensorboard_writer_or_none = lambda *a, **k: None
    sys.argv = [script, *argv]
    runpy.run_path(script, run_name="__main__")


def main():
    if sys.argv[1] == "entry":  # python tests/torch_parallel_worker.py entry <script> <arguments>
        torch.set_num_threads(2)
        run_entry_point(sys.argv[2], sys.argv[3:])
        return
    rank, world, address, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(2)  # the test process's count (torch_port_helpers): the same convolution algorithms
    from simpledepthestimation_tpu_torch.utils import comm

    comm.init_process_group(f"tcp://{address}", world_size=world, rank=rank, backend="gloo",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    result = {"comm": comm_case(rank, world)}
    for key, offset in (("bn", 30.0), ("bn_sync", 0.0)):
        x, weight, bias, cot = bn_inputs(offset=offset)
        result[key] = bn_case(rows(x, rank, world), weight, bias, rows(cot, rank, world))
    result["losses"] = loss_case(loss_inputs(), rank, world)
    # the state itself from rank 0 only; MotionLearning under TPU.REMAT, which recomputes every block in
    # the backward: the noise rows of its stacked batch are drawn again, as in the forward
    for family in ("supervised", "monodepth2", "motion"):
        result[family] = step_case(family, batch_rows(step_batch(family), rank, world), remat=family == "motion",
                                   keep_state=rank == 0)
    result["precise_bn"] = precise_bn_case(precise_bn_batches(rank))

    # a rank that goes missing: the other fails at the group's timeout instead of hanging
    import torch.distributed as dist

    lost = dist.new_group(timeout=datetime.timedelta(seconds=1))
    if rank == 0:
        t0 = time.perf_counter()
        try:
            dist.all_reduce(torch.ones(1), group=lost)
            result["lost_rank"] = {"raised": None}
        except RuntimeError as e:
            result["lost_rank"] = {"raised": type(e).__name__, "seconds": time.perf_counter() - t0}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    print(f"RANK{rank}_DONE", flush=True)
    os._exit(0)  # the group of the missing rank is left as it is


if __name__ == "__main__":
    main()
