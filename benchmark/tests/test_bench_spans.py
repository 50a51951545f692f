"""The readers of the port's spans (``core/spans.py`` and the six metrics that
use it) on traces built by hand, on a program without the spans and in a CPU
rehearsal: each reads what was worked out by hand where its spans are there,
and ``None`` where they are not, so the result line simply lacks it."""

import ast
import json
import os

import pytest

from conftest import BENCH

SPAN_METRICS = ("nets.depth_fwd_ms.train", "nets.pose_fwd_ms.train", "nets.norm_fwd_ms.train",
                "loss.fwd_ms.train", "step.backward_ms.train", "loss.launches.train")
STEP = 100.0  # us between the two steps' starts


def one_step(t):
    """The annotations and device operations of one step starting at ``t`` us:
    the forward (depth net with two BatchNorms, pose net with a GroupNorm,
    the loss with an idle gap), the backward, the grad norm and Adam; a
    side-stream copy overlaps the depth and pose nets."""
    annotations = [
        ("train_step.forward", 0, 41), ("meta_arch.depth_net", 2, 20), ("norm.batch_norm", 5, 7),
        ("norm.batch_norm", 12, 14), ("meta_arch.pose_net", 20, 26), ("norm.group_norm", 22, 23),
        ("meta_arch.loss", 26, 40), ("train_step.backward", 41, 42), ("train_step.grad_norm", 81, 83),
        ("Optimizer.step#Adam.step", 84, 90)]
    ops = [
        ("normalize", 0, 1), ("normalize", 1, 2),
        ("conv", 2, 5), ("batch_norm", 5, 7), ("conv", 7, 12), ("batch_norm", 12, 14), ("conv", 14, 20),
        ("cat", 20, 21), ("conv", 21, 22), ("group_norm", 22, 23), ("conv", 23, 26),
        ("warp_bilinear_fwd", 26, 30), ("photometric_map_fwd", 30, 31), ("amin", 33, 40),  # idle 31-33
        ("sum", 40, 41),
        ("fill", 41, 42), ("conv_dgrad", 43, 60), ("batch_norm_backward", 60, 80),  # idle 42-43
        ("foreach_norm", 81, 83), ("adam", 84, 90),
        ("Memcpy HtoD (Pinned -> Device)", 10, 25), ("Memcpy HtoD (Pinned -> Device)", 50, 70)]
    shift = lambda items: [(n, s + t, e + t) for n, s, e in items]  # noqa: E731
    return shift(annotations), shift(ops)


# per step, by hand: depth 2-20 (18 us); pose 20-26 (6); norms 2+2+1 (5); loss 4+1+7 (12, the
# gap left out); loss operations 3; backward from the forward's end (41) to the grad norm (81):
# the seed's fill, the two backward kernels (1+17+20 = 38; the copies left out, Adam not)
BY_HAND = {"nets.depth_fwd_ms.train": 0.018, "nets.pose_fwd_ms.train": 0.006, "nets.norm_fwd_ms.train": 0.005,
           "loss.fwd_ms.train": 0.012, "step.backward_ms.train": 0.038, "loss.launches.train": 3.0}


def hand_run(keep=None, steps=2):
    """A ``Run`` with the card's and the host's stretch of ``steps`` steps;
    only the annotations named in ``keep`` (all where ``None``)."""
    from core.trace import Trace
    from drivers.train import Run

    annotations, ops = [], []
    for k in range(steps):
        a, o = one_step(k * STEP)
        annotations += a
        ops += o
    if keep is not None:
        annotations = [a for a in annotations if a[0] in keep]
    window = (0.0, steps * STEP)
    host_ops = [(name, s, e) for name, s, e in annotations]  # the spans' CPU ranges, near enough
    device = Trace(window=window, device_ops=list(ops), annotations=[])
    host = Trace(window=window, device_ops=list(ops), annotations=annotations, host_ops=host_ops)
    return Run(config={}, mix={}, images_per_s=1.0, enqueue_ms=[1.0], h2d_ms=[], trace=device, traced_steps=steps,
               host_trace=host, host_traced_steps=steps)


def read(name, run):
    import run as harness

    return harness.reader(name)(run)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_against_numbers_by_hand(name):
    assert read(name, hand_run()) == pytest.approx(BY_HAND[name], rel=1e-12)


def test_backward_keeps_to_its_step():
    """Each step's backward runs from that step's forward to that step's grad
    norm: one step reads what two read a step. Without ``train_step.forward``
    the nested ``meta_arch.*`` ranges still end the forward, at the loss's
    end, and the total loss's sum (1 us) then counts in the backward."""
    assert read("step.backward_ms.train", hand_run(steps=1)) == pytest.approx(0.038)
    nested_only = set(a[0] for a in one_step(0)[0]) - {"train_step.forward"}
    assert read("step.backward_ms.train", hand_run(keep=nested_only)) == pytest.approx(0.039)


# which of the six a trace holding only some spans still reads
PARTIAL = [
    ((), ()),  # the parent's program: only Adam's own range
    (("train_step.forward",), ()),
    (("train_step.grad_norm",), ()),
    (("meta_arch.depth_net",), ("nets.depth_fwd_ms.train",)),
    (("norm.group_norm",), ("nets.norm_fwd_ms.train",)),
    (("meta_arch.loss",), ("loss.fwd_ms.train", "loss.launches.train")),
    (("train_step.forward", "train_step.grad_norm"), ("step.backward_ms.train",)),
]


@pytest.mark.parametrize("spans,reads", PARTIAL)
def test_absent_spans_read_none(spans, reads):
    run = hand_run(keep=set(spans) | {"Optimizer.step#Adam.step"})
    for name in SPAN_METRICS:
        value = read(name, run)
        assert (value is not None) is (name in reads), (name, value)


def test_no_stretch_reads_none():
    run = hand_run()
    run.host_trace, run.host_traced_steps = None, 0
    assert all(read(name, run) is None for name in SPAN_METRICS)


def test_rehearsal_reads_none(bench):
    """A CPU rehearsal records no GPU range: every new reader reads ``None``."""
    from test_bench_harness import rehearsal

    _, out, _, _ = rehearsal(bench, "md2_r18.train_b96", True)
    assert all(read(name, out["run"]) is None for name in SPAN_METRICS)


@pytest.mark.parametrize("spans", [False, True])
def test_result_line_lacks_what_is_absent(bench, capsys, spans):
    """``run.py`` with ``--trace 1`` on a hand-built run: without the spans
    (the parent's program) the line simply lacks the six metrics; with them
    it has all six."""
    import run as harness

    cell = next(w for w in bench["workloads"] if w["name"] == "md2_r18.train_b96")
    run = hand_run(keep=None if spans else {"Optimizer.step#Adam.step"})
    run.mix = {"batch": 96, "contexts": 2, "height": 192, "width": 640}
    run.config = {"cfg": json.load(open(os.path.join(BENCH, "configs", "md2_r18.json")))["cfg"]}
    limits = {"loss_gap": 0.07}
    out = {"correct": True, "attempted": 1, "failed": 0, "run": run, "check": {"loss_gap": 0.0},
           "readings": {"loss_gap": 0.0}, "notes": []}
    device = {"platform": "gpu", "kind": "by hand", "count": 1, "memory_peak_bytes": 0}
    assert harness.report(bench, cell, out, True, device, limits) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(SPAN_METRICS) & set(line["metrics"]) == (set(SPAN_METRICS) if spans else set())
    assert "optimizer.device_ms.train" in line["metrics"]
    if spans:
        assert {k: line["metrics"][k]["value"] for k in SPAN_METRICS} == pytest.approx(BY_HAND)


def test_readers_import_nothing_of_the_port():
    """The six readers and ``core/spans.py`` import only the harness's own
    ``core`` and the standard library."""
    files = [os.path.join(BENCH, "metrics", f"{name}.py") for name in SPAN_METRICS]
    for path in files + [os.path.join(BENCH, "core", "spans.py")]:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.module.split(".")[0] in ("core", "__future__", "typing"), (path, node.module)
            assert not isinstance(node, ast.Import), path
