"""The port's profiler spans (``utils/tracing.py``), on the CPU at a tiny size.

Two MonoDepth2-R18 train steps (float32, B=2, 64x128, N=2) under
``torch.profiler``: each span of the train step and of the meta-architecture
appears once a step, each norm span once a norm layer's call, the
meta-architecture's spans inside the step's forward. With no profiler a span
never enters ``record_function``. Losses, gradients, parameters and running
statistics are the same to the bit with the profiler on and off, on
MonoDepth2 and on PackNet's residual block (its GroupNorm path).
"""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.models import packnet
from simpledepthestimation_tpu_torch.models.norm_layers import BatchNorm2d, GroupNorm
from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

from torch_port_helpers import REPO, batch_to_torch, make_batch

B, H, W, N = 2, 64, 128, 2
STEPS = 2
STEP_SPANS = ("train_step.forward", "train_step.backward", "train_step.grad_norm")
META_SPANS = ("meta_arch.depth_net", "meta_arch.pose_net", "meta_arch.loss")
NORM_SPANS = {"norm.batch_norm": BatchNorm2d, "norm.group_norm": GroupNorm}


def _monodepth2():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "projects", "MonoDepth2", "configs", "resnet18.yaml"))
    cfg.merge_from_list(["MODEL.DEPTH_NET.ENCODER_NAME", "18", "TPU.COMPUTE_DTYPE", "float32"])
    state = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0), steps_per_epoch=2)
    return state, make_train_step(state)


def _batches():
    return [batch_to_torch(make_batch(seed=20 + i, B=B, H=H, W=W, N=N, smooth=True)) for i in range(STEPS)]


def _steps(profiled):
    """Two train steps from the same weights and batches; the profiler's
    events (None without it) and everything the steps computed."""
    state, step = _monodepth2()
    batches = _batches()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            metrics = [step(b) for b in batches]
        events = prof.events()
    else:
        metrics, events = [step(b) for b in batches], None
    params = dict(state.model.named_parameters())
    return events, state.model, {
        "metrics": [{k: v.clone() for k, v in m.items()} for m in metrics],
        "grads": {n: p.grad.clone() for n, p in params.items() if p.grad is not None},
        "params": {n: p.detach().clone() for n, p in params.items()},
        "buffers": {n: b.clone() for n, b in state.model.named_buffers()},
    }


@pytest.fixture(scope="module")
def runs():
    return _steps(profiled=True), _steps(profiled=False)


def _ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]


def test_each_span_once_a_step_and_nested(runs):
    (events, model, _), _ = runs
    for name in STEP_SPANS + META_SPANS:
        assert len(_ranges(events, name)) == STEPS, name
    for name, cls in NORM_SPANS.items():
        calls = sum(isinstance(m, cls) for m in model.modules())
        assert calls > 0 and len(_ranges(events, name)) == STEPS * calls, name
    forwards = _ranges(events, "train_step.forward")
    for name in META_SPANS + tuple(NORM_SPANS):
        for s, e in _ranges(events, name):
            assert any(fs <= s and e <= fe for fs, fe in forwards), name
    nets = _ranges(events, "meta_arch.depth_net") + _ranges(events, "meta_arch.pose_net")
    for name in NORM_SPANS:  # each norm inside one of the nets
        assert all(any(ns <= s and e <= ne for ns, ne in nets) for s, e in _ranges(events, name)), name


def test_spans_change_no_number(runs):
    (_, _, on), (_, _, off) = runs
    assert [m.keys() for m in on["metrics"]] == [m.keys() for m in off["metrics"]]
    for a, b in zip(on["metrics"], off["metrics"]):
        assert all(torch.equal(a[k], b[k]) for k in a), a
    for part in ("grads", "params", "buffers"):
        assert on[part].keys() == off[part].keys() and on[part]
        for name in on[part]:
            assert torch.equal(on[part][name], off[part][name]), (part, name)


def test_no_profiler_no_record_function(monkeypatch):
    """Without a profiler a span is the shared no-op context; with one, each
    span enters ``record_function`` (counted by a stand-in)."""
    from simpledepthestimation_tpu_torch.utils import tracing

    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    state, step = _monodepth2()
    batch = _batches()[0]
    step(batch)
    assert entered == [] and tracing.span("meta_arch.loss") is tracing.span("norm.batch_norm")
    with profile(activities=[ProfilerActivity.CPU]):
        step(batch)
    assert set(STEP_SPANS + META_SPANS + tuple(NORM_SPANS)) <= set(entered)


def test_packnet_group_norm_spans_change_no_number():
    """PackNet's residual block (three GroupNorms a ResidualConv) in training,
    forward and backward, with the profiler on and off."""

    def run(profiled):
        torch.manual_seed(0)
        block = packnet.ResidualBlock(16, 32, num_blocks=2, stride=2)
        x = torch.randn(2, 16, 32, 32, generator=torch.Generator().manual_seed(1))
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out = block(x)
                out.square().sum().backward()
            assert len(_ranges(prof.events(), "norm.group_norm")) == 6
        else:
            out = block(x)
            out.square().sum().backward()
        return [out.detach()] + [p.grad for p in block.parameters()]

    on, off = run(True), run(False)
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))
