"""BtsModel (``resnet50_bts``) in bfloat16: the port vs the JAX package on the CPU.

``tests/test_torch_bts.py``'s model, weights and batch (``bts_r50.yaml`` at
``BTS_SIZE`` 128, B=2, 224x320) with ``TPU.COMPUTE_DTYPE bfloat16`` on both
sides; the JAX function is compiled with ``xla_allow_excess_precision`` off, so
that it rounds where its source says (``tests/test_torch_bf16_parity.py``'s
pattern), and the port run in float32 on the same weights is the control.

The median pixel, ``test_torch_bf16_parity.py``'s check, cannot be the check
here: a rounding flip of one convolution moves the next one's sums, and
BTS-R50 chains some 70 convolutions, so by the last one most pixels sit one
bfloat16 step apart (median 5.2e-4, the port in float32 6.1e-4, on an
8-core Intel Xeon CPU). What stays sharp is the share of depth pixels on the
JAX package's own value (within 1e-6): 14.8 % in bfloat16, 0.096 % for the port in
float32 (limit 5 %). The loss: 4.6e-5 (limit 2e-4); the float32 port's 7.3e-5
passes that too, so the share is the control's check.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.flax_import import load_flax_variables

from torch_port_helpers import batch_to_torch, make_sup_batch, nhwc, shared_variables, supervised_cfgs

B, H, W = 2, 224, 320
OVERRIDES = ["MODEL.DEPTH_NET.BTS_SIZE", "128"]
BF16_LOSS_RTOL, BF16_SAME_SHARE = 2e-4, 0.05  # measured: module docstring
ROUND_AS_WRITTEN = {"xla_allow_excess_precision": False}


def _cfgs(dtype):
    return supervised_cfgs("bts_r50.yaml", OVERRIDES + ["TPU.COMPUTE_DTYPE", dtype])


@pytest.fixture(scope="module")
def bf16():
    """(loss, depth) of the JAX package in bfloat16, the port in bfloat16 and in float32,
    on ``tests/test_torch_bts.py``'s weights and batch."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    port = build_model(_cfgs("float32")[1], device="cpu", generator=torch.Generator().manual_seed(0))
    variables = shared_variables(port, cfg_j)
    batch = make_sup_batch(seed=5, B=B, H=H, W=W, flip=(False, True))
    model_j = build_model_jax(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_fn(v, b):
        out, _ = model_j.apply(v, b, train=True, mutable=["batch_stats"])
        return out["silog_loss"], model_j.apply(v, b, train=False)["depth_pred"]

    loss, depth = jax.jit(jax_fn).lower(variables, jb).compile(compiler_options=ROUND_AS_WRITTEN)(variables, jb)
    port = build_model(cfg_t, device="cpu")
    load_flax_variables(port, variables["params"], variables["batch_stats"])
    port_f32 = build_model(_cfgs("float32")[1], device="cpu")
    port_f32.load_state_dict(port.state_dict())
    tb = batch_to_torch(batch)
    out = {"jax": (float(loss), np.asarray(depth))}
    for key, model in (("port_bf16", port), ("port_f32", port_f32)):
        with torch.no_grad():
            depth_t = model(tb, train=False)["depth_pred"]
            loss_t = model(tb, train=True)["silog_loss"]
        out[key] = (float(loss_t), nhwc(depth_t))
    return out


def _bf16_errs(got, ref):
    """Loss relative error; share of depth pixels within 1e-6 of the reference (relative)."""
    rel = np.abs(got[1] - ref[1]) / np.abs(ref[1])
    return abs(got[0] - ref[0]) / abs(ref[0]), float((rel <= 1e-6).mean())


def test_bf16_loss_and_depth_match_jax(bf16):
    loss_err, same = _bf16_errs(bf16["port_bf16"], bf16["jax"])
    assert np.isfinite(bf16["port_bf16"][1]).all()
    assert loss_err <= BF16_LOSS_RTOL and same >= BF16_SAME_SHARE, (loss_err, same)


def test_float32_port_fails_the_bf16_checks(bf16):
    """The control: the port in float32 on the same weights puts almost no pixel
    on the JAX package's bfloat16 values."""
    _, same = _bf16_errs(bf16["port_f32"], bf16["jax"])
    assert same < BF16_SAME_SHARE, same
