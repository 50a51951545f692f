"""Normalization and compute-dtype layer variants.

Counterpart of ``simpledepthestimation_tpu/models/norm_layers.py`` as far as
the MonoDepth2 forward uses it (the frozen/sync/TF-padding variants are not
ported yet: nothing ported uses them), plus the casting layers that carry the
compute-dtype policy of the port:

- ``Conv2d``: an ``nn.Conv2d`` whose parameters stay float32 and whose
  convolution runs in ``compute_dtype`` by **explicit casts** of input, weight
  and bias (not autocast), so that nothing outside the convolutions changes
  dtype behind the caller's back. Output is ``compute_dtype``. Below float32
  the bias is added to the rounded convolution, in ``compute_dtype``, as
  ``flax.linen.Conv`` adds it (and as cuDNN's path does); a bias folded into
  the convolution would round once where the JAX package rounds twice. In
  float32 the bias stays folded in (a last-bit difference only).
- ``BatchNorm2d`` / ``GroupNorm``: compute in float32 whatever they are fed,
  and return float32. ``BatchNorm2d.forward(x, train)`` takes the mode as an
  argument, as the JAX modules do; ``nn.Module.train()`` is not consulted.
  ``momentum`` and ``eps`` are the constructor's (torch's convention: momentum
  0.1 equals Flax's 0.9, 0.01 equals BTS's 0.99; the two are one minus the other).
  The running variance folds in the *biased* batch variance, as
  ``flax.linen.BatchNorm`` does (``F.batch_norm`` would fold in the unbiased
  one, a factor n/(n−1) on the update term), so that a trained model's
  ``train=False`` output equals the JAX package's. Inside
  :func:`statistics_frozen` a train-mode BatchNorm normalises as always but
  leaves its running statistics alone: the recomputation of an
  activation-checkpointed forward (``TPU.REMAT``) runs every BatchNorm a
  second time, and JAX's functional ``jax.checkpoint`` updates them once.

In a run of several processes (``parallel.mesh.is_global()``) a train-mode
``BatchNorm2d`` normalises with the global batch's statistics, as every
BatchNorm of the JAX package's global program does, and folds the biased
global variance into its running statistics, so these stay equal on every
rank (:class:`_GlobalBatchNorm`: one collective forward, one backward, and
again in a ``TPU.REMAT`` recomputation, in the same order on every rank).
Eval mode issues no collective: the evaluation's shards are unequal.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh
from ..utils.tracing import span


class _CastingConv:
    """The compute-dtype rule of :class:`Conv2d` and :class:`Conv3d`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, xavier: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.xavier = xavier

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.bias is None or dt == torch.float32:
            bias = None if self.bias is None else self.bias.to(dt)
            return self._conv_forward(x.to(dt), self.weight.to(dt), bias)
        out = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return out + self.bias.to(dt).view(-1, *([1] * (out.dim() - 2)))


class Conv2d(_CastingConv, nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` with float32 parameters.
    ``xavier=True`` marks a kernel that ``models.build.init_weights`` draws
    Xavier-uniform (where the JAX module names ``xavier_uniform``) instead of
    N(0, 1/fan_in)."""


class Conv3d(_CastingConv, nn.Conv3d):
    """``nn.Conv3d`` under :class:`Conv2d`'s rule (PackNet's packed convolution)."""


_frozen = threading.local()


@contextlib.contextmanager
def statistics_frozen():
    """Within this context a train-mode ``BatchNorm2d`` does not update its
    running statistics. The flag is the entering thread's: a checkpoint's
    recomputation enters it on the thread of the backward that needs it."""
    depth = getattr(_frozen, "depth", 0)
    _frozen.depth = depth + 1
    try:
        yield
    finally:
        _frozen.depth = depth


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of ``x`` [B,C,H,W] float32 over the global batch.

    Forward: each rank's count, mean and centred second moment per channel,
    gathered in one all-reduce (``mesh.gather_rows``) and combined in float64
    in rank order (Chan's parallel rule: no E[x²] − E[x]², which cancels on
    post-ReLU activations). Backward: the global Σdy and Σdy·x̂ in one
    all-reduce; the affine gradients are the rank's own sums, which the step
    sums over ranks. Returns the output, the global mean and the biased global
    variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        n = x.numel() // x.shape[1]
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        parts = mesh.gather_rows(torch.stack([torch.full_like(mean, n), mean, var * n]))  # [world, 3, C]
        parts = parts.double()
        counts, means, m2s = parts[:, 0], parts[:, 1], parts[:, 2]
        total = counts.sum(0)
        g_mean = (counts * means).sum(0) / total
        g_var = (m2s.sum(0) + (counts * (means - g_mean) ** 2).sum(0)) / total
        g_mean, g_var, total = g_mean.float(), g_var.float(), total.float()
        invstd = torch.rsqrt(g_var + eps)
        out = (x - g_mean[None, :, None, None]) * (invstd * weight)[None, :, None, None] + bias[None, :, None, None]
        ctx.save_for_backward(x, weight, g_mean, invstd, total)
        ctx.mark_non_differentiable(g_mean, g_var)
        return out, g_mean, g_var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, total = ctx.saved_tensors
        xhat = (x - mean[None, :, None, None]) * invstd[None, :, None, None]
        sum_dy = dy.sum(dim=(0, 2, 3))
        sum_dy_xhat = (dy * xhat).sum(dim=(0, 2, 3))
        g_dy, g_dy_xhat = mesh.all_reduce_sum(torch.stack([sum_dy, sum_dy_xhat]), "backward").unbind()
        dx = (dy - (g_dy / total)[None, :, None, None] - xhat * (g_dy_xhat / total)[None, :, None, None]) \
            * (weight * invstd)[None, :, None, None]
        return dx, sum_dy_xhat, sum_dy, None


class BatchNorm2d(nn.BatchNorm2d):
    """float32 batch norm with an explicit ``train`` argument."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        with span("norm.batch_norm"):
            if not train:
                return F.batch_norm(
                    x.float(), self.running_mean, self.running_var, self.weight, self.bias,
                    training=False, momentum=self.momentum, eps=self.eps,
                )
            if mesh.is_global():
                out, mean, var = _GlobalBatchNorm.apply(x.float(), self.weight, self.bias, self.eps)
            else:
                # the statistics are updated by hand from the batch mean and the biased
                # batch variance (1/invstd² − eps) that the normalisation saves anyway
                out, mean, invstd = torch.native_batch_norm(
                    x.float(), self.weight, self.bias, None, None, True, self.momentum, self.eps
                )
                var = None
            if getattr(_frozen, "depth", 0):
                return out
            with torch.no_grad():
                self.num_batches_tracked += 1
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(invstd.pow(-2).sub_(self.eps) if var is None else var, self.momentum)
            return out


class GroupNorm(nn.GroupNorm):
    """float32 group norm."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm.group_norm"):
            return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
