"""Normalization and compute-dtype layer variants.

Counterpart of ``simpledepthestimation_tpu/models/norm_layers.py`` as far as
the MonoDepth2 forward uses it (the frozen/sync/TF-padding variants are not
ported yet: nothing ported uses them), plus the casting layers that carry the
compute-dtype policy of the port:

- ``Conv2d``: an ``nn.Conv2d`` whose parameters stay float32 and whose
  convolution runs in ``compute_dtype`` by **explicit casts** of input, weight
  and bias (not autocast), so that nothing outside the convolutions changes
  dtype behind the caller's back. Output is ``compute_dtype``.
- ``BatchNorm2d`` / ``GroupNorm``: compute in float32 whatever they are fed,
  and return float32. ``BatchNorm2d.forward(x, train)`` takes the mode as an
  argument, as the JAX modules do; ``nn.Module.train()`` is not consulted.
  momentum 0.1 equals Flax's 0.9 (the conventions are one minus the other).
  The running variance folds in the *biased* batch variance, as
  ``flax.linen.BatchNorm`` does (``F.batch_norm`` would fold in the unbiased
  one, a factor n/(n−1) on the update term), so that a trained model's
  ``train=False`` output equals the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` with float32 parameters."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """float32 batch norm with an explicit ``train`` argument."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(
                x.float(), self.running_mean, self.running_var, self.weight, self.bias,
                training=False, momentum=self.momentum, eps=self.eps,
            )
        # the statistics are updated by hand from the batch mean and the biased
        # batch variance (1/invstd² − eps) that the normalisation saves anyway
        out, mean, invstd = torch.native_batch_norm(
            x.float(), self.weight, self.bias, None, None, True, self.momentum, self.eps
        )
        with torch.no_grad():
            self.num_batches_tracked += 1
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2).sub_(self.eps), self.momentum)
        return out


class GroupNorm(nn.GroupNorm):
    """float32 group norm."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
