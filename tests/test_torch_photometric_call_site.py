"""The MonoDepth2 loss's photometric call site: the identity reprojections'
map is a call of its own, so the map's VJP runs on the N·B warped planes of a
scale and not on all 2N·B candidates.

On the CPU (the plain versions), MonoDepth2-R18 in float32 at B=2, 64x128,
N=2, smooth frames: one train forward + backward of the port's model against
the same model computing each scale's maps as one call on the concatenated
candidates (written out below). The loss dict and every parameter gradient
agree to 1e-6 (relative to each tensor's largest value); the VJP sees N·B
planes per scale instead of 2N·B.
"""

import copy
import types

import pytest
import torch

from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.ops import photometric

from torch_port_helpers import batch_to_torch, make_batch, monodepth2_cfgs

B, H, W, N = 2, 64, 128, 2
TOL = 1e-6


def _concatenated_scale_maps(self, resized_image, sampled, resized_targets, N):
    """One scale's maps as one call on [warped; identity] against a 2N-fold
    repeated target, clipped per group of B."""
    B = resized_image.shape[0]
    if self.automask:
        candidates = torch.cat([sampled, resized_targets], dim=0)
        ref = resized_image.repeat(2 * N, 1, 1, 1)
    else:
        candidates = sampled
        ref = resized_image.repeat(N, 1, 1, 1)
    return self._clip(self._photometric_map(ref, candidates), n_groups=candidates.shape[0] // B)


@pytest.mark.parametrize("overrides", [[], ["LOSS.CLIP", "0.5"]], ids=["config-default", "clip"])
def test_vjp_sees_only_the_warped_planes(overrides, monkeypatch):
    _, cfg = monodepth2_cfgs(overrides)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    concatenated = copy.deepcopy(model)
    concatenated._scale_maps = types.MethodType(_concatenated_scale_maps, concatenated)
    batch = batch_to_torch(make_batch(seed=10, B=B, H=H, W=W, N=N, smooth=True))

    planes = []
    vjp = photometric.photometric_vjp

    def recording_vjp(a, *args, **kwargs):
        planes.append(a.shape[0])
        return vjp(a, *args, **kwargs)

    monkeypatch.setattr(photometric, "photometric_vjp", recording_vjp)

    def loss_and_grads(m):
        planes.clear()
        losses = m(batch, train=True)
        sum(losses.values()).backward()
        return ({k: float(v) for k, v in losses.items()},
                {k: p.grad.clone() for k, p in m.named_parameters()}, list(planes))

    losses, grads, seen = loss_and_grads(model)
    ref_losses, ref_grads, ref_seen = loss_and_grads(concatenated)
    assert seen == [N * B] * 4  # one VJP per scale, on the warped planes only
    assert ref_seen == [2 * N * B] * 4
    assert set(losses) == set(ref_losses) == {"rec_loss", "smooth_loss"}
    for k, v in ref_losses.items():
        assert abs(losses[k] - v) <= TOL * abs(v), k
    assert any(float(g.abs().max()) > 0 for k, g in ref_grads.items() if k.startswith("pose_net."))
    for k, g in ref_grads.items():
        assert (grads[k] - g).abs().max().item() <= TOL * max(g.abs().max().item(), 1e-30), k
