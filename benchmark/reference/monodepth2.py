"""Plain float32 MonoDepth2 training in PyTorch: the loss, its backward and Adam.

The self-supervised objective of MonoDepth2 (Godard et al. 2019,
arXiv:1806.01260) as the benchmark's configurations state it: per scale the
target and contexts resized bilinearly (corners aligned) to the depth map, the
contexts warped into the target through the predicted depth and pose
(``F.grid_sample``, zeros outside), the photometric error α·SSIM + (1−α)·L1
(3×3 SSIM window over a reflection pad), the per-pixel minimum over the warped
and (automask) the unwarped contexts, its mean, and the edge-aware smoothness
of the mean-normalised inverse depth weighted by 1/2^(3−i) at scale i. Adam is
written out (Kingma & Ba, bias-corrected, ε outside the square root).

Nothing here imports the system under test: it reads the benchmark's own
batches and weights, and is judged against only by what the system returns.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nets import DepthResNet, PackNet01A, PoseNet

PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)


class MonoDepth2(nn.Module):
    """``depth_net`` and ``pose_net`` under the names the checkpoints use."""

    def __init__(self, depth_net: nn.Module, num_contexts: int, loss: Dict):
        super().__init__()
        self.depth_net = depth_net
        self.pose_net = PoseNet(num_contexts)
        self.alpha = float(loss["SSIM_WEIGHT"])
        self.C1, self.C2 = float(loss["C1"]), float(loss["C2"])
        self.smooth_w = float(loss["SMOOTHNESS_WEIGHT"])
        self.automask = bool(loss["AUTOMASK"])

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        mean = torch.tensor(PIXEL_MEAN, device=batch["img"].device).reshape(1, 3, 1, 1)
        std = torch.tensor(PIXEL_STD, device=batch["img"].device).reshape(1, 3, 1, 1)
        depths = self.depth_net((batch["img"] - mean) / std, batch["flip"])
        ctx = batch["ctx_img"]
        B, N, _, H, W = ctx.shape
        poses = self.pose_net(torch.cat([batch["img"]] + [ctx[:, j] for j in range(N)], 1))
        image, contexts, K = batch["img_orig"], batch["ctx_img_orig"], batch["intrinsics"]

        rec, smooth = [], []
        n_scales = len(depths)
        for i, depth in enumerate(depths):
            h, w = depth.shape[2:]
            target = resize(image, h, w)
            Ki = K * torch.tensor([[w / W, 1.0, w / W], [1.0, h / H, h / H], [1.0, 1.0, 1.0]], device=K.device)
            maps = []
            for j in range(N):
                src = resize(contexts[:, j], h, w)
                maps.append(self.photometric(warp(src, depth, Ki, *poses[j]), target))
            if self.automask:
                maps += [self.photometric(resize(contexts[:, j], h, w), target) for j in range(N)]
            rec.append(torch.stack(maps).amin(dim=0).mean())
            smooth.append(smoothness(depth, target) * self.smooth_w / 2 ** (n_scales - i - 1) / n_scales)
        return sum(rec) / n_scales + sum(smooth)

    def photometric(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        l1 = (a - b).abs().mean(1, keepdim=True)
        return self.alpha * ssim(a, b, self.C1, self.C2).mean(1, keepdim=True) + (1 - self.alpha) * l1


def build(cfg: Dict) -> MonoDepth2:
    """The reference for a configuration's ``cfg`` (the benchmark's JSON file)."""
    model = cfg["MODEL"]
    net = model["DEPTH_NET"]
    max_depth = float(model["MAX_DEPTH"])
    if net["NAME"] == "DepthResNet" and str(net["ENCODER_NAME"]).startswith("18"):
        depth_net = DepthResNet(max_depth)
    elif net["NAME"] == "PackNet01" and net.get("VERSION") == "1A":
        depth_net = PackNet01A(max_depth)
    else:
        raise ValueError(f"no reference for {net}")
    return MonoDepth2(depth_net, int(model["POSE_NET"]["NUM_CONTEXTS"]), cfg["LOSS"])


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def warp(src: torch.Tensor, depth: torch.Tensor, K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``src`` seen from the target camera: lift each target pixel by ``depth``,
    move it by (R, t), project with K, sample ``src`` bilinearly there."""
    B, _, h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device, dtype=torch.float32),
                            torch.arange(w, device=depth.device, dtype=torch.float32), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(1, 3, h * w)
    fx, fy, cx, cy = K[:, 0, 0, None], K[:, 1, 1, None], K[:, 0, 2, None], K[:, 1, 2, None]
    z = depth.reshape(B, h * w)
    cam = torch.stack([(pix[:, 0] - cx) / fx * z, (pix[:, 1] - cy) / fy * z, z], 1)  # [B,3,hw]
    proj = K @ (R @ cam + t)
    x = torch.nan_to_num(proj[:, 0] / (proj[:, 2] + 1e-6)).clamp(0, w - 1)
    y = torch.nan_to_num(proj[:, 1] / (proj[:, 2] + 1e-6)).clamp(0, h - 1)
    grid = torch.stack([2 * x / (w - 1) - 1, 2 * y / (h - 1) - 1], -1).reshape(B, h, w, 2)
    return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def ssim(x: torch.Tensor, y: torch.Tensor, C1: float, C2: float) -> torch.Tensor:
    """SSIM distance clamp((1 − SSIM)/2, 0, 1) over 3×3 windows of a reflection pad."""
    def pool(v):
        return F.avg_pool2d(F.pad(v, (1, 1, 1, 1), mode="reflect"), 3, stride=1)

    mx, my = pool(x), pool(y)
    sx, sy, sxy = pool(x * x) - mx * mx, pool(y * y) - my * my, pool(x * y) - mx * my
    n = (2 * mx * my + C1) * (2 * sxy + C2)
    d = (mx * mx + my * my + C1) * (sx + sy + C2)
    return torch.clamp((1 - n / d) / 2, 0, 1)


def smoothness(depth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / depth.clamp_min(1e-6)
    inv = inv / inv.mean((2, 3), keepdim=True).clamp_min(1e-6)
    dx, dy = inv[..., :-1] - inv[..., 1:], inv[..., :-1, :] - inv[..., 1:, :]
    wx = torch.exp(-(image[..., :-1] - image[..., 1:]).abs().mean(1, keepdim=True))
    wy = torch.exp(-(image[..., :-1, :] - image[..., 1:, :]).abs().mean(1, keepdim=True))
    return (dx * wx).abs().mean() + (dy * wy).abs().mean()


@contextlib.contextmanager
def full_float32():
    """float32 matrix products and convolutions without TF32, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Adam:
    """Adam over named parameters, with one learning rate per parameter."""

    def __init__(self, params: Dict[str, torch.Tensor], lrs: Dict[str, float], betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lrs, self.betas, self.eps, self.t = params, lrs, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lrs[k] * m_hat / (v_hat.sqrt() + self.eps))


def learning_rates(model: nn.Module, solver: Dict) -> Dict[str, float]:
    """``adam_multistep`` before its first milestone: POSE_LR for the pose net,
    DEPTH_LR for the rest."""
    if solver["OPT"] != "adam_multistep":
        raise ValueError(f"no reference for SOLVER.OPT {solver['OPT']}")
    return {k: float(solver["POSE_LR"] if k.startswith("pose_net.") else solver["DEPTH_LR"])
            for k, _ in model.named_parameters()}


def train(model: MonoDepth2, batches: Sequence[Dict[str, torch.Tensor]], solver: Dict) -> Dict[str, object]:
    """Train ``model`` in place for one step per batch. Returns each step's
    loss, the first step's gradient by parameter and the parameters' change
    over all the steps by parameter."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, learning_rates(model, solver), eps=float(solver.get("EPS", 1e-8)))
    losses: List[float] = []
    first_grads = None
    for batch in batches:
        loss = model(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
        losses.append(loss.item())
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in grads.items()}
        opt.step(grads)
    change = {k: (p.detach() - start[k]) for k, p in params.items()}
    return {"losses": losses, "first_grads": first_grads, "change": change}
