"""PyTorch/CUDA port of ``simpledepthestimation_tpu`` for NVIDIA Hopper.

Same sub-package names as the JAX package (``config/ utils/ geometry/ ops/
models/``): the counterpart of a module is found by its path. This package
imports ``torch`` (+ numpy, yaml) and nothing of JAX or of the JAX package.

Layout (decided once, here): everything is **NCHW and contiguous** —
``img [B,3,H,W]``, ``ctx_img [B,N,3,H,W]``, depth ``[B,1,H,W]``, warp
coordinates ``x, y [B,H,W]``, ``intrinsics [B,3,3]``, ``flip [B]`` bool. That
is the layout of ``state_dict`` weights, of cuDNN and of the hand-written
kernels under ``csrc/``. The package never transposes to or from NHWC; tests
that compare with the NHWC JAX package transpose in a test helper.

Device: entry points (``models.build_model(cfg, device=None)``) default to
``torch.device("cuda")`` and raise when no CUDA device is present. The CPU is
used only when the caller passes ``device="cpu"``. Kernel wrappers
(``ops/warp.py``, ``ops/photometric.py``) launch their CUDA kernel for a CUDA
tensor and take their plain PyTorch version only for a CPU tensor.

Randomness is explicit: weight initialisation takes a ``torch.Generator``, and
so does the noise of ``RandLayerNorm`` (a training state carries one on the
model's device).
"""
