"""Model FLOPs of one training step, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the reference's forward and
backward at the cell's shapes on the meta device (shapes only: nothing is
computed and nothing is allocated), so the count is the same whatever
implements the step and includes no recomputation.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import monodepth2

BF16_DENSE_FLOPS_PER_S = 989e12  # one H100 SXM, bfloat16 dense, full power limit


def train_step_flops(cfg: Dict, B: int, N: int, H: int, W: int) -> int:
    with torch.device("meta"):
        model = monodepth2.build(cfg)
        batch = {"img": torch.empty(B, 3, H, W), "img_orig": torch.empty(B, 3, H, W),
                 "ctx_img": torch.empty(B, N, 3, H, W), "ctx_img_orig": torch.empty(B, N, 3, H, W),
                 "intrinsics": torch.empty(B, 3, 3), "flip": torch.empty(B, dtype=torch.bool)}
        counter = FlopCounterMode(display=False)
        with counter:
            model(batch).backward()
    return int(counter.get_total_flops())
