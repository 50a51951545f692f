"""Monodepth2-style U-Net depth decoder (NCHW).

Counterpart of ``simpledepthestimation_tpu/models/depth_decoder.py``: 5
up-stages (upconv0 → nearest 2× → skip concat → upconv1), softplus disparity
heads at 4 scales. The convs sit in one ``ModuleList`` named ``decoder`` at
indices 0..13, the way checkpoints of this architecture name them:
(upconv,i,0), (upconv,i,1) for i = 4..0 at indices 0..9, then (dispconv,s)
for s = 0..3 at indices 10..13.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv3x3, ConvBlock, upsample_nearest_2x


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Tuple[int, ...], compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        num_ch_dec = (16, 32, 64, 128, 256)
        convs = []
        for i in range(4, -1, -1):
            in0 = num_ch_enc[-1] if i == 4 else num_ch_dec[i + 1]
            convs.append(ConvBlock(in0, num_ch_dec[i], compute_dtype))
            in1 = num_ch_dec[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            convs.append(ConvBlock(in1, num_ch_dec[i], compute_dtype))
        for s in range(4):
            convs.append(Conv3x3(num_ch_dec[s], 1, compute_dtype=compute_dtype))
        self.decoder = nn.ModuleList(convs)

    def forward(self, input_features: Sequence[torch.Tensor]) -> Dict[int, torch.Tensor]:
        outputs: Dict[int, torch.Tensor] = {}
        x = input_features[-1]
        for i in range(4, -1, -1):
            k = 2 * (4 - i)
            x = self.decoder[k](x)
            x = upsample_nearest_2x(x)
            if i > 0:
                x = torch.cat([x.float(), input_features[i - 1]], dim=1)
            x = self.decoder[k + 1](x)
            if i < 4:
                outputs[i] = F.softplus(self.decoder[10 + i](x))
        return outputs
