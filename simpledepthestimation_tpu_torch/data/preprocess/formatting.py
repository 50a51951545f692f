"""uint8 HWC frames → float32 HWC in [0, 1] (``ToTensor``).

As in the JAX package, a sample's arrays stay HWC numpy through the whole
preprocess list, so each op reads line for line like its counterpart; the
batch collator (``data/build.py``) makes the NCHW tensors.
"""

from __future__ import annotations

import numpy as np

from .build import PREPROCESS_REGISTRY, Preprocess


@PREPROCESS_REGISTRY.register()
class ToTensor(Preprocess):
    def forward(self, data_dict, rng=None):
        for key in ("img", "img_orig"):
            if key in data_dict:
                data_dict[key] = data_dict[key].astype(np.float32) / 255.0
        for key in ("ctx_img", "ctx_img_orig"):
            if key in data_dict:
                data_dict[key] = [a.astype(np.float32) / 255.0 for a in data_dict[key]]
        return data_dict
