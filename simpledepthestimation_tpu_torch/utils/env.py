"""Seeding and environment information."""

from __future__ import annotations

import datetime
import logging
import os
import random
import sys
from typing import Optional

import numpy as np
import torch


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seed Python's, numpy's and torch's global generators; a generated seed
    when ``seed`` is None or negative. Returns the seed used. The training
    noise and the data pipeline use explicit generators of their own; this
    covers whatever else draws from the global ones."""
    if seed is None or seed < 0:
        seed = (os.getpid() + int(datetime.datetime.now().strftime("%S%f"))
                + int.from_bytes(os.urandom(2), "big"))
        logging.getLogger(__name__).info(f"Using a generated random seed {seed}")
    seed = int(seed) % (2**31)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return seed


def collect_env_info() -> str:
    lines = [
        f"python: {sys.version.split()[0]}",
        f"numpy: {np.__version__}",
        f"torch: {torch.__version__} (CUDA {torch.version.cuda})",
        f"cuda available: {torch.cuda.is_available()}",
    ]
    if torch.cuda.is_available():
        lines.append(f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
    return "\n".join(lines)
