"""Tests of the benchmark's harness, on the CPU at small sizes (those marked
``cuda`` run on a card only). Run from the checkout's root:

    python -m pytest benchmark/tests -q
"""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def load_json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def bench():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_parts(bench, workload, batch, height, width):
    """The cell's configuration, its mix cut to ``batch`` × ``height`` ×
    ``width`` and its limits."""
    from traffic import generator as traffic

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(ROOT, entry["file"]))
    mix = copy.deepcopy(traffic.load(cell["traffic"]))
    mix.update(batch=batch, height=height, width=width, pool=3, warmup_steps=1, trace_steps=1, host_trace_steps=1)
    limits = {k: v["limit"] for k, v in load_json(os.path.join(BENCH, "checks", f"{workload}.json")).items()}
    return cell, config, mix, limits


# small sizes the CPU holds: (batch, height, width) per cell
SMALL = {"md2_r18.train_b96": (4, 64, 128), "packnet_1a.train_b8": (2, 64, 64)}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)
