"""Readings that the limits of a cell's comparison are set from.

    python benchmark/calibrate.py --workload md2_r18.train_b96 --variant program --seeds 101-112

For each seed, in one process: the cell's pool, weights and train state, its
three checked steps through ``device_prefetch`` as a run's set-up makes them,
then the plain reference, and the numbers that ``core.check`` compares; one
JSON line per seed. ``--variant``: ``program`` (the system under test),
``fp8`` (the control: the reference with its convolutions in float8 in the
program's place), ``half_batch`` and ``state_unchanged`` (the system with
that fault planted). No window is run: the numbers come from set-up alone.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from core import check, faults  # noqa: E402
from drivers import train  # noqa: E402
from traffic import generator as traffic  # noqa: E402

VARIANTS = {
    "program": train.build_program,
    "fp8": faults.reference_in_float8,
    "half_batch": faults.half_batch(train.build_program),
    "state_unchanged": faults.state_unchanged(train.build_program),
}


def readings(config, mix, seed, device, build):
    from simpledepthestimation_tpu_torch.engine.runtime import device_prefetch

    cfg = train.port_cfg(config)
    pool = traffic.make_pool(mix, seed, device)
    shapes = train.reference_shapes(config)
    weights = train.start_weights(shapes, seed, device, mix)
    state, step = build(cfg, weights, device, traffic.steps_per_epoch(mix))
    feed = device_prefetch(itertools.cycle(pool), torch.device(device))
    program = train.checked_steps(state, step, feed, weights)
    del state, step, feed, weights
    train.free_device(torch.device(device).type == "cuda")
    return check.readings(program, train.reference_readings(config, mix, pool, shapes, seed, device))


def seed_list(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="program")
    ap.add_argument("--seeds", type=seed_list, required=True, help="first-last")
    args = ap.parse_args(argv)
    root = os.path.dirname(HERE)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    mix = traffic.load(cell["traffic"])
    for seed in args.seeds:
        t = time.perf_counter()
        values = readings(config, mix, seed, "cuda", VARIANTS[args.variant])
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed, **values,
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
