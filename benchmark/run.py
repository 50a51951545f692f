"""Run one cell of the benchmark once and print its result as the last line.

    python benchmark/run.py --workload md2_r18.train_b96 --seed 7 --seconds 40 --trace 0

Run from the root of a checkout. Everything is found by name from
``BENCHMARK.json``: the cell (``workloads``), its configuration
(``configs[].file``), its traffic mix (``benchmark/traffic/<traffic>.json``,
whose ``kind`` names the driver ``benchmark/drivers/<kind>.py``), the limits of
its comparison (``benchmark/checks/<workload>.json``) and, with ``--trace 1``,
each per-layer metric's reader (``benchmark/metrics/<metric>.py``).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics and the device's busy time from a traced stretch. Both
compare the checked steps with the plain reference and print each number
beside its limit, last on standard error and last in the result's line.

Exits non-zero, printing no result, without a CUDA device, with fewer devices
than the cell needs, where the system under test cannot be imported, or where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
METRICS = os.path.join(HERE, "metrics")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "simpledepthestimation_tpu"}

# every build and kernel cache at a fixed place inside the checkout, set before torch loads
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

from core.trace import breakdown  # noqa: E402


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_of(bench, name):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, config


def applies(metric, cell):
    """A metric with ``workloads`` applies to those cells; one without, to every cell."""
    return cell["name"] in metric.get("workloads", [cell["name"]])


def reader(name):
    path = os.path.join(METRICS, f"{name}.py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def assemble(bench, cell, out, trace, device, limits):
    """The result line of a driver's ``out``: with ``trace`` the cell's
    per-layer metrics, each read by its own reader (left out where it finds
    nothing), the traced window's busy and total seconds and the breakdown;
    without, its end-to-end metrics. The compared numbers come last."""
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if trace:
        run = out["run"]
        for m in bench["per_layer"]:
            if applies(m, cell):
                value = reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(device, busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        result.update(metrics=metrics, device=device, breakdown=breakdown(run.trace, run.host_trace))
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
        result.update(metrics=metrics, device=device)
    result["check"] = {k: {"value": v, "limit": limits[k]} for k, v in out["check"].items()}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config_entry = cell_of(bench, args.workload)
    config = load_json(os.path.join(ROOT, config_entry["file"]))
    mix = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    limits = {k: v["limit"] for k, v in load_json(os.path.join(HERE, "checks", f"{cell['name']}.json")).items()}

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    driver = importlib.import_module(f"drivers.{mix['kind']}")
    out = driver.run(config, mix, args.seed, args.seconds, bool(args.trace), "cuda", T0, limits)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    return report(bench, cell, out, bool(args.trace), device, limits)


def report(bench, cell, out, trace, device, limits):
    """Assemble the result line, print the notes and each compared number
    beside its limit on standard error, and print the line, unless JAX or the
    JAX package is loaded by then (checked last, after every reader has
    run): then name what was found and print no result. Returns the exit code."""
    result = assemble(bench, cell, out, trace, device, limits)
    for line in out["notes"]:
        print(line, file=sys.stderr)
    for k, v in out["readings"].items():
        if k not in out["check"]:
            print(f"reading {k} {v} (not compared)", file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v} limit {limits[k]}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX package)", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
