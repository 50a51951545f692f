"""The harness on the CPU at a small size: a rehearsal of each cell through the
driver, the result line it would print, and what the run loads."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import BENCH, ROOT, SMALL, cell_parts

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "simpledepthestimation_tpu"}


def rehearsal(bench, workload, trace):
    """A run of the cell on the CPU at a small size: the cell, the driver's
    output, the limits and the device record."""
    from drivers import train

    cell, config, mix, limits = cell_parts(bench, workload, *SMALL[workload])
    out = train.run(config, mix, 2**31 + 99, 0.5, trace, "cpu", time.perf_counter(), limits)
    device = {"platform": "cpu", "kind": "rehearsal", "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    return cell, out, limits, device


def rehearse(bench, workload, trace):
    import run as harness

    cell, out, limits, device = rehearsal(bench, workload, trace)
    return json.loads(json.dumps(harness.assemble(bench, cell, out, trace, device, limits))), cell, out


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(bench, trace):
    line, cell, out = rehearse(bench, "md2_r18.train_b96", trace)
    assert isinstance(line["correct"], bool)
    assert isinstance(line["attempted"], int) and line["attempted"] >= 1
    assert line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        # on the CPU no device operation is traced: the device metrics' readers find nothing
        assert set(line["metrics"]) == {"step.enqueue_ms.train"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert list(line)[-1] == "check"
    assert set(line["check"]) == {"loss_gap", "grad_gap_worst", "grad_gap_mean", "change_gap_worst",
                                  "nonfinite_steps"}
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())


@pytest.mark.parametrize("reader_loads_jax", [False, True])
def test_jax_loaded_by_a_reader_withholds_the_result(bench, tmp_path, monkeypatch, capsys, reader_loads_jax):
    """The check for JAX comes after every per-layer reader has run: a reader
    that loads a module named ``jax`` (a stub here) once the window has
    closed makes the run exit non-zero and print no result; the same run
    with readers that load nothing prints its line."""
    import run as harness

    cell, out, limits, device = rehearsal(bench, "md2_r18.train_b96", True)
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "jax.py").write_text("")
    (tmp_path / "metrics").mkdir()
    body = ("import jax\n" if reader_loads_jax else "") + "\n\ndef read(run):\n    return 1.0\n"
    for m in bench["per_layer"]:
        (tmp_path / "metrics" / f"{m['name']}.py").write_text(body)
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    monkeypatch.setattr(harness, "METRICS", str(tmp_path / "metrics"))
    assert "jax" not in sys.modules
    try:
        rc = harness.report(bench, cell, out, True, device, limits)
    finally:
        loaded = sys.modules.pop("jax", None) is not None
    printed = capsys.readouterr()
    assert loaded is reader_loads_jax
    if reader_loads_jax:
        assert rc != 0 and printed.out == ""
        assert "jax" in printed.err
    else:
        assert rc == 0 and set(json.loads(printed.out.strip().splitlines()[-1])["metrics"]) == {
            m["name"] for m in bench["per_layer"] if cell["name"] in m["workloads"]}


def test_every_file_is_found_by_name(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/configs/")
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(BENCH, "checks", f"{w['name']}.json"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]


REHEARSAL = """
import json, sys, time
sys.path[:0] = [{bench!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from conftest import SMALL, cell_parts, load_json
from drivers import train
bench = load_json({bench_json!r})
for workload in sorted(SMALL):
    cell, config, mix, limits = cell_parts(bench, workload, *SMALL[workload])
    train.run(config, mix, 5, 0.2, True, "cpu", time.perf_counter(), limits)
print(json.dumps(sorted({{name.split(".")[0] for name in sys.modules}})))
"""


def test_a_rehearsal_loads_no_jax():
    """After a rehearsal of each cell, in a process of its own, no module of
    JAX or of the JAX package is loaded (by whole top-level name: the
    system's own name begins with the JAX package's)."""
    code = REHEARSAL.format(bench=BENCH, tests=os.path.join(BENCH, "tests"),
                            bench_json=os.path.join(ROOT, "BENCHMARK.json"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    loaded = set(json.loads(done.stdout.strip().splitlines()[-1]))
    assert "simpledepthestimation_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_harness_imports_no_jax():
    import ast

    for folder, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    tree = ast.parse(f.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        tops = {a.name.split(".")[0] for a in node.names}
                    elif isinstance(node, ast.ImportFrom) and node.level == 0:
                        tops = {(node.module or "").split(".")[0]}
                    else:
                        continue
                    assert not tops & FORBIDDEN, (name, tops)


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no result."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    done = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "md2_r18.train_b96",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
