"""The comparison has to fail: the control (the reference computed in float8 in
the system's place) and the system with each fault a one-card training cell
can have planted in its timed path, driven through the rest of a run, come out
not ``correct`` under the cell's limits. On the CPU at a small size; the
control also at the cell's own size on a card (``cuda``)."""

import time

import pytest

from conftest import SMALL, cell_parts

STANDS_IN = ["fp8", "half_batch", "state_unchanged"]


@pytest.mark.parametrize("variant", STANDS_IN)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_run_with_the_fault_is_not_correct(bench, workload, variant):
    import calibrate
    from drivers import train

    _, config, mix, limits = cell_parts(bench, workload, *SMALL[workload])
    out = train.run(config, mix, 3, 0.2, False, "cpu", time.perf_counter(), limits, build=calibrate.VARIANTS[variant])
    assert out["correct"] is False, out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_fails_at_the_cells_size_on_a_card(bench, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import calibrate
    from drivers import train
    from traffic import generator as traffic

    cell, config, _, limits = cell_parts(bench, workload, *SMALL[workload])
    mix = traffic.load(cell["traffic"])  # the cell's own sizes
    for seed in (11, 12, 13):
        values = calibrate.readings(config, mix, seed, "cuda", calibrate.VARIANTS["fp8"])
        values["nonfinite_steps"] = 0
        assert not train.check.judge(values, limits), values
