"""The plain reference against the system under test, both in float32 at a
small size on the CPU: each step's loss, the first gradient and the change of
the parameters over the checked steps, from one set of seeded weights."""

import copy

import pytest
import torch

from conftest import SMALL, cell_parts


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_reference_follows_the_port_in_float32(bench, workload):
    import calibrate
    from drivers import train

    _, config, mix, _ = cell_parts(bench, workload, *SMALL[workload])
    config = copy.deepcopy(config)
    config["cfg"]["TPU"]["COMPUTE_DTYPE"] = "float32"
    values = calibrate.readings(config, mix, 7, "cpu", train.build_program)
    # same weights and batch, float32 both: the first loss and gradient agree to round-off
    # (the worst parameter's gradient sums over the most terms: PackNet's packed layers)
    assert values["loss_gap_first"] < 1e-5
    assert values["grad_gap_median"] < 1e-4
    assert values["grad_gap_mean"] < 1e-3
    assert values["grad_gap_worst"] < 1e-2
    # Adam moves every element by about ±lr whatever the size of its gradient, so an
    # element whose gradient is near round-off moves either way, and the later losses follow
    assert values["loss_gap"] < 1e-3
    assert values["change_gap_median"] < 1e-3
    assert values["change_gap_worst"] < 2e-2


def test_reference_imports_nothing_of_the_system():
    import ast
    import os

    from conftest import BENCH

    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            with open(os.path.join(ref, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    tops = [(node.module or "").split(".")[0]] if node.level == 0 else []
                else:
                    continue
                assert set(tops) <= {"torch", "contextlib", "typing", "__future__"}, (name, tops)


def test_weights_are_the_seeds():
    from core.weights import seeded_weights

    shapes = [("a.weight", torch.Size([4, 3, 3, 3])), ("a.bias", torch.Size([4])), ("n.weight", torch.Size([4]))]
    one = seeded_weights(shapes, 2**31 + 11, "cpu")
    two = seeded_weights(shapes, 2**31 + 11, "cpu")
    other = seeded_weights(shapes, 2**31 + 12, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert torch.equal(one["a.bias"], torch.zeros(4)) and torch.equal(one["n.weight"], torch.ones(4))
    assert abs(float(one["a.weight"].std()) - (1 / 27) ** 0.5) < 0.1
