"""The control, on the card at each cell's own size: the plain reference
one precision below the configuration's (TF32 for float32, float32 for
float64) put in the program's place must fail at least one of the cell's
checked numbers, on three seeds. Run with ``python -m pytest -q -m gpu
perfbench/tests`` on a machine with a card; skips without one."""

import importlib

import pytest
import torch

from perfbench.harness import spec
from perfbench.readings import control_samples

SEEDS = (4_100_000_001, 4_100_000_002, 4_100_000_003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_bench()["workloads"]])
def test_control_fails_a_limit(workload, seed, card):
    cell = spec.load_cell(workload)
    op = importlib.import_module(f"perfbench.ops.{cell.config['op']}").Op(
        cell.config, cell.mix, seed, card)
    numbers = op.numbers(control_samples(op, cell.mix, seed))
    over = {k: v for k, v in numbers.items()
            if not v <= cell.limits[k]["limit"]}
    print(workload, seed, numbers)
    assert over, f"the control passes every limit: {numbers}"
